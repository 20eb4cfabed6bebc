// The MLP forward on the points-stage machinery: K4's kernel
// (fused_shaded.cu), the forward of K3's composed path
// (fused_render_bwd.cu) and of K2 (fused_render.cu), all with the shading
// epilogue, and K1 (fused_mlp.cu) with the raw one.  Its design, budget
// and bound: fused_shaded.cu.
#pragma once

#include "mlp_bwd_points.cuh"

namespace mcn {

// One ReLU layer of the forward: the bias of the lane's columns into
// registers first, so that its loads wait under the products (2% at the
// fine pass on an H100 against loading it after them, PERF.md), then
// ring_gemm and bf16(relu(acc + bias)) into the warp's rows of buf,
// visible to the next product.  No mask bits, nothing to the workspace:
// no backward follows.
template <int NC>
__device__ __forceinline__ void fwd_layer(const PtGemm& G, uint32_t a_addr, uint32_t half,
                                          Ring& rg, const bf16* __restrict__ bias,
                                          unsigned char* buf, const Frag& f) {
  __nv_bfloat162 b[NC / 8];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
    b[j] = *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * j + 2 * f.tig);
  float acc[NC / 2];
  ring_gemm<NC>(G, a_addr, half, acc, rg);
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162 v;
      v.x = __float2bfloat16_rn(fmaxf(acc[4 * j + 2 * h] + __bfloat162float(b[j].x), 0.f));
      v.y = __float2bfloat16_rn(fmaxf(acc[4 * j + 2 * h + 1] + __bfloat162float(b[j].y), 0.f));
      *reinterpret_cast<__nv_bfloat162*>(frag_at(buf, (int)half, j, h, f)) = v;
    }
  __syncwarp();
  wg_sync();
}

// fwd_layer at the product's width (32, 64, 128 or 256).
__device__ __forceinline__ void fwd_layer_at(int nc, const PtGemm& G, uint32_t a_addr,
                                             uint32_t half, Ring& rg, const bf16* bias,
                                             unsigned char* buf, const Frag& f) {
  switch (nc) {
    case 256: fwd_layer<256>(G, a_addr, half, rg, bias, buf, f); break;
    case 128: fwd_layer<128>(G, a_addr, half, rg, bias, buf, f); break;
    case 64: fwd_layer<64>(G, a_addr, half, rg, bias, buf, f); break;
    default: fwd_layer<32>(G, a_addr, half, rg, bias, buf, f); break;
  }
}

// What fwd_consume writes from the output fragment (its template argument):
constexpr int FWD_SHADED = 0;  // K4, K3's composed forward: [P, 8] rows, sigma and rgb
constexpr int FWD_RAW = 1;     // K1: [P, 32] rows, the packed head's raw output

// Where fwd_consume's features come from (its second template argument):
constexpr int FEAT_ROWS = 0;  // feat [P, enc] bf16 rows (load_feat_rows): training, the
                              //   public feat entry points
constexpr int FEAT_RAYS = 1;  // encoded in the prologue from the rays and depths (encode_rows)
constexpr int ENC_PAD = 4;    // [x, y, z, 0] ahead of the octaves in the encode's lanes

// The warp's 16 rows of the kernel-order encode (ops/cuda/fused_mlp.py::
// encode_kernel_order) into the feature columns [0, ep) of its act buffer,
// in load_feat_rows' core-matrix layout: row row0 + r is ray (row0 + r) /
// s, sample (row0 + r) % s, so its depth is z[row0 + r] of z [rays, s];
// xyz = o + d z, then lanes [x, y, z, 0, sin f0 x3, cos f0 x3, ...] of
// the double-angle recurrence of models/encoding.py::spectrum_octaves
// (s' = (2s) c, c' = 1 - (2s) s), each op rounded on its own as torch's
// kernels round it (no contraction into an FMA; sinf / cosf the precise
// functions), each lane rounded to bf16.  Rows at or past nr, the pad lane
// and the lanes past enc are zero.  The 48 chains of a warp (16 rows x 3
// coordinates) run two a lane: coordinate lane / 16 and coordinate 2 of
// row lane % 16 (lanes 16..31 compute the second and keep none of it).
__device__ __forceinline__ void encode_rows(const MLPParams& p, const PtArgs& a, long long row0,
                                            int nr, unsigned char* act, int half, int ep) {
  const int lane = threadIdx.x & 31, chunks = ep >> 3;
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int r8 = idx & 7, rest = idx >> 3;
    const int c = rest % chunks, hh = rest / chunks;
    *reinterpret_cast<uint4*>(act + hh * half + c * 128 + r8 * 16) = make_uint4(0, 0, 0, 0);
  }
  __syncwarp();
  const int r = lane & 15;
  if (r < nr) {
    const long long i = row0 + r, ray = i / a.s;
    const float z = a.z[i];
    const int dim[2] = {lane >> 4, 2};
    const bool keep[2] = {true, lane < 16};
    unsigned char* row = act + (r >> 3) * half + (r & 7) * 16;
    float s[2], c[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float x =
          __fadd_rn(a.rays_o[3 * ray + dim[k]], __fmul_rn(a.rays_d[3 * ray + dim[k]], z));
      s[k] = sinf(x);
      c[k] = cosf(x);
      if (keep[k]) {
        const int e = dim[k];
        *reinterpret_cast<bf16*>(row + (e >> 3) * 128 + (e & 7) * 2) = __float2bfloat16_rn(x);
      }
    }
    const int n_freqs = (p.enc - ENC_PAD) / 6;
    for (int f = 0; f < n_freqs; ++f) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (keep[k]) {
          const int es = ENC_PAD + 6 * f + dim[k], ec = es + 3;
          *reinterpret_cast<bf16*>(row + (es >> 3) * 128 + (es & 7) * 2) =
              __float2bfloat16_rn(s[k]);
          *reinterpret_cast<bf16*>(row + (ec >> 3) * 128 + (ec & 7) * 2) =
              __float2bfloat16_rn(c[k]);
        }
        const float s2 = __fmul_rn(2.f, s[k]);
        const float sn = __fmul_rn(s2, c[k]);
        c[k] = __fsub_rn(1.f, __fmul_rn(s2, s[k]));
        s[k] = sn;
      }
    }
  }
  __syncwarp();
}

// One consumer warp's share of every tile of its block (tiles b, b + G,
// ...), in its slab (act [ep + width] and h1 [nch] columns of its 16 rows;
// its warpgroup's four slabs are the A operand): the recompute of
// mlp_points_kernel (pt_consume) with nothing kept for a backward -- feat
// into the act buffer, the trunk (h over the act buffer's hidden columns),
// head layer 0 in passes of nch columns, each followed by its share of
// head layer 1 into the output fragment o, plus head layer 1's bias --
// then, by EPI: FWD_SHADED, the warp's rows of [P, 8] from o (forward_out's
// raw sigma and shaded rgb into columns 0..3, zeros into 4..7); FWD_RAW,
// the warp's rows of [P, 32] as they stand (sigma, the SH lanes; zeros
// past column 0 for a sigma-only pack).  pt_consume keeps its own copy of
// the loop: one shared helper moved K6's coarse points stage by 3.5% on an
// H100 (PERF.md); the epilogue as a template argument left K4 unmoved
// (PERF.md, K1's redesign).  FEAT: FEAT_ROWS loads the rows of a.feat,
// FEAT_RAYS encodes them from a.rays_o, a.rays_d and a.z (encode_rows);
// the skip layers reread them from the act buffer either way.
template <int EPI, int FEAT>
__device__ __forceinline__ void fwd_consume(const MLPParams& p, const PtArgs& a,
                                            const PtSchedule& sc, unsigned char* slab, Ring& rg) {
  const int warp = threadIdx.x >> 5;
  const int ep = a.ep, wd = p.width, depth = p.depth, half = a.half;
  const Frag f;
  unsigned char* act = slab;
  unsigned char* h1 = slab + a.h1_off;
  const uint32_t wg_slab = smem_u32(slab) - (uint32_t)((warp & 3) * 2 * half);
  const uint32_t a_act = wg_slab, a_h = wg_slab + ep * 16, a_h1 = wg_slab + a.h1_off;
  const uint32_t uhalf = (uint32_t)half;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const long long row0 = t * TILE_M + 16 * warp, left = a.points - row0;
    const int nr = left <= 0 ? 0 : (left >= 16 ? 16 : (int)left);
    int gi = 0;
    if constexpr (FEAT == FEAT_RAYS)
      encode_rows(p, a, row0, nr, act, half, ep);
    else
      load_feat_rows(p, a.feat, row0, nr, act, half, ep);
    wg_sync();
    for (int l = 0; l < depth; ++l) {
      const bool takes_feat = l == 0 || ((p.skip_mask >> l) & 1);
      fwd_layer_at(wd, sc.g[gi++], takes_feat ? a_act : a_h, uhalf, rg, p.b[l], act + ep * 16,
                   f);
    }
    float o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;
    for (int c0 = 0; c0 < p.head0; c0 += a.nch) {
      const int nc = min(a.nch, p.head0 - c0);
      fwd_layer_at(nc, sc.g[gi++], a_h, uhalf, rg, p.b[depth] + c0, h1, f);
      float acc[16];
      ring_gemm<32>(sc.g[gi++], a_h1, uhalf, acc, rg);
#pragma unroll
      for (int i = 0; i < 16; ++i) o[i] += acc[i];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b =
          *reinterpret_cast<const __nv_bfloat162*>(p.b[depth + 1] + 8 * j + 2 * f.tig);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * j + 2 * h] += __bfloat162float(b.x);
        o[4 * j + 2 * h + 1] += __bfloat162float(b.y);
      }
    }
    if constexpr (EPI == FWD_RAW) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.g + 8 * h;
        if (r < nr) {
          float* row = a.out32 + (row0 + r) * OUT_COLS + 2 * f.tig;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float2*>(row + 8 * j) =
                make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
        }
      }
    } else {
      float* rows = a.out8 + row0 * IO_FLOATS;
      forward_out(o, a, row0, nr, rows, f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = f.g + 8 * h;
        if (r < nr && f.tig == 1)
          *reinterpret_cast<float4*>(rows + r * IO_FLOATS + 4) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// Persistent: warpgroups 0 and 1 consume, warp 8 produces; registers moved
// by setmaxnreg from the producer's warpgroup to the consumers', as in
// mlp_points_kernel.
template <int EPI, int FEAT>
__global__ void __launch_bounds__(PT_THREADS, 1)
    shaded_fwd_kernel(const __grid_constant__ MLPParams p, const __grid_constant__ PtArgs a,
                      const __grid_constant__ PtSchedule sc) {
  extern __shared__ __align__(128) unsigned char psmem[];
  Ring rg;
  rg.slots = psmem;
  rg.nst = a.nst;
  rg.stage = 0;
  rg.phase = 0;
  unsigned char* slabs = psmem + (size_t)a.nst * PT_STAGE;
  rg.full = reinterpret_cast<uint64_t*>(slabs + (size_t)PT_WARPS * 2 * a.half);
  rg.empty = rg.full + a.nst;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.nst; ++s) {
      mbar_init(rg.full + s, 1);   // the producer's arrive, plus the bulk bytes
      mbar_init(rg.empty + s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == PT_THREADS / 128 - 1) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < THREADS + 32) pt_produce(sc, a.img, a.tiles, rg);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    fwd_consume<EPI, FEAT>(p, a, sc, slabs + (size_t)(threadIdx.x >> 5) * 2 * a.half, rg);
  }
}

// Width of K4's head-0 passes: head0 up to 256.  With no backward's plan
// to make room for, one pass at the coarse pack and two at the fine ran as
// fast or 2.5% faster than pt_nch's 128 on an H100 (PERF.md).  K3's
// composed path keeps its backward's pt_nch: it shares that schedule's
// images.
static inline int fwd_nch(int head0) { return head0 < NC_MAX ? head0 : NC_MAX; }

// The recompute's products of pt_schedule (shaded, head layer 0 in passes
// of nch): sc and im cut to them; returns their images' bytes (-1 for a
// pack the schedule does not take).
static long long fwd_schedule(const MLPParams& p, int nch, PtSchedule* sc, PtImages* im) {
  if (pt_schedule(p, true, nch, sc, im) < 0) return -1;
  sc->count = im->count = pt_recompute_products(p, nch, true);
  const PtGemm& g = sc->g[sc->count - 1];
  sc->stages = im->m[sc->count - 1].stage0 + g.k_tiles;
  return g.off + (long long)g.k_tiles * KT * g.nc * 2;
}

// One launch of shaded_fwd_kernel<EPI, FEAT> over a.points points (a:
// feat, or FEAT_RAYS' rays_o, rays_d and z; basis16, the outputs EPI
// writes, s, nb, nch and the images at a.img, written for the
// recompute's products that sc holds) on the forward-only plan: per
// half-slab act [ep + width] and h1 [nch] columns x 16 bytes, no mask
// bits, no backward buffer, and the ring as deep as the rest of the
// block's shared memory allows, up to PT_MAX_STAGES (on an H100 4 slots
// ran as fast as 7 or 9, PERF.md); one persistent block per SM.  Returns
// cudaGetLastError().
template <int EPI, int FEAT = FEAT_ROWS>
static int launch_shaded_fwd(const MLPParams& p, PtArgs a, const PtSchedule& sc,
                             cudaStream_t st) {
  int dev = 0, limit = 0, sms = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  a.tiles = pt_tiles(a.points);
  a.ep = pt_ep(p);
  a.h1_off = (a.ep + p.width) * 16;
  a.half = a.h1_off + a.nch * 16;
  const long long slabs = (long long)PT_WARPS * 2 * a.half;
  const long long room = ((long long)limit - slabs - 16 * PT_MAX_STAGES) / PT_STAGE;
  a.nst = (int)(room < PT_MAX_STAGES ? room : PT_MAX_STAGES);
  if (a.nst < 2) return cudaErrorInvalidValue;
  const size_t smem = (size_t)a.nst * PT_STAGE + (size_t)slabs + 16 * a.nst;
  err = cudaFuncSetAttribute(shaded_fwd_kernel<EPI, FEAT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const long long blocks = a.tiles < sms ? a.tiles : sms;
  shaded_fwd_kernel<EPI, FEAT><<<(unsigned)blocks, PT_THREADS, smem, st>>>(p, a, sc);
  return cudaGetLastError();
}

}  // namespace mcn
