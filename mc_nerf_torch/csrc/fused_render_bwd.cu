// fused_render backward for Hopper: recompute, composite and shading
// backward, MLP backward, and the weight gradients summed over all points.
//
// Replaces mc_nerf_tpu/ops/pallas/fused_render.py::_render_bwd_kernel
// (fused_render.py:290, pallas_call at :618 via _render_bwd_call :559 and
// the custom VJP _fused_render_bwd :697).  Outputs: dfeat [rays*s, enc]
// fp32, dbasis [rays, 16] fp32, and the fp32 gradient of every packed
// weight and bias, summed over all points.
//
// Design (two stages, three __global__ kernels, all deterministic):
//
// 1. render_bwd_points_kernel.  A block takes whole rays, max(1, 256 / s)
//    of them, as the forward does.  (a) Recompute: each 128-point tile runs
//    the MLP of mlp_tile.cuh, which also stores every trunk layer's bf16
//    output, head layer 0's bf16 output and the fp32 packed output to a
//    device workspace; sigma and the sigmoid rgb stay in shared memory.
//    (b) Composite and shading backward, one warp per ray: a forward
//    __shfl_up_sync scan recomputes the exclusive prefix sums of
//    softplus(sigma [+ noise]) * delta (noise-free for depth and opacity,
//    noisy for rgb), then a reverse __shfl_down_sync scan takes the
//    exclusive suffix sums of d(cum) (the TPU kernel's seg^T @ dcum); the
//    last delta is 1e10, where exp(-sd) is 0 and no inf * 0 arises.  The
//    white background subtracts sum(drgb).  Shading backward: sigmoid on
//    the rgb lanes only; d(out32) goes to the workspace in fp32, dbasis is
//    summed over the ray's samples in fp32 (a direct 9-term product, no
//    tile/group tables).  (c) MLP backward per tile (mlp_bwd.cuh's
//    mlp_bwd_tile), reading activations back from the workspace for the
//    ReLU masks, with bias partials per block.
// 2. weight_grad_kernel and reduce_rows_kernel (mlp_bwd.cuh): dW = sum over
//    points of xin^T @ d_a for every layer, split over at most 16 chunks of
//    points (persistent blocks, a TMA-fed ring, wgmma from shared memory),
//    and the partials summed in a fixed order, so the result is the same
//    run to run.
//
// Rounding points follow fused_render.py:401-436: dout32 -> bf16 before
// the head products; ReLU masks from the bf16 activations; d_h1 and every
// d_a rounded to bf16; all products accumulate in fp32; d_hb1 sums the
// fp32 dout32, the other biases the bf16 d_a.
//
// The workspace (mlp_bwd.cuh) holds ~10.5 KB per point at the fine pack
// (2.4 GB at 224,000 points) and ~3.4 KB at the coarse 4x128 full pack.
// Shared memory: max(forward MLP tile, backward buffers) + 24 bytes per
// staged sample, so 2 <= s <= 1301 at the fine pack with 64 feature lanes
// (mcn_render_bwd_max_samples, which max_samples_bwd in
// ops/cuda/fused_render.py asks to refuse a longer ray).
//
// Bound (H100 SXM, dense bf16 989 TFLOP/s): operations.  Per point the
// backward needs the recompute (1x the forward's MACs), dX (1x) and dW
// (1x): 3 x 629,248 MAC at the fine pack, 3 x 101,632 at the coarse full
// pack; chip_smoke.py counts them exactly.

#include "mlp_bwd.cuh"

using namespace mcn;

constexpr int BASIS_LANES = 16;
constexpr int RAY_POINTS = 256;           // points per block (rounded down to whole rays)
constexpr int SAMPLE_FLOATS = 6;          // staged per sample: sigma, rgb, two prefix sums

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + logf(1.f + expf(-fabsf(x)));
}

__device__ __forceinline__ float warp_exclusive_scan(float x, float& carry) {
  const int lane = threadIdx.x & 31;
  float v = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) v = 0.f;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  const float excl = v + carry;
  carry += __shfl_sync(0xffffffffu, v + x, 31);
  return excl;
}

// Exclusive suffix sum across the warp (lanes above this one), plus
// `carry`, the sum of every later chunk; updates carry.
__device__ __forceinline__ float warp_exclusive_suffix(float x, float& carry) {
  const int lane = threadIdx.x & 31;
  float v = __shfl_down_sync(0xffffffffu, x, 1);
  if (lane == 31) v = 0.f;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += y;
  }
  const float excl = v + carry;
  carry += __shfl_sync(0xffffffffu, v + x, 0);
  return excl;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rays per block (whole rays, as the forward takes them) and the workspace.
static int rays_per_block(int s) { return s >= RAY_POINTS ? 1 : RAY_POINTS / s; }

static Layout render_layout(int rays, int s, int enc, int depth, int skip_mask, int width,
                            int head0) {
  const int rpb = rays_per_block(s);
  return make_layout((long long)rays * s, (rays + rpb - 1) / rpb, enc, depth, skip_mask, width,
                     head0, true, false);
}

struct PointArgs {
  const bf16* feat;
  const float* basis16;
  const float* z;
  const float* noise;  // null without noise
  const float* dray;   // [rays, 8]: d rgb (3), d depth, d opacity, 3 unused
  float* dfeat;        // [P, enc]
  float* dbasis;       // [rays, 16]
  Workspace ws;
  long long points;
  int rays, s, rays_per_block, nb, white_back, nbias;
};

__global__ void __launch_bounds__(THREADS) render_bwd_points_kernel(MLPParams p, PointArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // recompute layout
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* h1 = act + TILE_M * p.act_pitch;
  bf16* wst_f = h1 + TILE_M * p.h1_pitch;
  float* outs = reinterpret_cast<float*>(wst_f + 2 * STAGE_ELEMS);
  // staged samples, after the region mlp_bwd_tile shares with the recompute
  const int s = a.s, nb = a.nb, npb = a.rays_per_block * s;
  float* sig = reinterpret_cast<float*>(smem + bwd_region_bytes(p));
  float* rgb = sig + npb;
  float* cnf = rgb + 3 * npb;
  float* cn = cnf + npb;

  const int ray0 = blockIdx.x * a.rays_per_block;
  const int n_rays = min(a.rays_per_block, a.rays - ray0);
  const int n_pts = n_rays * s;
  const long long pt0 = (long long)ray0 * s;
  const Workspace& ws = a.ws;

  // ---- (a) recompute: MLP + shading, activations to the workspace
  for (int t0 = 0; t0 < n_pts; t0 += TILE_M) {
    __syncthreads();
    load_feat_tile(p, a.feat, pt0 + t0, pt0 + n_pts, act);
    const ActSave save = {ws.h, ws.h1, ws.out32, a.points, pt0 + t0, min(TILE_M, n_pts - t0)};
    mlp_tile(p, act, h1, wst_f, outs, &save);
    for (int r = threadIdx.x; r < TILE_M; r += THREADS) {
      const int lp = t0 + r;
      if (lp < n_pts) {
        const float* o = outs + r * OUT_PITCH;
        const float* bas = a.basis16 + (size_t)(ray0 + lp / s) * BASIS_LANES;
        sig[lp] = o[0];
        for (int c = 0; c < 3; ++c) {
          float acc = 0.f;
          for (int b = 0; b < nb; ++b) acc += o[1 + nb * c + b] * bas[b];
          rgb[lp * 3 + c] = sigmoidf(acc);
        }
      }
    }
  }
  __syncthreads();

  // ---- (b) composite + shading backward: one warp per ray
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* noise = a.noise;
  for (int rl = warp; rl < n_rays; rl += THREADS / 32) {
    const int ray = ray0 + rl;
    const long long base = (long long)ray * s;
    const float* dr = a.dray + (size_t)ray * 8;
    const float dR = dr[0], dG = dr[1], dB = dr[2], dDepth = dr[3], dOpac = dr[4];
    const float dbg = a.white_back ? dR + dG + dB : 0.f;
    const float* bas = a.basis16 + (size_t)ray * BASIS_LANES;
    // forward prefix sums
    float c_nf = 0.f, c_n = 0.f;
    for (int i0 = 0; i0 < s; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < s;
      float d = 0.f, sg = 0.f, nz = 0.f;
      if (valid) {
        d = i < s - 1 ? a.z[base + i + 1] - a.z[base + i] : 1e10f;
        sg = sig[rl * s + i];
        if (noise) nz = noise[base + i];
      }
      const float sd_nf = valid ? softplus(sg) * d : 0.f;
      const float sd_n = (valid && noise) ? softplus(sg + nz) * d : 0.f;
      const float cum_nf = warp_exclusive_scan(sd_nf, c_nf);
      const float cum_n = noise ? warp_exclusive_scan(sd_n, c_n) : 0.f;
      if (valid) {
        cnf[rl * s + i] = cum_nf;
        cn[rl * s + i] = cum_n;
      }
    }
    // reverse pass: suffix sums of d(cum), then d(sigma) and d(rgb)
    float r_nf = 0.f, r_n = 0.f;
    float db[9];
#pragma unroll
    for (int b = 0; b < 9; ++b) db[b] = 0.f;
    for (int i0 = (s - 1) / 32 * 32; i0 >= 0; i0 -= 32) {
      const int i = i0 + lane;
      const bool valid = i < s;
      float zi = 0.f, d = 0.f, sg = 0.f, nz = 0.f, cum_nf = 0.f, cum_n = 0.f;
      float cr = 0.f, cg = 0.f, cb = 0.f;
      if (valid) {
        zi = a.z[base + i];
        d = i < s - 1 ? a.z[base + i + 1] - zi : 1e10f;
        sg = sig[rl * s + i];
        if (noise) nz = noise[base + i];
        cum_nf = cnf[rl * s + i];
        cum_n = cn[rl * s + i];
        cr = rgb[3 * (rl * s + i)];
        cg = rgb[3 * (rl * s + i) + 1];
        cb = rgb[3 * (rl * s + i) + 2];
      }
      const float dw = dR * cr + dG * cg + dB * cb - dbg;
      const float dprob = dDepth * zi + dOpac;
      const float sd_nf = softplus(sg) * d;
      const float e_nf = expf(-sd_nf), t_nf = expf(-cum_nf), al_nf = 1.f - e_nf;
      const float dwc_nf = noise ? dprob : dprob + dw;
      const float dcum_nf = valid ? -(dwc_nf * al_nf) * t_nf : 0.f;
      const float dsd_nf = warp_exclusive_suffix(dcum_nf, r_nf) + dwc_nf * t_nf * e_nf;
      float dsig = dsd_nf * d * sigmoidf(sg);
      float w = al_nf * t_nf;
      if (noise) {
        const float sgn = sg + nz;
        const float sd_n = softplus(sgn) * d;
        const float e_n = expf(-sd_n), t_n = expf(-cum_n), al_n = 1.f - e_n;
        const float dcum_n = valid ? -(dw * al_n) * t_n : 0.f;
        const float dsd_n = warp_exclusive_suffix(dcum_n, r_n) + dw * t_n * e_n;
        dsig += dsd_n * d * sigmoidf(sgn);
        w = al_n * t_n;
      }
      if (valid) {
        const float gr[3] = {w * dR * cr * (1.f - cr), w * dG * cg * (1.f - cg),
                             w * dB * cb * (1.f - cb)};
        float* dst = ws.dout + (base + i) * OUT_COLS;
        const float* o = ws.out32 + (base + i) * OUT_COLS;
        dst[0] = dsig;
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int b = 0; b < 9; ++b) {
            if (b < nb) {
              dst[1 + nb * c + b] = gr[c] * bas[b];
              db[b] += gr[c] * o[1 + nb * c + b];
            }
          }
        }
        for (int l = 1 + 3 * nb; l < OUT_COLS; ++l) dst[l] = 0.f;
      }
    }
#pragma unroll
    for (int b = 0; b < 9; ++b) db[b] = warp_sum(db[b]);
    if (lane == 0) {
      float* o = a.dbasis + (size_t)ray * BASIS_LANES;
#pragma unroll
      for (int b = 0; b < 9; ++b) o[b] = b < nb ? db[b] : 0.f;
      for (int b = 9; b < BASIS_LANES; ++b) o[b] = 0.f;
    }
  }
  __syncthreads();

  // ---- (c) MLP backward, one tile at a time
  float* part = ws.bias_part + (size_t)blockIdx.x * a.nbias;
  for (int t0 = 0; t0 < n_pts; t0 += TILE_M)
    mlp_bwd_tile(p, ws, a.points, pt0 + t0, min(TILE_M, n_pts - t0), t0 == 0, part, a.dfeat,
                 smem);
}

// ------------------------------------------------------------- C interface

// The most samples per ray render_bwd_points_kernel takes with this pack
// shape: its shared region plus SAMPLE_FLOATS staged floats per sample
// within the device's shared memory per block; 0 for a shape it does not
// take.
extern "C" int mcn_render_bwd_max_samples(int enc, int depth, int width, int head0) {
  MLPParams p;
  if (set_shape(&p, depth, 0, enc, width, head0)) return 0;
  return max_staged_samples(bwd_region_bytes(p), sizeof(float) * SAMPLE_FLOATS);
}

// Bytes of the device workspace both launches share (0 for no points).
extern "C" long long mcn_render_bwd_workspace(int rays, int s, int enc, int depth, int skip_mask,
                                              int width, int head0) {
  if (rays <= 0 || s <= 0) return 0;
  return (long long)render_layout(rays, s, enc, depth, skip_mask, width, head0).bytes;
}

// Stage 1: recompute, composite/shading backward, dX chain, bias partials.
// feat [rays*s, enc] bf16; basis16 [rays, 16], z [rays, s], noise [rays, s]
// or null, dray [rays, 8] fp32; dfeat [rays*s, enc], dbasis [rays, 16]
// fp32 out.  Returns cudaGetLastError() (0 on success).
extern "C" int mcn_render_bwd_points(const void* feat, const void* basis16, const void* z,
                                     const void* noise, const void* dray, void* dfeat,
                                     void* dbasis, void* workspace, int rays, int s, int nb,
                                     int white_back, int enc, int depth, int skip_mask,
                                     int width, int head0, const void* const* w,
                                     const void* const* b, void* stream) {
  MLPParams p;
  int err = make_params(&p, feat, depth, skip_mask, enc, width, head0, w, b);
  if (err) return err;
  if (s < 2 || nb < 1 || nb > 9) return cudaErrorInvalidValue;
  if (rays <= 0) return 0;
  const Layout L = render_layout(rays, s, enc, depth, skip_mask, width, head0);
  PointArgs a;
  a.feat = static_cast<const bf16*>(feat);
  a.basis16 = static_cast<const float*>(basis16);
  a.z = static_cast<const float*>(z);
  a.noise = static_cast<const float*>(noise);
  a.dray = static_cast<const float*>(dray);
  a.dfeat = static_cast<float*>(dfeat);
  a.dbasis = static_cast<float*>(dbasis);
  a.ws = carve(L, workspace);
  a.points = L.points;
  a.rays = rays;
  a.s = s;
  a.rays_per_block = rays_per_block(s);
  a.nb = nb;
  a.white_back = white_back;
  a.nbias = L.nbias;
  const size_t smem = bwd_region_bytes(p) + sizeof(float) * SAMPLE_FLOATS *
                                               (size_t)a.rays_per_block * s;
  err = cudaFuncSetAttribute(render_bwd_points_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  render_bwd_points_kernel<<<L.blocks, THREADS, smem, (cudaStream_t)stream>>>(p, a);
  return cudaGetLastError();
}

// Stage 2: dW of every layer (flat, layer order, each [K, N] row-major)
// and the biases (flat, layer order), from the workspace stage 1 filled.
extern "C" int mcn_render_bwd_weights(const void* feat, void* workspace, void* dw, void* db,
                                      int rays, int s, int enc, int depth, int skip_mask,
                                      int width, int head0, void* stream) {
  if (depth < 1 || depth + 2 > MAX_LAYERS) return cudaErrorInvalidValue;
  if (rays <= 0) return 0;
  const Layout L = render_layout(rays, s, enc, depth, skip_mask, width, head0);
  return launch_weight_grads(L, carve(L, workspace), static_cast<const bf16*>(feat), enc, depth,
                             skip_mask, width, head0, static_cast<float*>(dw),
                             static_cast<float*>(db), (cudaStream_t)stream);
}
