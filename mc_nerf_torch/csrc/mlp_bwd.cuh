// What the MLP backwards of fused_render_bwd.cu (fused_render's backward)
// and fused_mlp_bwd.cu (fused_shaded_mlp's and fused_mlp's) share: the
// device workspace that their points stage (mlp_bwd_points.cuh) fills, and
// the weight gradients summed over all points from it.
//
// Weight gradients (launch_weight_grads): dW = sum over points of
// xin^T @ d_a for every layer (xin = feat, the saved layer outputs, h1),
// split over at most 16 large chunks of points; persistent blocks walk the
// (split, job, tile) items, a ring of swizzled X and D stages feeding wgmma
// with both operands in shared memory; reduce_rows_kernel then sums the
// partials (and the bias partials) in a fixed order, so the result is the
// same run to run (the section's own note below).
//
// Why a workspace: per 128-point tile the saved activations of the fine
// 8x256 pack take ~688 KB in bf16, above the 227 KB of shared memory a
// block may use.  The workspace holds ~10.3 KB per point at the fine pack
// and ~3.1 KB at the coarse 4x128 full pack.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "mlp_tile.cuh"

namespace mcn {

constexpr int MAX_JOBS = 32;
constexpr int DBP_LANES = 16;             // per-point dbasis partials (mlp_bwd_points.cuh)
constexpr int WKT = 64;                   // points per stage (K step) of the weight gradients
constexpr int WG_NC = 128;                // dW columns per weight-gradient tile
constexpr int WG_MIN_CHUNK = 4096;        // fewest points per weight-gradient split
constexpr int WG_MAX_SPLITS = 16;         // most weight-gradient splits
constexpr int WG_WAVE = 132;              // tiles one wave of blocks takes (an H100's SMs)

// Columns of a job's dW tile: 128, or 64 for a job at most 64 wide.
static inline int round_nc(int n) { return n > 64 ? WG_NC : 64; }

// The weight-gradient jobs of a pack, in order (one per layer, two for a
// skip layer: feat and the hidden input share d_a[l]):
//   f(x, m, d, n, out) -- X operand x of m columns (-1: feat, l < depth:
//   h[l], depth: h1), D operand d of n columns (l < depth: d_a[l], depth:
//   d_h1, depth + 1: dout), out = the offset of the [m, n] block in the
//   flat dW (layer order).
template <class F>
static void weight_jobs(int enc, int depth, int skip_mask, int width, int head0, F f) {
  long long off = 0;
  for (int l = 0; l < depth; ++l) {
    if (l == 0 || ((skip_mask >> l) & 1)) {
      f(-1, enc, l, width, off);
      off += (long long)enc * width;
    }
    if (l > 0) {
      f(l - 1, width, l, width, off);
      off += (long long)width * width;
    }
  }
  f(depth - 1, width, depth, head0, off);
  off += (long long)width * head0;
  f(depth, head0, depth + 1, OUT_COLS, off);
}

// Weight-gradient splits at `points` points: at most ceil(points /
// WG_MIN_CHUNK) and WG_MAX_SPLITS, and among those down to half as many,
// the count whose items (splits x `tiles` per split) fill whole waves of
// WG_WAVE best (the larger count on a tie).  Shapes and constants only:
// the same splits, and so the same bits, on any card.
static inline int weight_splits(long long points, int tiles) {
  long long s_max = (points + WG_MIN_CHUNK - 1) / WG_MIN_CHUNK;
  s_max = s_max < 1 ? 1 : (s_max > WG_MAX_SPLITS ? WG_MAX_SPLITS : s_max);
  auto fill = [&](long long s) {
    const long long items = s * tiles, waves = (items + WG_WAVE - 1) / WG_WAVE;
    return (double)items / (double)(waves * WG_WAVE);
  };
  long long best = s_max;
  for (long long s = s_max - 1; 2 * s >= s_max; --s)
    if (fill(s) > fill(best) + 1e-9) best = s;
  return (int)best;
}

// ---------------------------------------------------------------- workspace

struct Layout {
  long long points, nweights, chunk;  // chunk: points per weight-gradient split
  int blocks, splits, nbias;
  size_t h, h1, doutb, da, dh1, dbp, bias_part, w_part, bytes;
};

static inline size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// The workspace of a backward over `points` points with `blocks` rows of
// bias partials; the per-point dbasis partials only where the caller asks
// for them.
static Layout make_layout(long long points, int blocks, int enc, int depth, int skip_mask,
                          int width, int head0, bool with_dbp) {
  Layout L;
  L.points = points;
  L.blocks = blocks;
  int tiles = 0;
  weight_jobs(enc, depth, skip_mask, width, head0, [&](int, int m, int, int n, long long out) {
    tiles += (m + TILE_M - 1) / TILE_M * ((n + round_nc(n) - 1) / round_nc(n));
    L.nweights = out + (long long)m * n;
  });
  const int s = weight_splits(points, tiles);
  L.chunk = ((points + s - 1) / s + WKT - 1) / WKT * WKT;  // every split but the last whole stages
  L.splits = (int)((points + L.chunk - 1) / L.chunk);
  L.nbias = depth * width + head0 + OUT_COLS;
  const size_t P = (size_t)points;
  size_t at = 0;
  auto take = [&](size_t bytes) { const size_t o = at; at = align256(at + bytes); return o; };
  L.h = take(2 * P * depth * width);
  L.h1 = take(2 * P * head0);
  L.doutb = take(2 * P * OUT_COLS);
  L.da = take(2 * P * depth * width);
  L.dh1 = take(2 * P * head0);
  L.dbp = with_dbp ? take(4 * P * DBP_LANES) : 0;
  L.bias_part = take(4 * (size_t)blocks * L.nbias);
  L.w_part = take(4 * (size_t)L.splits * L.nweights);
  L.bytes = at;
  return L;
}

struct Workspace {
  bf16* h;           // [depth][P][width]   trunk layer outputs
  bf16* h1;          // [P][head0]          head layer 0 output
  bf16* doutb;       // [P][32]             d(out32), bf16
  bf16* da;          // [depth][P][width]   d of each trunk layer's pre-activation
  bf16* dh1;         // [P][head0]          d of head layer 0's pre-activation
  float* dbp;        // [P][16]             per-point dbasis partials (or null)
  float* bias_part;  // [blocks][nbias]
  float* w_part;     // [splits][nweights]
};

static Workspace carve(const Layout& L, void* base) {
  char* b = static_cast<char*>(base);
  Workspace w;
  w.h = reinterpret_cast<bf16*>(b + L.h);
  w.h1 = reinterpret_cast<bf16*>(b + L.h1);
  w.doutb = reinterpret_cast<bf16*>(b + L.doutb);
  w.da = reinterpret_cast<bf16*>(b + L.da);
  w.dh1 = reinterpret_cast<bf16*>(b + L.dh1);
  w.dbp = L.dbp ? reinterpret_cast<float*>(b + L.dbp) : nullptr;
  w.bias_part = reinterpret_cast<float*>(b + L.bias_part);
  w.w_part = reinterpret_cast<float*>(b + L.w_part);
  return w;
}

// ----------------------------------------------------- weight gradients
//
// dW = sum over points of xin^T @ d_a for every layer: one GEMM per job
// (M = X's columns, N = D's columns, K = points), X and D bf16 rows in the
// workspace (or feat), fp32 sums.  Memory-bound: at the fine 8x256 pack a
// point's jobs read 11,072 bytes of X and D for 638,976 MACs, 115 FLOP per
// byte against the card's 295, so the design is about reading each byte
// once and keeping enough of them in flight.
//  * Work items: (split, job, m-tile of 128 rows, n-tile of 128 columns),
//    the tile index fastest.  A persistent grid hands them out round
//    robin, so the tiles that share a job's X (its n-tiles) or D (its
//    m-tiles) run at once on neighbouring blocks over the same points: the
//    next reads of an operand are served by L2.  A 128 x 128 tile keeps
//    64 fp32 accumulators a consumer thread, where a 128 x 256 tile left
//    ptxas short of registers (it serialized the wgmma) and ran 1.3x
//    slower at the fine pack (PERF.md, section 6).
//  * Few, large splits: the split count comes from the point count, the
//    tiles per split and compile-time constants (weight_splits), never
//    from the card, so the partials and their fixed-order sum give the
//    same bits on any card.  At 910,000 points of the fine pack (44 tiles
//    a split): 15 splits of 60,672 points, 38 MB of partials.
//  * A ring of WG_STAGES stages of WKT points, fed by TMA: one producer
//    warp waits for a free stage (its `empty` mbarrier), then one lane
//    loads X's one or two 64-column boxes and D's one or two with
//    cp.async.bulk.tensor (tensor maps encoded on the host, passed as a
//    __grid_constant__ parameter; 128-byte swizzle; rows past the points
//    and columns past the job come back zero) onto the stage's `full`
//    mbarrier.  The two consumer warpgroups each multiply 64 rows of the
//    tile with wgmma, both operands from shared memory (A = X^T and B = D,
//    MN-major), wait_group 1 so one product stays in flight while the next
//    stage is awaited, and release a stage once its product is done.  The
//    producer runs ahead across items, so the next item's loads overlap
//    this one's flush.
//  * X rows whose pitch is not a multiple of 16 bytes (an encode width not
//    a multiple of 8, e.g. 28 lanes) cannot be a tensor map: the producer
//    warp writes those boxes with element loads instead.
// Budget (ptxas -v, printed by chip_smoke.py): 384 threads at one block per
// SM, 168 registers a thread and no spills, setmaxnreg moving registers
// from the producer's warpgroup (40 a thread) to the consumers' (232);
// shared memory 4 stages x 32 KB + barriers.  reduce_rows_kernel then sums
// the splits' partials (and the points kernels' bias partials) in row order.

constexpr int WG_STAGES = 4;           // ring depth
constexpr int WG_PROMOTE = 128;        // stages per tensor-core accumulation (8192 points)
constexpr int WG_BOX = WKT * 128;     // bytes of one 64-column box of a stage
constexpr int WG_X_BOXES = TILE_M / 64;
constexpr int WG_STAGE = (WG_X_BOXES + WG_NC / 64) * WG_BOX;
constexpr int WG_THREADS = THREADS + 128;  // two consumer warpgroups + the producer's
// Dynamic shared memory of weight_grad_kernel: the ring, its full and empty
// mbarriers, and slack to align the ring to the swizzle atom's 1024 bytes.
constexpr size_t WEIGHT_SMEM = size_t(WG_STAGES) * WG_STAGE + 2 * WG_STAGES * 8 + 1024;

// One weight-gradient product: dW[r, c] (at `out`, rows of n) = sum over
// points p of x[p, r] * d[p, c], r < m, c < n (x rows of m, d rows of n).
struct WJob {
  const bf16* x;
  long long out;
  int m, n, nc, n_tiles, tile0;  // tile0: the job's first tile within a split
  int x_tma;                     // X rows load by TMA (else element loads)
};

struct WJobs {
  CUtensorMap xmap[MAX_JOBS];  // X [points, m] in boxes of 64 columns x WKT rows
  CUtensorMap dmap[MAX_JOBS];  // D [points, n]
  WJob j[MAX_JOBS];
  long long points, chunk, nweights;
  int count, splits, tiles;  // tiles: of all jobs, per split
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and expect `bytes` more of asynchronous copies on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The box of `map` at (column c0, row c1) into shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The producer warp's X boxes of points [p0, p0 + WKT) for a job TMA cannot
// take, as a TMA box would land them: row r at r * 128 bytes, its 16-byte
// chunk c at chunk c ^ (r % 8) (the 128-byte swizzle), zero past the
// points and the job's columns; then visible to wgmma (the async proxy).
__device__ void stage_x_elements(const WJob& J, long long p0, long long p_end, int m0,
                                 unsigned char* st, int lane) {
  for (int idx = lane; idx < WG_X_BOXES * WKT * 8; idx += 32) {
    const int b = idx / (WKT * 8), r = (idx >> 3) % WKT, c = idx & 7;
    if (m0 + 64 * b >= J.m) continue;
    const long long pt = p0 + r;
    const int col = m0 + 64 * b + 8 * c;
    const bf16* src = J.x + pt * J.m + col;
    __align__(16) bf16 v[8];
    for (int q = 0; q < 8; ++q)
      v[q] = pt < p_end && col + q < J.m ? src[q] : __float2bfloat16_rn(0.f);
    *reinterpret_cast<uint4*>(st + b * WG_BOX + r * 128 + ((c ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
  fence_async_shared();
  __syncwarp();
}

// Item `it` of the persistent walk: item = split * tiles + tile, a job's
// tiles m-major then n.
struct WItem {
  int job, m0, n0, split;
  long long p_begin, p_end;
};

__device__ __forceinline__ WItem weight_item(const WJobs& js, int it) {
  WItem w;
  w.split = it / js.tiles;
  const int t = it - w.split * js.tiles;
  int jb = 0;
  while (jb + 1 < js.count && t >= js.j[jb + 1].tile0) ++jb;
  const int nt_all = js.j[jb].n_tiles, local = t - js.j[jb].tile0;
  w.job = jb;
  w.m0 = local / nt_all * TILE_M;
  w.n0 = local % nt_all * js.j[jb].nc;
  w.p_begin = (long long)w.split * js.chunk;
  w.p_end = min(js.points, w.p_begin + js.chunk);
  return w;
}

// Add a consumer warpgroup's accumulators (rows r0 + 8h of its fragment,
// columns c0 + 8j) into the split's partials at `out` (rows of n, bounds m
// x n) and zero them: stored at an item's first flush, added after.  The
// tensor cores' fp32 accumulation loses about one low bit per product it
// adds (a one-sided error over long sums), so the products of at most
// WG_PROMOTE stages (8192 points) go into one accumulation and the rest in
// ordinary fp32 adds, in a fixed order.
template <int NC>
__device__ __forceinline__ void flush_tile(float* acc, float* out, int m, int n, int r0, int c0,
                                           bool first) {
  constexpr int GROUP = NC / 8 < 8 ? NC / 8 : 8;
#pragma unroll
  for (int j0 = 0; j0 < NC / 8; j0 += GROUP) {
    float2 old[GROUP][2];
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, col = c0 + 8 * (j0 + j);
        old[j][h] = make_float2(0.f, 0.f);
        if (!first && r < m && col < n)
          old[j][h] = *reinterpret_cast<const float2*>(out + (size_t)r * n + col);
      }
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h, col = c0 + 8 * (j0 + j);
        float* a = acc + 4 * (j0 + j) + 2 * h;
        const float2 v = make_float2(old[j][h].x + a[0], old[j][h].y + a[1]);
        a[0] = 0.f;
        a[1] = 0.f;
        if (r < m && col < n) *reinterpret_cast<float2*>(out + (size_t)r * n + col) = v;
      }
  }
}

// A consumer warpgroup's share of one item: rows m0 + 64 wg .. + 63 of the
// job's dW tile, summed over the item's points into the split's partials.
// Rows past the job's (the second warpgroup of a 64-row job) multiply what
// the stage holds there and are never stored: a branch around the wgmma
// would make ptxas serialize every wgmma of the kernel.  `stage` and
// `phase` carry the ring's position across items.
template <int NC>
__device__ void consume_tile(const WJob& J, const WItem& w, int wg, unsigned char* ring,
                             uint64_t* full, uint64_t* empty, int& stage, uint32_t& phase,
                             float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3, row_w = warp * 16;
  const bool lead = (threadIdx.x & 127) == 0;
  const int n_steps = (int)((w.p_end - w.p_begin + WKT - 1) / WKT);

  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;

  float* out = part + J.out;
  int prev = -1;
  for (int i = 0; i < n_steps; ++i) {
    mbar_wait(full + stage, phase);
    const uint32_t st = smem_u32(ring + stage * WG_STAGE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WKT / 16; ++kk)
      wgmma_ss<NC>(acc, make_desc_sw128(st + wg * WG_BOX + kk * 2048, WG_BOX, 1024),
                   make_desc_sw128(st + WG_X_BOXES * WG_BOX + kk * 2048, WG_BOX, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // the product of the previous stage is done
    if (prev >= 0 && lead) mbar_arrive(empty + prev);
    prev = stage;
    if (++stage == WG_STAGES) {
      stage = 0;
      phase ^= 1;
    }
    if ((i + 1) % WG_PROMOTE == 0 || i + 1 == n_steps) {
      wgmma_wait<0>();
      if (lead) mbar_arrive(empty + prev);
      prev = -1;
      flush_tile<NC>(acc, out, J.m, J.n, w.m0 + row_w + g, w.n0 + tig * 2, i < WG_PROMOTE);
    }
  }
}

// The producer warp: for each of the block's items, each stage of WKT
// points: wait for a free slot of the ring, then load X's boxes (TMA, or
// element loads where X cannot be a tensor map) and D's boxes onto the
// slot's full barrier.
__device__ __forceinline__ void produce(const WJobs& js, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty) {
  const int lane = threadIdx.x & 31, items = js.splits * js.tiles;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const WItem w = weight_item(js, it);
    const WJob J = js.j[w.job];
    const int nx = J.m - w.m0 > 64 ? 2 : 1, nd = J.nc / 64;
    const uint32_t bytes = uint32_t((J.x_tma ? nx : 0) + nd) * WG_BOX;
    for (long long p0 = w.p_begin; p0 < w.p_end; p0 += WKT) {
      mbar_wait(empty + stage, phase ^ 1);  // the slot is free (at once on the first lap)
      unsigned char* st = ring + stage * WG_STAGE;
      if (!J.x_tma) stage_x_elements(J, p0, w.p_end, w.m0, st, lane);
      if (lane == 0) {
        mbar_expect_tx(full + stage, bytes);
        if (J.x_tma)
          for (int b = 0; b < nx; ++b)
            tma_load_2d(st + b * WG_BOX, &js.xmap[w.job], w.m0 + 64 * b, (int)p0, full + stage);
        for (int b = 0; b < nd; ++b)
          tma_load_2d(st + (WG_X_BOXES + b) * WG_BOX, &js.dmap[w.job], w.n0 + 64 * b, (int)p0,
                      full + stage);
      }
      __syncwarp();
      if (++stage == WG_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// Persistent: block b takes items b, b + gridDim.x, ...; warpgroups 0 and 1
// consume, warp 8 of warpgroup 2 produces (its other warps idle).  The
// warpgroup index goes through a shuffle so that the compiler sees it as
// uniform over each warp (a branch it takes for divergent makes it
// serialize the wgmma), and the two roles never reconverge, so that
// setmaxnreg can move registers from the producer's warpgroup (40 a
// thread) to the consumers' (232).
__global__ void __launch_bounds__(WG_THREADS, 1)
    weight_grad_kernel(const __grid_constant__ WJobs js, float* w_part) {
  extern __shared__ __align__(1024) unsigned char wsmem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wsmem) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WG_STAGES * WG_STAGE);
  uint64_t* empty = full + WG_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + s, 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(empty + s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == WG_THREADS / 128 - 1) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < THREADS + 32) produce(js, ring, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int items = js.splits * js.tiles;
    int stage = 0;
    uint32_t phase = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const WItem w = weight_item(js, it);
      const WJob J = js.j[w.job];
      float* part = w_part + (size_t)w.split * js.nweights;
      switch (J.nc) {
        case 128: consume_tile<128>(J, w, role, ring, full, empty, stage, phase, part); break;
        default: consume_tile<64>(J, w, role, ring, full, empty, stage, phase, part); break;
      }
    }
  }
}

// out[c] = sum over r of in[r, c], r in order: the fixed-order reduction of
// the per-split and per-block partials.
__global__ void reduce_rows_kernel(const float* __restrict__ in, int rows, long long cols,
                                   float* __restrict__ out) {
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < cols;
       c += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += in[(size_t)r * cols + c];
    out[c] = acc;
  }
}

typedef PFN_cuTensorMapEncodeTiled_v12000 TensorMapEncode;

// cuTensorMapEncodeTiled, found once through cudaGetDriverEntryPoint (no
// link against libcuda); null where the installed CUDA has none.
static TensorMapEncode tensor_map_encoder() {
  static TensorMapEncode fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TensorMapEncode>(p);
  }
  return fn;
}

// A tensor map over dense bf16 rows [rows, cols] at base, in boxes of 64
// columns x WKT rows, 128-byte swizzle, zero out of bounds.
static int encode_rows(TensorMapEncode encode, CUtensorMap* map, const bf16* base,
                       long long rows, int cols) {
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  cuuint32_t box[2] = {64, WKT};
  cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Host side: launch the weight gradients from the workspace the points
// kernel filled: dW of every layer (flat, layer order, each [K, N]
// row-major) into dw and the biases (flat, layer order) into db.  Returns
// cudaGetLastError() after the launches (0 on success).
static int launch_weight_grads(const Layout& L, const Workspace& ws, const bf16* feat, int enc,
                               int depth, int skip_mask, int width, int head0, float* dw,
                               float* db, cudaStream_t st) {
  if (depth < 1 || depth + 2 > MAX_LAYERS || depth + 2 + depth > MAX_JOBS)
    return cudaErrorInvalidValue;
  WJobs js;
  js.points = L.points;
  js.chunk = L.chunk;
  js.nweights = L.nweights;
  js.splits = L.splits;
  js.count = 0;
  js.tiles = 0;
  const TensorMapEncode encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  int err = 0;
  const size_t lw = (size_t)L.points * width;
  weight_jobs(enc, depth, skip_mask, width, head0,
              [&](int xi, int m, int di, int n, long long out) {
    const bf16* x = xi < 0 ? feat : xi < depth ? ws.h + xi * lw : ws.h1;
    const bf16* d = di < depth ? ws.da + di * lw : di == depth ? ws.dh1 : ws.doutb;
    const int k = js.count++;
    WJob& J = js.j[k];
    J.x = x;
    J.m = m;
    J.n = n;
    J.out = out;
    J.nc = round_nc(n);
    J.n_tiles = (n + J.nc - 1) / J.nc;
    J.tile0 = js.tiles;
    js.tiles += (m + TILE_M - 1) / TILE_M * J.n_tiles;
    J.x_tma = m % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    if (J.x_tma && !err) err = encode_rows(encode, &js.xmap[k], x, L.points, m);
    if (!err) err = encode_rows(encode, &js.dmap[k], d, L.points, n);
  });
  if (err) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cudaFuncSetAttribute(weight_grad_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)WEIGHT_SMEM);
  if (err) return err;
  const int items = js.splits * js.tiles;
  weight_grad_kernel<<<items < sms ? items : sms, WG_THREADS, WEIGHT_SMEM, st>>>(js, ws.w_part);
  err = cudaGetLastError();
  if (err) return err;
  reduce_rows_kernel<<<(int)((L.nweights + 255) / 256), 256, 0, st>>>(ws.w_part, L.splits,
                                                                      L.nweights, dw);
  err = cudaGetLastError();
  if (err) return err;
  reduce_rows_kernel<<<(L.nbias + 255) / 256, 256, 0, st>>>(ws.bias_part, L.blocks, L.nbias, db);
  return cudaGetLastError();
}

}  // namespace mcn
