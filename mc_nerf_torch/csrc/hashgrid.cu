// Instant-NGP's multiresolution hash encoding, forward and backward: the
// kernels behind models/hashgrid.py::hash_encode on CUDA tensors
// (ops/cuda/hashgrid.py).  models/hashgrid.py::hash_encode_plain is the
// same math in plain PyTorch, the CPU route and these kernels' oracle.
//
// Replaces no TPU kernel: the JAX package has no hash-grid field.  It is
// the port's first kernel of random gathers and scatters.  At the train
// cell's 2^18 points a step and 16 levels of 2 features: the forward reads
// 8 corners x 8 B a point and level (33.5 M gathers, 268 MB of logical
// bytes, ~1.07 GB in 32-byte sectors), the backward adds the same number
// of fp32 atomic adds into the table's gradient (48.8 MB), contended on
// the dense coarse levels.  Both are bound by the memory system's latency
// and sectors, not by arithmetic.
//
// One thread a (point, level), the level fastest: the L threads of a point
// sit side by side in a warp, so its [L * 2] bf16 output row is written by
// neighbouring lanes (coalesced), the point's 12 bytes are read once per
// warp, and the backward sums d/dx over the point's levels with shuffles.
// A level whose gate is 0 (BARF has not reached it) reads and writes no
// table entry.  The backward's atomics land in no fixed order: the table's
// gradient is held to the plain body's by a tolerance, not by bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Levels {
  int res[MAX_LEVELS];           // N_l
  long long offset[MAX_LEVELS];  // the level's first table row
  int hashed[MAX_LEVELS];        // 1: hashed into T rows; 0: dense (N + 1)^3
};

struct Args {
  const float* x;          // [P, 3] world points
  const float* table;      // [E, 2] (8-byte aligned)
  const float* gate;       // [L] level gate, or null (all 1)
  long long points;
  int levels;
  unsigned table_mask;     // T - 1
  float lo, inv_extent;    // the box [lo, lo + 1 / inv_extent]^3
  Levels lv;
};

// The table row of lattice corner (i, j, k) at level l.
__device__ __forceinline__ long long corner_row(const Args& a, int l, int i, int j, int k) {
  if (a.lv.hashed[l]) {
    const uint32_t h = (uint32_t)i * 1u ^ (uint32_t)j * 2654435761u ^ (uint32_t)k * 805459861u;
    return a.lv.offset[l] + (long long)(h & a.table_mask);
  }
  const long long n1 = a.lv.res[l] + 1;
  return a.lv.offset[l] + i + j * n1 + k * n1 * n1;
}

// A point's cell at level l: its corner (i, j, k), the fractions, and
// whether each coordinate lies in the box (the clamp passes a gradient
// there only, as torch.clamp's does, faces included).  Each operation is
// rounded on its own, in the plain body's order (no FMA contraction): a
// point within a rounding of a cell face must land in the plain body's
// cell, since d/dx jumps there.
struct Cell {
  int c[3];
  float f[3];
  bool inside[3];
};

__device__ __forceinline__ Cell locate(const Args& a, long long p, int l) {
  Cell cell;
  const int n = a.lv.res[l];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float raw = __fmul_rn(__fsub_rn(__ldg(&a.x[p * 3 + d]), a.lo), a.inv_extent);
    cell.inside[d] = raw >= 0.f && raw <= 1.f;
    const float u = fminf(fmaxf(raw, 0.f), 1.f);
    const float pos = __fmul_rn(u, (float)n);
    const int i = min((int)floorf(pos), n - 1);
    cell.c[d] = i;
    cell.f[d] = __fsub_rn(pos, (float)i);
  }
  return cell;
}

__global__ void __launch_bounds__(THREADS) hash_encode_fwd_kernel(Args a, __nv_bfloat162* out) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long p = t / a.levels;
  const int l = (int)(t - p * a.levels);
  if (p >= a.points) return;
  const float g = a.gate ? __ldg(&a.gate[l]) : 1.f;
  float v0 = 0.f, v1 = 0.f;
  if (g != 0.f) {
    const Cell cell = locate(a, p, l);
    const float2* tab = reinterpret_cast<const float2*>(a.table);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int bx = c & 1, by = (c >> 1) & 1, bz = (c >> 2) & 1;
      const float w = (bx ? cell.f[0] : 1.f - cell.f[0]) * (by ? cell.f[1] : 1.f - cell.f[1]) *
                      (bz ? cell.f[2] : 1.f - cell.f[2]);
      const float2 e = __ldg(&tab[corner_row(a, l, cell.c[0] + bx, cell.c[1] + by,
                                             cell.c[2] + bz)]);
      v0 += w * e.x;
      v1 += w * e.y;
    }
    v0 *= g;
    v1 *= g;
  }
  out[t] = __floats2bfloat162_rn(v0, v1);
}

// d table (atomics) and d x (summed over the point's levels by shuffles:
// levels divides 32, so a point's lanes are one aligned group).  Every
// lane of a warp takes part in the shuffles; lanes past the last point
// carry zeros.
__global__ void __launch_bounds__(THREADS) hash_encode_bwd_kernel(
    Args a, const __nv_bfloat162* gout, float* gtable, float* gx) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long p = t / a.levels;
  const int l = (int)(t - p * a.levels);
  const bool live = p < a.points;
  const float g = live ? (a.gate ? __ldg(&a.gate[l]) : 1.f) : 0.f;
  float dx[3] = {0.f, 0.f, 0.f};
  if (g != 0.f) {
    const float2 go = __bfloat1622float2(gout[t]);
    const float g0 = go.x * g, g1 = go.y * g;
    const Cell cell = locate(a, p, l);
    const float2* tab = reinterpret_cast<const float2*>(a.table);
    const float wlo[3] = {1.f - cell.f[0], 1.f - cell.f[1], 1.f - cell.f[2]};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int b[3] = {c & 1, (c >> 1) & 1, (c >> 2) & 1};
      float w1[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) w1[d] = b[d] ? cell.f[d] : wlo[d];
      const long long row = corner_row(a, l, cell.c[0] + b[0], cell.c[1] + b[1], cell.c[2] + b[2]);
      const float w = w1[0] * w1[1] * w1[2];
      atomicAdd(&gtable[2 * row], w * g0);
      atomicAdd(&gtable[2 * row + 1], w * g1);
      if (gx) {
        const float2 e = __ldg(&tab[row]);
        const float dot = g0 * e.x + g1 * e.y;
        dx[0] += (b[0] ? 1.f : -1.f) * w1[1] * w1[2] * dot;
        dx[1] += (b[1] ? 1.f : -1.f) * w1[0] * w1[2] * dot;
        dx[2] += (b[2] ? 1.f : -1.f) * w1[0] * w1[1] * dot;
      }
    }
    const float scale = (float)a.lv.res[l] * a.inv_extent;
#pragma unroll
    for (int d = 0; d < 3; ++d) dx[d] = cell.inside[d] ? dx[d] * scale : 0.f;
  }
  if (!gx) return;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    for (int off = a.levels >> 1; off > 0; off >>= 1)
      dx[d] += __shfl_xor_sync(FULL, dx[d], off, a.levels);
  if (live && l == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) gx[p * 3 + d] = dx[d];
  }
}

int fill_args(Args* a, const void* x, const void* table, const void* gate, long long points,
              int levels, int log2_size, float lo, float inv_extent, const int* res,
              const long long* offsets, const int* hashed) {
  if (points < 0 || levels < 1 || levels > MAX_LEVELS || (32 % levels) != 0 ||
      log2_size < 1 || log2_size > 31 || !(inv_extent > 0.f))
    return cudaErrorInvalidValue;
  a->x = static_cast<const float*>(x);
  a->table = static_cast<const float*>(table);
  a->gate = static_cast<const float*>(gate);
  a->points = points;
  a->levels = levels;
  a->table_mask = (1u << log2_size) - 1u;
  a->lo = lo;
  a->inv_extent = inv_extent;
  for (int l = 0; l < levels; ++l) {
    a->lv.res[l] = res[l];
    a->lv.offset[l] = offsets[l];
    a->lv.hashed[l] = hashed[l];
  }
  return 0;
}

unsigned blocks_for(long long points, int levels) {
  return (unsigned)((points * levels + THREADS - 1) / THREADS);
}

}  // namespace

// x [P, 3] fp32, table [E, 2] fp32 (8-byte aligned), gate [L] fp32 or null,
// out [P, 2L] bf16; res / offsets / hashed: the L levels' resolution, first
// row and kind (L a divisor of 32); lo and inv_extent = 1 / (hi - lo) the
// box.  Launches on `stream`, returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int mcn_hashgrid_fwd(const void* x, const void* table, const void* gate, void* out,
                                long long points, int levels, int log2_size, float lo,
                                float inv_extent, const int* res, const long long* offsets,
                                const int* hashed, void* stream) {
  Args a;
  const int err = fill_args(&a, x, table, gate, points, levels, log2_size, lo, inv_extent,
                            res, offsets, hashed);
  if (err) return err;
  if (points == 0) return 0;
  hash_encode_fwd_kernel<<<blocks_for(points, levels), THREADS, 0, (cudaStream_t)stream>>>(
      a, static_cast<__nv_bfloat162*>(out));
  return cudaGetLastError();
}

// gout [P, 2L] bf16, the features' cotangent; gtable [E, 2] fp32, zeroed
// by the caller, receives the table's gradient; gx [P, 3] fp32 or null
// receives the points' gradient.  The rest as mcn_hashgrid_fwd.
extern "C" int mcn_hashgrid_bwd(const void* x, const void* table, const void* gate,
                                const void* gout, void* gtable, void* gx, long long points,
                                int levels, int log2_size, float lo, float inv_extent,
                                const int* res, const long long* offsets, const int* hashed,
                                void* stream) {
  Args a;
  const int err = fill_args(&a, x, table, gate, points, levels, log2_size, lo, inv_extent,
                            res, offsets, hashed);
  if (err) return err;
  if (points == 0) return 0;
  hash_encode_bwd_kernel<<<blocks_for(points, levels), THREADS, 0, (cudaStream_t)stream>>>(
      a, static_cast<const __nv_bfloat162*>(gout), static_cast<float*>(gtable),
      static_cast<float*>(gx));
  return cudaGetLastError();
}
