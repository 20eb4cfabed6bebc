// Inverse-CDF sampling of depths from per-ray weights: the kernel behind
// ops/volume.py::sample_pdf on CUDA tensors (ops/cuda/sample_pdf.py).
//
// Replaces no TPU kernel: the JAX package's sample_pdf
// (mc_nerf_tpu/ops/volume.py) is plain jnp that XLA fuses.  In PyTorch the
// same formulation brackets each draw by masked max / min over [R, K, S-1]
// tensors, four `where`s and four reductions over ~75M elements an eval
// chunk; here a ray's row stays in registers and shared memory, and the
// call moves only its inputs and outputs: at the frame's chunk of 16384
// rays, the PMF [16384, 66] in and [16384, 48] out, then z and w
// [16384, 48] in and [16384, 32] out, ~16 MB, ~5 us at 3.35 TB/s.
//
// One warp a ray, WARPS rays a block.  Each warp:
//  1. loads the PMF w[1:-1] + eps, 32 * SLOTS values at most, a slot a
//     lane (j = lane + 32 * slot), and the midpoints of z into shared
//     memory (z's rows may share one row: a row stride of 0);
//  2. sums the PMF (each lane its slots, then a butterfly of shuffles) and
//     takes its inclusive prefix (a shuffle scan of each slot's 32 values,
//     the running total carried from slot to slot): the plain path's sums
//     in another order, so the CDF may differ from it in its last bits;
//  3. draws u = (k + 0.5) / K, or (k + u_k) / K, clamped to 1 - 1e-6, two
//     draws a lane (k and k + 32);
//  4. brackets each u by the plain path's masked max / min over the whole
//     row (cdf <= u below, the rest above, +-1e10 where a side is empty,
//     NaN anywhere in the row as torch's amax / amin carry it): a literal
//     O(S) scan, both draws in one pass, that assumes no monotone row;
//  5. interpolates in the plain path's fp32 order, each operation rounded
//     on its own (__f*_rn: no contraction into an FMA).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int SLOTS = 4;                 // PMF values a lane
constexpr int MAX_PMF = 32 * SLOTS;      // S - 2 at most
constexpr int WARPS = 8;                 // rays a block
constexpr unsigned FULL = 0xffffffffu;
constexpr float BIG = 1e10f;

struct Args {
  const float* z;       // [rays, s] depths, row stride z_stride (0: one row)
  long long z_stride;
  const float* w;       // [rays, s] weights
  const float* u;       // [rays, k] U[0, 1) draws, or null: the midpoints
  float* out;           // [rays, k]
  int rays, s, k;
  float eps;
};

// The sum of x over the warp, the same bits on every lane.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// The inclusive prefix of x over the warp's lanes.
__device__ __forceinline__ float warp_scan(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x = __fadd_rn(x, y);
  }
  return x;
}

// The draw of u from one ray's row: the masked max / min of the plain
// path, over every bin.
struct Bracket {
  float c_lo, z_lo, c_hi, z_hi;

  __device__ __forceinline__ explicit Bracket(float inf)
      : c_lo(-inf), z_lo(-inf), c_hi(inf), z_hi(inf) {}

  __device__ __forceinline__ void add(float2 e, float u) {   // e: (cdf, mid)
    const bool below = e.x <= u;
    c_lo = fmaxf(c_lo, below ? e.x : -BIG);
    z_lo = fmaxf(z_lo, below ? e.y : -BIG);
    c_hi = fminf(c_hi, below ? BIG : e.x);
    z_hi = fminf(z_hi, below ? BIG : e.y);
  }

  __device__ __forceinline__ float depth(float u) const {
    const float gap = __fsub_rn(c_hi, c_lo);
    const float denom = gap < 1e-8f ? 1.0f : gap;
    const float t = __fdiv_rn(__fsub_rn(u, c_lo), denom);
    return __fadd_rn(z_lo, __fmul_rn(t, __fsub_rn(z_hi, z_lo)));
  }
};

__global__ void __launch_bounds__(32 * WARPS) inverse_cdf_kernel(Args a) {
  __shared__ float2 row_s[WARPS][MAX_PMF + 1];   // (cdf, mid) a bin
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * WARPS + wid;
  if (ray >= a.rays) return;                 // the whole warp
  const int n = a.s - 2, bins = a.s - 1;
  const float* wr = a.w + ray * a.s;
  const float* zr = a.z + ray * a.z_stride;
  float2* row = row_s[wid];

  bool has_nan = false;
  for (int j = lane; j < bins; j += 32) {
    row[j].y = __fmul_rn(__fadd_rn(zr[j + 1], zr[j]), 0.5f);
    has_nan |= row[j].y != row[j].y;
  }
  float v[SLOTS];
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < n ? __fadd_rn(wr[1 + j], a.eps) : 0.0f;
  }
  const float total = warp_sum(__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])));
  float carry = 0.0f;
#pragma unroll
  for (int i = 0; i < SLOTS; ++i) {
    const bool in_row = lane + 32 * i < n;
    float c = warp_scan(in_row ? __fdiv_rn(v[i], total) : 0.0f, lane);
    c = __fadd_rn(carry, c);
    carry = __shfl_sync(FULL, c, 31);
    if (in_row) row[1 + lane + 32 * i].x = c;
    has_nan |= c != c;
  }
  if (lane == 0) row[0].x = 0.0f;
  // a NaN anywhere in the row's CDF or midpoints makes every depth NaN in
  // the plain path (torch's amax / amin carry it); elsewhere fmaxf / fminf
  // give its maxima and minima
  has_nan = __any_sync(FULL, has_nan);
  __syncwarp();

  const float top = (float)(1.0 - 1e-6);
  // two draws a lane in one pass over the row: k and k + 32
  for (int k = lane; k < a.k; k += 64) {
    const int k2 = k + 32 < a.k ? k + 32 : k;
    float u = __fdiv_rn(__fadd_rn((float)k, a.u ? a.u[ray * a.k + k] : 0.5f), (float)a.k);
    float u2 = __fdiv_rn(__fadd_rn((float)k2, a.u ? a.u[ray * a.k + k2] : 0.5f), (float)a.k);
    u = u > top ? top : u;
    u2 = u2 > top ? top : u2;
    Bracket b(CUDART_INF_F), b2(CUDART_INF_F);
    for (int j = 0; j < bins; ++j) {
      const float2 e = row[j];
      b.add(e, u);
      b2.add(e, u2);
    }
    a.out[ray * a.k + k] = has_nan ? CUDART_NAN_F : b.depth(u);
    if (k2 != k) a.out[ray * a.k + k2] = has_nan ? CUDART_NAN_F : b2.depth(u2);
  }
}

}  // namespace

// The most PMF bins a row may have: S - 1 <= this.
extern "C" int mcn_sample_pdf_max_bins() { return MAX_PMF + 1; }

// z [rays, s] fp32 with row stride z_stride (floats, 0: every ray the same
// row), columns contiguous; w [rays, s] fp32 contiguous; u [rays, k] fp32
// contiguous or null (the strata midpoints); out [rays, k] fp32.  Launches
// on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int mcn_sample_pdf(const void* z, long long z_stride, const void* w, const void* u,
                              void* out, int rays, int s, int k, float eps, void* stream) {
  if (rays < 0 || s < 3 || s - 2 > MAX_PMF || k < 1 || z_stride < 0)
    return cudaErrorInvalidValue;
  if (rays == 0) return 0;
  Args a;
  a.z = static_cast<const float*>(z);
  a.z_stride = z_stride;
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.out = static_cast<float*>(out);
  a.rays = rays;
  a.s = s;
  a.k = k;
  a.eps = eps;
  inverse_cdf_kernel<<<(rays + WARPS - 1) / WARPS, 32 * WARPS, 0, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}
