// Two MLP backwards for Hopper over flat tiles of points: fused_shaded_mlp's
// (with the SH shading's backward) and the differentiable fused_mlp's.
//
// Replaces mc_nerf_tpu/ops/pallas/fused_mlp.py::_shaded_bwd_kernel
// (fused_mlp.py:423, pallas_call at :648 via _shaded_bwd_call :609 and the
// custom VJP _fused_shaded_bwd :720) and ::_bwd_kernel (:739, pallas_call
// at :869 via _fused_mlp_bwd_call :836 and the fused_mlp custom VJP :925).
// Outputs: dfeat [P, enc] fp32, for the shaded one dbasis [P / s, 16] fp32,
// and the fp32 gradient of every packed weight and bias, summed over all
// points.
//
// Design: mlp_bwd_points_kernel takes TILES_PER_BLOCK tiles of 128
// consecutive points (no ray alignment: nothing here scans along a ray).
// Per tile: (a) the recompute of mlp_tile.cuh, storing every trunk layer's
// and head layer 0's bf16 output to the device workspace (mlp_bwd.cuh);
// (b) the packed output's cotangent dout32 per point, into the workspace:
//   * shaded (fused_mlp.py:479-493): draw8 = dout8 * (rgb lanes ?
//     sig * (1 - sig) : 1), dout32[0] = draw8[0], dout32[1 + nb*c + b] =
//     draw8[1 + c] * basis[b] (fp32), and the point's dbasis partial
//     sum_c draw8[1 + c] * out32[1 + nb*c + b] to the workspace;
//   * plain MLP (fused_mlp.py:761, :788): dout rounded to bf16 first, so
//     d head_b1 sums the bf16-rounded values;
// (c) mlp_bwd_tile: heads and trunk backward with the bias partials.
// Then, for the shaded backward, ray_sum_kernel sums each ray's s dbasis
// partials in sample order, and launch_weight_grads (mlp_bwd.cuh) sums
// the weight gradients by split-K with a fixed-order reduction: the same
// bits run to run.  The TPU kernel keeps a block's activations in VMEM and
// carries the weight sums across its sequential grid; a block here has at
// most 227 KB of shared memory (one fine tile's activations take ~688 KB)
// and blocks run in no order, hence the workspace and the partials.
//
// Bound (H100 SXM, dense bf16 989 TFLOP/s): operations.  Per point the
// backward needs the recompute (1x the forward's MACs), dX (1x) and dW
// (1x): 3 x 629,248 MAC at the fine pack, 3 x 101,632 at the coarse full
// pack (>= 3.47 ms and 0.55 ms for the grid train passes at 7000 x 130
// and 7000 x 128 points); chip_smoke.py counts them exactly.

#include "mlp_bwd.cuh"

using namespace mcn;

constexpr int BASIS_LANES = 16;
constexpr int SHADED_COLS = 8;
constexpr int TILES_PER_BLOCK = 4;  // 512 points per block: one bias-partial row each

struct FlatArgs {
  const bf16* feat;
  const float* basis16;  // [P / s, 16] (shaded)
  const float* dout_in;  // dout8 [P, 8] (shaded) or dout [P, 32]
  float* dfeat;          // [P, enc]
  Workspace ws;
  long long points;
  int s, nb, nbias;
};

template <bool SHADED>
__global__ void __launch_bounds__(THREADS) mlp_bwd_points_kernel(MLPParams p, FlatArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* h1 = act + TILE_M * p.act_pitch;
  bf16* wst = h1 + TILE_M * p.h1_pitch;
  float* outs = reinterpret_cast<float*>(wst + 2 * STAGE_ELEMS);
  const Workspace& ws = a.ws;
  float* part = ws.bias_part + (size_t)blockIdx.x * a.nbias;

  for (int t = 0; t < TILES_PER_BLOCK; ++t) {
    const long long row0 = ((long long)blockIdx.x * TILES_PER_BLOCK + t) * TILE_M;
    if (row0 >= a.points) break;
    const int n_rows = (int)min((long long)TILE_M, a.points - row0);
    __syncthreads();  // the previous tile's backward is done with the shared buffers
    load_feat_tile(p, a.feat, row0, a.points, act);
    const ActSave save = {ws.h, ws.h1, nullptr, a.points, row0, n_rows};
    mlp_tile(p, act, h1, wst, outs, &save);
    for (int r = threadIdx.x; r < n_rows; r += THREADS) {
      const long long pt = row0 + r;
      float* dst = ws.dout + pt * OUT_COLS;
      if (SHADED) {
        const float* o = outs + r * OUT_PITCH;
        const float* bas = a.basis16 + (pt / a.s) * BASIS_LANES;
        const float* d8 = a.dout_in + pt * SHADED_COLS;
        const int nb = a.nb;
        float dr[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float acc = 0.f;
#pragma unroll
          for (int b = 0; b < 9; ++b)
            if (b < nb) acc += o[1 + nb * c + b] * bas[b];
          const float sg = sigmoidf(acc);
          dr[c] = d8[1 + c] * (sg * (1.f - sg));
        }
        dst[0] = d8[0];
        float* dbp = ws.dbp + pt * DBP_LANES;
#pragma unroll
        for (int b = 0; b < 9; ++b) {
          float acc = 0.f;
          if (b < nb) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              dst[1 + nb * c + b] = dr[c] * bas[b];
              acc += dr[c] * o[1 + nb * c + b];
            }
          }
          dbp[b] = acc;
        }
        for (int b = 9; b < DBP_LANES; ++b) dbp[b] = 0.f;
        for (int l = 1 + 3 * nb; l < OUT_COLS; ++l) dst[l] = 0.f;
      } else {
        const float* d = a.dout_in + pt * OUT_COLS;
        for (int c = 0; c < OUT_COLS; ++c) dst[c] = __bfloat162float(__float2bfloat16_rn(d[c]));
      }
    }
    mlp_bwd_tile(p, ws, a.points, row0, n_rows, t == 0, part, a.dfeat, smem);
  }
}

// dbasis[ray, b] = sum over the ray's s points, in order, of the partials.
__global__ void ray_sum_kernel(const float* __restrict__ dbp, int rays, int s,
                               float* __restrict__ dbasis) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)rays * BASIS_LANES) return;
  const long long ray = idx / BASIS_LANES;
  const int b = (int)(idx % BASIS_LANES);
  float acc = 0.f;
  for (int i = 0; i < s; ++i) acc += dbp[(ray * s + i) * DBP_LANES + b];
  dbasis[idx] = acc;
}

static Layout flat_layout(long long points, int enc, int depth, int skip_mask, int width,
                          int head0, bool shaded) {
  const long long tiles = (points + TILE_M - 1) / TILE_M;
  const int blocks = (int)((tiles + TILES_PER_BLOCK - 1) / TILES_PER_BLOCK);
  return make_layout(points, blocks, enc, depth, skip_mask, width, head0, false, shaded);
}

// Both backwards: the points kernel, then (shaded) the per-ray dbasis sums,
// then the weight gradients.
static int run_backward(bool shaded, const void* feat, const void* basis16, const void* dout_in,
                        void* dfeat, void* dbasis, void* dw, void* db, void* workspace,
                        long long points, int s, int nb, int enc, int depth, int skip_mask,
                        int width, int head0, const void* const* w, const void* const* b,
                        void* stream) {
  MLPParams p;
  int err = make_params(&p, feat, depth, skip_mask, enc, width, head0, w, b);
  if (err) return err;
  if (shaded && (s < 1 || nb < 1 || nb > 9 || points % s)) return cudaErrorInvalidValue;
  if (points <= 0) return 0;
  const Layout L = flat_layout(points, enc, depth, skip_mask, width, head0, shaded);
  FlatArgs a;
  a.feat = static_cast<const bf16*>(feat);
  a.basis16 = static_cast<const float*>(basis16);
  a.dout_in = static_cast<const float*>(dout_in);
  a.dfeat = static_cast<float*>(dfeat);
  a.ws = carve(L, workspace);
  a.points = points;
  a.s = s;
  a.nb = nb;
  a.nbias = L.nbias;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = bwd_region_bytes(p);
  if (shaded) {
    err = cudaFuncSetAttribute(mlp_bwd_points_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    mlp_bwd_points_kernel<true><<<L.blocks, THREADS, smem, st>>>(p, a);
    err = cudaGetLastError();
    if (err) return err;
    const long long n = points / s * BASIS_LANES;
    ray_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        a.ws.dbp, (int)(points / s), s, static_cast<float*>(dbasis));
  } else {
    err = cudaFuncSetAttribute(mlp_bwd_points_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    mlp_bwd_points_kernel<false><<<L.blocks, THREADS, smem, st>>>(p, a);
  }
  err = cudaGetLastError();
  if (err) return err;
  return launch_weight_grads(L, a.ws, a.feat, enc, depth, skip_mask, width, head0,
                             static_cast<float*>(dw), static_cast<float*>(db), st);
}

// ------------------------------------------------------------- C interface

// Bytes of the device workspace of a backward over `points` points (0 for
// none); `shaded` adds the per-point dbasis partials.
extern "C" long long mcn_mlp_bwd_workspace(long long points, int enc, int depth, int skip_mask,
                                           int width, int head0, int shaded) {
  if (points <= 0) return 0;
  return (long long)flat_layout(points, enc, depth, skip_mask, width, head0, shaded != 0).bytes;
}

// fused_shaded_mlp's backward.  feat [P, enc] bf16, basis16 [P / s, 16] and
// dout8 [P, 8] fp32; dfeat [P, enc], dbasis [P / s, 16], dw (every layer's
// [K, N], flat in layer order) and db (flat) fp32 out.  Returns
// cudaGetLastError() (0 on success).
extern "C" int mcn_shaded_bwd(const void* feat, const void* basis16, const void* dout8,
                              void* dfeat, void* dbasis, void* dw, void* db, void* workspace,
                              long long points, int s, int nb, int enc, int depth, int skip_mask,
                              int width, int head0, const void* const* w, const void* const* b,
                              void* stream) {
  return run_backward(true, feat, basis16, dout8, dfeat, dbasis, dw, db, workspace, points, s,
                      nb, enc, depth, skip_mask, width, head0, w, b, stream);
}

// fused_mlp's backward.  feat [P, enc] bf16 and dout [P, 32] fp32; dfeat
// [P, enc], dw and db fp32 out, as mcn_shaded_bwd.
extern "C" int mcn_mlp_bwd(const void* feat, const void* dout, void* dfeat, void* dw, void* db,
                           void* workspace, long long points, int enc, int depth, int skip_mask,
                           int width, int head0, const void* const* w, const void* const* b,
                           void* stream) {
  return run_backward(false, feat, nullptr, dout, dfeat, nullptr, dw, db, workspace, points, 1,
                      1, enc, depth, skip_mask, width, head0, w, b, stream);
}

// The weight stage alone (launch_weight_grads: dW and db as the two calls
// above give them), from a workspace that one of them filled at the same
// shapes: its stage timed apart.
extern "C" int mcn_mlp_bwd_weights(const void* feat, void* workspace, void* dw, void* db,
                                   long long points, int enc, int depth, int skip_mask, int width,
                                   int head0, int shaded, void* stream) {
  if (depth < 1 || depth + 2 > MAX_LAYERS) return cudaErrorInvalidValue;
  if (points <= 0) return 0;
  const Layout L = flat_layout(points, enc, depth, skip_mask, width, head0, shaded != 0);
  return launch_weight_grads(L, carve(L, workspace), static_cast<const bf16*>(feat), enc, depth,
                             skip_mask, width, head0, static_cast<float*>(dw),
                             static_cast<float*>(db), (cudaStream_t)stream);
}
