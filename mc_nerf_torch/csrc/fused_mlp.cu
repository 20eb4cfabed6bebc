// fused_mlp_apply for Hopper: the NeRF MLP over pre-encoded points.
//
// Replaces mc_nerf_tpu/ops/pallas/fused_mlp.py::_kernel (fused_mlp.py:241,
// pallas_call at :313 via fused_mlp_apply :276).  feat [P, enc] bf16 ->
// out [P, 32] fp32: col 0 raw sigma, cols 1..27 SH (zeros past col 0 for
// a sigma-only pack).  One block of 256 threads per 128 points; a ragged
// last block masks its rows.  The math and its rounding points are in
// mlp_tile.cuh.
//
// Bound (H100 SXM): compute.  The eval coarse pass (sigma-only 4x128)
// needs 81,792 MAC per point (63 real feature lanes at layer 0 and at the
// skip, the sigma column alone in the last head layer); a 16384-ray x
// 48-sample chunk is 786,432 points, >= 0.130 ms at 989 TFLOP/s dense
// bf16; its bytes (feat 64 lanes bf16 in, 32 fp32 out per point) take
// 0.060 ms at 3.35 TB/s.

#include "mlp_tile.cuh"

using namespace mcn;

__global__ void __launch_bounds__(THREADS)
    fused_mlp_kernel(MLPParams p, const bf16* __restrict__ feat,
                     float* __restrict__ out, long long n_points) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* h1 = act + TILE_M * p.act_pitch;
  bf16* wst = h1 + TILE_M * p.h1_pitch;
  float* outs = reinterpret_cast<float*>(wst + 2 * STAGE_ELEMS);

  const long long first = (long long)blockIdx.x * TILE_M;
  load_feat_tile(p, feat, first, n_points, act);
  mlp_tile(p, act, h1, wst, outs);
  for (int idx = threadIdx.x; idx < TILE_M * OUT_COLS; idx += THREADS) {
    const int r = idx / OUT_COLS, c = idx % OUT_COLS;
    if (first + r < n_points) out[(first + r) * OUT_COLS + c] = outs[r * OUT_PITCH + c];
  }
}

// feat [n_points, enc] bf16, out [n_points, 32] fp32; w[l] / b[l] for the
// depth trunk layers then the two head layers.  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int mcn_fused_mlp(const void* feat, void* out, long long n_points,
                             int enc, int depth, int skip_mask, int width,
                             int head0, const void* const* w,
                             const void* const* b, void* stream) {
  MLPParams p;
  int err = make_params(&p, feat, depth, skip_mask, enc, width, head0, w, b);
  if (err) return err;
  if (n_points <= 0) return 0;
  const size_t smem = mlp_smem_bytes(p);
  err = cudaFuncSetAttribute(fused_mlp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const long long blocks = (n_points + TILE_M - 1) / TILE_M;
  fused_mlp_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      p, static_cast<const bf16*>(feat), static_cast<float*>(out), n_points);
  return cudaGetLastError();
}
