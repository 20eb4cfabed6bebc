// fused_shaded_mlp for Hopper: the NeRF MLP over pre-encoded points with
// the SH shading per point.
//
// Replaces mc_nerf_tpu/ops/pallas/fused_mlp.py::_shaded_fwd_kernel
// (fused_mlp.py:381, pallas_call at :583 via _shaded_fwd_call :557 and
// fused_shaded_mlp :686).  feat [P, enc] bf16 and basis16 [P / s, 16] fp32
// -> out [P, 8] fp32: col 0 the raw sigma, cols 1..3 the rgb
// sigmoid(sum_b sh[1 + nb*c + b] * basis[ray, b]) in fp32, cols 4..7 zero.
//
// Design: one block of 256 threads per 128 points, the MLP of
// mlp_tile.cuh, then a shading epilogue per point from the fp32 packed
// output in shared memory: ray = point / s, a direct 9-term product per
// channel (the TPU kernel's tile / group / rgbmask matmuls, fused_mlp.py:
// 358-378 and :408-418, are a Mosaic workaround for the same sums).  Blocks
// need not hold whole rays: each point reads its own ray's basis, so the
// TPU's 8-ray block alignment (_shaded_block, :540-545) has no counterpart
// and a ragged last block masks its rows.
//
// Bound (H100 SXM): compute.  The grid train fine pass (8x256, 629,248 MAC
// per point) over 7000 x 130 points is >= 1.158 ms at 989 TFLOP/s dense
// bf16; the coarse full 4x128 pass (101,632 MAC) over 7000 x 128 points
// >= 0.184 ms; its bytes (feat 64 lanes bf16 in, 8 fp32 out per point)
// take ~0.06 ms at 3.35 TB/s.

#include "mlp_tile.cuh"

using namespace mcn;

constexpr int BASIS_LANES = 16;
constexpr int SHADED_COLS = 8;

__global__ void __launch_bounds__(THREADS)
    fused_shaded_kernel(MLPParams p, const bf16* __restrict__ feat,
                        const float* __restrict__ basis16, float* __restrict__ out,
                        long long n_points, int s, int nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* h1 = act + TILE_M * p.act_pitch;
  bf16* wst = h1 + TILE_M * p.h1_pitch;
  float* outs = reinterpret_cast<float*>(wst + 2 * STAGE_ELEMS);

  const long long first = (long long)blockIdx.x * TILE_M;
  load_feat_tile(p, feat, first, n_points, act);
  mlp_tile(p, act, h1, wst, outs);
  for (int r = threadIdx.x; r < TILE_M; r += THREADS) {
    const long long pt = first + r;
    if (pt >= n_points) continue;
    const float* o = outs + r * OUT_PITCH;
    const float* bas = basis16 + (pt / s) * BASIS_LANES;
    float rgb[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < 9; ++b)
        if (b < nb) acc += o[1 + nb * c + b] * bas[b];
      rgb[c] = sigmoidf(acc);
    }
    float4* dst = reinterpret_cast<float4*>(out + pt * SHADED_COLS);
    dst[0] = make_float4(o[0], rgb[0], rgb[1], rgb[2]);
    dst[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// feat [n_points, enc] bf16, basis16 [n_points / s, 16] fp32, out
// [n_points, 8] fp32; w[l] / b[l] for the depth trunk layers then the two
// head layers (a full pack).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int mcn_fused_shaded(const void* feat, const void* basis16, void* out,
                                long long n_points, int s, int nb, int enc, int depth,
                                int skip_mask, int width, int head0, const void* const* w,
                                const void* const* b, void* stream) {
  MLPParams p;
  int err = make_params(&p, feat, depth, skip_mask, enc, width, head0, w, b);
  if (err) return err;
  if (s < 1 || nb < 1 || nb > 9 || n_points % s) return cudaErrorInvalidValue;
  if (n_points <= 0) return 0;
  const size_t smem = mlp_smem_bytes(p);
  err = cudaFuncSetAttribute(fused_shaded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err) return err;
  const long long blocks = (n_points + TILE_M - 1) / TILE_M;
  fused_shaded_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      p, static_cast<const bf16*>(feat), static_cast<const float*>(basis16),
      static_cast<float*>(out), n_points, s, nb);
  return cudaGetLastError();
}
