// fused_render forward for Hopper: MLP + SH shading + alpha composite.
//
// Replaces mc_nerf_tpu/ops/pallas/fused_render.py::_render_fwd_kernel
// (fused_render.py:211, pallas_call at :535 via _render_fwd_call :476 and
// fused_render :650).  Encoded points go in and per-ray results come out:
// ray_out [rays, 8] = rgb (+ white background), noise-free depth,
// noise-free opacity, three zeros; optionally wsel [rays, s], the
// selection weights.  The per-sample [points, 8] tensor never reaches
// device memory.
//
// Design.  A block takes whole rays: max(1, 256 / s) of them.  Their points run through the MLP 128 at a time
// (mlp_tile.cuh); each point's raw sigma and sigmoid rgb
// (rgb_c = sigmoid(sum_b sh[1 + nb*c + b] * basis[b]), a direct 9-term dot)
// stay in shared memory.  Then one warp per ray composites: the exclusive
// prefix sum of softplus(sigma [+ noise]) * delta runs in 32-wide chunks
// with __shfl_up_sync and a carried running sum; up to three sigma
// variants share the pass (noise-free for depth/opacity, +noise for the
// rgb weights, +noise_sel for wsel).  delta comes from the unpadded z,
// with the last delta 1e10.  The TPU kernel's block-diagonal seg_lt /
// r_mat matmuls were a Mosaic workaround for this scan and are not
// carried over, nor is its s <= 160 VMEM ceiling.  The ceiling here is
// shared memory: the block stages 16 bytes per sample (sigma, rgb) beside
// the MLP tile, within 227 KB, so 2 <= s <= 1952 at the fine 8x256 pack
// with 64 feature lanes (mcn_render_max_samples, which max_samples in
// ops/cuda/fused_render.py asks to refuse a longer ray before launch).
//
// Bound (H100 SXM): compute.  The eval fine pass (full 8x256) needs
// 629,248 MAC per point (63 real feature lanes at layer 0 and at the skip,
// the two diagonal blocks of the last head layer); a 16384-ray x 32-sample
// chunk is 524,288 points, >= 0.667 ms at 989 TFLOP/s dense bf16.

#include "mlp_tile.cuh"

using namespace mcn;

constexpr int BASIS_LANES = 16;
constexpr int RAY_POINTS = 256;  // points per block (rounded down to whole rays)

__device__ __forceinline__ float softplus(float x) {
  // max(x, 0) + log(1 + exp(-|x|)), the JAX kernel's form
  return fmaxf(x, 0.f) + logf(1.f + expf(-fabsf(x)));
}

// Exclusive prefix sum across the warp of x, plus `carry`; updates carry
// to the running total including this chunk.
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
    fused_render_kernel(MLPParams p, const bf16* __restrict__ feat,
                        const float* __restrict__ basis16, const float* __restrict__ z,
                        const float* __restrict__ noise,
                        const float* __restrict__ noise_sel,
                        float* __restrict__ ray_out, float* __restrict__ wsel,
                        int rays, int s, int rays_per_block, int nb, int white_back) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* act = reinterpret_cast<bf16*>(smem);
  bf16* h1 = act + TILE_M * p.act_pitch;
  bf16* wst = h1 + TILE_M * p.h1_pitch;
  float* outs = reinterpret_cast<float*>(wst + 2 * STAGE_ELEMS);
  float* sig = outs + TILE_M * OUT_PITCH;        // [rays_per_block * s]
  float* rgb = sig + rays_per_block * s;         // [rays_per_block * s, 3]

  const int ray0 = blockIdx.x * rays_per_block;
  const int n_rays = min(rays_per_block, rays - ray0);
  const int n_pts = n_rays * s;
  const long long pt0 = (long long)ray0 * s;

  // ---- MLP + shading, one tile of points at a time
  for (int t0 = 0; t0 < n_pts; t0 += TILE_M) {
    __syncthreads();  // the previous tile's outs are consumed
    load_feat_tile(p, feat, pt0 + t0, pt0 + n_pts, act);
    mlp_tile(p, act, h1, wst, outs);
    for (int r = threadIdx.x; r < TILE_M; r += THREADS) {
      const int lp = t0 + r;
      if (lp < n_pts) {
        const float* o = outs + r * OUT_PITCH;
        const float* bas = basis16 + (size_t)(ray0 + lp / s) * BASIS_LANES;
        sig[lp] = o[0];
        for (int c = 0; c < 3; ++c) {
          float acc = 0.f;
          for (int b = 0; b < nb; ++b) acc += o[1 + nb * c + b] * bas[b];
          rgb[lp * 3 + c] = 1.f / (1.f + expf(-acc));
        }
      }
    }
  }
  __syncthreads();

  // ---- composite: one warp per ray
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rl = warp; rl < n_rays; rl += THREADS / 32) {
    const long long base = (long long)(ray0 + rl) * s;
    float c_nf = 0.f, c_n = 0.f, c_s = 0.f;  // running prefix sums
    float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_w = 0.f, acc_d = 0.f, acc_o = 0.f;
    for (int i0 = 0; i0 < s; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < s;
      float zi = 0.f, d = 0.f, sg = 0.f;
      if (valid) {
        zi = z[base + i];
        d = i < s - 1 ? z[base + i + 1] - zi : 1e10f;
        sg = sig[rl * s + i];
      }
      const float sd_nf = valid ? softplus(sg) * d : 0.f;
      const float sd_n = (valid && noise) ? softplus(sg + noise[base + i]) * d : 0.f;
      const float sd_s = (valid && noise_sel) ? softplus(sg + noise_sel[base + i]) * d : 0.f;
      const float cum_nf = warp_exclusive_scan(sd_nf, c_nf);
      const float cum_n = noise ? warp_exclusive_scan(sd_n, c_n) : 0.f;
      const float cum_s = noise_sel ? warp_exclusive_scan(sd_s, c_s) : 0.f;
      if (!valid) continue;
      const float prob = (1.f - expf(-sd_nf)) * expf(-cum_nf);
      const float w = noise ? (1.f - expf(-sd_n)) * expf(-cum_n) : prob;
      const float* col = rgb + (rl * s + i) * 3;
      acc_r += w * col[0];
      acc_g += w * col[1];
      acc_b += w * col[2];
      acc_w += w;
      acc_d += zi * prob;
      acc_o += prob;
      if (wsel) wsel[base + i] = noise_sel ? (1.f - expf(-sd_s)) * expf(-cum_s) : prob;
    }
    acc_r = warp_sum(acc_r);
    acc_g = warp_sum(acc_g);
    acc_b = warp_sum(acc_b);
    acc_w = warp_sum(acc_w);
    acc_d = warp_sum(acc_d);
    acc_o = warp_sum(acc_o);
    if (lane == 0) {
      const float bg = white_back ? 1.f - acc_w : 0.f;
      float* o = ray_out + (size_t)(ray0 + rl) * 8;
      o[0] = acc_r + bg;
      o[1] = acc_g + bg;
      o[2] = acc_b + bg;
      o[3] = acc_d;
      o[4] = acc_o;
      o[5] = o[6] = o[7] = 0.f;
    }
  }
}

// The most samples per ray the kernel takes with this pack shape: the MLP
// tile plus 16 staged bytes per sample within the device's shared memory
// per block; 0 for a shape the kernel does not take.
extern "C" int mcn_render_max_samples(int enc, int depth, int width, int head0) {
  MLPParams p;
  if (set_shape(&p, depth, 0, enc, width, head0)) return 0;
  return max_staged_samples(mlp_smem_bytes(p), sizeof(float) * 4);
}

// feat [rays*s, enc] bf16; basis16 [rays, 16] fp32; z [rays, s] fp32;
// noise / noise_sel [rays, s] fp32 or null (noise_sel only with noise);
// ray_out [rays, 8] fp32; wsel [rays, s] fp32 or null.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int mcn_fused_render(const void* feat, const void* basis16, const void* z,
                                const void* noise, const void* noise_sel,
                                void* ray_out, void* wsel, int rays, int s, int nb,
                                int white_back, int enc, int depth, int skip_mask,
                                int width, int head0, const void* const* w,
                                const void* const* b, void* stream) {
  MLPParams p;
  int err = make_params(&p, feat, depth, skip_mask, enc, width, head0, w, b);
  if (err) return err;
  if (s < 2 || nb < 1 || nb > 9 || (noise_sel && !noise)) return cudaErrorInvalidValue;
  if (rays <= 0) return 0;
  const int rpb = s >= RAY_POINTS ? 1 : RAY_POINTS / s;
  const size_t smem = mlp_smem_bytes(p) + sizeof(float) * 4 * (size_t)rpb * s;
  err = cudaFuncSetAttribute(fused_render_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int blocks = (rays + rpb - 1) / rpb;
  fused_render_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      p, static_cast<const bf16*>(feat), static_cast<const float*>(basis16),
      static_cast<const float*>(z), static_cast<const float*>(noise),
      static_cast<const float*>(noise_sel), static_cast<float*>(ray_out),
      static_cast<float*>(wsel), rays, s, rpb, nb, white_back);
  return cudaGetLastError();
}
