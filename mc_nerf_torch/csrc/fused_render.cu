// fused_render forward for Hopper: MLP + SH shading + alpha composite.
//
// Replaces mc_nerf_tpu/ops/pallas/fused_render.py::_render_fwd_kernel
// (fused_render.py:211, pallas_call at :535 via _render_fwd_call :476 and
// fused_render :650).  Encoded points go in and per-ray results come out:
// ray_out [rays, 8] = rgb (+ white background), noise-free depth,
// noise-free opacity, three zeros; optionally wsel [rays, s], the
// selection weights.  Rounding points as the Pallas body's MLP and shading
// (fused_render.py:179-208, which is K4's, fused_mlp.py:381-420): bf16
// operands, fp32 accumulation, the bf16-stored bias added in fp32, a bf16
// cast after every trunk layer and after head layer 0, the last head in
// fp32, rgb_c = sigmoid(sum_b sh[1 + nb*c + b] * basis[ray, b]) in fp32.
//
// Design: K4's forward (shaded_fwd.cuh) and a composite kernel, three
// launches on the caller's stream:
//  1. weight_images_kernel writes the recompute's weight images into the
//     workspace (anew on every call: weights updated in place are read
//     anew);
//  2. shaded_fwd_kernel, K4's persistent kernel on the TMA ring of those
//     images, writes each point's raw sigma and shaded rgb as a [P, 8]
//     fp32 row into the workspace after the images;
//  3. composite_fwd_kernel, one warp per ray (composite_fwd_ray): the
//     exclusive prefix sum of softplus(sigma [+ noise]) * delta in 32-wide
//     chunks with __shfl_up_sync and a carried total, up to three sigma
//     variants in one pass (noise-free for depth and opacity, +noise for
//     the rgb weights, +noise_sel for wsel), the last delta 1e10.
// The TPU kernel's block-diagonal seg_lt / r_mat matmuls were a Mosaic
// workaround for this scan and are not carried over, nor is its s <= 160
// VMEM ceiling: the composite keeps its carries in registers and reads
// each ray's rows from device memory, so rays of any length run
// (mcn_render_max_samples: 2**31 - 1).  The [P, 8] round trip costs 64
// bytes a point (the rows written, the sector of sigma and rgb read back):
// ~0.01 ms at the eval chunk.
//
// Bound (H100 SXM): compute.  The eval fine pass (full 8x256) needs
// 629,248 MAC per point (63 real feature lanes at layer 0 and at the skip,
// the two diagonal blocks of the last head layer); a 16384-ray x 32-sample
// chunk is 524,288 points, >= 0.667 ms at 989 TFLOP/s dense bf16.  Its
// bytes (tools/bwd_check.render_forward_bytes: feat, the composite's
// inputs and outputs, the weights and images, the round trip) take ~0.03
// ms at 3.35 TB/s.

#include <climits>

#include "shaded_fwd.cuh"

using namespace mcn;

constexpr int COMPOSITE_THREADS = 256;  // one warp per ray

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The composite of one ray (fused_render.py:211-288, ops/volume.py's
// weights) by one warp, a lane per sample, 32 at a time.  io: the ray's s
// rows of IO_FLOATS floats, columns 0..3 its samples' raw sigma and shaded
// rgb; z, noise and noise_sel (noise_sel only with noise; either may be
// null) point at its s samples.  The exclusive prefix sums of
// softplus(sigma [+ noise]) * delta run as __shfl_up_sync scans with a
// carried total, up to three variants in one pass: noise-free for depth
// and opacity, +noise for the rgb weights, +noise_sel for wsel; delta from
// z, the last 1e10.  Writes the ray's row of ray_out (rgb, plus 1 - sum w
// with the white background; depth; opacity; three zeros) and, where wsel
// is given, its s selection weights (the noise-free weights without
// noise_sel).
__device__ __forceinline__ void composite_fwd_ray(const float* io, const float* z,
                                                  const float* noise, const float* noise_sel,
                                                  float* ray_out, float* wsel, int s,
                                                  int white_back) {
  const int lane = threadIdx.x & 31;
  float c_nf = 0.f, c_n = 0.f, c_s = 0.f;  // running prefix sums
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_w = 0.f, acc_d = 0.f, acc_o = 0.f;
  for (int i0 = 0; i0 < s; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < s;
    float zi = 0.f, d = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) {
      zi = z[i];
      d = i < s - 1 ? z[i + 1] - zi : 1e10f;
      o = *reinterpret_cast<const float4*>(io + (size_t)i * IO_FLOATS);
    }
    const float sd_nf = valid ? softplus(o.x) * d : 0.f;
    const float sd_n = (valid && noise) ? softplus(o.x + noise[i]) * d : 0.f;
    const float sd_s = (valid && noise_sel) ? softplus(o.x + noise_sel[i]) * d : 0.f;
    const float cum_nf = warp_exclusive_scan(sd_nf, c_nf);
    const float cum_n = noise ? warp_exclusive_scan(sd_n, c_n) : 0.f;
    const float cum_s = noise_sel ? warp_exclusive_scan(sd_s, c_s) : 0.f;
    if (!valid) continue;
    const float prob = (1.f - expf(-sd_nf)) * expf(-cum_nf);
    const float w = noise ? (1.f - expf(-sd_n)) * expf(-cum_n) : prob;
    acc_r += w * o.y;
    acc_g += w * o.z;
    acc_b += w * o.w;
    acc_w += w;
    acc_d += zi * prob;
    acc_o += prob;
    if (wsel) wsel[i] = noise_sel ? (1.f - expf(-sd_s)) * expf(-cum_s) : prob;
  }
  acc_r = warp_sum(acc_r);
  acc_g = warp_sum(acc_g);
  acc_b = warp_sum(acc_b);
  acc_w = warp_sum(acc_w);
  acc_d = warp_sum(acc_d);
  acc_o = warp_sum(acc_o);
  if (lane == 0) {
    const float bg = white_back ? 1.f - acc_w : 0.f;
    *reinterpret_cast<float4*>(ray_out) = make_float4(acc_r + bg, acc_g + bg, acc_b + bg, acc_d);
    *reinterpret_cast<float4*>(ray_out + 4) = make_float4(acc_o, 0.f, 0.f, 0.f);
  }
}

// One warp per ray over the [P, 8] rows the forward wrote.
__global__ void __launch_bounds__(COMPOSITE_THREADS)
    composite_fwd_kernel(const float* __restrict__ io, const float* __restrict__ z,
                         const float* __restrict__ noise, const float* __restrict__ noise_sel,
                         float* __restrict__ ray_out, float* __restrict__ wsel, int rays, int s,
                         int white_back) {
  const int ray = blockIdx.x * (COMPOSITE_THREADS / 32) + (threadIdx.x >> 5);
  if (ray >= rays) return;  // whole warps
  const long long base = (long long)ray * s;
  composite_fwd_ray(io + base * IO_FLOATS, z + base, noise ? noise + base : nullptr,
                    noise_sel ? noise_sel + base : nullptr, ray_out + (size_t)ray * 8,
                    wsel ? wsel + base : nullptr, s, white_back);
}

// ------------------------------------------------------------- C interface

// The most samples per ray the forward takes with this pack shape: no
// limit (2**31 - 1), the composite reading each ray's rows from device
// memory; 0 for a shape it does not take.
extern "C" int mcn_render_max_samples(int enc, int depth, int width, int head0) {
  MLPParams p;
  if (set_shape(&p, depth, 0, enc, width, head0) || head0 != 2 * width) return 0;
  return INT_MAX;
}

// Bytes of the workspace mcn_fused_render needs: the weight images, then
// the [rays * s, 8] fp32 rows (0 for a shape it does not take: a full
// pack, head0 = 2 * width, only).
extern "C" long long mcn_fused_render_workspace(int rays, int s, int enc, int depth,
                                                int skip_mask, int width, int head0) {
  MLPParams p;
  if (rays <= 0 || s <= 0 || set_shape(&p, depth, skip_mask, enc, width, head0) ||
      head0 != 2 * width)
    return 0;
  for (int l = 0; l < depth + 2; ++l) p.w[l] = p.b[l] = nullptr;
  PtSchedule sc;
  PtImages im;
  const long long img = fwd_schedule(p, fwd_nch(head0), &sc, &im);
  if (img < 0) return 0;
  return (long long)(align256((size_t)img) + (size_t)rays * s * IO_FLOATS * sizeof(float));
}

// feat [rays*s, enc] bf16; basis16 [rays, 16] fp32; z [rays, s] fp32;
// noise / noise_sel [rays, s] fp32 or null (noise_sel only with noise);
// ray_out [rays, 8] fp32; wsel [rays, s] fp32 or null; workspace of
// mcn_fused_render_workspace bytes; w[l] / b[l] for the depth trunk layers
// then the two head layers (a full pack).  Launches on `stream` and
// returns cudaGetLastError() (0 on success), or the error of a step
// before it.
extern "C" int mcn_fused_render(const void* feat, const void* basis16, const void* z,
                                const void* noise, const void* noise_sel, void* ray_out,
                                void* wsel, void* workspace, int rays, int s, int nb,
                                int white_back, int enc, int depth, int skip_mask, int width,
                                int head0, const void* const* w, const void* const* b,
                                void* stream) {
  MLPParams p;
  int err = make_params(&p, feat, depth, skip_mask, enc, width, head0, w, b);
  if (err) return err;
  if (s < 2 || nb < 1 || nb > 9 || (noise_sel && !noise) || head0 != 2 * width)
    return cudaErrorInvalidValue;
  if (rays <= 0) return 0;
  PtSchedule sc;
  PtImages im;
  const long long img = fwd_schedule(p, fwd_nch(head0), &sc, &im);
  if (img < 0) return cudaErrorInvalidValue;
  float* io = reinterpret_cast<float*>(static_cast<char*>(workspace) + align256((size_t)img));
  PtArgs a = {};
  a.nch = fwd_nch(head0);
  a.feat = static_cast<const bf16*>(feat);
  a.basis16 = static_cast<const float*>(basis16);
  a.out8 = io;
  a.img = static_cast<const unsigned char*>(workspace);
  a.points = (long long)rays * s;
  a.s = s;
  a.nb = nb;
  cudaStream_t st = (cudaStream_t)stream;
  weight_images_kernel<<<sc.stages, THREADS, 0, st>>>(im, sc,
                                                      static_cast<unsigned char*>(workspace));
  err = cudaGetLastError();
  if (!err) err = launch_shaded_fwd<FWD_SHADED>(p, a, sc, st);
  if (err) return err;
  const int per_block = COMPOSITE_THREADS / 32;
  composite_fwd_kernel<<<(rays + per_block - 1) / per_block, COMPOSITE_THREADS, 0, st>>>(
      io, static_cast<const float*>(z), static_cast<const float*>(noise),
      static_cast<const float*>(noise_sel), static_cast<float*>(ray_out),
      static_cast<float*>(wsel), rays, s, white_back);
  return cudaGetLastError();
}
