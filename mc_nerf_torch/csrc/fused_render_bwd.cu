// fused_render backward for Hopper: the recompute, the composite and
// shading backward, the MLP backward, and the weight gradients summed over
// all points.
//
// Replaces mc_nerf_tpu/ops/pallas/fused_render.py::_render_bwd_kernel
// (fused_render.py:290, pallas_call at :618 via _render_bwd_call :559 and
// the custom VJP _fused_render_bwd :697).  Outputs: dfeat [rays*s, enc]
// fp32, dbasis [rays, 16] fp32, and the fp32 gradient of every packed
// weight and bias, summed over all points.
//
// Design: the backward is K5's (fused_shaded_mlp's, fused_mlp_bwd.cu) with
// a per-ray composite backward in front.  The cotangent the composite
// hands the MLP is per point: dout8 = (d raw sigma, w * d rgb_c for the
// three sigmoid rgb channels), after which the shading backward (the
// sigmoid's derivative, dout32 = draw_c * basis[b], the dbasis sums) and
// the heads-and-trunk backward are K5's arithmetic at the Pallas body's
// rounding points (fused_render.py:393-436, fused_mlp.py:479-535): dout32
// rounded to bf16 before the head products, d head_b1 summed over the fp32
// dout32, ReLU masks from the bf16 activations, d_h1 and every d_a rounded
// to bf16.  The composite (mlp_bwd_points.cuh, composite_ray) is one warp
// per ray: a forward scan of softplus(sigma [+ noise]) * delta, then a
// reverse scan of the suffix sums of d(cum).  Two launches from Python:
//
// 1. mcn_render_bwd_points (render_bwd_points), the points stage, on the
//    weight images, TMA ring and wgmma from shared memory of
//    mlp_bwd_points.cuh, by one of two paths chosen from s (fused_rays):
//    * fused, where whole rays fill at least 7/8 of a warpgroup's 64 rows
//      (the importance fine pass, s = 32): mlp_points_kernel<PT_RENDER>
//      takes tiles of whole rays; after the recompute each warp stages its
//      rows' sigma and shaded rgb in shared memory, a warp per ray runs the
//      composite there between two warpgroup barriers, and each warp goes
//      on into K5's shading and MLP backward from its rows' dout8.  One
//      recompute, nothing between the steps in device memory;
//    * composed, for every other s (the coarse pass, s = 48, whose rays
//      would leave a quarter of the rows idle; rays of any length):
//      mlp_points_kernel<PT_FORWARD> (the recompute alone, sigma and rgb
//      out, 16 bytes a point, into a [P, 8] buffer), composite_bwd_kernel
//      (dout8 in place over it; no shared memory, so no ceiling on s), then
//      K5's mlp_points_kernel<PT_SHADED> from that dout8;
//    then ray_sum_kernel: dbasis as each ray's per-point partials summed
//    in order.  Either path writes dfeat, the bias partials and the
//    workspace that the weight stage reads.
// 2. mcn_render_bwd_weights (render_bwd_weights): launch_weight_grads
//    (mlp_bwd.cuh) over that workspace, reduced in a fixed order, so the
//    whole backward gives the same bits run to run.
//
// Bound (H100 SXM): the recompute and dX products need 2 x 629,248 MAC a
// point at the fine pack (0.57 ms at 7000 x 32 points, 989 TFLOP/s dense
// bf16) and 2 x 101,632 at the coarse full pack (0.14 ms at 7000 x 48).
// The stage's own bytes (tools/bwd_check.render_points_stage_bytes: the
// points stage's workspace, dfeat and dbasis partials, the composite's
// inputs; the composed path also its forward's and composite's buffer and
// the recompute's images read again) are ~10.9 KB a point at the fine
// pass (0.73 ms at 3.35 TB/s) and ~3.9 KB at the coarse (0.39 ms): bytes
// bound both, narrowly.

#include <climits>

#include "mlp_bwd_points.cuh"

using namespace mcn;

constexpr int COMPOSITE_THREADS = 256;  // one warp per ray

// Path A's composite: one warp per ray over the [P, 8] buffer the forward
// filled (composite_ray: columns 0..3 sigma and rgb in, dout8 out).
__global__ void __launch_bounds__(COMPOSITE_THREADS)
    composite_bwd_kernel(float* __restrict__ io, const float* __restrict__ z,
                         const float* __restrict__ noise, const float* __restrict__ dray,
                         int rays, int s, int white_back) {
  const int ray = blockIdx.x * (COMPOSITE_THREADS / 32) + (threadIdx.x >> 5);
  if (ray >= rays) return;  // whole warps
  const long long base = (long long)ray * s;
  composite_ray(io + base * IO_FLOATS, z + base, noise ? noise + base : nullptr,
                dray + (size_t)ray * 8, s, white_back);
}

// Rays per warpgroup of the fused path, or 0 for the composed one: fused
// where whole rays fill at least 7/8 of a warpgroup's RAY_ROWS rows (s =
// 32: 64 rows, s = 20: 60), since its products run on every row, live or
// not.  On an H100 the fused path took 3.48 ms at the fine pass (7000 x 32,
// all rows live) against the composed path's 4.15, and 3.00 ms at the
// coarse pass (7000 x 48, 48 of 64 rows) against 2.48 (PERF.md).  From s
// alone, so the path, the tiles and the bias-partial rows are the same on
// any card.
static int fused_rays(int s) {
  const int k = s <= RAY_ROWS ? RAY_ROWS / s : 0;
  return 8 * k * s >= 7 * RAY_ROWS ? k : 0;
}

// Tiles of the points stage: of 2 x fused_rays(s) whole rays, or of 128
// points.
static long long render_tiles(int rays, int s) {
  const int k = fused_rays(s);
  return k ? (rays + 2LL * k - 1) / (2LL * k) : pt_tiles((long long)rays * s);
}

// The workspace of a backward over rays x s points: K5's points stage's
// (flat_plan, shaded: the regions the weight stage reads, the per-point
// dbasis partials, the weight images; f.bytes of them), then, for the
// composed path, the [P, 8] buffer of the forward's outputs and the
// composite's dout8.
static size_t render_bytes(const FlatPlan& f, int rays, int s) {
  if (!f.bytes || fused_rays(s)) return f.bytes;
  return f.bytes + align256((size_t)rays * s * IO_FLOATS * sizeof(float));
}

// ------------------------------------------------------------- C interface

// The most samples per ray the backward takes with this pack shape: no
// limit (rays longer than the fused path's tiles take the composed path,
// whose composite keeps its carries in registers and its prefix sums in
// device memory, over flat tiles), so any ray the forward takes
// (mcn_render_max_samples); 0 for a shape it does not take.
extern "C" int mcn_render_bwd_max_samples(int enc, int depth, int width, int head0) {
  MLPParams p;
  if (set_shape(&p, depth, 0, enc, width, head0)) return 0;
  return INT_MAX;
}

// Bytes of the device workspace both launches share (0 for no points).
extern "C" long long mcn_render_bwd_workspace(int rays, int s, int enc, int depth, int skip_mask,
                                              int width, int head0) {
  MLPParams p;
  if (rays <= 0 || s <= 0 || set_shape(&p, depth, skip_mask, enc, width, head0)) return 0;
  for (int l = 0; l < depth + 2; ++l) p.w[l] = p.b[l] = nullptr;
  PtSchedule sc;
  PtImages im;
  const FlatPlan f = flat_plan(p, (long long)rays * s, render_tiles(rays, s), true, &sc, &im);
  return (long long)render_bytes(f, rays, s);
}

// Stage 1: the recompute and the composite backward, fused or composed,
// then K5's shading and MLP backward (dX chain, dbasis, bias partials, the
// workspace).  feat [rays*s, enc] bf16;
// basis16 [rays, 16], z [rays, s], noise [rays, s] or null, dray [rays, 8]
// fp32; dfeat [rays*s, enc], dbasis [rays, 16] fp32 out.  Returns
// cudaGetLastError() (0 on success).
extern "C" int mcn_render_bwd_points(const void* feat, const void* basis16, const void* z,
                                     const void* noise, const void* dray, void* dfeat,
                                     void* dbasis, void* workspace, int rays, int s, int nb,
                                     int white_back, int enc, int depth, int skip_mask,
                                     int width, int head0, const void* const* w,
                                     const void* const* b, void* stream) {
  if (s < 2) return cudaErrorInvalidValue;
  MLPParams p;
  FlatPlan f;
  PtSchedule sc;
  PtImages im;
  PtArgs a;
  int err = points_args(true, &p, &f, &sc, &im, &a, feat, basis16, nullptr, dfeat, workspace,
                        (long long)rays * s, render_tiles(rays, s), s, nb, enc, depth,
                        skip_mask, width, head0, w, b);
  if (err || rays <= 0) return err;
  const int ray_k = fused_rays(s);
  cudaStream_t st = (cudaStream_t)stream;
  size_t smem = 0;
  err = points_setup(p, f, sc, im, ray_k != 0, &a, &smem, st);
  if (err) return err;
  if (ray_k) {  // fused: one launch, the composite between recompute and backward
    a.z = static_cast<const float*>(z);
    a.noise = static_cast<const float*>(noise);
    a.dray = static_cast<const float*>(dray);
    a.rays = rays;
    a.ray_k = ray_k;
    a.white_back = white_back;
    err = launch_points<PT_RENDER>(p, a, sc, f.groups, smem, st);
    return err ? err : launch_ray_sums(a, dbasis, st);
  }
  // composed: the forward, the composite, then K5's points stage from dout8
  float* io = reinterpret_cast<float*>(static_cast<char*>(workspace) + f.bytes);
  a.out8 = io;
  a.dout_in = io;
  PtSchedule fwd = sc;  // the recompute's products, at the head of the schedule
  fwd.count = pt_recompute_products(p, f.nch, true);
  err = launch_points<PT_FORWARD>(p, a, fwd, f.groups, smem, st);
  if (err) return err;
  const int per_block = COMPOSITE_THREADS / 32;
  composite_bwd_kernel<<<(rays + per_block - 1) / per_block, COMPOSITE_THREADS, 0, st>>>(
      io, static_cast<const float*>(z), static_cast<const float*>(noise),
      static_cast<const float*>(dray), rays, s, white_back);
  err = cudaGetLastError();
  if (err) return err;
  err = launch_points<PT_SHADED>(p, a, sc, f.groups, smem, st);
  return err ? err : launch_ray_sums(a, dbasis, st);
}

// Stage 2: dW of every layer (flat, layer order, each [K, N] row-major)
// and the biases (flat, layer order), from the workspace stage 1 filled.
extern "C" int mcn_render_bwd_weights(const void* feat, void* workspace, void* dw, void* db,
                                      int rays, int s, int enc, int depth, int skip_mask,
                                      int width, int head0, void* stream) {
  MLPParams p;
  if (set_shape(&p, depth, skip_mask, enc, width, head0)) return cudaErrorInvalidValue;
  if (rays <= 0) return 0;
  for (int l = 0; l < depth + 2; ++l) p.w[l] = p.b[l] = nullptr;
  PtSchedule sc;
  PtImages im;
  const Layout L = flat_plan(p, (long long)rays * s, render_tiles(rays, s), true, &sc, &im).L;
  return launch_weight_grads(L, carve(L, workspace), static_cast<const bf16*>(feat), enc, depth,
                             skip_mask, width, head0, static_cast<float*>(dw),
                             static_cast<float*>(db), (cudaStream_t)stream);
}
