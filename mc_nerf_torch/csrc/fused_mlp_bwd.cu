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
// Two stages.  The points stage (mlp_bwd_points.cuh, mlp_points_kernel)
// takes 128-point tiles in a persistent grid (no ray alignment: nothing
// here scans along a ray): the recompute, the packed output's cotangent
// (for the shaded one the shading backward, fused_mlp.py:479-493; for the
// plain MLP dout rounded to bf16 first, :761, :788), the heads and trunk
// backward, with the saved activations and every d_a written to the device
// workspace (mlp_bwd.cuh) and the bias partials in a fixed order; its
// weights come from images that weight_images_kernel tiles once per call.
// Then, for the shaded backward, ray_sum_kernel sums each ray's s dbasis
// partials in sample order, and launch_weight_grads (mlp_bwd.cuh) sums the
// weight gradients by split-K with a fixed-order reduction: the same bits
// run to run.  The TPU kernel keeps a block's activations in VMEM and
// carries the weight sums across its sequential grid; a block here has at
// most 227 KB of shared memory (one fine tile's activations take ~688 KB)
// and blocks run in no order, hence the workspace and the partials.
//
// Bound (H100 SXM, dense bf16 989 TFLOP/s): operations.  Per point the
// backward needs the recompute (1x the forward's MACs), dX (1x) and dW
// (1x): 3 x 629,248 MAC at the fine pack, 3 x 101,632 at the coarse full
// pack (>= 3.47 ms and 0.55 ms for the grid train passes at 7000 x 130
// and 7000 x 128 points); chip_smoke.py counts them exactly.

#include "mlp_bwd_points.cuh"

using namespace mcn;

// The points stage of both backwards: the weight images, the points
// kernel, then (shaded) the per-ray dbasis sums.  Fills the workspace the
// weight stage reads; returns 0 or a CUDA error.
static int run_points(bool shaded, const MLPParams& p, const FlatPlan& f, const PtSchedule& sc,
                      const PtImages& im, PtArgs a, void* dbasis, cudaStream_t st) {
  size_t smem = 0;
  int err = points_setup(p, f, sc, im, false, &a, &smem, st);
  if (err) return err;
  if (!shaded) return launch_points<PT_MLP>(p, a, sc, f.groups, smem, st);
  err = launch_points<PT_SHADED>(p, a, sc, f.groups, smem, st);
  return err ? err : launch_ray_sums(a, dbasis, st);
}

// Both backwards: the points stage, then the weight gradients.
static int run_backward(bool shaded, const void* feat, const void* basis16, const void* dout_in,
                        void* dfeat, void* dbasis, void* dw, void* db, void* workspace,
                        long long points, int s, int nb, int enc, int depth, int skip_mask,
                        int width, int head0, const void* const* w, const void* const* b,
                        void* stream) {
  MLPParams p;
  FlatPlan f;
  PtSchedule sc;
  PtImages im;
  PtArgs a;
  int err = points_args(shaded, &p, &f, &sc, &im, &a, feat, basis16, dout_in, dfeat, workspace,
                        points, pt_tiles(points), s, nb, enc, depth, skip_mask, width, head0, w,
                        b);
  if (err || points <= 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  err = run_points(shaded, p, f, sc, im, a, dbasis, st);
  if (err) return err;
  return launch_weight_grads(f.L, a.ws, a.feat, enc, depth, skip_mask, width, head0,
                             static_cast<float*>(dw), static_cast<float*>(db), st);
}

// ------------------------------------------------------------- C interface

// Bytes of the device workspace of a backward over `points` points (0 for
// none); `shaded` adds the per-point dbasis partials.
extern "C" long long mcn_mlp_bwd_workspace(long long points, int enc, int depth, int skip_mask,
                                           int width, int head0, int shaded) {
  MLPParams p;
  if (points <= 0 || set_shape(&p, depth, skip_mask, enc, width, head0)) return 0;
  for (int l = 0; l < depth + 2; ++l) p.w[l] = p.b[l] = nullptr;
  PtSchedule sc;
  PtImages im;
  return (long long)flat_plan(p, points, pt_tiles(points), shaded != 0, &sc, &im).bytes;
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
  MLPParams p;
  if (set_shape(&p, depth, skip_mask, enc, width, head0)) return cudaErrorInvalidValue;
  if (points <= 0) return 0;
  PtSchedule sc;
  PtImages im;
  const Layout L = flat_plan(p, points, pt_tiles(points), shaded != 0, &sc, &im).L;
  return launch_weight_grads(L, carve(L, workspace), static_cast<const bf16*>(feat), enc, depth,
                             skip_mask, width, head0, static_cast<float*>(dw),
                             static_cast<float*>(db), (cudaStream_t)stream);
}

// The points stage alone (what mcn_shaded_bwd, `shaded`, or mcn_mlp_bwd run
// before the weight stage: dfeat, dbasis and the workspace), its time apart
// from the weight stage's.  dout is dout8 (shaded) or dout [P, 32];
// basis16 and dbasis are ignored unless shaded.
extern "C" int mcn_mlp_bwd_points(const void* feat, const void* basis16, const void* dout,
                                  void* dfeat, void* dbasis, void* workspace, long long points,
                                  int s, int nb, int enc, int depth, int skip_mask, int width,
                                  int head0, const void* const* w, const void* const* b,
                                  int shaded, void* stream) {
  MLPParams p;
  FlatPlan f;
  PtSchedule sc;
  PtImages im;
  PtArgs a;
  int err = points_args(shaded != 0, &p, &f, &sc, &im, &a, feat, basis16, dout, dfeat, workspace,
                        points, pt_tiles(points), shaded ? s : 1, shaded ? nb : 1, enc, depth,
                        skip_mask, width, head0, w, b);
  if (err || points <= 0) return err;
  return run_points(shaded != 0, p, f, sc, im, a, dbasis, (cudaStream_t)stream);
}
