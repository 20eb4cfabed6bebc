// fused_mlp_apply for Hopper: the NeRF MLP over pre-encoded points.
//
// Replaces mc_nerf_tpu/ops/pallas/fused_mlp.py::_kernel (fused_mlp.py:241,
// pallas_call at :313 via fused_mlp_apply :276).  feat [P, enc] bf16 ->
// out [P, 32] fp32: col 0 raw sigma, cols 1..27 SH (zeros past col 0 for
// a sigma-only pack).  Rounding points as the Pallas body (fused_mlp.py:
// 241-268): bf16 operands, fp32 accumulation, the bf16-stored bias added
// in fp32, a bf16 cast after every trunk layer and after head layer 0, the
// last head in fp32.
//
// Design: K4's forward kernel (shaded_fwd.cuh, shaded_fwd_kernel) with its
// raw epilogue (FWD_RAW): weight_images_kernel writes the recompute's
// weight images into the workspace (anew on every call), then the
// persistent kernel on the TMA ring of those images runs every 128-point
// tile through the trunk and both heads and writes each warp's rows of
// the head output fragment, plus head layer 1's bias, as fp32 [P, 32]
// rows from registers.  Full packs (head0 = 2 * width; the fused_mlp VJP's
// forward) run head layer 0 in passes of up to 256 columns, the sigma-only
// pack (head0 = width; the demos' coarse pass) in one pass of its width.
//
// Bound (H100 SXM): compute.  The eval coarse pass (sigma-only 4x128)
// needs 81,792 MAC per point (63 real feature lanes at layer 0 and at the
// skip, the sigma column alone in the last head layer); a 16384-ray x
// 48-sample chunk is 786,432 points, >= 0.130 ms at 989 TFLOP/s dense
// bf16; its bytes (feat 64 lanes bf16 in, 32 fp32 out per point, the
// weights and images: tools/bwd_check.mlp_forward_bytes) take 0.060 ms at
// 3.35 TB/s.

#include "shaded_fwd.cuh"

using namespace mcn;

// ------------------------------------------------------------- C interface

// Bytes of the weight images mcn_fused_mlp needs (0 for a shape it does
// not take).
extern "C" long long mcn_fused_mlp_workspace(int enc, int depth, int skip_mask, int width,
                                             int head0) {
  MLPParams p;
  if (set_shape(&p, depth, skip_mask, enc, width, head0)) return 0;
  for (int l = 0; l < depth + 2; ++l) p.w[l] = p.b[l] = nullptr;
  PtSchedule sc;
  PtImages im;
  const long long bytes = fwd_schedule(p, fwd_nch(head0), &sc, &im);
  return bytes < 0 ? 0 : bytes;
}

// feat [n_points, enc] bf16, out [n_points, 32] fp32, workspace of
// mcn_fused_mlp_workspace bytes (the weight images, written here); w[l] /
// b[l] for the depth trunk layers then the two head layers (a full or a
// sigma-only pack).  Launches on `stream` and returns cudaGetLastError()
// (0 on success), or the error of a step before it.
extern "C" int mcn_fused_mlp(const void* feat, void* out, void* workspace, long long n_points,
                             int enc, int depth, int skip_mask, int width, int head0,
                             const void* const* w, const void* const* b, void* stream) {
  MLPParams p;
  int err = make_params(&p, feat, depth, skip_mask, enc, width, head0, w, b);
  if (err) return err;
  if (n_points <= 0) return 0;
  PtSchedule sc;
  PtImages im;
  PtArgs a = {};
  a.nch = fwd_nch(head0);
  if (fwd_schedule(p, a.nch, &sc, &im) < 0) return cudaErrorInvalidValue;
  a.feat = static_cast<const bf16*>(feat);
  a.out32 = static_cast<float*>(out);
  a.img = static_cast<const unsigned char*>(workspace);
  a.points = n_points;
  a.s = 1;
  cudaStream_t st = (cudaStream_t)stream;
  weight_images_kernel<<<sc.stages, THREADS, 0, st>>>(im, sc,
                                                      static_cast<unsigned char*>(workspace));
  err = cudaGetLastError();
  return err ? err : launch_shaded_fwd<FWD_RAW>(p, a, sc, st);
}
