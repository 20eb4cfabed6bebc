// fused_shaded_mlp for Hopper: the NeRF MLP over pre-encoded points with
// the SH shading per point, forward only.
//
// Replaces mc_nerf_tpu/ops/pallas/fused_mlp.py::_shaded_fwd_kernel
// (fused_mlp.py:381, pallas_call at :583 via _shaded_fwd_call :557 and
// fused_shaded_mlp :686).  feat [P, enc] bf16 and basis16 [P / s, 16] fp32
// -> out [P, 8] fp32: col 0 the raw sigma, cols 1..3 the rgb
// sigmoid(sum_b sh[1 + nb*c + b] * basis[ray, b]) in fp32, cols 4..7 zero.
// Rounding points as the Pallas body: bf16 operands, fp32 accumulation,
// the bf16-stored bias added in fp32, a bf16 cast after every trunk layer
// and after head layer 0, the last head in fp32.
//
// Design (shaded_fwd.cuh, shaded_fwd_kernel, which K3's composed path
// runs too): the recompute of the points stage (mlp_bwd_points.cuh) with
// nothing kept for a backward, in a kernel of its own:
//  * Weights as pre-tiled images, written once per call by
//    weight_images_kernel into a buffer the caller allocates (the
//    recompute's products of pt_schedule: nothing is cached across calls,
//    so weights updated in place are always read anew), each K tile in
//    wgmma's B layout, so a ring slot is one bulk copy.
//  * A ring of 16 KB slots fed by TMA bulk copies from one producer warp
//    that walks the schedule tile after tile as far ahead as the ring
//    allows; two consumer warpgroups of 64 rows, A from shared memory in
//    the core-matrix layout, one product in flight while the next issues.
//  * Persistent blocks over 128-point tiles; each warp's 16 rows stay with
//    it from the feat load to the output rows, which the shading epilogue
//    (forward_out) writes from registers as float4 rows: no fp32 staging,
//    no block barrier in the tile loop.  Every row is computed by one
//    warpgroup in an order fixed by the shapes, so the bits do not depend
//    on the grid or on which block took a tile.
//  * A forward-only shared-memory plan: per half-slab (8 rows) act [ep +
//    width] and h1 [nch] columns x 16 bytes (nch: head layer 0 in passes
//    of up to 256 columns, fwd_nch), no ReLU mask bits, no backward
//    buffer; the ring takes the rest, up to PT_MAX_STAGES (6) slots.  At
//    the fine 8x256 pack (ep 64, nch 256): 9,216 B a half-slab, 147,456
//    for the 16, 5 slots (81,920 B) and their barriers: 229,456 of the
//    232,448 a block may have (the backward's plan leaves room for 3).  At
//    the coarse 4x128 full pack (nch 256): 7,168 B a half-slab, 114,688
//    for the 16, 6 slots: 213,088.
//
// Bound (H100 SXM): compute.  The fine pass (8x256, 629,248 MAC per
// point) over 7000 x 130 points is >= 1.158 ms at 989 TFLOP/s dense bf16,
// an eval chunk of 16384 x 130 >= 2.711 ms; the coarse full 4x128 pass
// (101,632 MAC) over 7000 x 128 >= 0.184 ms.  Its bytes (feat in, [P, 8]
// out, the images: tools/bwd_check.shaded_forward_bytes) take ~0.045 ms
// at 3.35 TB/s at the train passes.  The L2 is the other wall: a 128-row
// tile reads all the images, 1,277,952 B at the fine pack and 212,992 at
// the coarse (9,984 and 1,664 B a point; tools/bwd_check.
// forward_l2_bytes_per_point), for 126 FLOP a byte: at the bf16 peak ~7.9
// TB/s of L2 reads (coarse ~8.1); a 2-CTA cluster multicasting each slot
// into both blocks would halve it.  On an H100 the ring's loads cost
// nothing measurable (skipping them all moved no time), and the cluster
// version ran 1.4-1.7x slower than this one (PERF.md).

#include "shaded_fwd.cuh"

using namespace mcn;

// ------------------------------------------------------------- C interface

// Bytes of the weight images mcn_fused_shaded needs (0 for a shape it does
// not take).
extern "C" long long mcn_fused_shaded_workspace(int enc, int depth, int skip_mask, int width,
                                                int head0) {
  MLPParams p;
  if (set_shape(&p, depth, skip_mask, enc, width, head0) || head0 != 2 * width) return 0;
  for (int l = 0; l < depth + 2; ++l) p.w[l] = p.b[l] = nullptr;
  PtSchedule sc;
  PtImages im;
  const long long bytes = fwd_schedule(p, fwd_nch(head0), &sc, &im);
  return bytes < 0 ? 0 : bytes;
}

// feat [n_points, enc] bf16, basis16 [n_points / s, 16] fp32, out
// [n_points, 8] fp32, workspace of mcn_fused_shaded_workspace bytes (the
// weight images, written here); w[l] / b[l] for the depth trunk layers then
// the two head layers (a full pack).  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or the error of a step before it.
extern "C" int mcn_fused_shaded(const void* feat, const void* basis16, void* out, void* workspace,
                                long long n_points, int s, int nb, int enc, int depth,
                                int skip_mask, int width, int head0, const void* const* w,
                                const void* const* b, void* stream) {
  MLPParams p;
  int err = make_params(&p, feat, depth, skip_mask, enc, width, head0, w, b);
  if (err) return err;
  if (s < 1 || nb < 1 || nb > 9 || n_points % s || head0 != 2 * width)
    return cudaErrorInvalidValue;
  if (n_points <= 0) return 0;
  PtSchedule sc;
  PtImages im;
  PtArgs a = {};
  a.nch = fwd_nch(head0);
  if (fwd_schedule(p, a.nch, &sc, &im) < 0) return cudaErrorInvalidValue;
  a.feat = static_cast<const bf16*>(feat);
  a.basis16 = static_cast<const float*>(basis16);
  a.out8 = static_cast<float*>(out);
  a.img = static_cast<const unsigned char*>(workspace);
  a.points = n_points;
  a.s = s;
  a.nb = nb;
  cudaStream_t st = (cudaStream_t)stream;
  weight_images_kernel<<<sc.stages, THREADS, 0, st>>>(im, sc,
                                                      static_cast<unsigned char*>(workspace));
  err = cudaGetLastError();
  return err ? err : launch_shaded_fwd<FWD_SHADED>(p, a, sc, st);
}
