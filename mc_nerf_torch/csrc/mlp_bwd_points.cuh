// The points stage of the MLP backwards (fused_mlp_bwd.cu: K5, the
// backward of fused_shaded_mlp, and K6, the fused_mlp VJP;
// fused_render_bwd.cu: K3, fused_render's), designed for Hopper: per tile
// the recompute of the MLP, the packed output's cotangent (K5, K3: the SH
// shading's backward) and the heads-and-trunk backward, writing dfeat, the
// per-point dbasis partials (K5, K3), the bias partials and the workspace
// that the weight stage (mlp_bwd.cuh, launch_weight_grads) reads: h, h1,
// doutb, d_a, d_h1, at the offsets of make_layout / carve.  The kernel's
// MODE (PT_MLP, PT_SHADED, PT_FORWARD, PT_RENDER) picks the work: K3 runs
// PT_RENDER (tiles of whole rays, the composite backward of each ray,
// composite_ray, in shared memory between the recompute and the shading
// backward) or PT_FORWARD (the recompute alone, sigma and rgb out), then
// its composite kernel, then PT_SHADED.
//
// Rounding points are the Pallas bodies' (fused_mlp.py:495-535, :783-824):
// bf16 operands, fp32 accumulation, ReLU masks from the bf16 activations,
// d_h1 and every d_a rounded to bf16, fp32 dfeat; d head_b1 sums dout32 as
// K5 computes it (fp32) or as K6 rounds it (bf16).
//
// Design (one persistent block of 384 threads per SM):
//  * Rows are independent.  Each of the eight consumer warps owns 16 rows
//    of the tile through every product, from the recompute to dfeat, in its
//    own slab of shared memory; a warpgroup's four slabs form the 64-row A
//    operand of its wgmma, read from shared memory in the K-major
//    core-matrix layout (each 8 x 8 block of bf16 128 contiguous bytes, the
//    blocks of a row group along K 128 bytes apart, the row groups one
//    half-slab apart).  A warpgroup barrier after each epilogue is the only
//    synchronization in the tile loop; no block barrier.
//  * Weights as pre-tiled images.  weight_images_kernel writes every B
//    operand of the tile's schedule once per call into the workspace, each
//    32-row K tile already in wgmma's no-swizzle MN-major layout: the
//    recompute's W and the backward's W^T alike, the skip layers' zero gap
//    rows and the rows past K as zeros.  So one primitive (ring_gemm) serves
//    both directions, and a ring slot is one contiguous bulk copy.
//  * A ring of NST slots of 16 KB (up to 8 consecutive K tiles of a narrow
//    product in one slot) fed by TMA bulk copies (cp.async.bulk ...
//    mbarrier::complete_tx) from one producer warp, which walks the same
//    schedule, tile after tile, as far ahead as the ring allows.  Consumer
//    warpgroups (64 rows each) issue two wgmma per K tile and wait with
//    wait_group 1, so one product is in flight while the next is issued (A
//    comes from shared memory, so no operand register of a product in
//    flight is rewritten); a slot goes back to the producer once both
//    warpgroups' products on it are done (its `empty` mbarrier counts two
//    arrivals).
//  * ReLU masks as bits in shared memory: the recompute's epilogues set one
//    bit per activation (bf16 > 0) for every trunk layer and head layer 0;
//    the backward's epilogues read them.  No activation is read back from
//    device memory.
//  * The packed output's cotangent stays in registers: the head-1 products
//    accumulate into 16 fp32 registers a thread, the shading backward (K5)
//    works on that fragment with quad shuffles, and the bf16 dout becomes
//    the A operand of d_h1's product as it stands (the accumulator layout
//    of an 8-column block is the register A layout of a k16 slice).
//  * Bias partials from registers in a fixed order: the warp's 16 rows are
//    summed by a reduce-scatter shuffle butterfly (each lane ends with a
//    few columns), then added to the warp's own row of the partials
//    (GROUP_ROWS = 8 rows per group, stored at the group's first tile);
//    reduce_rows_kernel sums the rows in order.  No atomics.
//  * Persistent blocks: G = min(tiles, WG_WAVE) groups, block b taking
//    tiles b, b + G, ...; the partial rows, and which tiles feed each, come
//    from the shapes and compile-time constants only, so the result has the
//    same bits on any card.
//  * Workspace stores: after each epilogue the warp copies its rows from
//    shared memory with 16-byte stores, eight lanes on one 128-byte block.
//
// Shared memory (bytes; a half-slab holds 8 rows, a warp's slab two):
//   forward:  act [ep + width] + h1 [nch] columns x 16 bytes (bf16, 8 rows)
//   backward: dbuf [head0] columns x 16 bytes, overlapping the forward's
//   masks:    8 rows x (depth * width + head0) / 32 words, kept from the
//             recompute to the backward
//   ring:     NST x 16 KB, and 2 x NST mbarriers
//   PT_RENDER: the composite's buffer, 2 x 64 rows x 32 bytes
// ep is the encode padded to 32, nch the head-0 pass (128 at most).  At
// the fine 8x256 pack (ep 64, head0 512): half-slab max(7,168, 8,192) +
// 2,560 = 10,752, 16 of them 172,032, ring 3 x 16,384 and its barriers:
// 221,232 of the 232,448 a block may have (PT_RENDER 225,328).  At the
// coarse 4x128 full pack (head0 256): half-slab max(5,120, 4,096) + 768 =
// 5,888, 16 of them 94,208, ring 6 x 16,384: 192,608.
//
// Bound (H100 SXM): the recompute and dX products need 2 x 629,248 MAC a
// point at the fine pack (2.3 ms of tensor-core time at 7000 x 130 points),
// and the stage writes ~10.7 KB a point of workspace and dfeat (2.9 ms at
// 3.35 TB/s): bytes, narrowly (tools/bwd_check.points_stage_bytes).
#pragma once

#include "mlp_bwd.cuh"

namespace mcn {

constexpr int PT_THREADS = THREADS + 128;  // two consumer warpgroups + the producer's
constexpr int PT_WARPS = THREADS / 32;     // consumer warps, 16 rows each
constexpr int PT_STAGE = KT * NC_MAX * 2;  // bytes of one ring slot (32 K rows x 256 columns)
constexpr int PT_MAX_STAGES = 6;
constexpr int PT_MAX_GEMMS = 64;
constexpr int GROUP_ROWS = PT_WARPS;       // bias-partial rows per group
constexpr int BASIS_LANES = 16;            // a ray's SH basis, padded

// What mlp_points_kernel runs per tile (its template argument):
constexpr int PT_MLP = 0;      // K6: the recompute, then the backward from dout [P, 32]
constexpr int PT_SHADED = 1;   // K5, K3: the recompute, then the shading backward from
                               // dout8 [P, 8] and the heads-and-trunk backward
constexpr int PT_FORWARD = 2;  // K3's forward: the recompute alone, sigma and the shaded
                               // rgb out; nothing to the workspace
constexpr int PT_RENDER = 3;   // K3 fused: tiles of whole rays, the recompute, the
                               // composite backward in shared memory, then as PT_SHADED
constexpr int RAY_ROWS = 64;   // PT_RENDER: a warpgroup's rows, whole rays of s <= 64
constexpr int IO_FLOATS = 8;   // a row of the composite's buffer (sigma, rgb, dout8, scratch)

// wgmma with both operands in shared memory, A K-major and B MN-major,
// neither swizzled (imm-trans-a 0, imm-trans-b 1): A is the warpgroup's 64
// rows of an activation buffer in the core-matrix layout below, B a ring
// slot of a weight image.
__device__ __forceinline__ void wgmma_ss_ka_32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_ka_64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_ka_128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_ka_256(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss_ka(float* d, uint64_t da, uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256, "wgmma_ss_ka: N");
  if constexpr (N == 32) wgmma_ss_ka_32(d, da, db);
  else if constexpr (N == 64) wgmma_ss_ka_64(d, da, db);
  else if constexpr (N == 128) wgmma_ss_ka_128(d, da, db);
  else wgmma_ss_ka_256(d, da, db);
}

// One product of the tile's schedule, as the producer and the consumers see
// it: k_tiles stages of 32 K rows x nc columns, the first at `off` bytes
// into the weight images.
struct PtGemm {
  long long off;
  int k_tiles, nc;
};

// How weight_images_kernel fills a product's image:
//   kind 0 (recompute): B[k][n] = w[(row0 + row(k)) * ldw + n0 + n], row(k) as
//     mlp_tile.cuh's WeightRows (k below feat_rows, none in the gap up to
//     gap_end, k - gap_end + feat_rows after), zero past K;
//   kind 1 (backward, W^T): B[k][n] = w[(n0 + n) * ldw + k] for n < n_lim
//     and k < K, else zero.
struct PtImage {
  const bf16* w;
  int kind, ldw, row0, n0, K, feat_rows, gap_end, n_lim;
  int stage0;  // the product's first stage among all products
};

struct PtSchedule {
  PtGemm g[PT_MAX_GEMMS];
  int count, stages;  // products, and their K tiles (of one tile of points)
};

struct PtImages {
  PtImage m[PT_MAX_GEMMS];
  int count;
};

struct PtArgs {
  const bf16* feat;
  const float* basis16;  // [P / s, 16] (shaded)
  const float* dout_in;  // dout8 [P, 8] (shaded) or dout [P, 32]
  float* out8;           // PT_FORWARD: sigma, rgb into columns 0..3 of [P, 8]
  float* dfeat;          // [P, enc]
  const float* z;        // PT_RENDER: the composite's inputs, [rays, s], [rays, s] or
  const float* noise;    //   null, [rays, 8]
  const float* dray;
  long long rays;
  int ray_k, white_back;  // PT_RENDER: rays per warpgroup
  const unsigned char* img;
  Workspace ws;
  long long points, tiles;
  int s, nb, nbias, nch, nst;
  int ep;                // encode lanes padded to 32: the act buffer's feature columns
  int half;              // bytes of one half-slab (8 rows; a warp's slab holds two)
  int h1_off, mask_off;  // offsets in a half-slab (act and dbuf at 0)
  int mask_words;
};

// ------------------------------------------------------------ the images

// One block per stage of the schedule: its 32 K rows x nc columns in the
// layout of stage_tile (mlp_tile.cuh): the 16-byte chunk of row k, columns
// 8c..8c+7, at byte (k / 8) * (nc * 16) + c * 128 + (k % 8) * 16.
__global__ void weight_images_kernel(const __grid_constant__ PtImages im,
                                     const __grid_constant__ PtSchedule sc, unsigned char* img) {
  int g = 0;
  while (g + 1 < im.count && (int)blockIdx.x >= im.m[g + 1].stage0) ++g;
  const PtImage& m = im.m[g];
  const int kt = blockIdx.x - m.stage0, nc = sc.g[g].nc, per_row = nc >> 3;
  unsigned char* base = img + sc.g[g].off + (size_t)kt * KT * nc * 2;
  for (int idx = threadIdx.x; idx < KT * per_row; idx += blockDim.x) {
    const int r8 = idx & 7, rest = idx >> 3;
    const int c = rest % per_row, kg = rest / per_row;
    const int k = kt * KT + kg * 8 + r8;
    __align__(16) bf16 v[8];
    if (m.kind == 0) {
      int row = -1;
      if (k < m.K) row = k < m.feat_rows ? k : (k < m.gap_end ? -1 : k - m.gap_end + m.feat_rows);
      uint4 q = make_uint4(0, 0, 0, 0);
      if (row >= 0)
        q = *reinterpret_cast<const uint4*>(m.w + (size_t)(m.row0 + row) * m.ldw + m.n0 + c * 8);
      *reinterpret_cast<uint4*>(v) = q;
    } else {
      for (int e = 0; e < 8; ++e) {
        const int n = c * 8 + e;
        v[e] = n < m.n_lim && k < m.K ? m.w[(size_t)(m.n0 + n) * m.ldw + k]
                                      : __float2bfloat16_rn(0.f);
      }
    }
    *reinterpret_cast<uint4*>(base + kg * (nc * 16) + c * 128 + r8 * 16) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// ------------------------------------------------------------- the ring

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct Ring {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  int nst, stage;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++stage == nst) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// K tiles of a product of `nc` columns that one ring slot holds: as many as
// fit in PT_STAGE bytes (1 at 256 columns, 8 at 32).
__host__ __device__ constexpr int tiles_per_slot(int nc) { return PT_STAGE / (KT * nc * 2); }

// The producer warp: every stage of every product of every tile of the
// block, in schedule order, into the next free slot; a stage holds up to
// tiles_per_slot(nc) consecutive K tiles of one product.
__device__ void pt_produce(const PtSchedule& sc, const unsigned char* img, long long tiles,
                           Ring rg) {
  if ((threadIdx.x & 31) != 0) return;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
    for (int g = 0; g < sc.count; ++g) {
      const int nc = sc.g[g].nc, per = tiles_per_slot(nc);
      const unsigned char* src = img + sc.g[g].off;
      for (int kt = 0; kt < sc.g[g].k_tiles; kt += per) {
        const int n = sc.g[g].k_tiles - kt < per ? sc.g[g].k_tiles - kt : per;
        const uint32_t bytes = (uint32_t)n * KT * nc * 2;
        mbar_wait(rg.empty + rg.stage, rg.phase ^ 1);  // free (at once on the first lap)
        mbar_expect_tx(rg.full + rg.stage, bytes);
        bulk_load(rg.slots + (size_t)rg.stage * PT_STAGE, src, bytes, rg.full + rg.stage);
        src += bytes;
        rg.advance();
      }
    }
}

// One K tile's two k16 products: acc += A (the warpgroup's rows at
// a_addr, K-major, 8-row groups `half` bytes apart) x the slot's rows.
template <int NC>
__device__ __forceinline__ void stage_mma(float* acc, uint32_t a_addr, uint32_t half,
                                          uint32_t slot) {
  wgmma_fence();
  wgmma_ss_ka<NC>(acc, make_desc(a_addr, 128, half), make_desc(slot, NC * 16, 128));
  wgmma_ss_ka<NC>(acc, make_desc(a_addr + 256, 128, half),
                  make_desc(slot + 2 * NC * 16, NC * 16, 128));
  wgmma_commit();
}

// One K tile of a product: wait for its slot where the tile opens one,
// issue its two products, then wait for the previous tile's and release
// the slot that tile closed (the warpgroup's lead thread arrives); a slot
// this tile closes is released by the next call or the product's end.
template <int NC>
__device__ __forceinline__ void k_step(float* acc, uint32_t a_addr, uint32_t half, int kt,
                                       int k_tiles, Ring& rg, int& pending, bool lead) {
  constexpr int PER = tiles_per_slot(NC);
  const int j = kt % PER;
  if (j == 0) mbar_wait(rg.full + rg.stage, rg.phase);
  stage_mma<NC>(acc, a_addr, half,
                smem_u32(rg.slots + (size_t)rg.stage * PT_STAGE) + j * KT * NC * 2);
  wgmma_wait<1>();
  if (pending >= 0 && lead) mbar_arrive(rg.empty + pending);
  pending = -1;
  if (j == PER - 1 || kt == k_tiles - 1) {
    pending = rg.stage;
    rg.advance();
  }
}

// acc[the warpgroup's 64 rows x NC] = A[rows, k] x B_g[k, n] over the
// product's K (a multiple of 32; its stages from the ring), A the columns
// from a_addr on of a K-major buffer (32 columns = 512 bytes).  One product
// stays in flight while the next is issued (wait_group 1): A is read from
// shared memory, so no register of a product in flight is rewritten.  On
// return every product is done and every slot released.
template <int NC>
__device__ __forceinline__ void ring_gemm(const PtGemm& G, uint32_t a_addr, uint32_t half,
                                          float* acc, Ring& rg) {
  const bool lead = (threadIdx.x & 127) == 0;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  int pending = -1;
  for (int kt = 0; kt < G.k_tiles; ++kt)
    k_step<NC>(acc, a_addr + kt * 512, half, kt, G.k_tiles, rg, pending, lead);
  wgmma_wait<0>();
  if (lead) mbar_arrive(rg.empty + pending);
}

// The same for a one-stage product whose A fragments are already in
// registers (d_h1 = dout_b x hw1^T, K = 32).
template <int NC>
__device__ __forceinline__ void ring_gemm_regs(const uint32_t* a, float* acc, Ring& rg) {
  const bool lead = (threadIdx.x & 127) == 0;
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  mbar_wait(rg.full + rg.stage, rg.phase);
  const uint32_t slot = smem_u32(rg.slots + (size_t)rg.stage * PT_STAGE);
  wgmma_fence();
  wgmma_rs<NC>(acc, a, make_desc(slot, NC * 16, 128));
  wgmma_rs<NC>(acc, a + 4, make_desc(slot + 2 * NC * 16, NC * 16, 128));
  wgmma_commit();
  wgmma_wait<0>();
  if (lead) mbar_arrive(rg.empty + rg.stage);
  rg.advance();
}

// ------------------------------------------------------------- epilogues

// The lane's place in an accumulator fragment: rows g and g + 8 of the
// warp's 16, columns 8 j + 2 tig (+1).
struct Frag {
  int g, tig;
  __device__ __forceinline__ Frag() : g((threadIdx.x & 31) >> 2), tig(threadIdx.x & 3) {}
};

// Copy the warp's first nr rows x ncols (a multiple of 8) of a buffer in
// the core-matrix layout (buf: its first half-slab; row r at half r / 8,
// 16-byte chunk c of it at c * 128 + (r % 8) * 16) to global rows of `ld`
// elements, 16 bytes a lane: eight lanes take one chunk of eight rows (128
// contiguous bytes of shared memory), and each row gets 64 bytes per
// instruction.
__device__ __forceinline__ void store_core_rows(const unsigned char* buf, int half, int ncols,
                                                bf16* dst, long long ld, int nr) {
  const int chunks = ncols >> 3;
  for (int idx = threadIdx.x & 31; idx < 16 * chunks; idx += 32) {
    const int r8 = idx & 7, rest = idx >> 3;
    const int c = rest % chunks, hh = rest / chunks, r = 8 * hh + r8;
    if (r < nr)
      *reinterpret_cast<uint4*>(dst + r * ld + c * 8) =
          *reinterpret_cast<const uint4*>(buf + hh * half + c * 128 + r8 * 16);
  }
}

// The warpgroup's A rows, written by its four warps, visible to its next
// wgmma: each thread's writes to the async proxy, then a barrier of the
// warpgroup's 128 threads (named barrier 1 + warpgroup); PT_RENDER's
// composite buffer is handed between the warps by it too.
__device__ __forceinline__ void wg_sync() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + ((int)threadIdx.x >> 7)) : "memory");
}

// The warp's column sums of one product's output (per lane: v[2 j + e] =
// the sum of its two rows at column 8 j + 2 tig + e) over its 16 rows, in
// a fixed order, added into the warp's row of the bias partials at `part`
// (columns col0 onward; stored when `first`).  A reduce-scatter butterfly
// over the lane bits that pick the row (4, 3, 2): each step halves the
// columns a lane keeps while there are two or more blocks of 8, then plain
// adds; the lanes left holding a block's sums write it.
template <int NC>
__device__ __forceinline__ void bias_sums(float* v, float* part, int col0, bool first,
                                          const Frag& f) {
  constexpr int J = NC / 8;
  int jbase = 0, nj = J;
  bool writer = true;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int bit = 16; bit >= 4; bit >>= 1) {
    const bool hi = (lane & bit) != 0;
    if (nj >= 2) {
      const int half = nj / 2;
#pragma unroll
      for (int jj = 0; jj < J / 2; ++jj) {
        if (jj < half) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lo_v = v[2 * jj + e], hi_v = v[2 * (jj + half) + e];
            const float send = hi ? lo_v : hi_v;
            const float keep = hi ? hi_v : lo_v;
            v[2 * jj + e] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
          }
        }
      }
      if (hi) jbase += half;
      nj = half;
    } else {
#pragma unroll
      for (int e = 0; e < 2; ++e) v[e] += __shfl_xor_sync(0xffffffffu, v[e], bit);
      writer = writer && !hi;
    }
  }
  if (!writer) return;
#pragma unroll
  for (int jj = 0; jj < nj; ++jj) {
    float2* dst = reinterpret_cast<float2*>(part + col0 + 8 * (jbase + jj) + 2 * f.tig);
    const float2 old = first ? make_float2(0.f, 0.f) : *dst;
    *dst = make_float2(old.x + v[2 * jj], old.y + v[2 * jj + 1]);
  }
}

// Where the lane's fragment element (row g + 8 h, columns 8 j + 2 tig, +1)
// lives in a core-matrix buffer (buf: its first half-slab).
__device__ __forceinline__ unsigned char* frag_at(unsigned char* buf, int half, int j, int h,
                                                  const Frag& f) {
  return buf + h * half + j * 128 + f.g * 16 + f.tig * 4;
}

// Recompute epilogue of a ReLU layer: bf16(relu(acc + bias)) into the
// warp's rows of the buffer at `buf`, its mask bits (per 32 columns: the
// lane's bits, or-ed over the quad; word w of fragment row g + 8 h at
// masks + h * half + g * 4 words + 4 w), then (STORE) the rows to the
// workspace.  STORE is a template argument: as a run-time test of g_dst it
// cost K5's coarse pass 2.5% on an H100 (PERF.md).
template <int NC, bool STORE>
__device__ __forceinline__ void relu_epilogue(const float* acc, const bf16* __restrict__ bias,
                                              unsigned char* buf, int half, unsigned char* masks,
                                              int words, int mask_col, bf16* g_dst, long long ld,
                                              int nr, const Frag& f) {
#pragma unroll
  for (int q = 0; q < (NC + 31) / 32; ++q) {
    uint32_t bits[2] = {0u, 0u};
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * q + jj;
      if (j < NC / 8) {
        const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bias + 8 * j + 2 * f.tig);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(fmaxf(acc[4 * j + 2 * h] + __bfloat162float(b.x), 0.f));
          v.y = __float2bfloat16_rn(fmaxf(acc[4 * j + 2 * h + 1] + __bfloat162float(b.y), 0.f));
          *reinterpret_cast<__nv_bfloat162*>(frag_at(buf, half, j, h, f)) = v;
          const uint32_t b0 = __bfloat162float(v.x) > 0.f, b1 = __bfloat162float(v.y) > 0.f;
          bits[h] |= (b0 | (b1 << 1)) << (8 * jj + 2 * f.tig);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bits[h] |= __shfl_xor_sync(0xffffffffu, bits[h], 1);
      bits[h] |= __shfl_xor_sync(0xffffffffu, bits[h], 2);
      if (f.tig == 0)
        reinterpret_cast<uint32_t*>(masks + h * half)[f.g * words + mask_col / 32 + q] = bits[h];
    }
  }
  __syncwarp();
  if constexpr (STORE) store_core_rows(buf, half, NC, g_dst, ld, nr);
  wg_sync();
}

// Backward epilogue of a masked layer: d = bf16(mask ? acc : 0) into the
// warp's rows of the buffer at `buf` and the workspace, and its column sums
// into the bias partials, per group of 64 columns (so that the sums of at
// most 16 columns a lane are held at once).
template <int NC>
__device__ __forceinline__ void mask_epilogue(const float* acc, unsigned char* buf, int half,
                                              const unsigned char* masks, int words,
                                              int mask_col, bf16* g_dst, long long ld, int nr,
                                              float* part, int part_col, bool first,
                                              const Frag& f) {
  constexpr int CJ = NC / 8 < 8 ? NC / 8 : 8;
#pragma unroll
  for (int c = 0; c < NC / 8 / CJ; ++c) {
    float sums[2 * CJ];
#pragma unroll
    for (int jj = 0; jj < CJ; ++jj) {
      const int j = c * CJ + jj, col = mask_col + 8 * j + 2 * f.tig;
      sums[2 * jj] = sums[2 * jj + 1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t word =
            reinterpret_cast<const uint32_t*>(masks + h * half)[f.g * words + col / 32];
        const int bit = col & 31;
        __nv_bfloat162 v;
        v.x = __float2bfloat16_rn((word >> bit) & 1u ? acc[4 * j + 2 * h] : 0.f);
        v.y = __float2bfloat16_rn((word >> (bit + 1)) & 1u ? acc[4 * j + 2 * h + 1] : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(frag_at(buf, half, j, h, f)) = v;
        sums[2 * jj] += __bfloat162float(v.x);
        sums[2 * jj + 1] += __bfloat162float(v.y);
      }
    }
    bias_sums<8 * CJ>(sums, part, part_col + 64 * c, first, f);
  }
  __syncwarp();
  store_core_rows(buf, half, NC, g_dst, ld, nr);
  wg_sync();
}

// dfeat[row, col] (+)= acc for col < enc, rows below nr: a skip layer's
// share (stored, the first) or layer 0's (added).
template <int NC>
__device__ __forceinline__ void feat_epilogue(const float* acc, float* dfeat, int enc, int nr,
                                              bool add, const Frag& f) {
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = 8 * j + 2 * f.tig;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.g + 8 * h;
      if (r >= nr) continue;
      float* row = dfeat + (size_t)r * enc;
      if (col < enc) row[col] = (add ? row[col] : 0.f) + acc[4 * j + 2 * h];
      if (col + 1 < enc) row[col + 1] = (add ? row[col + 1] : 0.f) + acc[4 * j + 2 * h + 1];
    }
  }
}

// ------------------------------------------------ the composite backward

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + logf(1.f + expf(-fabsf(x)));
}

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

// Exclusive suffix sum across the warp (lanes above this one), plus
// `carry`, the sum of every later chunk; updates carry.
__device__ __forceinline__ float warp_exclusive_suffix(float x, float& carry) {
  const int lane = threadIdx.x & 31;
  float v = __shfl_down_sync(0xffffffffu, x, 1);
  if (lane == 31) v = 0.f;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += y;
  }
  const float excl = v + carry;
  carry += __shfl_sync(0xffffffffu, v + x, 0);
  return excl;
}

// The backward of the composite and of the sigmoid rgb outputs of one ray
// (fused_render.py:343-404), by one warp, a lane per sample, 32 at a time.
// io: the ray's s rows of IO_FLOATS floats, in shared or device memory; on
// entry columns 0..3 of row i hold sample i's raw sigma and shaded rgb; on
// return they hold its dout8 (d sigma, w * d rgb_c), and columns 4..5 the
// exclusive prefix sums the forward scan parked there.  z and noise (or
// null) point at the ray's s samples, dr at its dray row (d rgb, d depth,
// d opacity).  A forward __shfl_up_sync scan of softplus(sigma [+ noise])
// * delta (noise-free for depth and opacity, noisy for rgb; the last delta
// 1e10, where exp(-sd) is 0 and no inf * 0 arises), then a reverse
// __shfl_down_sync scan of the exclusive suffix sums of d(cum) (the TPU
// kernel's seg^T @ dcum); the white background subtracts sum(d rgb).
__device__ __forceinline__ void composite_ray(float* io, const float* z, const float* noise,
                                              const float* dr, int s, int white_back) {
  const int lane = threadIdx.x & 31;
  const float dR = dr[0], dG = dr[1], dB = dr[2], dDepth = dr[3], dOpac = dr[4];
  const float dbg = white_back ? dR + dG + dB : 0.f;
  float c_nf = 0.f, c_n = 0.f;
  for (int i0 = 0; i0 < s; i0 += 32) {
    const int i = i0 + lane;
    const bool valid = i < s;
    float d = 0.f, sg = 0.f, nz = 0.f;
    if (valid) {
      d = i < s - 1 ? z[i + 1] - z[i] : 1e10f;
      sg = io[i * IO_FLOATS];
      if (noise) nz = noise[i];
    }
    const float sd_nf = valid ? softplus(sg) * d : 0.f;
    const float sd_n = (valid && noise) ? softplus(sg + nz) * d : 0.f;
    const float cum_nf = warp_exclusive_scan(sd_nf, c_nf);
    const float cum_n = noise ? warp_exclusive_scan(sd_n, c_n) : 0.f;
    if (valid) *reinterpret_cast<float2*>(io + i * IO_FLOATS + 4) = make_float2(cum_nf, cum_n);
  }
  float r_nf = 0.f, r_n = 0.f;
  for (int i0 = (s - 1) / 32 * 32; i0 >= 0; i0 -= 32) {
    const int i = i0 + lane;
    const bool valid = i < s;
    float zi = 0.f, d = 0.f, nz = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float2 cum = make_float2(0.f, 0.f);
    if (valid) {
      zi = z[i];
      d = i < s - 1 ? z[i + 1] - zi : 1e10f;
      if (noise) nz = noise[i];
      o = *reinterpret_cast<const float4*>(io + i * IO_FLOATS);
      cum = *reinterpret_cast<const float2*>(io + i * IO_FLOATS + 4);
    }
    const float sg = o.x;
    const float dw = dR * o.y + dG * o.z + dB * o.w - dbg;
    const float dprob = dDepth * zi + dOpac;
    const float sd_nf = softplus(sg) * d;
    const float e_nf = expf(-sd_nf), t_nf = expf(-cum.x), al_nf = 1.f - e_nf;
    const float dwc_nf = noise ? dprob : dprob + dw;
    const float dcum_nf = valid ? -(dwc_nf * al_nf) * t_nf : 0.f;
    const float dsd_nf = warp_exclusive_suffix(dcum_nf, r_nf) + dwc_nf * t_nf * e_nf;
    float dsig = dsd_nf * d * sigmoidf(sg);
    float w = al_nf * t_nf;
    if (noise) {
      const float sgn = sg + nz;
      const float sd_n = softplus(sgn) * d;
      const float e_n = expf(-sd_n), t_n = expf(-cum.y), al_n = 1.f - e_n;
      const float dcum_n = valid ? -(dw * al_n) * t_n : 0.f;
      const float dsd_n = warp_exclusive_suffix(dcum_n, r_n) + dw * t_n * e_n;
      dsig += dsd_n * d * sigmoidf(sgn);
      w = al_n * t_n;
    }
    if (valid)
      *reinterpret_cast<float4*>(io + i * IO_FLOATS) = make_float4(dsig, w * dR, w * dG, w * dB);
  }
}

// ------------------------------------------------- the consumer warps

// Run ring_gemm at the product's width (32, 64, 128 or 256) and hand the
// accumulators to `epi`.
template <class Epi>
__device__ __forceinline__ void gemm_at(int nc, const PtGemm& G, uint32_t a_addr, uint32_t half,
                                        Ring& rg, const Epi& epi) {
  switch (nc) {
    case 256: { float acc[128]; ring_gemm<256>(G, a_addr, half, acc, rg); epi.template run<256>(acc); break; }
    case 128: { float acc[64]; ring_gemm<128>(G, a_addr, half, acc, rg); epi.template run<128>(acc); break; }
    case 64: { float acc[32]; ring_gemm<64>(G, a_addr, half, acc, rg); epi.template run<64>(acc); break; }
    default: { float acc[16]; ring_gemm<32>(G, a_addr, half, acc, rg); epi.template run<32>(acc); break; }
  }
}

template <bool STORE>
struct ReluEpi {
  const bf16* bias;
  unsigned char* buf;
  int half;
  unsigned char* masks;
  int words, mask_col;
  bf16* g_dst;
  long long ld;
  int nr;
  template <int NC>
  __device__ __forceinline__ void run(const float* acc) const {
    relu_epilogue<NC, STORE>(acc, bias, buf, half, masks, words, mask_col, g_dst, ld, nr,
                             Frag());
  }
};

struct MaskEpi2 {
  unsigned char* buf;
  int half;
  const unsigned char* masks;
  int words, mask_col;
  bf16* g_dst;
  long long ld;
  int nr;
  float* part;
  int part_col;
  bool first;
  template <int NC>
  __device__ __forceinline__ void run(const float* acc) const {
    mask_epilogue<NC>(acc, buf, half, masks, words, mask_col, g_dst, ld, nr, part, part_col,
                      first, Frag());
  }
};

struct FeatEpi2 {
  float* dfeat;
  int enc, nr;
  bool add;
  template <int NC>
  __device__ __forceinline__ void run(const float* acc) const {
    feat_epilogue<NC>(acc, dfeat, enc, nr, add, Frag());
  }
};

// The shaded rgb of fragment row g + 8 h, in every lane of the quad:
// sg[c] = sigmoid(sum_b out32[1 + nb c + b] * bas[b]) from the output
// fragment `o` (fused_mlp.py:408-418).
__device__ __forceinline__ void shade_rgb(const float* o, const float* bas, int nb, int h,
                                          const Frag& f, float* sg) {
  float part_c[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * f.tig + e;
      const int lane_sh = col - 1;
      if (col >= 1 && lane_sh < 3 * nb) {
        const int c = lane_sh / nb, b = lane_sh - c * nb;
        const float t = o[4 * j + 2 * h + e] * bas[b];
        part_c[0] += c == 0 ? t : 0.f;
        part_c[1] += c == 1 ? t : 0.f;
        part_c[2] += c == 2 ? t : 0.f;
      }
    }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = part_c[c];
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    sg[c] = sigmoidf(acc);
  }
}

// The raw sigma (column 0 of the fragment, lane tig 0) and the shaded rgb
// of the warp's live rows into columns 0..3 of rows of IO_FLOATS floats
// (`io` the warp's first row): PT_FORWARD's output, PT_RENDER's staging.
__device__ __forceinline__ void forward_out(const float* o, const PtArgs& a, long long row0,
                                            int nr, float* io, const Frag& f) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = f.g + 8 * h;
    float sg[3];
    shade_rgb(o, a.basis16 + (r < nr ? (row0 + r) / a.s : 0) * BASIS_LANES, a.nb, h, f, sg);
    if (r < nr && f.tig == 0)
      *reinterpret_cast<float4*>(io + r * IO_FLOATS) = make_float4(o[2 * h], sg[0], sg[1], sg[2]);
  }
}

// The packed output's cotangent of the warp's rows, from the fragment
// `o` (the recompute's out32, 16 registers: rows g, g + 8, columns 8 j +
// 2 tig + e) and, for K5, the shading backward (fused_mlp.py:479-493):
//   draw_c = dout8[1 + c] * sig_c (1 - sig_c), sig_c = sigmoid(sum_b
//   out32[1 + nb c + b] * basis[b]); dout32[0] = dout8[0], dout32[1 + nb c
//   + b] = draw_c * basis[b]; the point's dbasis partial b = sum_c draw_c *
//   out32[1 + nb c + b];
// for K6 the cotangent rounded to bf16 (fused_mlp.py:761, :788).  Writes
// the A fragments of d_h1's product (bf16), doutb and (K5) the dbasis
// partials to the workspace, and adds the column sums of dout32 (d
// head_b1) into the bias partials.  Rows at or past nr get a zero
// cotangent.
template <bool SHADED>
__device__ __forceinline__ void out_cotangent(const float* o, const PtArgs& a, long long row0,
                                              int nr, const float* d8rows, uint32_t* afrag,
                                              float* part, bool first, const Frag& f) {
  float d[16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = f.g + 8 * h;
    const long long pt = row0 + r;
    const bool live = r < nr;
    if (SHADED) {
      const int nb = a.nb;
      const float* bas = a.basis16 + (live ? pt / a.s : 0) * BASIS_LANES;
      float sg[3], draw[3];
      shade_rgb(o, bas, nb, h, f, sg);
      const float* d8 = d8rows + (live ? r : 0) * IO_FLOATS;
#pragma unroll
      for (int c = 0; c < 3; ++c) draw[c] = live ? d8[1 + c] * (sg[c] * (1.f - sg[c])) : 0.f;
      float dbp[9];
#pragma unroll
      for (int b = 0; b < 9; ++b) dbp[b] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * f.tig + e;
          const int lane_sh = col - 1;
          float v = 0.f;
          if (col == 0) {
            v = live ? d8[0] : 0.f;
          } else if (lane_sh < 3 * nb) {
            const int c = lane_sh / nb, b = lane_sh - c * nb;
            const float dc = c == 0 ? draw[0] : (c == 1 ? draw[1] : draw[2]);
            v = dc * bas[b];
            const float t = dc * o[4 * j + 2 * h + e];
#pragma unroll
            for (int bb = 0; bb < 9; ++bb) dbp[bb] += bb == b ? t : 0.f;
          }
          d[4 * j + 2 * h + e] = v;
        }
#pragma unroll
      for (int b = 0; b < 9; ++b) {
        dbp[b] += __shfl_xor_sync(0xffffffffu, dbp[b], 1);
        dbp[b] += __shfl_xor_sync(0xffffffffu, dbp[b], 2);
      }
      if (live) {  // lane tig writes lanes 4 tig .. 4 tig + 3 of the point's 16
        float w4[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          w4[q] = 0.f;
#pragma unroll
          for (int b = 0; b < 9; ++b) w4[q] = b == 4 * f.tig + q ? dbp[b] : w4[q];
        }
        *reinterpret_cast<float4*>(a.ws.dbp + pt * DBP_LANES + 4 * f.tig) =
            make_float4(w4[0], w4[1], w4[2], w4[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float2 v = make_float2(0.f, 0.f);
        if (live)
          v = *reinterpret_cast<const float2*>(a.dout_in + pt * OUT_COLS + 8 * j + 2 * f.tig);
        d[4 * j + 2 * h] = __bfloat162float(__float2bfloat16_rn(v.x));
        d[4 * j + 2 * h + 1] = __bfloat162float(__float2bfloat16_rn(v.y));
      }
    }
  }
  // A fragments of the k16 slices (columns 0-15, 16-31): a0 (row g, 2 tig),
  // a1 (row g + 8, 2 tig), a2 (row g, 2 tig + 8), a3 (row g + 8, 2 tig + 8)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __nv_bfloat162 p;
      p.x = __float2bfloat16_rn(d[4 * j + 2 * h]);
      p.y = __float2bfloat16_rn(d[4 * j + 2 * h + 1]);
      afrag[(j >> 1) * 4 + (j & 1) * 2 + h] = *reinterpret_cast<const uint32_t*>(&p);
      const long long pt = row0 + f.g + 8 * h;
      if (f.g + 8 * h < nr)
        *reinterpret_cast<__nv_bfloat162*>(a.ws.doutb + pt * OUT_COLS + 8 * j + 2 * f.tig) = p;
    }
  float sums[8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) sums[2 * j + e] = d[4 * j + e] + d[4 * j + 2 + e];
  bias_sums<32>(sums, part, 0, first, f);
}

// The warp's 16 feat rows from row0 into the feature columns [0, ep) of
// its act buffer (core-matrix layout, `act` its first half-slab), lanes
// past enc and rows at or past nr zero.
__device__ __forceinline__ void load_feat_rows(const MLPParams& p, const bf16* __restrict__ feat,
                                               long long row0, int nr, unsigned char* act,
                                               int half, int ep) {
  const int lane = threadIdx.x & 31, chunks = ep >> 3;
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int r8 = idx & 7, rest = idx >> 3;
    const int c = rest % chunks, hh = rest / chunks, r = 8 * hh + r8;
    __align__(16) bf16 v[8];
    if (p.feat_vec && 8 * c < p.enc) {
      *reinterpret_cast<uint4*>(v) =
          r < nr ? *reinterpret_cast<const uint4*>(feat + (row0 + r) * p.enc + 8 * c)
                 : make_uint4(0, 0, 0, 0);
    } else {
      for (int e = 0; e < 8; ++e)
        v[e] = r < nr && 8 * c + e < p.enc ? feat[(row0 + r) * p.enc + 8 * c + e]
                                           : __float2bfloat16_rn(0.f);
    }
    *reinterpret_cast<uint4*>(act + hh * half + c * 128 + r8 * 16) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// One consumer warp's share of every tile of the block: its 16 rows in its
// slab (two half-slabs of 8 rows), the warpgroup's products reading the
// four slabs of its warps as one K-major A operand.  Tiles are 128 points
// in a row, or (PT_RENDER) 2 x ray_k whole rays, ray_k to a warpgroup, its
// rows past ray_k x s dead.  PT_FORWARD stops after the recompute (its
// schedule holds the recompute's products only); PT_RENDER stages each
// row's sigma and rgb in `io` (the warpgroup's 64 rows of IO_FLOATS), runs
// the composite backward of each of its rays there (a warp per ray), and
// takes each row's dout8 from there.
template <int MODE>
__device__ __forceinline__ void pt_consume(const MLPParams& p, const PtArgs& a,
                                           const PtSchedule& sc, unsigned char* slab, float* io,
                                           Ring& rg) {
  constexpr bool SHADED = MODE != PT_MLP, FWD = MODE == PT_FORWARD, RENDER = MODE == PT_RENDER;
  const int warp = threadIdx.x >> 5;
  const int ep = a.ep, wd = p.width, depth = p.depth, words = a.mask_words, half = a.half;
  const Frag f;
  unsigned char* act = slab;
  unsigned char* h1 = slab + a.h1_off;
  unsigned char* dbuf = slab;
  unsigned char* masks = slab + a.mask_off;
  // the warpgroup's A operands: its first warp's slab
  const uint32_t wg_slab = smem_u32(slab) - (uint32_t)((warp & 3) * 2 * half);
  const uint32_t a_act = wg_slab, a_h = wg_slab + ep * 16, a_h1 = wg_slab + a.h1_off;
  const uint32_t a_d = wg_slab, uhalf = (uint32_t)half;
  float* part = a.ws.bias_part + ((size_t)blockIdx.x * GROUP_ROWS + warp) * a.nbias;
  const Workspace& ws = a.ws;
  const long long P = a.points;
  bool first = true;
  for (long long t = blockIdx.x; t < a.tiles; t += gridDim.x, first = false) {
    long long row0, left;  // the warp's first point, and the points from it on
    long long ray0 = 0;
    int n_rays = 0;        // PT_RENDER: the warpgroup's first ray and its ray count
    if constexpr (RENDER) {
      ray0 = (2 * t + (warp >> 2)) * a.ray_k;
      const long long rl = a.rays - ray0;
      n_rays = rl <= 0 ? 0 : (rl < a.ray_k ? (int)rl : a.ray_k);
      row0 = ray0 * a.s + 16 * (warp & 3);
      left = (long long)n_rays * a.s - 16 * (warp & 3);
    } else {
      row0 = t * TILE_M + 16 * warp;
      left = P - row0;
    }
    const int nr = left <= 0 ? 0 : (left >= 16 ? 16 : (int)left);
    int gi = 0;
    load_feat_rows(p, a.feat, row0, nr, act, half, ep);
    wg_sync();
    // recompute: trunk, h written over the act buffer's hidden columns
    for (int l = 0; l < depth; ++l) {
      const bool takes_feat = l == 0 || ((p.skip_mask >> l) & 1);
      const ReluEpi<!FWD> e = {p.b[l], act + ep * 16, half, masks, words, l * wd,
                               ws.h + ((size_t)l * P + row0) * wd, wd, nr};
      gemm_at(wd, sc.g[gi++], takes_feat ? a_act : a_h, uhalf, rg, e);
    }
    // recompute: head layer 0 in passes of nch columns, each followed (K5)
    // by its share of head layer 1 into the output fragment
    float o[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;
    for (int c0 = 0; c0 < p.head0; c0 += a.nch) {
      const int nc = min(a.nch, p.head0 - c0);
      const ReluEpi<!FWD> e = {p.b[depth] + c0, h1, half, masks, words, depth * wd + c0,
                               ws.h1 + row0 * p.head0 + c0, p.head0, nr};
      gemm_at(nc, sc.g[gi++], a_h, uhalf, rg, e);
      if (SHADED) {
        float acc[16];
        ring_gemm<32>(sc.g[gi++], a_h1, uhalf, acc, rg);
#pragma unroll
        for (int i = 0; i < 16; ++i) o[i] += acc[i];
      }
    }
    if (SHADED) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 b =
            *reinterpret_cast<const __nv_bfloat162*>(p.b[depth + 1] + 8 * j + 2 * f.tig);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          o[4 * j + 2 * h] += __bfloat162float(b.x);
          o[4 * j + 2 * h + 1] += __bfloat162float(b.y);
        }
      }
    }
    if constexpr (FWD) {
      forward_out(o, a, row0, nr, a.out8 + row0 * IO_FLOATS, f);
      continue;
    }
    const float* d8rows = RENDER ? io + 16 * (warp & 3) * IO_FLOATS
                                 : a.dout_in + row0 * IO_FLOATS;
    if constexpr (RENDER) {
      forward_out(o, a, row0, nr, io + 16 * (warp & 3) * IO_FLOATS, f);
      wg_sync();
      for (int j = warp & 3; j < n_rays; j += 4) {
        const long long ray = ray0 + j;
        composite_ray(io + j * a.s * IO_FLOATS, a.z + ray * a.s,
                      a.noise ? a.noise + ray * a.s : nullptr, a.dray + ray * 8, a.s,
                      a.white_back);
      }
      wg_sync();
    }
    // the packed output's cotangent: d head_b1, doutb, dbasis partials
    uint32_t da[8];
    out_cotangent<SHADED>(o, a, row0, nr, d8rows, da, part + depth * wd + p.head0, first, f);
    // head layer 1: d_h1 = mask(h1) * (dout_b @ hw1^T), passes of <= 256
    for (int c0 = 0; c0 < p.head0; c0 += NC_MAX) {
      const int nc = min(NC_MAX, p.head0 - c0);
      const MaskEpi2 e = {dbuf + c0 * 16, half, masks, words, depth * wd + c0,
                          ws.dh1 + row0 * p.head0 + c0, p.head0, nr, part, depth * wd + c0,
                          first};
      ++gi;
      switch (nc) {
        case 256: { float acc[128]; ring_gemm_regs<256>(da, acc, rg); e.run<256>(acc); break; }
        case 128: { float acc[64]; ring_gemm_regs<128>(da, acc, rg); e.run<128>(acc); break; }
        default: { float acc[32]; ring_gemm_regs<64>(da, acc, rg); e.run<64>(acc); break; }
      }
    }
    // head layer 0: d_a of the last trunk layer = mask(h_last) * (d_h1 @ hw0^T)
    {
      const MaskEpi2 e = {dbuf, half, masks, words, (depth - 1) * wd,
                          ws.da + ((size_t)(depth - 1) * P + row0) * wd, wd, nr, part,
                          (depth - 1) * wd, first};
      gemm_at(wd, sc.g[gi++], a_d, uhalf, rg, e);
    }
    // trunk, top down: the feature rows to dfeat, the hidden rows (masked
    // by the layer below) become that layer's d_a, in place
    bool feat_done = false;
    for (int l = depth - 1; l >= 0; --l) {
      const bool skip = l > 0 && ((p.skip_mask >> l) & 1);
      if (l == 0 || skip) {
        const FeatEpi2 e = {a.dfeat + row0 * p.enc, p.enc, nr, feat_done};
        gemm_at(sc.g[gi].nc, sc.g[gi], a_d, uhalf, rg, e);
        ++gi;
        feat_done = true;
      }
      if (l > 0) {
        const MaskEpi2 e = {dbuf, half, masks, words, (l - 1) * wd,
                            ws.da + ((size_t)(l - 1) * P + row0) * wd, wd, nr, part,
                            (l - 1) * wd, first};
        gemm_at(wd, sc.g[gi++], a_d, uhalf, rg, e);
      }
    }
  }
}

// Persistent: block b takes tiles b, b + gridDim.x, ...; warpgroups 0 and
// 1 consume (16 rows a warp), warp 8 of warpgroup 2 produces (its other
// warps idle).  Roles as in weight_grad_kernel (mlp_bwd.cuh): through a
// shuffle, so that the compiler sees them uniform over each warp, never
// reconverging, registers moved by setmaxnreg from the producer's
// warpgroup (40 a thread) to the consumers' (232): a 256-column product
// keeps 128 fp32 accumulators a thread, and short of registers ptxas
// serializes the wgmma (C7512).
template <int MODE>
__global__ void __launch_bounds__(PT_THREADS, 1)
    mlp_points_kernel(const __grid_constant__ MLPParams p, const __grid_constant__ PtArgs a,
                      const __grid_constant__ PtSchedule sc) {
  extern __shared__ __align__(128) unsigned char psmem[];
  Ring rg;
  rg.slots = psmem;
  rg.nst = a.nst;
  rg.stage = 0;
  rg.phase = 0;
  unsigned char* slabs = psmem + (size_t)a.nst * PT_STAGE;
  rg.full = reinterpret_cast<uint64_t*>(slabs + (size_t)PT_WARPS * 2 * a.half);
  rg.empty = rg.full + a.nst;
  // PT_RENDER: the composite's buffer, RAY_ROWS rows a warpgroup
  float* io = reinterpret_cast<float*>(rg.empty + a.nst) +
              (threadIdx.x >> 7) * RAY_ROWS * IO_FLOATS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.nst; ++s) {
      mbar_init(rg.full + s, 1);   // the producer's arrive, plus the bulk bytes
      mbar_init(rg.empty + s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int role = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (role == PT_THREADS / 128 - 1) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x < THREADS + 32) pt_produce(sc, a.img, a.tiles, rg);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    pt_consume<MODE>(p, a, sc, slabs + (size_t)(threadIdx.x >> 5) * 2 * a.half, io, rg);
  }
}

// ------------------------------------------------------------ host side

// Feature columns of the act buffer: the encode padded to 32, so that
// every product's K is a whole number of 32-row K tiles.
static inline int pt_ep(const MLPParams& p) { return (p.enc + 31) / 32 * 32; }

// The tile's schedule of products, in the order the consumers run them,
// with each product's image: the recompute (trunk; head layer 0 in passes
// of nch, each followed for K5 by its head-layer-1 share), then the
// backward (d_h1 in passes of 256; head layer 0; the trunk top down, a
// layer's feature rows before its hidden rows).  Offsets are bytes into
// the images; returns their total size, or -1 past PT_MAX_GEMMS.
static long long pt_schedule(const MLPParams& p, bool shaded, int nch, PtSchedule* sc,
                             PtImages* im) {
  const int ep = pt_ep(p), wd = p.width, depth = p.depth;
  long long off = 0;
  int stages = 0;
  sc->count = 0;
  auto add = [&](int K, int nc, PtImage m) {
    if (sc->count >= PT_MAX_GEMMS) return;
    PtGemm& g = sc->g[sc->count];
    g.off = off;
    g.k_tiles = (K + KT - 1) / KT;
    g.nc = nc;
    m.K = K;
    m.stage0 = stages;
    im->m[sc->count] = m;
    ++sc->count;
    stages += g.k_tiles;
    off += (long long)g.k_tiles * KT * nc * 2;
  };
  auto fwd = [&](const bf16* w, int ldw, int w_row0, int n0, int feat_rows, int gap_end) {
    PtImage m = {w, 0, ldw, w_row0, n0, 0, feat_rows, gap_end, 0, 0};
    return m;
  };
  auto bwd = [&](const bf16* w, int ldw, int n0, int n_lim) {
    PtImage m = {w, 1, ldw, 0, n0, 0, 0, 0, n_lim, 0};
    return m;
  };
  for (int l = 0; l < depth; ++l) {
    const bool tf = l == 0 || ((p.skip_mask >> l) & 1);
    add(l == 0 ? ep : (tf ? ep + wd : wd), wd, fwd(p.w[l], wd, 0, 0, tf ? p.enc : 0, tf ? ep : 0));
  }
  for (int c0 = 0; c0 < p.head0; c0 += nch) {
    const int nc = nch < p.head0 - c0 ? nch : p.head0 - c0;
    add(wd, nc, fwd(p.w[depth], p.head0, 0, c0, 0, 0));
    if (shaded) add(nc, OUT_COLS, fwd(p.w[depth + 1], OUT_COLS, c0, 0, 0, 0));
  }
  for (int c0 = 0; c0 < p.head0; c0 += NC_MAX) {
    const int nc = NC_MAX < p.head0 - c0 ? NC_MAX : p.head0 - c0;
    add(OUT_COLS, nc, bwd(p.w[depth + 1], OUT_COLS, c0, nc));
  }
  add(p.head0, wd, bwd(p.w[depth], p.head0, 0, wd));
  const int enc_nc = p.enc <= 32 ? 32 : (p.enc <= 64 ? 64 : (p.enc <= 128 ? 128 : 256));
  for (int l = depth - 1; l >= 0; --l) {
    const bool skip = l > 0 && ((p.skip_mask >> l) & 1);
    if (l == 0 || skip) add(wd, enc_nc, bwd(p.w[l], wd, 0, p.enc));
    if (l > 0) add(wd, wd, bwd(p.w[l], wd, skip ? p.enc : 0, wd));
  }
  sc->stages = stages;
  im->count = sc->count;
  return sc->count >= PT_MAX_GEMMS ? -1 : off;
}

// Width of the recompute's head-0 passes: head0, or 128 where it is wider
// (the fine pack's slab then leaves room for a third ring slot; at the
// coarse pack 128 ran 7-9% faster than 256 on an H100, PERF.md).
static inline int pt_nch(int head0) { return head0 > NC_MAX / 2 ? NC_MAX / 2 : head0; }

// Bytes of one half-slab (8 rows; see the header comment) and its offsets:
// act (and, over it, dbuf) at 0, h1 after act, the masks after the larger.
static inline int pt_half_bytes(const MLPParams& p, int nch, int* h1_off, int* mask_off) {
  const int ep = pt_ep(p);
  *h1_off = (ep + p.width) * 16;
  const int fwd = *h1_off + nch * 16, bwd = p.head0 * 16;
  *mask_off = fwd > bwd ? fwd : bwd;
  return *mask_off + 8 * ((p.depth * p.width + p.head0) / 32) * 4;
}

// Tiles of a pass over `points` points in rows of TILE_M.
static inline long long pt_tiles(long long points) { return (points + TILE_M - 1) / TILE_M; }

// Bias-partial groups of a pass over `tiles` tiles: one per tile up to
// WG_WAVE, the block count of the persistent grid (shapes only).
static inline int pt_groups(long long tiles) {
  return (int)(tiles < WG_WAVE ? (tiles < 1 ? 1 : tiles) : WG_WAVE);
}

// The recompute's products at the head of pt_schedule's list: the trunk,
// then each head-0 pass (with, shaded, its head-1 share).
static inline int pt_recompute_products(const MLPParams& p, int nch, bool shaded) {
  return p.depth + (p.head0 + nch - 1) / nch * (shaded ? 2 : 1);
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

// The workspace of a points stage over `points` points: make_layout's
// regions (one bias-partial row per consumer warp of each group) and, after
// them, the weight images.
struct FlatPlan {
  Layout L;
  size_t img_at, bytes;
  long long tiles;
  int groups, nch;
};

static FlatPlan flat_plan(const MLPParams& p, long long points, long long tiles, bool shaded,
                          PtSchedule* sc, PtImages* im) {
  FlatPlan f;
  f.tiles = tiles;
  f.groups = pt_groups(tiles);
  f.nch = pt_nch(p.head0);
  f.L = make_layout(points, f.groups * GROUP_ROWS, p.enc, p.depth, p.skip_mask, p.width, p.head0,
                    shaded);
  const long long img = pt_schedule(p, shaded, f.nch, sc, im);
  f.img_at = align256(f.L.bytes);
  f.bytes = img < 0 ? 0 : f.img_at + align256((size_t)img);
  return f;
}

// The arguments of a points stage over `tiles` tiles; returns 0 or an
// error for shapes the kernels do not take.
static int points_args(bool shaded, MLPParams* p, FlatPlan* f, PtSchedule* sc, PtImages* im,
                       PtArgs* a, const void* feat, const void* basis16, const void* dout_in,
                       void* dfeat, void* workspace, long long points, long long tiles, int s,
                       int nb, int enc, int depth, int skip_mask, int width, int head0,
                       const void* const* w, const void* const* b) {
  int err = make_params(p, feat, depth, skip_mask, enc, width, head0, w, b);
  if (err) return err;
  if (shaded && (s < 1 || nb < 1 || nb > 9 || points % s)) return cudaErrorInvalidValue;
  *f = flat_plan(*p, points, tiles, shaded, sc, im);
  if (!f->bytes) return cudaErrorInvalidValue;
  a->feat = static_cast<const bf16*>(feat);
  a->basis16 = static_cast<const float*>(basis16);
  a->dout_in = static_cast<const float*>(dout_in);
  a->out8 = nullptr;
  a->z = a->noise = a->dray = nullptr;
  a->rays = 0;
  a->ray_k = a->white_back = 0;
  a->dfeat = static_cast<float*>(dfeat);
  a->ws = carve(f->L, workspace);
  a->img = static_cast<const unsigned char*>(workspace) + f->img_at;
  a->points = points;
  a->s = s;
  a->nb = nb;
  return 0;
}

// The shared-memory layout of mlp_points_kernel at this pack (the slabs'
// offsets and the ring's depth into `a`; `render`: with PT_RENDER's
// composite buffer) and its bytes into *smem; then the weight images,
// written once per call for every product of the schedule.
static int points_setup(const MLPParams& p, const FlatPlan& f, const PtSchedule& sc,
                        const PtImages& im, bool render, PtArgs* a, size_t* smem,
                        cudaStream_t st) {
  int dev = 0, limit = 0;
  int err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  a->half = pt_half_bytes(p, f.nch, &a->h1_off, &a->mask_off);
  a->ep = pt_ep(p);
  const long long slabs = (long long)PT_WARPS * 2 * a->half;
  const long long io = render ? (long long)sizeof(float) * 2 * RAY_ROWS * IO_FLOATS : 0;
  const long long room = (long long)limit - slabs - io - 16 * PT_MAX_STAGES;
  a->nst = (int)(room / PT_STAGE < PT_MAX_STAGES ? room / PT_STAGE : PT_MAX_STAGES);
  if (a->nst < 2) return cudaErrorInvalidValue;
  *smem = (size_t)a->nst * PT_STAGE + (size_t)slabs + 16 * a->nst + (size_t)io;
  a->tiles = f.tiles;
  a->nch = f.nch;
  a->mask_words = (p.depth * p.width + p.head0) / 32;
  a->nbias = f.L.nbias;
  weight_images_kernel<<<sc.stages, THREADS, 0, st>>>(im, sc, const_cast<unsigned char*>(a->img));
  return cudaGetLastError();
}

// One launch of mlp_points_kernel<MODE> over the persistent grid.
template <int MODE>
static int launch_points(const MLPParams& p, const PtArgs& a, const PtSchedule& sc, int groups,
                         size_t smem, cudaStream_t st) {
  int err = cudaFuncSetAttribute(mlp_points_kernel<MODE>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  mlp_points_kernel<MODE><<<groups, PT_THREADS, smem, st>>>(p, a, sc);
  return cudaGetLastError();
}

// K5's per-ray dbasis: the sums of the per-point partials in sample order.
static int launch_ray_sums(const PtArgs& a, void* dbasis, cudaStream_t st) {
  const long long n = a.points / a.s * BASIS_LANES;
  ray_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.ws.dbp, (int)(a.points / a.s), a.s, static_cast<float*>(dbasis));
  return cudaGetLastError();
}

}  // namespace mcn
