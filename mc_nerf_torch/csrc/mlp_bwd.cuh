// The MLP backward shared by fused_render_bwd.cu (fused_render's backward)
// and fused_mlp_bwd.cu (fused_shaded_mlp's and fused_mlp's): the device
// workspace, the per-tile heads-and-trunk backward with wgmma on K-major
// W^T, and the weight gradients summed over all points.
//
// Per tile (mlp_bwd_tile), from the packed output's cotangent dout32 (fp32,
// in the workspace) and the recompute's saved bf16 activations: dout32
// rounds to bf16; d_h1 = mask(h1) * (dout_b @ hw1^T), d_a of each trunk
// layer = mask(h_out) * (d_x @ W^T), each rounded to bf16 and stored to the
// workspace; dfeat (fp32) sums the skip layers' first enc columns and layer
// 0's.  The products are wgmma with A (the bf16 cotangent) from registers
// and B = W^T staged K-major from the weights in global memory.  Bias
// gradients: each block sums its points' bf16 d_a (and fp32 dout32 for the
// last bias) per column into its own row of a partial buffer.
//
// Weight gradients (launch_weight_grads): dW = sum over points of
// xin^T @ d_a for every layer (xin = feat, the saved layer outputs, h1),
// split over chunks of 4096 points; each block writes a 128 x N fp32
// partial of its chunk, its X and D tiles of 64 points double-buffered with
// cp.async.  reduce_rows_kernel then sums the partials (and the bias
// partials) in a fixed order, so the result is the same run to run.
//
// Rounding points follow the Pallas backward bodies (fused_render.py:
// 401-436, fused_mlp.py:495-535 and :783-824): bf16 operands, fp32
// accumulation, ReLU masks from the bf16 activations, d_h1 and every d_a
// rounded to bf16; d_hb1 sums dout32 as the workspace holds it (the caller
// stores it fp32, or already rounded where the Pallas body sums bf16).
//
// Why a workspace: per 128-point tile the saved activations of the fine
// 8x256 pack take ~688 KB in bf16, above the 227 KB of shared memory a
// block may use.  The workspace holds ~10.4 KB per point at the fine pack
// and ~3.3 KB at the coarse 4x128 full pack.
#pragma once

#include "mlp_tile.cuh"

namespace mcn {

constexpr int DOUT_PITCH = OUT_COLS + 8;  // bf16 dout tile, the A operand of head layer 1
constexpr int WG_CHUNK = 4096;            // points per split of the weight-gradient products
constexpr int WKT = 64;                   // points per K step of the weight-gradient products
constexpr int XS_PITCH = TILE_M + 8;      // bf16 X tile [WKT points][128 columns]
constexpr int MAX_JOBS = 32;
constexpr int DBP_LANES = 16;             // per-point dbasis partials (fused_mlp_bwd.cu)

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// ---------------------------------------------------------------- workspace

struct Layout {
  long long points, nweights;
  int blocks, splits, nbias;
  size_t h, h1, out32, dout, doutb, da, dh1, dbp, bias_part, w_part, bytes;
  long long w_off[MAX_LAYERS];  // offset of each layer's [K, N] block in the flat dW
};

static inline size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// The workspace of a backward over `points` points run by `blocks` blocks
// (one bias-partial row each); out32 and the per-point dbasis partials only
// where the caller asks for them.
static Layout make_layout(long long points, int blocks, int enc, int depth, int skip_mask,
                          int width, int head0, bool with_out32, bool with_dbp) {
  Layout L;
  L.points = points;
  L.blocks = blocks;
  L.splits = (int)((points + WG_CHUNK - 1) / WG_CHUNK);
  L.nbias = depth * width + head0 + OUT_COLS;
  long long off = 0;
  for (int l = 0; l < depth; ++l) {
    const int k = l == 0 ? enc : (((skip_mask >> l) & 1) ? enc + width : width);
    L.w_off[l] = off;
    off += (long long)k * width;
  }
  L.w_off[depth] = off;
  off += (long long)width * head0;
  L.w_off[depth + 1] = off;
  off += (long long)head0 * OUT_COLS;
  L.nweights = off;
  const size_t P = (size_t)points;
  size_t at = 0;
  auto take = [&](size_t bytes) { const size_t o = at; at = align256(at + bytes); return o; };
  L.h = take(2 * P * depth * width);
  L.h1 = take(2 * P * head0);
  L.out32 = with_out32 ? take(4 * P * OUT_COLS) : 0;
  L.dout = take(4 * P * OUT_COLS);
  L.doutb = take(2 * P * OUT_COLS);
  L.da = take(2 * P * depth * width);
  L.dh1 = take(2 * P * head0);
  L.dbp = with_dbp ? take(4 * P * DBP_LANES) : 0;
  L.bias_part = take(4 * (size_t)blocks * L.nbias);
  L.w_part = take(4 * (size_t)L.splits * L.nweights);
  L.bytes = at;
  return L;
}

struct Workspace {
  bf16* h;           // [depth][P][width]   trunk layer outputs
  bf16* h1;          // [P][head0]          head layer 0 output
  float* out32;      // [P][32]             packed output (or null)
  float* dout;       // [P][32]             d(out32), fp32
  bf16* doutb;       // [P][32]             d(out32), bf16
  bf16* da;          // [depth][P][width]   d of each trunk layer's pre-activation
  bf16* dh1;         // [P][head0]          d of head layer 0's pre-activation
  float* dbp;        // [P][16]             per-point dbasis partials (or null)
  float* bias_part;  // [blocks][nbias]
  float* w_part;     // [splits][nweights]
};

static Workspace carve(const Layout& L, void* base) {
  char* b = static_cast<char*>(base);
  Workspace w;
  w.h = reinterpret_cast<bf16*>(b + L.h);
  w.h1 = reinterpret_cast<bf16*>(b + L.h1);
  w.out32 = L.out32 ? reinterpret_cast<float*>(b + L.out32) : nullptr;
  w.dout = reinterpret_cast<float*>(b + L.dout);
  w.doutb = reinterpret_cast<bf16*>(b + L.doutb);
  w.da = reinterpret_cast<bf16*>(b + L.da);
  w.dh1 = reinterpret_cast<bf16*>(b + L.dh1);
  w.dbp = L.dbp ? reinterpret_cast<float*>(b + L.dbp) : nullptr;
  w.bias_part = reinterpret_cast<float*>(b + L.bias_part);
  w.w_part = reinterpret_cast<float*>(b + L.w_part);
  return w;
}

// ------------------------------------------------- transposed-weight GEMMs

// Stage K tile kt of B[k][n] = w[(n_row0 + n) * ldw + k] (zero where
// n >= n_limit or k >= K) into buf, K-major for wgmma: the 16-byte chunk
// of row n, k = 8c..8c+7, lands at byte c * (nc * 16) + (n / 8) * 128 +
// (n % 8) * 16, so LBO (K direction) is nc * 16 and SBO (N direction) 128.
__device__ __forceinline__ void stage_bt(const bf16* w, int ldw, int n_row0, int n_limit, int K,
                                         int nc, int kt, bf16* buf) {
  char* base = reinterpret_cast<char*>(buf);
  for (int idx = threadIdx.x; idx < nc * (KT / 8); idx += THREADS) {
    const int c = idx & 3, n = idx >> 2;
    const int k = kt * KT + c * 8;
    const bool ok = n < n_limit && k < K;
    const bf16* src = ok ? w + size_t(n_row0 + n) * ldw + k : w;
    cp_async16(base + c * (nc * 16) + (n >> 3) * 128 + (n & 7) * 16, src, ok ? 16 : 0);
  }
  cp_async_commit();
}

// acc[m, n] = sum_k A[m, k] * w[n_row0 + n, k] over the tile's 128 rows,
// k in [0, K) (a multiple of 32), n in [0, NC); then, for each pair of
// columns (col even), aux = epi.load(row, col) and epi(row, col, v0, v1,
// aux).  The epilogue loads a group of pairs before storing any: a load
// after a store through a pointer that may alias it waits for the store,
// and one by one they would serialize.  Same warp layout and double-
// buffered cp.async stage as mlp_tile.cuh's gemm_pass.
template <int NC, class Epi>
__device__ void gemm_bt(const bf16* A, int a_pitch, int K, const bf16* w, int ldw, int n_row0,
                        int n_limit, bf16* wst, const Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row_w = warp * 16;
  const int n_kt = K / KT;
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_col = (lane >> 4) * 8;
  const bf16* a_base = A + (row_w + lm_row) * a_pitch + lm_col;

  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;

  stage_bt(w, ldw, n_row0, n_limit, K, NC, 0, wst);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      stage_bt(w, ldw, n_row0, n_limit, K, NC, kt + 1, wst + ((kt + 1) & 1) * STAGE_ELEMS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t stage = smem_u32(wst + (kt & 1) * STAGE_ELEMS);
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, a_base + kt * KT);
    ldsm_x4(a1, a_base + kt * KT + 16);
    wgmma_fence();
    wgmma_rs<NC, 0>(acc, a0, make_desc(stage, NC * 16, 128));
    wgmma_rs<NC, 0>(acc, a1, make_desc(stage + 2 * NC * 16, NC * 16, 128));
    wgmma_commit_and_wait();
    __syncthreads();
  }
  constexpr int GROUP = NC / 8 < 8 ? NC / 8 : 8;
#pragma unroll
  for (int j0 = 0; j0 < NC / 8; j0 += GROUP) {
    uint2 aux[GROUP][2];
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) aux[j][h] = epi.load(row_w + g + 8 * h, (j0 + j) * 8 + tig * 2);
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(row_w + g + 8 * h, (j0 + j) * 8 + tig * 2, acc[4 * (j0 + j) + 2 * h],
            acc[4 * (j0 + j) + 2 * h + 1], aux[j][h]);
  }
}

template <class Epi>
__device__ __forceinline__ void bt_pass(int nc, const bf16* A, int a_pitch, int K, const bf16* w,
                                        int ldw, int n_row0, int n_limit, bf16* wst,
                                        const Epi& epi) {
  if (nc > 128) gemm_bt<256>(A, a_pitch, K, w, ldw, n_row0, n_limit, wst, epi);
  else if (nc > 64) gemm_bt<128>(A, a_pitch, K, w, ldw, n_row0, n_limit, wst, epi);
  else if (nc > 32) gemm_bt<64>(A, a_pitch, K, w, ldw, n_row0, n_limit, wst, epi);
  else gemm_bt<32>(A, a_pitch, K, w, ldw, n_row0, n_limit, wst, epi);
}

// d = bf16(h > 0 ? v : 0): into the shared A buffer of the next product
// and, for rows holding points, into the workspace.
struct MaskEpi {
  bf16* sm;
  int sm_pitch;
  const bf16* h;  // the layer's bf16 output, rows of `ld`
  bf16* g;        // the workspace copy of d, rows of `ld`
  int ld, n_rows;
  // the pair of activations h[r, col..col+1] (0 past the points)
  __device__ __forceinline__ uint2 load(int r, int col) const {
    return make_uint2(r < n_rows ? *reinterpret_cast<const uint32_t*>(h + size_t(r) * ld + col)
                                 : 0u, 0u);
  }
  __device__ __forceinline__ void operator()(int r, int col, float v0, float v1,
                                             uint2 aux) const {
    __nv_bfloat162 pr;
    pr.x = pr.y = __float2bfloat16_rn(0.f);
    if (r < n_rows) {
      const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&aux.x);
      pr.x = __float2bfloat16_rn(__bfloat162float(hv.x) > 0.f ? v0 : 0.f);
      pr.y = __float2bfloat16_rn(__bfloat162float(hv.y) > 0.f ? v1 : 0.f);
      *reinterpret_cast<__nv_bfloat162*>(g + size_t(r) * ld + col) = pr;
    }
    *reinterpret_cast<__nv_bfloat162*>(sm + r * sm_pitch + col) = pr;
  }
};

// dfeat[row, col] (+)= v for col < enc: a skip layer's share or layer 0's.
struct FeatEpi {
  float* g;
  int enc, n_rows;
  bool add;
  // the pair dfeat[r, col..col+1] to add to (0 where nothing is)
  __device__ __forceinline__ uint2 load(int r, int col) const {
    uint2 v = make_uint2(0u, 0u);
    if (add && r < n_rows) {
      const float* row = g + size_t(r) * enc;
      if (col < enc) v.x = __float_as_uint(row[col]);
      if (col + 1 < enc) v.y = __float_as_uint(row[col + 1]);
    }
    return v;
  }
  __device__ __forceinline__ void operator()(int r, int col, float v0, float v1,
                                             uint2 aux) const {
    if (r >= n_rows) return;
    float* row = g + size_t(r) * enc;
    if (col < enc) row[col] = __uint_as_float(aux.x) + v0;
    if (col + 1 < enc) row[col + 1] = __uint_as_float(aux.y) + v1;
  }
};

// The block's per-column sums of a bf16 tile (rows [0, n_rows)), into its
// own row of the bias partials: stored at the block's first tile, added
// after.
__device__ __forceinline__ void column_sums(const bf16* t, int pitch, int ncols, int n_rows,
                                            float* part, bool first) {
  for (int c = threadIdx.x; c < ncols; c += THREADS) {
    float acc = 0.f;
    for (int r = 0; r < n_rows; ++r) acc += __bfloat162float(t[r * pitch + c]);
    part[c] = first ? acc : part[c] + acc;
  }
}

// Shared memory of a backward points kernel besides what it stages of its
// own: the recompute's MLP tile, or mlp_bwd_tile's d buffer
// [128, head0 + 8], dout tile and weight stage, whichever is larger (they
// overlap).
__host__ __device__ inline size_t bwd_region_bytes(const MLPParams& p) {
  const size_t fwd = mlp_smem_bytes(p);
  const size_t bwd = sizeof(bf16) * (size_t(TILE_M) * (p.head0 + 8) + size_t(TILE_M) * DOUT_PITCH +
                                     2 * size_t(STAGE_ELEMS));
  return fwd > bwd ? fwd : bwd;
}

// The heads and trunk backward of one tile: points [row0, row0 + n_rows)
// of `points`, whose dout32 is in ws.dout and whose activations the
// recompute stored to the workspace.  Writes ws.doutb, every layer's d_a
// (ws.da, ws.dh1), dfeat rows [row0, row0 + n_rows) and the block's bias
// partials `part` (stored when `first`, added after).  Uses `smem` from
// byte 0 (bwd_region_bytes); starts with a block barrier, so the caller's
// writes to ws.dout and its reads of the shared recompute buffers are done.
__device__ void mlp_bwd_tile(const MLPParams& p, const Workspace& ws, long long points,
                             long long row0, int n_rows, bool first, float* part, float* dfeat,
                             unsigned char* smem) {
  const int dpitch = p.head0 + 8;
  bf16* dbuf = reinterpret_cast<bf16*>(smem);
  bf16* dout = dbuf + TILE_M * dpitch;
  bf16* wst_b = dout + TILE_M * DOUT_PITCH;
  const int wd = p.width, depth = p.depth;
  __syncthreads();  // the previous tile's buffers are consumed
  for (int idx = threadIdx.x; idx < TILE_M * OUT_COLS; idx += THREADS) {
    const int r = idx / OUT_COLS, c = idx - r * OUT_COLS;
    const float v = r < n_rows ? ws.dout[(row0 + r) * OUT_COLS + c] : 0.f;
    const bf16 bv = __float2bfloat16_rn(v);
    dout[r * DOUT_PITCH + c] = bv;
    if (r < n_rows) ws.doutb[(row0 + r) * OUT_COLS + c] = bv;
  }
  if (threadIdx.x < OUT_COLS) {  // d head_b1 sums dout32 as stored
    float acc = 0.f;
    for (int r = 0; r < n_rows; ++r) acc += ws.dout[(row0 + r) * OUT_COLS + threadIdx.x];
    float* dst = part + depth * wd + p.head0 + threadIdx.x;
    *dst = first ? acc : *dst + acc;
  }
  // head layer 1: d_h1 = mask(h1) * (dout_b @ hw1^T), in passes of <= 256 columns
  for (int c0 = 0; c0 < p.head0; c0 += NC_MAX) {
    const int nc = min(NC_MAX, p.head0 - c0);
    const MaskEpi e = {dbuf + c0, dpitch, ws.h1 + row0 * p.head0 + c0,
                       ws.dh1 + row0 * p.head0 + c0, p.head0, n_rows};
    bt_pass(nc, dout, DOUT_PITCH, OUT_COLS, p.w[depth + 1], OUT_COLS, c0, nc, wst_b, e);
  }
  __syncthreads();
  column_sums(dbuf, dpitch, p.head0, n_rows, part + depth * wd, first);
  // head layer 0: d_a of the last trunk layer = mask(h_last) * (d_h1 @ hw0^T)
  {
    const size_t lo = (size_t)(depth - 1) * points * wd + row0 * wd;
    const MaskEpi e = {dbuf, dpitch, ws.h + lo, ws.da + lo, wd, n_rows};
    bt_pass(wd, dbuf, dpitch, p.head0, p.w[depth], p.head0, 0, wd, wst_b, e);
  }
  __syncthreads();
  column_sums(dbuf, dpitch, wd, n_rows, part + (depth - 1) * wd, first);
  // trunk, top down: d_x = d_a @ W^T; the feature rows go to dfeat, the
  // hidden rows (masked by the layer below) become that layer's d_a
  bool feat_done = false;
  for (int l = depth - 1; l >= 0; --l) {
    const bool skip = l > 0 && ((p.skip_mask >> l) & 1);
    if (l == 0 || skip) {
      const FeatEpi fe = {dfeat + row0 * p.enc, p.enc, n_rows, feat_done};
      bt_pass(p.enc, dbuf, dpitch, wd, p.w[l], wd, 0, p.enc, wst_b, fe);
      feat_done = true;
    }
    if (l > 0) {
      const size_t lo = (size_t)(l - 1) * points * wd + row0 * wd;
      const MaskEpi e = {dbuf, dpitch, ws.h + lo, ws.da + lo, wd, n_rows};
      bt_pass(wd, dbuf, dpitch, wd, p.w[l], wd, skip ? p.enc : 0, wd, wst_b, e);
      __syncthreads();
      column_sums(dbuf, dpitch, wd, n_rows, part + (l - 1) * wd, first);
    }
  }
}

// ----------------------------------------------------- weight gradients

// One weight-gradient product: dW[r, n] (+ out, rows of ldo) = sum over
// points p of x[p, r] * d[p, n], r < m, n < n_cols.
struct WJob {
  const bf16* x;
  long long ldx;
  const bf16* d;
  long long out;
  int m, n, ldo, nc, m_tiles, n_tiles, block0;
};

struct WJobs {
  WJob j[MAX_JOBS];
  long long points, nweights;
  int count, splits;
};

// Stage points [p0, p0 + WKT) of a job into one buffer pair: the X tile
// (WKT points x 128 columns from m0, row-major, pitch XS_PITCH) and the D
// tile (WKT points x NC columns from n0) in wgmma's MN-major layout (as
// stage_tile), with 16-byte cp.async copies that zero-fill past the data.
// X rows that are not 16-byte aligned (an encode width that is not a
// multiple of 8) take element loads instead.
template <int NC>
__device__ __forceinline__ void stage_weight_tiles(const WJob& J, long long p0, long long p_end,
                                                   int m0, int n0, bool x_vec, bf16* xs,
                                                   bf16* ds) {
  for (int idx = threadIdx.x; idx < WKT * (TILE_M / 8); idx += THREADS) {
    const int kr = idx >> 4, c = idx & 15;
    const long long pt = p0 + kr;
    const int col = m0 + c * 8;
    bf16* dst = xs + kr * XS_PITCH + c * 8;
    const bf16* src = J.x + pt * J.ldx + col;
    if (x_vec || pt >= p_end) {
      const bool ok = pt < p_end && col + 8 <= J.m;
      cp_async16(dst, ok ? src : J.x, ok ? 16 : 0);
    } else {
      for (int q = 0; q < 8; ++q) dst[q] = col + q < J.m ? src[q] : __float2bfloat16_rn(0.f);
    }
  }
  for (int idx = threadIdx.x; idx < WKT * (NC / 8); idx += THREADS) {
    const int r8 = idx & 7, rest = idx >> 3;
    const int c = rest % (NC / 8), kg = rest / (NC / 8);
    const long long pt = p0 + kg * 8 + r8;
    const int col = n0 + c * 8;
    const bool ok = pt < p_end && col < J.n;
    cp_async16(reinterpret_cast<char*>(ds) + kg * (NC * 16) + c * 128 + r8 * 16,
               ok ? J.d + pt * J.n + col : J.d, ok ? 16 : 0);
  }
  cp_async_commit();
}

// One 128 x NC tile of a job's dW over one split's points, written to that
// split's row of the partials (`part`).  The tiles of the next WKT points
// load (cp.async, double-buffered) while the current ones multiply.
template <int NC>
__device__ void weight_tile(const WJob& J, long long points, int mt, int nt, int split,
                            float* part, bf16* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3, row_w = warp * 16;
  const long long p_begin = (long long)split * WG_CHUNK;
  const long long p_end = min(points, p_begin + WG_CHUNK);
  const int m0 = mt * TILE_M, n0 = nt * NC;
  // a vector copy needs 16-byte aligned rows and every 8-column group
  // whole or past the end (m a multiple of 8)
  const bool x_vec = (J.ldx % 8) == 0 && (J.m % 8) == 0 &&
                     (reinterpret_cast<uintptr_t>(J.x) % 16) == 0;
  // ldmatrix.trans addressing: matrix i = lane / 8 holds points
  // 8 * (i / 2) + lane % 8 and columns row_w + 8 * (i % 2) .. + 7
  const int lt_k = (lane & 7) + ((lane >> 4) << 3);
  const int lt_m = row_w + ((lane >> 3) & 1) * 8;
  bf16* xs[2] = {smem, smem + WKT * XS_PITCH};
  bf16* ds[2] = {smem + 2 * WKT * XS_PITCH, smem + 2 * WKT * XS_PITCH + WKT * NC_MAX};

  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;

  stage_weight_tiles<NC>(J, p_begin, p_end, m0, n0, x_vec, xs[0], ds[0]);
  int buf = 0;
  for (long long p0 = p_begin; p0 < p_end; p0 += WKT, buf ^= 1) {
    if (p0 + WKT < p_end) {
      stage_weight_tiles<NC>(J, p0 + WKT, p_end, m0, n0, x_vec, xs[buf ^ 1], ds[buf ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t stage = smem_u32(ds[buf]);
    uint32_t a[WKT / 16][4];
#pragma unroll
    for (int k = 0; k < WKT / 16; ++k) ldsm_x4_trans(a[k], xs[buf] + (lt_k + 16 * k) * XS_PITCH + lt_m);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < WKT / 16; ++k)
      wgmma_rs<NC, 1>(acc, a[k], make_desc(stage + k * 2 * NC * 16, NC * 16, 128));
    wgmma_commit_and_wait();
    __syncthreads();
  }
  float* out = part + J.out;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + row_w + g + 8 * h;
      const int col = n0 + j * 8 + tig * 2;
      if (r < J.m) {
        if (col < J.n) out[(size_t)r * J.ldo + col] = acc[4 * j + 2 * h];
        if (col + 1 < J.n) out[(size_t)r * J.ldo + col + 1] = acc[4 * j + 2 * h + 1];
      }
    }
  }
}

// Dynamic shared memory of weight_grad_kernel: two X and two D buffers.
constexpr size_t WEIGHT_SMEM = sizeof(bf16) * 2 * (size_t(WKT) * XS_PITCH + size_t(WKT) * NC_MAX);

__global__ void __launch_bounds__(THREADS) weight_grad_kernel(WJobs js, float* w_part) {
  extern __shared__ __align__(128) unsigned char wsmem[];
  int jb = 0;
  while (jb + 1 < js.count && (int)blockIdx.x >= js.j[jb + 1].block0) ++jb;
  const WJob& J = js.j[jb];
  int t = blockIdx.x - J.block0;
  const int split = t % js.splits;
  t /= js.splits;
  const int nt = t % J.n_tiles, mt = t / J.n_tiles;
  float* part = w_part + (size_t)split * js.nweights;
  bf16* sm = reinterpret_cast<bf16*>(wsmem);
  switch (J.nc) {
    case 256: weight_tile<256>(J, js.points, mt, nt, split, part, sm); break;
    case 128: weight_tile<128>(J, js.points, mt, nt, split, part, sm); break;
    case 64: weight_tile<64>(J, js.points, mt, nt, split, part, sm); break;
    default: weight_tile<32>(J, js.points, mt, nt, split, part, sm); break;
  }
}

// out[c] = sum over r of in[r, c], r in order: the fixed-order reduction of
// the per-split and per-block partials.
__global__ void reduce_rows_kernel(const float* __restrict__ in, int rows, long long cols,
                                   float* __restrict__ out) {
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < cols;
       c += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) acc += in[(size_t)r * cols + c];
    out[c] = acc;
  }
}

static int round_nc(int n) { return n > 128 ? 256 : n > 64 ? 128 : n > 32 ? 64 : 32; }

// Host side: launch the weight gradients from the workspace the points
// kernel filled: dW of every layer (flat, layer order, each [K, N]
// row-major) into dw and the biases (flat, layer order) into db.  Returns
// cudaGetLastError() after the launches (0 on success).
static int launch_weight_grads(const Layout& L, const Workspace& ws, const bf16* feat, int enc,
                               int depth, int skip_mask, int width, int head0, float* dw,
                               float* db, cudaStream_t st) {
  if (depth < 1 || depth + 2 > MAX_LAYERS || depth + 2 + depth > MAX_JOBS)
    return cudaErrorInvalidValue;
  WJobs js;
  js.points = L.points;
  js.nweights = L.nweights;
  js.splits = L.splits;
  js.count = 0;
  auto add = [&](const bf16* x, long long ldx, int m, const bf16* d, int n, long long out,
                 int ldo) {
    WJob& J = js.j[js.count++];
    J.x = x;
    J.ldx = ldx;
    J.m = m;
    J.d = d;
    J.n = n;
    J.out = out;
    J.ldo = ldo;
    J.nc = round_nc(n < NC_MAX ? n : NC_MAX);
    J.m_tiles = (m + TILE_M - 1) / TILE_M;
    J.n_tiles = (n + J.nc - 1) / J.nc;
  };
  const size_t lw = (size_t)L.points * width;
  for (int l = 0; l < depth; ++l) {
    const bf16* dl = ws.da + l * lw;
    if (l == 0) {
      add(feat, enc, enc, dl, width, L.w_off[0], width);
    } else if ((skip_mask >> l) & 1) {
      add(feat, enc, enc, dl, width, L.w_off[l], width);
      add(ws.h + (l - 1) * lw, width, width, dl, width, L.w_off[l] + (long long)enc * width,
          width);
    } else {
      add(ws.h + (l - 1) * lw, width, width, dl, width, L.w_off[l], width);
    }
  }
  add(ws.h + (depth - 1) * lw, width, width, ws.dh1, head0, L.w_off[depth], head0);
  add(ws.h1, head0, head0, ws.doutb, OUT_COLS, L.w_off[depth + 1], OUT_COLS);
  int blocks = 0;
  for (int i = 0; i < js.count; ++i) {
    js.j[i].block0 = blocks;
    blocks += js.j[i].m_tiles * js.j[i].n_tiles * L.splits;
  }
  int err = cudaFuncSetAttribute(weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)WEIGHT_SMEM);
  if (err) return err;
  weight_grad_kernel<<<blocks, THREADS, WEIGHT_SMEM, st>>>(js, ws.w_part);
  err = cudaGetLastError();
  if (err) return err;
  reduce_rows_kernel<<<(int)((L.nweights + 255) / 256), 256, 0, st>>>(ws.w_part, L.splits,
                                                                      L.nweights, dw);
  err = cudaGetLastError();
  if (err) return err;
  reduce_rows_kernel<<<(L.nbias + 255) / 256, 256, 0, st>>>(ws.bias_part, L.blocks, L.nbias, db);
  return cudaGetLastError();
}

}  // namespace mcn
