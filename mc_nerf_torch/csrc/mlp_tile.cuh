// The NeRF MLP (trunk with skip concat, then the packed heads) over one
// tile of 128 points, shared by fused_mlp.cu and fused_render.cu.
//
// Replaces the MLP half of the Pallas bodies
// mc_nerf_tpu/ops/pallas/fused_mlp.py::_kernel (fused_mlp.py:241-269) and
// fused_render.py::_mlp_shade_fwd (fused_render.py:179-208).
//
// Rounding points follow the Pallas kernel exactly: bf16 operands, fp32
// accumulation, the bf16-stored bias added in fp32, ReLU, then a cast back
// to bf16 after every trunk layer and after head layer 0; the last head
// adds its bias in fp32 with no cast.
//
// Layout.  The block keeps the tile's activations in shared memory as
// bf16 rows [feat (enc_pad lanes) | h (width lanes)], so a skip layer's
// input [feat | h] is a contiguous column range and needs no copy.  Head
// layer 0 runs in passes of at most 256 columns into a separate bf16
// buffer, and each pass is followed at once by its share of head layer 1
// (whose K rows are that pass's columns), summed into the fp32 [128, 32]
// output in shared memory.  Weights stay in global memory in the JAX
// layout [in, out] (the fine pack is ~1.3 MB and lives in L2); 32-row K
// tiles stream with cp.async into a double-buffered shared stage laid out
// as wgmma's MN-major operand (wgmma.cuh), while the previous tile is
// multiplied.  Two warpgroups each multiply 64 of the tile's rows by the
// whole pass width with one wgmma per 16 K rows, A from registers
// (ldmatrix), B from the stage.
//
// Bound (H100 SXM, dense bf16 989 TFLOP/s): compute.  The fine 8x256 pass
// needs 629,248 MAC per point, the coarse sigma-only 4x128 pass 81,792 (the
// zero pad lane and the zero blocks of the packed head are not counted).
// Each K tile ends in a block barrier and a wgmma wait, so the tensor
// cores idle between tiles; warp-specialized TMA loads are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace mcn {

typedef __nv_bfloat16 bf16;

constexpr int MAX_LAYERS = 16;          // trunk layers + 2 head layers
constexpr int TILE_M = 128;             // points per MLP tile
constexpr int THREADS = 256;            // 8 warps
constexpr int KT = 32;                  // weight rows per staged K tile
constexpr int NC_MAX = 256;             // output columns per pass
constexpr int STAGE_ELEMS = KT * NC_MAX;  // one staged K tile (bf16)
constexpr int OUT_COLS = 32;            // packed head output lanes
constexpr int OUT_PITCH = OUT_COLS + 1;

struct MLPParams {
  const bf16* w[MAX_LAYERS];  // [K_l, N_l] row-major, the JAX pack layout
  const bf16* b[MAX_LAYERS];  // [N_l]
  int depth;                  // trunk layers; w[depth], w[depth+1] are the heads
  int skip_mask;              // bit i: trunk layer i takes [feat | h]
  int enc;                    // feature lanes (4 + 6L)
  int enc_pad;                // enc rounded up to 16
  int width;                  // trunk width: 32, 64, 128 or 256
  int head0;                  // head layer 0 width: width or 2 * width
  int act_pitch;              // enc_pad + width + 8 (bf16 elements)
  int h1_pitch;               // min(head0, 256) + 8
  int feat_vec;               // feat rows load as 16-byte vectors
};

// Shared memory of one MLP tile, in bytes (the caller adds its own).
__host__ __device__ inline size_t mlp_smem_bytes(const MLPParams& p) {
  return sizeof(bf16) * (size_t(TILE_M) * p.act_pitch + size_t(TILE_M) * p.h1_pitch +
                         2 * size_t(STAGE_ELEMS)) +
         sizeof(float) * size_t(TILE_M) * OUT_PITCH;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Weight rows of one GEMM: smem column k of the A operand multiplies
// weight row w_row0 + row(k), where row(k) = k below feat_rows, no row
// (zeros) in [feat_rows, gap_end), and k - gap_end + feat_rows from
// gap_end on — the zero gap is the padding between the feature lanes and
// the hidden lanes of a skip input.
struct WeightRows {
  const bf16* w;
  int ldw;        // columns of the whole weight matrix
  int w_row0;
  int n0;         // first column of this pass
  int feat_rows;
  int gap_end;
};

// Issue the cp.async copies of K tile `kt` (KT rows x nc columns) into
// stage buffer `buf`, zero-filling gap rows and rows at or past K.  The
// 16-byte chunk of row k, columns 8c..8c+7, lands at byte
//   (k / 8) * (nc * 16) + c * 128 + (k % 8) * 16,
// wgmma's MN-major no-swizzle layout: 128-byte core matrices of 8 K rows,
// K-direction stride nc * 16 bytes (LBO), N-direction stride 128 (SBO), so
// the core matrices of one 8-row K group lie side by side.  Eight
// consecutive threads fill one core matrix from eight weight rows.
__device__ __forceinline__ void stage_tile(const WeightRows& wr, int K, int nc, int kt,
                                           bf16* buf) {
  const int per_row = nc >> 3;  // 16-byte chunks per row
  char* base = reinterpret_cast<char*>(buf);
  for (int idx = threadIdx.x; idx < KT * per_row; idx += THREADS) {
    const int r8 = idx & 7, rest = idx >> 3;
    const int c = rest % per_row, kg = rest / per_row;
    const int kk = kg * 8 + r8, k = kt * KT + kk;
    int row = -1;
    if (k < K) row = k < wr.feat_rows ? k : (k < wr.gap_end ? -1 : k - wr.gap_end + wr.feat_rows);
    const bf16* src =
        row >= 0 ? wr.w + size_t(wr.w_row0 + row) * wr.ldw + wr.n0 + c * 8 : wr.w;
    cp_async16(base + kg * (nc * 16) + c * 128 + r8 * 16, src, row >= 0 ? 16 : 0);
  }
  cp_async_commit();
}

enum Epilogue { RELU_BF16 = 0, OUT_ASSIGN = 1, OUT_ACCUMULATE = 2 };

// One GEMM pass over the tile's 128 rows and NC <= 256 output columns:
//   acc[m, n] = sum_k A[m, a_col + k] * W[w_row0 + row(k), n0 + n],  k in [0, K)
// RELU_BF16:      dst[m, dst_col + n] = bf16(relu(acc + bias[n0 + n]))
// OUT_ASSIGN:     outs[m, n] = acc + bias[n]      (fp32, no cast)
// OUT_ACCUMULATE: outs[m, n] += acc
// Warp w owns rows 16w..16w+15 (warpgroup w / 4 issues the wgmma for rows
// 64 * (w / 4) onward).  dst may alias A (a trunk layer updates h in
// place): every read of A finishes at a block barrier before the first
// write.
template <int EPI, int NC>
__device__ void gemm_pass(const bf16* A, int a_pitch, int a_col, int K,
                          const WeightRows& wr, const bf16* __restrict__ bias,
                          bf16* dst, int dst_pitch, int dst_col, float* outs, bf16* wst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int row_w = warp * 16;
  const int n_kt = (K + KT - 1) / KT;
  // ldmatrix lane addressing: matrix (lane / 8), row (lane % 8)
  const int lm_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lm_col = (lane >> 4) * 8;
  const bf16* a_base = A + (row_w + lm_row) * a_pitch + a_col + lm_col;

  float acc[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;

  stage_tile(wr, K, NC, 0, wst);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      stage_tile(wr, K, NC, kt + 1, wst + ((kt + 1) & 1) * STAGE_ELEMS);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();  // tile kt (and the previous pass's writes) are visible
    const uint32_t stage = smem_u32(wst + (kt & 1) * STAGE_ELEMS);
    const bool second = kt * KT + 16 < K;  // K is a multiple of 16
    uint32_t a0[4], a1[4];
    ldsm_x4(a0, a_base + kt * KT);
    if (second) ldsm_x4(a1, a_base + kt * KT + 16);
    wgmma_fence();
    wgmma_rs<NC>(acc, a0, make_desc(stage, NC * 16, 128));
    if (second) wgmma_rs<NC>(acc, a1, make_desc(stage + 2 * NC * 16, NC * 16, 128));
    wgmma_commit_and_wait();
    __syncthreads();  // every warp is done with this buffer (and with A)
  }

#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    const int col = j * 8 + tig * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_w + g + 8 * h;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (EPI == RELU_BF16) {
        const float b0 = __bfloat162float(bias[wr.n0 + col]);
        const float b1 = __bfloat162float(bias[wr.n0 + col + 1]);
        __nv_bfloat162 pr;
        pr.x = __float2bfloat16_rn(fmaxf(v0 + b0, 0.f));
        pr.y = __float2bfloat16_rn(fmaxf(v1 + b1, 0.f));
        *reinterpret_cast<__nv_bfloat162*>(dst + r * dst_pitch + dst_col + col) = pr;
      } else if (EPI == OUT_ASSIGN) {
        outs[r * OUT_PITCH + col] = v0 + __bfloat162float(bias[col]);
        outs[r * OUT_PITCH + col + 1] = v1 + __bfloat162float(bias[col + 1]);
      } else {
        outs[r * OUT_PITCH + col] += v0;
        outs[r * OUT_PITCH + col + 1] += v1;
      }
    }
  }
}

// gemm_pass with a RELU_BF16 epilogue at a run-time width (32, 64, 128 or
// 256: make_params admits no other).
__device__ __forceinline__ void relu_pass(int nc, const bf16* A, int a_pitch, int a_col, int K,
                                          const WeightRows& wr, const bf16* bias, bf16* dst,
                                          int dst_pitch, int dst_col, bf16* wst) {
  switch (nc) {
    case 256: gemm_pass<RELU_BF16, 256>(A, a_pitch, a_col, K, wr, bias, dst, dst_pitch, dst_col, nullptr, wst); break;
    case 128: gemm_pass<RELU_BF16, 128>(A, a_pitch, a_col, K, wr, bias, dst, dst_pitch, dst_col, nullptr, wst); break;
    case 64: gemm_pass<RELU_BF16, 64>(A, a_pitch, a_col, K, wr, bias, dst, dst_pitch, dst_col, nullptr, wst); break;
    default: gemm_pass<RELU_BF16, 32>(A, a_pitch, a_col, K, wr, bias, dst, dst_pitch, dst_col, nullptr, wst); break;
  }
}

// The whole MLP over one tile.  On entry act[:, 0:enc_pad] holds the
// tile's features (zero past enc and in rows past the data); on return
// outs[m, 0:32] holds the packed fp32 output (col 0 raw sigma, cols 1..
// SH), visible to every thread.
__device__ void mlp_tile(const MLPParams& p, bf16* act, bf16* h1, bf16* wst, float* outs) {
  const int ep = p.enc_pad, wd = p.width;
  for (int l = 0; l < p.depth; ++l) {
    const bool takes_feat = l == 0 || ((p.skip_mask >> l) & 1);
    const int K = l == 0 ? ep : (takes_feat ? ep + wd : wd);
    const WeightRows wr = {p.w[l], wd, 0, 0, takes_feat ? p.enc : 0, takes_feat ? ep : 0};
    relu_pass(wd, act, p.act_pitch, takes_feat ? 0 : ep, K, wr, p.b[l], act, p.act_pitch, ep,
              wst);
  }
  for (int c0 = 0; c0 < p.head0; c0 += NC_MAX) {
    const int nc = min(NC_MAX, p.head0 - c0);
    const WeightRows w0 = {p.w[p.depth], p.head0, 0, c0, 0, 0};
    relu_pass(nc, act, p.act_pitch, ep, wd, w0, p.b[p.depth], h1, p.h1_pitch, 0, wst);
    const WeightRows w1 = {p.w[p.depth + 1], OUT_COLS, c0, 0, 0, 0};
    if (c0 == 0) {
      gemm_pass<OUT_ASSIGN, OUT_COLS>(h1, p.h1_pitch, 0, nc, w1, p.b[p.depth + 1], nullptr, 0,
                                      0, outs, wst);
    } else {
      gemm_pass<OUT_ACCUMULATE, OUT_COLS>(h1, p.h1_pitch, 0, nc, w1, nullptr, nullptr, 0, 0,
                                          outs, wst);
    }
  }
  __syncthreads();
}

// Load rows [first, first + 128) of feat [*, enc] (bf16) into
// act[:, 0:enc_pad], zero-filling lanes past enc and rows at or past
// `limit`.
__device__ inline void load_feat_tile(const MLPParams& p, const bf16* __restrict__ feat,
                                      long long first, long long limit, bf16* act) {
  if (p.feat_vec) {  // enc == enc_pad, a multiple of 8, rows 16-byte aligned
    const int per_row = p.enc >> 3;
    for (int idx = threadIdx.x; idx < TILE_M * per_row; idx += THREADS) {
      const int r = idx / per_row, c = idx - r * per_row;
      const long long row = first + r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row < limit) v = *reinterpret_cast<const uint4*>(feat + row * p.enc + c * 8);
      *reinterpret_cast<uint4*>(act + r * p.act_pitch + c * 8) = v;
    }
    return;
  }
  for (int idx = threadIdx.x; idx < TILE_M * p.enc_pad; idx += THREADS) {
    const int r = idx / p.enc_pad, c = idx - r * p.enc_pad;
    const long long row = first + r;
    act[r * p.act_pitch + c] = (row < limit && c < p.enc) ? feat[row * p.enc + c]
                                                          : __float2bfloat16_rn(0.f);
  }
}

// Host side: the shape half of the parameters (what sets the shared-memory
// layout); returns 0, or cudaErrorInvalidValue for a shape the kernel does
// not take.
inline int set_shape(MLPParams* p, int depth, int skip_mask, int enc, int width, int head0) {
  const bool width_ok = width == 32 || width == 64 || width == 128 || width == 256;
  if (depth < 1 || depth + 2 > MAX_LAYERS || !width_ok ||
      (head0 != width && head0 != 2 * width) || enc < 1)
    return cudaErrorInvalidValue;
  p->depth = depth;
  p->skip_mask = skip_mask;
  p->enc = enc;
  p->enc_pad = (enc + 15) / 16 * 16;
  p->width = width;
  p->head0 = head0;
  p->act_pitch = p->enc_pad + width + 8;
  p->h1_pitch = (head0 < NC_MAX ? head0 : NC_MAX) + 8;
  return 0;
}

// Host side: fill the parameters from the C arguments; returns 0, or a
// CUDA error code for shapes or pointers the kernel does not take.
inline int make_params(MLPParams* p, const void* feat, int depth, int skip_mask, int enc,
                       int width, int head0, const void* const* w, const void* const* b) {
  const int err = set_shape(p, depth, skip_mask, enc, width, head0);
  if (err) return err;
  for (int l = 0; l < depth + 2; ++l) {
    if (reinterpret_cast<uintptr_t>(w[l]) % 16) return cudaErrorMisalignedAddress;
    p->w[l] = static_cast<const bf16*>(w[l]);
    p->b[l] = static_cast<const bf16*>(b[l]);
  }
  p->feat_vec = enc == p->enc_pad && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  return 0;
}

// Host side: the most samples per ray a kernel takes when its block holds
// `fixed` bytes of shared memory plus `per_sample` bytes per staged
// sample, within the current device's opt-in limit per block (227 KB on
// an H100); 0 if it does not fit at all or the device cannot be asked.
inline int max_staged_samples(size_t fixed, size_t per_sample) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
    return 0;
  return (size_t)limit > fixed ? int(((size_t)limit - fixed) / per_sample) : 0;
}

}  // namespace mcn
