// The NeRF MLP's shape and weights as the kernels take them (trunk with a
// skip concat, then the packed heads), and the constants of their tiles,
// shared by every kernel of the port: the forwards (shaded_fwd.cuh: K1,
// K2, K4) and the backwards (mlp_bwd_points.cuh, mlp_bwd.cuh: K3, K5, K6).
//
// Rounding points follow the Pallas kernels exactly: bf16 operands, fp32
// accumulation, the bf16-stored bias added in fp32, ReLU, then a cast back
// to bf16 after every trunk layer and after head layer 0; the last head
// adds its bias in fp32 with no cast.
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
constexpr int OUT_COLS = 32;            // packed head output lanes

struct MLPParams {
  const bf16* w[MAX_LAYERS];  // [K_l, N_l] row-major, the JAX pack layout
  const bf16* b[MAX_LAYERS];  // [N_l]
  int depth;                  // trunk layers; w[depth], w[depth+1] are the heads
  int skip_mask;              // bit i: trunk layer i takes [feat | h]
  int enc;                    // feature lanes (4 + 6L)
  int width;                  // trunk width: 32, 64, 128 or 256
  int head0;                  // head layer 0 width: width or 2 * width
  int feat_vec;               // feat rows load as 16-byte vectors
};

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Host side: the shape half of the parameters; returns 0, or
// cudaErrorInvalidValue for a shape the kernels do not take.
inline int set_shape(MLPParams* p, int depth, int skip_mask, int enc, int width, int head0) {
  const bool width_ok = width == 32 || width == 64 || width == 128 || width == 256;
  if (depth < 1 || depth + 2 > MAX_LAYERS || !width_ok ||
      (head0 != width && head0 != 2 * width) || enc < 1)
    return cudaErrorInvalidValue;
  p->depth = depth;
  p->skip_mask = skip_mask;
  p->enc = enc;
  p->width = width;
  p->head0 = head0;
  return 0;
}

// Host side: fill the parameters from the C arguments; returns 0, or a
// CUDA error code for shapes or pointers the kernels do not take.
inline int make_params(MLPParams* p, const void* feat, int depth, int skip_mask, int enc,
                       int width, int head0, const void* const* w, const void* const* b) {
  const int err = set_shape(p, depth, skip_mask, enc, width, head0);
  if (err) return err;
  for (int l = 0; l < depth + 2; ++l) {
    if (reinterpret_cast<uintptr_t>(w[l]) % 16) return cudaErrorMisalignedAddress;
    p->w[l] = static_cast<const bf16*>(w[l]);
    p->b[l] = static_cast<const bf16*>(b[l]);
  }
  p->feat_vec = enc % 16 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0;
  return 0;
}

}  // namespace mcn
