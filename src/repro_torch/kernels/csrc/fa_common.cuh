// What the flash-attention kernels share (flash_attention.cu, the forward,
// and flash_attention_bwd.cu, the backward): the masked-score sentinel, the
// position of a padded query row, the visibility rule of a (query, key)
// pair, the bf16 mma.sync fragment helpers and the class of a KV tile for
// a query block.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -0x1.fffffep+126f;   // float32 min / 2
constexpr int PAD_QPOS = 1 << 30;

// +inf: the log-sum-exp of a row that sees no key
__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && kp > qp - window;
  return ok;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

enum : uint8_t { TILE_SKIP = 0, TILE_FULL = 1, TILE_PARTIAL = 2 };
constexpr int INT_HI = 0x7fffffff, INT_LO = -0x7fffffff - 1;

// The class of a KV tile for a query block, from the range [kmin, kmax] of
// its keys' non-negative positions, whether any key is masked (kv_pos < 0
// or past Sk), and the range [qmin, qmax] of the block's query positions
// (rows past Sq left out): no pair visible (skip), every pair visible
// (full, no mask applied), or the element mask needed (partial).  The
// plain version is ref.attention_tile_classes.
__device__ __forceinline__ uint8_t tile_class(int kmin, int kmax, bool neg,
                                              int qmin, int qmax, int causal,
                                              int window) {
  if (kmin > kmax || (causal && kmin > qmax) ||
      (window > 0 && kmax <= qmin - window))
    return TILE_SKIP;
  if (!neg && (!causal || kmax <= qmin) &&
      (window <= 0 || kmin > qmax - window))
    return TILE_FULL;
  return TILE_PARTIAL;
}

}  // namespace
