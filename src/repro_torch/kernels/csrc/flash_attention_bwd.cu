// The backward of GQA flash attention for Hopper (sm_90a): dQ, dK and dV of
// flash_attention.cu's forward from its output O and each row's
// log-sum-exp, by the flash recompute (P is never stored):
//
//   P  = exp(scale * Q K^T - lse)       (0 where the mask hides a pair)
//   D  = rowsum(dO * O)
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = scale * dS K,
//   dK = scale * dS^T Q,
//
// dK and dV summed over the rep = H / Hkv query heads of each KV head.
//
// Replaces no Pallas kernel: the TPU's train step takes this gradient by
// XLA's autodiff of the blocked reference attention
// (src/repro/train/state.py:114, jax.value_and_grad, through
// src/repro/kernels/ref.py:52), since the Pallas kernel defines no
// custom_vjp.  On the card the gradient of attention is this kernel, as
// the forward is flash_attention.cu.  Contract: `ref.attention_bwd` of
// the port (q [B,Sq,H,D], k and v [B,Sk,Hkv,D], out and dout [B,Sq,H,D],
// lse float32 [B,H,Sq] in natural units, +inf for a row that sees no key;
// dq, dk, dv in the inputs' dtype; for bf16, P and dS are rounded to bf16
// before the products that take them).
//
// What bounds it: at qwen3-0.6b's training shape (B 8, S 2048, H 16, Hkv
// 8, D 128, causal) the 268.6 M visible (query, key, head) triples need
// 2 (3 D + 2 D) = 1280 FLOP each, 344 GFLOP of bf16 products (0.348 ms on
// an H100 SXM at 989 TFLOP/s), against ~0.4 GB of inputs and outputs
// (0.12 ms): the tensor cores bound it.  This first version recomputes S
// and dO V^T in both main kernels (1792 FLOP a triple) and runs on
// mma.sync, not wgmma: a simple kernel that is right, to be made fast
// later.
//
// Three kernels, launched in turn on the caller's stream:
//
// - `fa_bwd_delta`: D = rowsum(dO * O) in float32, a warp a row;
// - `fa_bwd_dkdv_*`: one CTA per (KV tile, KV head, batch row), looping
//   over the rep query heads and their query tiles in a fixed order; dK
//   and dV stay in registers for the whole loop and are stored once;
// - `fa_bwd_dq_*`: one CTA per (query tile, head, batch row), heaviest
//   (causal: last) tile first, looping over the KV tiles.
//
// No atomics: every sum runs in a fixed order, so two calls on the same
// inputs give the same bits.  A (query tile, KV tile) pair with no
// visible pair is skipped before its tiles are staged, and one whose
// every pair is visible takes no mask, by the classes of the forward's
// wgmma kernel (`tile_class`, `ref.attention_tile_classes`).  Ragged Sq and
// Sk are masked in the kernels: a query row past Sq has position 2^30, lse
// +inf and zero dO (it adds nothing), a key past Sk position -1; rows past
// the end are not stored.
//
// bf16 at D = 64 and 128: tensor cores, mma.sync m16n8k16 with float32
// accumulate; each warp owns 16 key rows (dK/dV) or 16 query rows (dQ);
// the operand that a product takes along the other axis (Q and dO for dK
// and dV, K for dQ) is also staged transposed in padded shared memory.
// float32 at D = 64 and 128: CUDA cores, full float32 products (no TF32),
// 32 x 32 tiles, four threads a row.
//
// Plain C interface, loaded with ctypes: fa_backward returns a
// cudaError_t, fa_bwd_supported says which (dtype, Dk, Dv) it takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fa_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// D = rowsum(dO * O), float32 [B, H, Sq]; one warp a (batch, query, head)
// row, in the layout of O.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(256) fa_bwd_delta(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, long long rows, int Sq, int H) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* orow = o + r * D;
  const T* drow = dout + r * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32)
    acc = fmaf(to_f(orow[c]), to_f(drow[c]), acc);
#pragma unroll
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(r % H);
    const long long bi = r / H;
    const long long b = bi / Sq;
    const int i = static_cast<int>(bi % Sq);
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
template <int D>
struct Bf16Tiles {
  // dK/dV kernel: 64 keys a CTA (16 a warp), BQ queries a step; at D = 128
  // the dK and dV accumulators take 128 registers a thread, so the step's
  // S and dP take 32 queries (16 each) and not 64
  static constexpr int BK = 64, BQ = D == 128 ? 32 : 64;
  static constexpr int RS = D + 8;   // row stride (bf16) of a row-major tile
  static constexpr int TS = BQ + 8;  // row stride of a transposed Q / dO
  static constexpr int DKDV_SMEM =
      (2 * BK * RS + 2 * BQ * RS + 2 * D * TS) * 2 + BQ * 12 + BK * 4;
  // dQ kernel: 64 queries a CTA (16 a warp, Q and dO in registers), KB
  // keys a step
  static constexpr int QB = 64, KB = D == 128 ? 32 : 64;
  static constexpr int KTS = KB + 8;  // row stride of the transposed K
};

template <int D>
__global__ void __launch_bounds__(128) fa_bwd_dkdv_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
    int Hkv, float scale, int causal, int window) {
  using C = Bf16Tiles<D>;
  constexpr int BK = C::BK, BQ = C::BQ, RS = C::RS, TS = C::TS;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(bwd_smem);  // [BK][RS]
  bf16* v_s = k_s + BK * RS;                      // [BK][RS]
  bf16* q_s = v_s + BK * RS;                      // [BQ][RS]
  bf16* do_s = q_s + BQ * RS;                     // [BQ][RS]
  bf16* qt_s = do_s + BQ * RS;                    // [D][TS]: Q transposed
  bf16* dot_s = qt_s + D * TS;                    // [D][TS]: dO transposed
  float* lse_s = reinterpret_cast<float*>(dot_s + D * TS);  // log2 units
  float* dd_s = lse_s + BQ;
  int* qp_s = reinterpret_cast<int*>(dd_s + BQ);
  int* kp_s = qp_s + BQ;

  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * BK, rep = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const float sl = scale * LOG2E;

  if (tid < BK) {
    const int j = k0 + tid;
    kp_s[tid] = j < Sk ? kpos[(long long)b * Sk + j] : -1;
  }
  for (int e = tid; e < BK * D / 8; e += 128) {
    const int r = e / (D / 8), c8 = (e % (D / 8)) * 8;
    const int j = k0 + r;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (j < Sk) {
      const long long off = (((long long)b * Sk + j) * Hkv + hk) * D + c8;
      kv = *reinterpret_cast<const uint4*>(k + off);
      vv = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(k_s + r * RS + c8) = kv;
    *reinterpret_cast<uint4*>(v_s + r * RS + c8) = vv;
  }
  __syncthreads();
  int kmin = INT_HI, kmax = INT_LO;
  bool neg = false;
  for (int j = 0; j < BK; ++j) {
    const int kp = kp_s[j];
    if (kp < 0) {
      neg = true;
    } else {
      kmin = min(kmin, kp);
      kmax = max(kmax, kp);
    }
  }
  // this thread's key rows of the tile: j0 and j1 = j0 + 8
  const int j0 = warp * 16 + gr, j1 = j0 + 8;
  const int kp0 = kp_s[j0], kp1 = kp_s[j1];

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  const int n_qb = (Sq + BQ - 1) / BQ;
  for (int hh = 0; hh < rep && kmin <= kmax; ++hh) {
    const int h = hk * rep + hh;
    for (int qb = 0; qb < n_qb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous step's tiles are read out
      if (tid < BQ) {
        const int i = q0 + tid;
        const bool in = i < Sq;
        const long long li = ((long long)b * H + h) * Sq + i;
        qp_s[tid] = in ? qpos[(long long)b * Sq + i] : PAD_QPOS;
        lse_s[tid] = in ? lse[li] * LOG2E : pos_inf();
        dd_s[tid] = in ? delta[li] : 0.f;
      }
      __syncthreads();
      int qmin = INT_HI, qmax = INT_LO;
      for (int i = 0; i < BQ && q0 + i < Sq; ++i) {
        qmin = min(qmin, qp_s[i]);
        qmax = max(qmax, qp_s[i]);
      }
      const uint8_t cls =
          tile_class(kmin, kmax, neg, qmin, qmax, causal, window);
      if (cls == TILE_SKIP) continue;  // the same for every thread
      const bool partial = cls == TILE_PARTIAL;
      // stage Q and dO, row-major and transposed (rows past Sq as zeros);
      // consecutive threads take consecutive rows, so each transposed
      // store of a warp writes one row of qt_s / dot_s without bank
      // conflicts
      for (int e = tid; e < BQ * D / 8; e += 128) {
        const int r = e % BQ, c8 = (e / BQ) * 8;
        const int i = q0 + r;
        uint4 qv = make_uint4(0u, 0u, 0u, 0u), gv = qv;
        if (i < Sq) {
          const long long off = (((long long)b * Sq + i) * H + h) * D + c8;
          qv = *reinterpret_cast<const uint4*>(q + off);
          gv = *reinterpret_cast<const uint4*>(dout + off);
        }
        *reinterpret_cast<uint4*>(q_s + r * RS + c8) = qv;
        *reinterpret_cast<uint4*>(do_s + r * RS + c8) = gv;
        const bf16* qe = reinterpret_cast<const bf16*>(&qv);
        const bf16* ge = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          qt_s[(c8 + t) * TS + r] = qe[t];
          dot_s[(c8 + t) * TS + r] = ge[t];
        }
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries;
      // register e of n-tile nt holds key j0 (e < 2) or j1 and query
      // nt * 8 + 2 tq + (e & 1)
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks * 16 + 2 * tq;
        const uint32_t ak[4] = {ld_u32(k_s + j0 * RS + c),
                                ld_u32(k_s + j1 * RS + c),
                                ld_u32(k_s + j0 * RS + c + 8),
                                ld_u32(k_s + j1 * RS + c + 8)};
        const uint32_t av[4] = {ld_u32(v_s + j0 * RS + c),
                                ld_u32(v_s + j1 * RS + c),
                                ld_u32(v_s + j0 * RS + c + 8),
                                ld_u32(v_s + j1 * RS + c + 8)};
#pragma unroll
        for (int nt = 0; nt < BQ / 8; ++nt) {
          const bf16* qr = q_s + (nt * 8 + gr) * RS + c;
          mma_bf16(s[nt], ak, ld_u32(qr), ld_u32(qr + 8));
          const bf16* gr_ = do_s + (nt * 8 + gr) * RS + c;
          mma_bf16(dp[nt], av, ld_u32(gr_), ld_u32(gr_ + 8));
        }
      }
      // P^T and dS^T = P^T * (dP^T - D)
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = nt * 8 + 2 * tq + (e & 1);
          const bool vis = !partial || visible(qp_s[i], e < 2 ? kp0 : kp1,
                                               causal, window);
          const float p = vis ? exp2f(fmaf(s[nt][e], sl, -lse_s[i])) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - dd_s[i]);
        }
      }
      // dV += P^T dO and dK += dS^T Q: P and dS rounded to bf16 as the A
      // fragments (the accumulator layout of S^T is the A layout of these
      // products), dO and Q read transposed
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t ap[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t as[4] = {
            pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
            pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
            pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
            pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          const bf16* gt = dot_s + (nt * 8 + gr) * TS + kk * 16 + 2 * tq;
          mma_bf16(dva[nt], ap, ld_u32(gt), ld_u32(gt + 8));
          const bf16* qt = qt_s + (nt * 8 + gr) * TS + kk * 16 + 2 * tq;
          mma_bf16(dka[nt], as, ld_u32(qt), ld_u32(qt + 8));
        }
      }
    }
  }

  const long long row0 = (((long long)b * Sk + k0 + j0) * Hkv + hk) * D;
  const long long row1 = (((long long)b * Sk + k0 + j1) * Hkv + hk) * D;
  const bool in0 = k0 + j0 < Sk, in1 = k0 + j1 < Sk;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (in0) {
      *reinterpret_cast<uint32_t*>(dk + row0 + c) =
          pack_bf16(dka[nt][0] * scale, dka[nt][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row0 + c) =
          pack_bf16(dva[nt][0], dva[nt][1]);
    }
    if (in1) {
      *reinterpret_cast<uint32_t*>(dk + row1 + c) =
          pack_bf16(dka[nt][2] * scale, dka[nt][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + row1 + c) =
          pack_bf16(dva[nt][2], dva[nt][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128) fa_bwd_dq_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int Hkv, float scale,
    int causal, int window) {
  using C = Bf16Tiles<D>;
  constexpr int BQ = C::QB, BK = C::KB, RS = C::RS, TS = C::KTS;
  __shared__ __align__(16) bf16 k_s[BK * RS];
  __shared__ __align__(16) bf16 v_s[BK * RS];
  __shared__ __align__(16) bf16 kt_s[D * TS];  // K transposed
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];

  const int n_qb = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qb - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const float sl = scale * LOG2E;

  if (tid < BQ) {
    const int i = q0 + tid;
    qp_s[tid] = i < Sq ? qpos[(long long)b * Sq + i] : PAD_QPOS;
  }
  // this warp's 16 query rows: r0 = warp * 16 + gr and r1 = r0 + 8, Q and
  // dO as A fragments
  const int r0 = warp * 16 + gr, r1 = r0 + 8;
  const bool in0 = q0 + r0 < Sq, in1 = q0 + r1 < Sq;
  const long long row0 = ((long long)b * Sq + q0 + r0) * H + h;
  const long long row1 = ((long long)b * Sq + q0 + r1) * H + h;
  uint32_t qf[D / 16][4], gf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * tq;
    qf[ks][0] = in0 ? ld_u32(q + row0 * D + c) : 0u;
    qf[ks][1] = in1 ? ld_u32(q + row1 * D + c) : 0u;
    qf[ks][2] = in0 ? ld_u32(q + row0 * D + c + 8) : 0u;
    qf[ks][3] = in1 ? ld_u32(q + row1 * D + c + 8) : 0u;
    gf[ks][0] = in0 ? ld_u32(dout + row0 * D + c) : 0u;
    gf[ks][1] = in1 ? ld_u32(dout + row1 * D + c) : 0u;
    gf[ks][2] = in0 ? ld_u32(dout + row0 * D + c + 8) : 0u;
    gf[ks][3] = in1 ? ld_u32(dout + row1 * D + c + 8) : 0u;
  }
  const long long l0 = ((long long)b * H + h) * Sq + q0 + r0;
  const long long l1 = l0 + 8;
  const float ls0 = in0 ? lse[l0] * LOG2E : pos_inf();
  const float ls1 = in1 ? lse[l1] * LOG2E : pos_inf();
  const float dd0 = in0 ? delta[l0] : 0.f, dd1 = in1 ? delta[l1] : 0.f;
  __syncthreads();
  const int qp0 = qp_s[r0], qp1 = qp_s[r1];
  int qmin = INT_HI, qmax = INT_LO;
  for (int i = 0; i < BQ && q0 + i < Sq; ++i) {
    qmin = min(qmin, qp_s[i]);
    qmax = max(qmax, qp_s[i]);
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nt][e] = 0.f;

  const int n_kb = (Sk + BK - 1) / BK;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile is read out
    if (tid < BK) {
      const int j = k0 + tid;
      kp_s[tid] = j < Sk ? kpos[(long long)b * Sk + j] : -1;
    }
    __syncthreads();
    int kmin = INT_HI, kmax = INT_LO;
    bool neg = false;
    for (int j = 0; j < BK; ++j) {
      const int kp = kp_s[j];
      if (kp < 0) {
        neg = true;
      } else {
        kmin = min(kmin, kp);
        kmax = max(kmax, kp);
      }
    }
    const uint8_t cls =
        tile_class(kmin, kmax, neg, qmin, qmax, causal, window);
    if (cls == TILE_SKIP) continue;  // the same for every thread
    const bool partial = cls == TILE_PARTIAL;
    // rows fastest across threads: the transposed stores of a warp write
    // one row of kt_s without bank conflicts
    for (int e = tid; e < BK * D / 8; e += 128) {
      const int r = e % BK, c8 = (e / BK) * 8;
      const int j = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < Sk) {
        const long long off = (((long long)b * Sk + j) * Hkv + hk) * D + c8;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(k_s + r * RS + c8) = kv;
      *reinterpret_cast<uint4*>(v_s + r * RS + c8) = vv;
      const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
      for (int t = 0; t < 8; ++t) kt_s[(c8 + t) * TS + r] = ke[t];
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x BK keys a warp
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const bf16* kr = k_s + (nt * 8 + gr) * RS + ks * 16 + 2 * tq;
        mma_bf16(s[nt], qf[ks], ld_u32(kr), ld_u32(kr + 8));
        const bf16* vr = v_s + (nt * 8 + gr) * RS + ks * 16 + 2 * tq;
        mma_bf16(dp[nt], gf[ks], ld_u32(vr), ld_u32(vr + 8));
      }
    }
    // dS = P * (dP - D)
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * tq + (e & 1);
        const bool vis = !partial || visible(e < 2 ? qp0 : qp1, kp_s[j],
                                             causal, window);
        const float p =
            vis ? exp2f(fmaf(s[nt][e], sl, -(e < 2 ? ls0 : ls1))) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - (e < 2 ? dd0 : dd1));
      }
    }
    // dQ += dS K: dS rounded to bf16 as the A fragment, K read transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                             pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                             pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                             pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const bf16* kt = kt_s + (nt * 8 + gr) * TS + kk * 16 + 2 * tq;
        mma_bf16(dqa[nt], a, ld_u32(kt), ld_u32(kt + 8));
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (in0)
      *reinterpret_cast<uint32_t*>(dq + row0 * D + c) =
          pack_bf16(dqa[nt][0] * scale, dqa[nt][1] * scale);
    if (in1)
      *reinterpret_cast<uint32_t*>(dq + row1 * D + c) =
          pack_bf16(dqa[nt][2] * scale, dqa[nt][3] * scale);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, full float32 products; 32 x 32 tiles, four threads
// a row (r = tid / 4), each taking every fourth key or query and column
// ---------------------------------------------------------------------------
constexpr int F_B = 32, F_PS = F_B + 1;

template <int D>
constexpr int f32_dkdv_smem() {
  return (4 * F_B * (D + 1) + 2 * F_B * F_PS + 4 * F_B) * 4;
}

template <int D>
constexpr int f32_dq_smem() {
  return (4 * F_B * (D + 1) + F_B * F_PS + 2 * F_B) * 4;
}

template <int D>
__global__ void __launch_bounds__(128, 1) fa_bwd_dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int Hkv, float scale, int causal, int window) {
  constexpr int RS = D + 1;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  float* k_s = reinterpret_cast<float*>(bwd_smem);  // [32][D+1]
  float* v_s = k_s + F_B * RS;
  float* q_s = v_s + F_B * RS;
  float* do_s = q_s + F_B * RS;
  float* p_s = do_s + F_B * RS;  // [key][query]
  float* ds_s = p_s + F_B * F_PS;
  float* lse_s = ds_s + F_B * F_PS;
  float* dd_s = lse_s + F_B;
  int* qp_s = reinterpret_cast<int*>(dd_s + F_B);
  int* kp_s = qp_s + F_B;

  const int kb = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kb * F_B, rep = H / Hkv;
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;  // key row, lane within its quad

  if (tid < F_B) {
    const int j = k0 + tid;
    kp_s[tid] = j < Sk ? kpos[(long long)b * Sk + j] : -1;
  }
  for (int e = tid; e < F_B * D; e += 128) {
    const int j = e / D, d = e % D;
    const bool in = k0 + j < Sk;
    const long long off = (((long long)b * Sk + k0 + j) * Hkv + hk) * D + d;
    k_s[j * RS + d] = in ? k[off] : 0.f;
    v_s[j * RS + d] = in ? v[off] : 0.f;
  }
  __syncthreads();
  int kmin = INT_HI, kmax = INT_LO;
  bool neg = false;
  for (int j = 0; j < F_B; ++j) {
    const int kp = kp_s[j];
    if (kp < 0) {
      neg = true;
    } else {
      kmin = min(kmin, kp);
      kmax = max(kmax, kp);
    }
  }
  const int kp = kp_s[r];

  float dka[D / 4], dva[D / 4];
#pragma unroll
  for (int t = 0; t < D / 4; ++t) dka[t] = dva[t] = 0.f;

  const int n_qb = (Sq + F_B - 1) / F_B;
  for (int hh = 0; hh < rep && kmin <= kmax; ++hh) {
    const int h = hk * rep + hh;
    for (int qb = 0; qb < n_qb; ++qb) {
      const int q0 = qb * F_B;
      __syncthreads();
      if (tid < F_B) {
        const int i = q0 + tid;
        const bool in = i < Sq;
        const long long li = ((long long)b * H + h) * Sq + i;
        qp_s[tid] = in ? qpos[(long long)b * Sq + i] : PAD_QPOS;
        lse_s[tid] = in ? lse[li] : pos_inf();
        dd_s[tid] = in ? delta[li] : 0.f;
      }
      __syncthreads();
      int qmin = INT_HI, qmax = INT_LO;
      for (int i = 0; i < F_B && q0 + i < Sq; ++i) {
        qmin = min(qmin, qp_s[i]);
        qmax = max(qmax, qp_s[i]);
      }
      const uint8_t cls =
          tile_class(kmin, kmax, neg, qmin, qmax, causal, window);
      if (cls == TILE_SKIP) continue;
      const bool partial = cls == TILE_PARTIAL;
      for (int e = tid; e < F_B * D; e += 128) {
        const int i = e / D, d = e % D;
        const bool in = q0 + i < Sq;
        const long long off = (((long long)b * Sq + q0 + i) * H + h) * D + d;
        q_s[i * RS + d] = in ? q[off] : 0.f;
        do_s[i * RS + d] = in ? dout[off] : 0.f;
      }
      __syncthreads();
      // P^T and dS^T for key r and queries c, c + 4, ..., c + 28
#pragma unroll
      for (int ii = 0; ii < F_B / 4; ++ii) {
        const int i = c + 4 * ii;
        float sd = 0.f, gd = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
          sd = fmaf(k_s[r * RS + d], q_s[i * RS + d], sd);
          gd = fmaf(v_s[r * RS + d], do_s[i * RS + d], gd);
        }
        const bool vis = !partial || visible(qp_s[i], kp, causal, window);
        const float p = vis ? expf(sd * scale - lse_s[i]) : 0.f;
        p_s[r * F_PS + i] = p;
        ds_s[r * F_PS + i] = p * (gd - dd_s[i]);
      }
      __syncwarp();  // the row's P and dS (written by its quad) are visible
#pragma unroll
      for (int t = 0; t < D / 4; ++t) {
        const int d = c + 4 * t;
        float pv = 0.f, sq = 0.f;
#pragma unroll 8
        for (int i = 0; i < F_B; ++i) {
          pv = fmaf(p_s[r * F_PS + i], do_s[i * RS + d], pv);
          sq = fmaf(ds_s[r * F_PS + i], q_s[i * RS + d], sq);
        }
        dva[t] += pv;
        dka[t] += sq;
      }
      __syncwarp();
    }
  }

  if (k0 + r < Sk) {
    const long long row = (((long long)b * Sk + k0 + r) * Hkv + hk) * D;
#pragma unroll
    for (int t = 0; t < D / 4; ++t) {
      dk[row + c + 4 * t] = dka[t] * scale;
      dv[row + c + 4 * t] = dva[t];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128, 1) fa_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    float* __restrict__ dq, int Sq, int Sk, int H, int Hkv, float scale,
    int causal, int window) {
  constexpr int RS = D + 1;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  float* q_s = reinterpret_cast<float*>(bwd_smem);  // [32][D+1]
  float* do_s = q_s + F_B * RS;
  float* k_s = do_s + F_B * RS;
  float* v_s = k_s + F_B * RS;
  float* ds_s = v_s + F_B * RS;  // [query][key]
  int* qp_s = reinterpret_cast<int*>(ds_s + F_B * F_PS);
  int* kp_s = qp_s + F_B;

  const int n_qb = (Sq + F_B - 1) / F_B;
  const int q0 = (n_qb - 1 - blockIdx.x) * F_B;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;  // query row, lane within its quad

  if (tid < F_B) {
    const int i = q0 + tid;
    qp_s[tid] = i < Sq ? qpos[(long long)b * Sq + i] : PAD_QPOS;
  }
  for (int e = tid; e < F_B * D; e += 128) {
    const int i = e / D, d = e % D;
    const bool in = q0 + i < Sq;
    const long long off = (((long long)b * Sq + q0 + i) * H + h) * D + d;
    q_s[i * RS + d] = in ? q[off] : 0.f;
    do_s[i * RS + d] = in ? dout[off] : 0.f;
  }
  const bool in = q0 + r < Sq;
  const long long li = ((long long)b * H + h) * Sq + q0 + r;
  const float lr = in ? lse[li] : pos_inf();
  const float ddr = in ? delta[li] : 0.f;
  __syncthreads();
  const int qp = qp_s[r];
  int qmin = INT_HI, qmax = INT_LO;
  for (int i = 0; i < F_B && q0 + i < Sq; ++i) {
    qmin = min(qmin, qp_s[i]);
    qmax = max(qmax, qp_s[i]);
  }

  float dqa[D / 4];
#pragma unroll
  for (int t = 0; t < D / 4; ++t) dqa[t] = 0.f;

  const int n_kb = (Sk + F_B - 1) / F_B;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * F_B;
    __syncthreads();
    if (tid < F_B) {
      const int j = k0 + tid;
      kp_s[tid] = j < Sk ? kpos[(long long)b * Sk + j] : -1;
    }
    __syncthreads();
    int kmin = INT_HI, kmax = INT_LO;
    bool neg = false;
    for (int j = 0; j < F_B; ++j) {
      const int kp = kp_s[j];
      if (kp < 0) {
        neg = true;
      } else {
        kmin = min(kmin, kp);
        kmax = max(kmax, kp);
      }
    }
    const uint8_t cls =
        tile_class(kmin, kmax, neg, qmin, qmax, causal, window);
    if (cls == TILE_SKIP) continue;
    const bool partial = cls == TILE_PARTIAL;
    for (int e = tid; e < F_B * D; e += 128) {
      const int j = e / D, d = e % D;
      const bool kin = k0 + j < Sk;
      const long long off = (((long long)b * Sk + k0 + j) * Hkv + hk) * D + d;
      k_s[j * RS + d] = kin ? k[off] : 0.f;
      v_s[j * RS + d] = kin ? v[off] : 0.f;
    }
    __syncthreads();
    // dS for row r and keys c, c + 4, ..., c + 28
#pragma unroll
    for (int jj = 0; jj < F_B / 4; ++jj) {
      const int j = c + 4 * jj;
      float sd = 0.f, gd = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        sd = fmaf(q_s[r * RS + d], k_s[j * RS + d], sd);
        gd = fmaf(do_s[r * RS + d], v_s[j * RS + d], gd);
      }
      const bool vis = !partial || visible(qp, kp_s[j], causal, window);
      const float p = vis ? expf(sd * scale - lr) : 0.f;
      ds_s[r * F_PS + j] = p * (gd - ddr);
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < D / 4; ++t) {
      const int d = c + 4 * t;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < F_B; ++j)
        acc = fmaf(ds_s[r * F_PS + j], k_s[j * RS + d], acc);
      dqa[t] += acc;
    }
    __syncwarp();
  }

  if (in) {
    float* row = dq + (((long long)b * Sq + q0 + r) * H + h) * D;
#pragma unroll
    for (int t = 0; t < D / 4; ++t) row[c + 4 * t] = dqa[t] * scale;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float *lse;
  const int *qpos, *kpos;
  void *dq, *dk, *dv;
  float* delta;
  int B, Sq, Sk, H, Hkv;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_delta(const BwdArgs& a) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  const long long blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fa_bwd_delta<T, D><<<static_cast<unsigned>(blocks), 256, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      rows, a.Sq, a.H);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const BwdArgs& a) {
  using C = Bf16Tiles<D>;
  cudaError_t err = launch_delta<bf16, D>(a);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_bf16<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::DKDV_SMEM);
  if (err != cudaSuccess) return err;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *g = static_cast<const bf16*>(a.dout);
  fa_bwd_dkdv_bf16<D><<<dim3((a.Sk + C::BK - 1) / C::BK, a.Hkv, a.B), 128,
                         C::DKDV_SMEM, a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.qpos, a.kpos, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal,
      a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_bf16<D><<<dim3((a.Sq + C::QB - 1) / C::QB, a.H, a.B), 128, 0,
                       a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.qpos, a.kpos, static_cast<bf16*>(a.dq),
      a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const BwdArgs& a) {
  cudaError_t err = launch_delta<float, D>(a);
  if (err != cudaSuccess) return err;
  constexpr int s1 = f32_dkdv_smem<D>(), s2 = f32_dq_smem<D>();
  if ((err = cudaFuncSetAttribute(fa_bwd_dkdv_f32<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dq_f32<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s2)) != cudaSuccess)
    return err;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *g = static_cast<const float*>(a.dout);
  fa_bwd_dkdv_f32<D><<<dim3((a.Sk + F_B - 1) / F_B, a.Hkv, a.B), 128, s1,
                        a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.qpos, a.kpos, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal,
      a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_f32<D><<<dim3((a.Sq + F_B - 1) / F_B, a.H, a.B), 128, s2,
                      a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.qpos, a.kpos, static_cast<float*>(a.dq),
      a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

bool supported(int dk, int dv) { return dk == dv && (dk == 64 || dk == 128); }

}  // namespace

extern "C" {

int fa_bwd_supported(int is_bf16, int dk, int dv) {
  (void)is_bf16;
  return supported(dk, dv) ? 1 : 0;
}

// dq [B,Sq,H,D], dk and dv [B,Sk,Hkv,D] in the inputs' dtype; delta is
// float32 [B,H,Sq] scratch (D of the recompute), written here.
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, const void* qpos,
                const void* kpos, void* dq, void* dk, void* dv, void* delta,
                int B, int Sq, int Sk, int H, int Hkv, int dk_, int dv_,
                int bf16_, float scale, int causal, int window,
                void* stream) {
  if (!supported(dk_, dv_) || Hkv < 1 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<const int*>(qpos),
                  static_cast<const int*>(kpos), dq, dk, dv,
                  static_cast<float*>(delta), B, Sq, Sk, H, Hkv, scale,
                  causal, window, static_cast<cudaStream_t>(stream)};
  if (bf16_) return dk_ == 64 ? launch_bf16<64>(a) : launch_bf16<128>(a);
  return dk_ == 64 ? launch_f32<64>(a) : launch_f32<128>(a);
}

const char* fa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
