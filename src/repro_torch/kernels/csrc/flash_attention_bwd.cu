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
// (src/repro/train/state.py:52, jax.value_and_grad, through
// src/repro/kernels/ref.py:52), since the Pallas kernel defines no
// custom_vjp.  On the card the gradient of attention is this kernel, as
// the forward is flash_attention.cu.  Contract: `ref.attention_bwd` of
// the port (q [B,Sq,H,Dk], k [B,Sk,Hkv,Dk], v [B,Sk,Hkv,Dv], out and
// dout [B,Sq,H,Dv], lse float32 [B,H,Sq] in natural units, +inf for a row
// that sees no key; dq, dk, dv in the inputs' dtype; for bf16, P and dS
// are rounded to bf16 before the products that take them).  Where V is
// K's first Dv < Dk columns (MLA's latent values, v == k with rows Dk
// apart), dK takes dV in its first Dv columns and dv is not written: the
// gradient of the storage both share (`ref.attention_bwd`'s folded
// contract, dS scaled before its rounding).
//
// What bounds it: at qwen3-0.6b's training shape (B 8, S 2048, H 16, Hkv
// 8, D 128, causal) the 268.6 M visible (query, key, head) triples need
// 2 (3 D + 2 D) = 1280 FLOP each, 344 GFLOP of bf16 products (0.348 ms on
// an H100 SXM at 989 TFLOP/s), against ~0.4 GB of inputs and outputs
// (0.12 ms): the tensor cores bound it, so the products must run on
// wgmma, fed by TMA, with the elementwise work (an exp2 and a handful of
// FFMAs a score) beside them and not between them.
//
// Three kernels, launched in turn on the caller's stream (bf16 at (64,
// 64), (80, 80) and (128, 128); at 80 a row takes two 64-column boxes, the
// second zero past column 79, and the products stop at column 80):
//
// - `fa_bwd_delta`: D = rowsum(dO * O) in float32, a warp a row;
// - `fa_bwd_dkdv_wgmma` (bf16): dK and dV.  A persistent grid (one CTA an
//   SM) walks work items of 128 keys of one KV head and batch row,
//   heaviest first (`item_of`).  A producer warp (setmaxnreg 40) loads
//   each item's K and V by TMA into one of two buffers (the next item's
//   load while this one's dK and dV are stored), classes the item's
//   64-query tiles 32 at a time, a lane a tile (`tile_class`), and sends
//   the tiles not skipped, chunk by chunk and each chunk's for each rep
//   head in turn: their Q and dO by TMA, their rows' lse, D and positions
//   by the warp, into a ring of stages guarded by full/empty mbarriers.
//   Two consumer warpgroups (232 registers) own 64 keys each: S^T = K Q^T
//   and dP^T = V dO^T run on wgmma with both operands K-major in shared
//   memory (m64n64k16), P^T and dS^T = P^T (dP^T - D) are formed in
//   registers (one FFMA and an exp2 a score; the element mask only on
//   partial tiles), and dV += P^T dO and dK += dS^T Q run on wgmma with
//   P^T and dS^T rounded to bf16 as the register A operand (the
//   accumulator layout of S^T is wgmma's A layout) and dO and Q read
//   MN-major, so nothing is transposed in shared memory.  dK and dV stay
//   in registers (64 + 64 a thread at D = 128) for the whole item and are
//   stored once, through the K and V buffer and a TMA store.
// - `fa_bwd_dq_wgmma` (bf16): dQ, the forward's `fa_wgmma_kernel` shape
//   with a third product.  Items of 128 queries of one head, heaviest
//   first; Q and dO are resident (two buffers, so the next item's load
//   while this one runs); the producer classes the 64-key tiles 32 at a
//   time and streams the K and V of those not skipped through a ring.
//   Each consumer warpgroup owns 64 queries: S = Q K^T and dP = dO V^T
//   on wgmma SS, dS in registers, dQ += dS K on wgmma RS with K read
//   MN-major; the sum over KV tiles runs in their fixed order.  dQ is
//   stored once, through the Q buffer and a TMA store.
//
// The producers class a chunk of tiles at once because a tile classed as
// it comes costs a serial load of its positions before the next, so the
// half of the training shape's tiles that causality skips, in runs at the
// start of each head's walk, drained the ring (attention_bwd_ablation.py
// times each kernel's ring alone, its consumers doing no work).  Within a
// consumer the products, the exp2s and the next products run in series;
// the two consumers' interleaving is what overlaps them (turns at the
// tensor cores, as the forward's consumers take them, measured no
// faster: the ablation's `turns`).  The m64n64 products S^T and dP^T
// (S and dP) read both operands from shared memory, 4 KB each 32 cycles
// at the tensor cores' rate, the shared memory's own; wider tiles would
// need more than the 232 registers a consumer has.
//
// Why two kernels and the recompute (S and dO V^T in both: 1792 FLOP a
// triple, 481 GFLOP at the training shape, against the bound's 1280).
// One kernel that also kept dQ per KV tile and summed it in a second pass
// would write and read back 272 visible (64-query, 128-key) tile pairs a
// (batch, head) x 32 KB of float32 partials x 128 (batch, head) = ~1.14
// GB: ~0.68 ms of traffic at 3.35 TB/s, more than the 0.14 ms the
// recompute costs at the tensor-core peak.  One kernel whose CTAs add dQ
// into one float32 buffer in a fixed order (each KV tile's CTA waiting on
// a per-query-tile counter) keeps 1280 FLOP, but its waits between CTAs
// can deadlock a persistent grid whose waiting CTAs hold every SM.
// Atomics would make the sums' order, and so the bits, change from call
// to call.
//
// No atomics: every sum runs in a fixed order, so two calls on the same
// inputs give the same bits.  A (query tile, KV tile) pair with no
// visible pair is skipped before its tiles are loaded, and one whose
// every pair is visible takes no mask, by the classes of the forward's
// wgmma kernel (`tile_class`, `ref.attention_tile_classes`); the plain
// version of both kernels' walks is `ref.attention_bwd_schedule`.
// Ragged Sq and Sk come from the tensor maps: rows past the end load as
// zeros (a query row past Sq also has lse +inf, so it adds nothing; a key
// past Sk has position -1, so it is masked), and the TMA stores write no
// row past the end.
//
// bf16 at MLA's (576, 512), V as K's first 512 columns: `fa_bwd_dkdv_mla`
// and `fa_bwd_dq_mla` (their section below), the same design at MLA's
// width: persistent, a producer warp and TMA rings, the products on
// wgmma; K resident with 32-row units of (query, head) rows streamed
// past it (dK), Q and dO resident with 32-key tiles streamed (dQ); two
// consumer warpgroups split the output's 576 columns and hand P and dS to
// each other.
//
// bf16 at the smoke sizes (32, 16), (32, 32) and (80, 64): `fa_bwd_dkdv_mma`
// and `fa_bwd_dq_mma`, one mma.sync template (its section below): a
// resident 64-row tile (keys, or (query, head) rows) and 32-row units
// streamed past it through a cp.async double buffer, S and dP for the
// pairs, then the output tile's products, its columns split across 8
// warps.  Like the wgmma kernels they skip a unit with no visible pair
// before loading it and mask only partial ones, with no atomics.
//
// float32 at every size but (576, 512): CUDA cores, full float32 products
// (no TF32), 32 x 32 tiles, four threads a row (`fa_bwd_dkdv_f32`,
// `fa_bwd_dq_f32`).
//
// Plain C interface, loaded with ctypes: fa_backward returns a
// cudaError_t, fa_bwd_variant names the kernels it runs for a (dtype, Dk,
// Dv) (-1: none), fa_bwd_kernel_info gives a bf16 kernel's stages,
// shared memory and registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fa_common.cuh"
#include "fa_hopper.cuh"
#include "mbarrier.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

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
// bf16 at D = 64, 80 and 128: TMA, wgmma, warp-specialised persistent CTAs
// ---------------------------------------------------------------------------
// Every tile lives in shared memory as TMA's 128-byte swizzle writes it:
// ceil(D / 64) boxes of (rows) x 128 bytes, each box 1024-byte aligned.  A
// K-major operand steps 32 bytes a 16-wide slice of D inside a box and a
// box every 4 slices; an MN-major operand steps 1024 bytes every 8 rows
// along its depth (SBO) and a box every 64 columns of N (LBO).

// S = A B^T over the depth D for one warpgroup's 64 rows and 64 columns:
// A's rows at `a` in boxes `abox` bytes apart, B's rows at `b` in boxes
// `bbox` apart, both K-major (wgmma m64n64k16, SS).
template <int D>
__device__ __forceinline__ void ss_64x64(float* s, uint32_t a, int abox,
                                         uint32_t b, int bbox) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n64(s, sw128_desc(a + (kk / 4) * abox + (kk % 4) * 32, 16,
                                  1024),
                    sw128_desc(b + (kk / 4) * bbox + (kk % 4) * 32, 16, 1024),
                    kk > 0);
}

// acc += A B over a depth of 64 rows: A (64 x 64) from registers, four
// 16-wide slices of `af`; B (64 rows x D) MN-major at `b`, boxes `bbox`
// bytes apart (wgmma m64nDk16, RS).  At D = 80, N runs from the first
// box's 64 columns on into the second box's first 16 (LBO).
template <int D>
__device__ __forceinline__ void rs_64xD(float* acc, uint32_t (*af)[4],
                                        uint32_t b, int bbox) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = sw128_desc(b + kk * 16 * 128, bbox, 1024);
    if constexpr (D == 128)
      wgmma_rs_m64n128(acc, af[kk], db);
    else if constexpr (D == 80)
      wgmma_rs_m64n80(acc, af[kk], db);
    else
      wgmma_rs_m64n64(acc, af[kk], db);
  }
}

// A 64 x 16 NK accumulator rounded to bf16 as wgmma's register A operand:
// columns 16kk..16kk+15 are the accumulator's column groups 2kk and
// 2kk + 1, in mma's A fragment order.
template <int NK = 4>
__device__ __forceinline__ void pack_a(const float* s, uint32_t (*af)[4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    af[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    af[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    af[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    af[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Keeps an A operand's registers from reuse until the product that reads
// them has been waited for.
template <int NK = 4>
__device__ __forceinline__ void fence_af(uint32_t (*af)[4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(af[kk][e])::"memory");
}

// The accumulator's element e of a 64 x 64 tile: row r0 (e & 2 == 0) or
// r0 + 8 of the thread's rows, column 8 (e / 4) + 2 tq + (e & 1).
__device__ __forceinline__ int acc_col(int e, int tq) {
  return 8 * (e >> 2) + 2 * tq + (e & 1);
}

// A consumer warpgroup's named barrier (ids 1 and 2), its 128 threads.
__device__ __forceinline__ void wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// Stores a warpgroup's 64 x D float32 accumulator (rows r0 and r0 + 8 of
// the thread, 64 w + 16 wl + lane / 4 of a tile of `rows` rows) times
// `mul`, rounded to bf16, into a swizzled tile at `g` (boxes of `rows` x
// 128 bytes), the layout its TMA store reads.
template <int D>
__device__ __forceinline__ void stage_out(uint8_t* g, int rows, int r0,
                                          int tq, const float* acc,
                                          float mul) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int e = 0; e < D / 8; ++e) {
    const int box = e / 8, ch = e % 8;
    uint8_t* p0 = g + box * rows * 128 + r0 * 128 + ((ch ^ (r0 & 7)) << 4);
    uint8_t* p1 = g + box * rows * 128 + r1 * 128 + ((ch ^ (r1 & 7)) << 4);
    *reinterpret_cast<uint32_t*>(p0 + 4 * tq) =
        pack_bf16(acc[4 * e] * mul, acc[4 * e + 1] * mul);
    *reinterpret_cast<uint32_t*>(p1 + 4 * tq) =
        pack_bf16(acc[4 * e + 2] * mul, acc[4 * e + 3] * mul);
  }
}

// The minimum and maximum of `lo` / `hi` over the warp.
__device__ __forceinline__ void warp_range(int& lo, int& hi) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// Shared memory of the dK/dV kernel, from a 1024-byte aligned base: KVBUF
// buffers of an item's K and V (128 keys each; two, so that the next
// item's load while this one's dK and dV are stored), a ring of STAGES
// (Q, dO) tiles of 64 queries with each stage's rows (lse in log2 units,
// D, position), the mbarriers (full and empty per K/V buffer and per
// stage), one slot per buffer naming its item (b, hk, k0; w = 0 ends the
// work) and one per stage naming its tile (q0, head, class; q0 = -1 ends
// the item).  A row of D columns takes NB = ceil(D / 64) whole boxes: at
// D = 80 TMA fills the second box's columns 80-127 with zeros (no product
// reads them) and its stores write nothing past column 79, so the byte
// counts are the boxes'.  NB = 2 (D = 80, 128): 2 x 64 KB of K and V and
// two stages of 32 KB, 194 KB (one buffer and three stages measured
// slower at D = 128); D = 64: four stages, 131 KB.
template <int D>
struct DkdvLayout {
  static constexpr int BK = 128, BQ = 64, NB = (D + 63) / 64;
  static constexpr int STAGES = NB == 2 ? 2 : 4, KVBUF = 2;
  static constexpr int KV_BOX = BK * 128, Q_BOX = BQ * 128;
  static constexpr int KV_BYTES = NB * KV_BOX, QT_BYTES = NB * Q_BOX;
  static constexpr int K_OFF = 0, V_OFF = KV_BYTES;  // buffer k: + 2k KV
  static constexpr int Q_OFF = KVBUF * 2 * KV_BYTES;  // stage s: Q, dO
  static constexpr int ROW_OFF = Q_OFF + STAGES * 2 * QT_BYTES;
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 3 * BQ * 4;
  static constexpr int ISLOT_OFF = BAR_OFF + 8 * (2 * KVBUF + 2 * STAGES);
  static constexpr int SLOT_OFF = ISLOT_OFF + 16 * KVBUF;
  static constexpr int BYTES = 1024 + SLOT_OFF + 16 * STAGES;
};

// A partial tile's element mask for the dK/dV kernel: bit e for the
// accumulator's element e (key row kp0 or kp1, query column acc_col).
__device__ __forceinline__ uint32_t dkdv_mask(const int* qp_s, int tq,
                                              int kp0, int kp1, int causal,
                                              int window) {
  uint32_t vis = 0u;
#pragma unroll
  for (int e = 0; e < 32; ++e)
    vis |= static_cast<uint32_t>(visible(qp_s[acc_col(e, tq)],
                                         (e & 2) ? kp1 : kp0, causal,
                                         window))
           << e;
  return vis;
}

template <int D>
__global__ void __launch_bounds__(384, 1) fa_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_dk,
    const __grid_constant__ CUtensorMap tm_dv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos, int Sq,
    int Sk, int H, int Hkv, int B, float scale, int causal, int window) {
  using L = DkdvLayout<D>;
  constexpr int BK = L::BK, BQ = L::BQ, ST = L::STAGES, KB = L::KVBUF;
  extern __shared__ uint8_t dkdv_smem[];
  const uint32_t raw = smem_u32(dkdv_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = dkdv_smem + (base - raw);
  const uint32_t bar = base + L::BAR_OFF;
  int4* islot = reinterpret_cast<int4*>(gbase + L::ISLOT_OFF);
  int4* slot = reinterpret_cast<int4*>(gbase + L::SLOT_OFF);
  float* rows = reinterpret_cast<float*>(gbase + L::ROW_OFF);
#define FULL_KV(k) (bar + 8 * (k))
#define EMPTY_KV(k) (bar + 8 * (KB + (k)))
#define FULL(s) (bar + 8 * (2 * KB + (s)))
#define EMPTY(s) (bar + 8 * (2 * KB + ST + (s)))
#define Q_STAGE(s) (base + L::Q_OFF + (s) * 2 * L::QT_BYTES)
#define KV_BUF(k) (base + (k) * 2 * L::KV_BYTES)

  const int n_kb = (Sk + BK - 1) / BK, n_qt = (Sq + BQ - 1) / BQ;
  const int n_items = n_kb * Hkv * B, rep = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int k = 0; k < KB; ++k) {
      mbar_init(FULL_KV(k), 1);
      mbar_init(EMPTY_KV(k), 2);  // one thread of each consumer warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(FULL(s), 32);    // every lane of the producer warp
      mbar_init(EMPTY(s), 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: one warp loads each item's K and V, then classes the
    // rep heads' query tiles (32 at a time, a lane a tile) and sends those
    // not skipped in a fixed order (Q and dO by TMA from lane 0, each lane
    // two rows' lse, D and position), then an end of item --------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 0) return;
    int ring = 0, n = 0;  // stages sent, items sent
    for (int item; (item = item_of(n, blockIdx.x, gridDim.x)) < n_items;
         ++n) {
      const int g = item / n_kb, k0 = item % n_kb * BK;
      const int hk = g % Hkv, b = g / Hkv;
      if (lane == 0) {
        const int kb = n % KB;
        mbar_wait(EMPTY_KV(kb), ((n / KB) & 1) ^ 1);
        islot[kb] = make_int4(b, hk, k0, 1);
        mbar_expect_tx(FULL_KV(kb), 2 * L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::NB; ++c) {
          tma_load_4d(KV_BUF(kb) + L::K_OFF + c * L::KV_BOX, &tm_k,
                      FULL_KV(kb), c * 64, hk, k0, b);
          tma_load_4d(KV_BUF(kb) + L::V_OFF + c * L::KV_BOX, &tm_v,
                      FULL_KV(kb), c * 64, hk, k0, b);
        }
      }
      int klo = INT_HI, khi = INT_LO;
      bool neg = false;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int j = k0 + lane * (BK / 32) + e;
        const int kp = j < Sk ? kpos[(long long)b * Sk + j] : -1;
        if (kp < 0) {
          neg = true;
        } else {
          klo = min(klo, kp);
          khi = max(khi, kp);
        }
      }
      warp_range(klo, khi);
      neg = __any_sync(0xffffffffu, neg);
      // the query tiles' classes, 32 at a time (a lane a tile), so that a
      // skipped tile costs no load of its own; then, for each rep head in
      // turn, the chunk's sent tiles in order
      for (int c0 = 0; c0 < n_qt && klo <= khi; c0 += 32) {
        int cl = TILE_SKIP;
        if (c0 + lane < n_qt) {
          const int i0 = (c0 + lane) * BQ, rows_in = min(BQ, Sq - i0);
          const int* qp_t = qpos + (long long)b * Sq + i0;
          int qlo = INT_HI, qhi = INT_LO;
#pragma unroll 16
          for (int i = 0; i < BQ; ++i) {
            if (i < rows_in) {
              const int qp = __ldg(qp_t + i);
              qlo = min(qlo, qp);
              qhi = max(qhi, qp);
            }
          }
          cl = tile_class(klo, khi, neg, qlo, qhi, causal, window);
        }
        const uint32_t part = __ballot_sync(0xffffffffu, cl == TILE_PARTIAL);
        const uint32_t sent = __ballot_sync(0xffffffffu, cl != TILE_SKIP);
        for (int hh = 0; hh < rep; ++hh) {
          const int h = hk * rep + hh;
          const long long lrow = ((long long)b * H + h) * Sq;
          for (uint32_t send = sent; send; send &= send - 1) {
            const int t = __ffs(send) - 1, q0 = (c0 + t) * BQ;
            int qp[2];
            float l2[2], dd[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = q0 + 2 * lane + e;
              const bool in = i < Sq;
              qp[e] = in ? qpos[(long long)b * Sq + i] : PAD_QPOS;
              l2[e] = in ? lse[lrow + i] * LOG2E : pos_inf();
              dd[e] = in ? delta[lrow + i] : 0.f;
            }
            const int s = ring % ST;
            mbar_wait(EMPTY(s), ((ring / ST) & 1) ^ 1);
            float* rs = rows + s * 3 * BQ;
            *reinterpret_cast<float2*>(rs + 2 * lane) =
                make_float2(l2[0], l2[1]);
            *reinterpret_cast<float2*>(rs + BQ + 2 * lane) =
                make_float2(dd[0], dd[1]);
            *reinterpret_cast<int2*>(rs + 2 * BQ + 2 * lane) =
                make_int2(qp[0], qp[1]);
            if (lane == 0) {
              slot[s] = make_int4(q0, h,
                                  (part >> t) & 1u ? TILE_PARTIAL : TILE_FULL,
                                  0);
              mbar_expect_tx(FULL(s), 2 * L::QT_BYTES);
#pragma unroll
              for (int c = 0; c < L::NB; ++c) {
                tma_load_4d(Q_STAGE(s) + c * L::Q_BOX, &tm_q, FULL(s),
                            c * 64, h, q0, b);
                tma_load_4d(Q_STAGE(s) + L::QT_BYTES + c * L::Q_BOX, &tm_do,
                            FULL(s), c * 64, h, q0, b);
              }
            } else {
              mbar_arrive(FULL(s));
            }
            ++ring;
          }
        }
      }
      const int s = ring % ST;  // the end of the item
      mbar_wait(EMPTY(s), ((ring / ST) & 1) ^ 1);
      if (lane == 0) slot[s] = make_int4(-1, 0, 0, 0);
      mbar_arrive(FULL(s));
      ++ring;
    }
    if (lane == 0) {  // no more items
      const int kb = n % KB;
      mbar_wait(EMPTY_KV(kb), ((n / KB) & 1) ^ 1);
      islot[kb] = make_int4(0, 0, 0, 0);
      mbar_arrive(FULL_KV(kb));
    }
    return;
  }

  // ---- two consumer warpgroups, 64 keys of each item each ---------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = warp / 4 - 1, wl = warp & 3, tq = lane & 3;
  const int r0 = 64 * w + 16 * wl + (lane >> 2), r1 = r0 + 8;  // item keys
  const float sl = scale * LOG2E;  // scores in log2 units
  float dk[D / 2], dv[D / 2], s[32], dp[32];
  uint32_t pf[4][4], sf[4][4];

  int ring = 0;  // stages consumed
  for (int n = 0;; ++n) {
    const int kb = n % KB;
    mbar_wait(FULL_KV(kb), (n / KB) & 1);
    const int4 it = islot[kb];
    if (!it.w) break;
    const int b = it.x, hk = it.y, k0 = it.z;
    const int kp0 = k0 + r0 < Sk ? kpos[(long long)b * Sk + k0 + r0] : -1;
    const int kp1 = k0 + r1 < Sk ? kpos[(long long)b * Sk + k0 + r1] : -1;
    const uint32_t ka = KV_BUF(kb) + L::K_OFF + w * 64 * 128;  // this
    const uint32_t va = KV_BUF(kb) + L::V_OFF + w * 64 * 128;  // WG's keys
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;

    int st;
    for (;;) {
      st = ring % ST;
      mbar_wait(FULL(st), (ring / ST) & 1);
      const int4 tile = slot[st];
      if (tile.x < 0) break;
      const uint32_t sq = Q_STAGE(st), sdo = sq + L::QT_BYTES;
      const float* rs = rows + st * 3 * BQ;
      // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x the
      // tile's 64 queries
      wgmma_fence();
      ss_64x64<D>(s, ka, L::KV_BOX, sq, L::Q_BOX);
      wgmma_commit();
      ss_64x64<D>(dp, va, L::KV_BOX, sdo, L::Q_BOX);
      wgmma_commit();
      const uint32_t vis =
          tile.z == TILE_PARTIAL
              ? dkdv_mask(reinterpret_cast<const int*>(rs + 2 * BQ), tq, kp0,
                          kp1, causal, window)
              : ~0u;
      wgmma_wait<1>();
      fence_regs<32>(s);
      // P^T = exp2(S^T scale log2(e) - lse), lse in log2 units a column
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = ex2(fmaf(s[e], sl, -rs[acc_col(e, tq)]));
        s[e] = (vis >> e) & 1u ? p : 0.f;
      }
      wgmma_wait<0>();
      fence_regs<32>(dp);
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = s[e] * (dp[e] - rs[BQ + acc_col(e, tq)]);
      pack_a(s, pf);
      pack_a(dp, sf);
      // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
      fence_regs<D / 2>(dv);
      fence_regs<D / 2>(dk);
      wgmma_fence();
      rs_64xD<D>(dv, pf, sdo, L::Q_BOX);
      rs_64xD<D>(dk, sf, sq, L::Q_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dv);
      fence_regs<D / 2>(dk);
      fence_af(pf);
      fence_af(sf);
      mbar_arrive(EMPTY(st));
      ++ring;
    }
    mbar_arrive(EMPTY(st));  // the end of the item holds no tile
    ++ring;

    // ---- epilogue: this warpgroup's rows of K and V are read out: dK
    // (times scale) and dV take their place, one TMA store each ---------
    stage_out<D>(gbase + kb * 2 * L::KV_BYTES + L::K_OFF, BK, r0, tq, dk,
                 scale);
    stage_out<D>(gbase + kb * 2 * L::KV_BYTES + L::V_OFF, BK, r0, tq, dv,
                 1.f);
    fence_proxy_async();
    wg_sync(w);
    if ((tid & 127) == 0) {
      if (k0 + 64 * w < Sk) {
#pragma unroll
        for (int c = 0; c < L::NB; ++c) {
          tma_store_4d(&tm_dk, ka + c * L::KV_BOX, c * 64, hk, k0 + 64 * w,
                       b);
          tma_store_4d(&tm_dv, va + c * L::KV_BOX, c * 64, hk, k0 + 64 * w,
                       b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      mbar_arrive(EMPTY_KV(kb));  // the buffer may load a later item
    }
  }
#undef FULL_KV
#undef EMPTY_KV
#undef FULL
#undef EMPTY
#undef Q_STAGE
#undef KV_BUF
}

// Shared memory of the dQ kernel, from a 1024-byte aligned base: two
// buffers of an item's Q and dO (128 queries each), a ring of STAGES K and
// V tiles of 64 keys, the mbarriers (Q full and Q empty per buffer; full
// and empty per stage), one slot per buffer naming its item (b, h, q0;
// w = 0 ends the work) and one per stage naming its tile (index and
// class; index -1 ends the item).  Whole boxes, as in DkdvLayout.  NB =
// 2 (D = 80, 128): 128 KB of Q and dO and three stages of 32 KB, 225 KB;
// D = 64: four stages, 129 KB.
template <int D>
struct DqLayout {
  static constexpr int BQ = 128, BK = 64, NB = (D + 63) / 64;
  static constexpr int STAGES = NB == 2 ? 3 : 4, QBUF = 2;
  static constexpr int Q_BOX = BQ * 128, K_BOX = BK * 128;
  static constexpr int Q_BYTES = NB * Q_BOX, KV_BYTES = NB * K_BOX;
  static constexpr int K_OFF = QBUF * 2 * Q_BYTES;  // stage s: K, then V
  static constexpr int BAR_OFF = K_OFF + STAGES * 2 * KV_BYTES;
  static constexpr int ISLOT_OFF = BAR_OFF + 8 * (2 * QBUF + 2 * STAGES);
  static constexpr int SLOT_OFF = ISLOT_OFF + 16 * QBUF;
  static constexpr int BYTES = 1024 + SLOT_OFF + 8 * STAGES;
};

// A partial tile's element mask for the dQ kernel: bit e for the
// accumulator's element e (query row qp0 or qp1, key acc_col of the tile
// at k0; a key past Sk has position -1).
__device__ __forceinline__ uint32_t dq_mask(const int* kp_row, int k0, int Sk,
                                            int tq, int qp0, int qp1,
                                            int causal, int window) {
  uint32_t vis = 0u;
#pragma unroll
  for (int e = 0; e < 32; e += 4) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int col = k0 + acc_col(e + x, tq);
      const int kp = col < Sk ? __ldg(kp_row + col) : -1;
      vis |= static_cast<uint32_t>(visible(qp0, kp, causal, window))
             << (e + x);
      vis |= static_cast<uint32_t>(visible(qp1, kp, causal, window))
             << (e + 2 + x);
    }
  }
  return vis;
}

template <int D>
__global__ void __launch_bounds__(384, 1) fa_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_dq,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos, int Sq,
    int Sk, int H, int Hkv, int B, float scale, int causal, int window) {
  using L = DqLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES, QB = L::QBUF;
  extern __shared__ uint8_t dq_smem[];
  const uint32_t raw = smem_u32(dq_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = dq_smem + (base - raw);
  const uint32_t bar = base + L::BAR_OFF;
  int4* islot = reinterpret_cast<int4*>(gbase + L::ISLOT_OFF);
  int2* slot = reinterpret_cast<int2*>(gbase + L::SLOT_OFF);
#define Q_BUF(q) (base + (q) * 2 * L::Q_BYTES)
#define FULL_Q(q) (bar + 8 * (q))
#define EMPTY_Q(q) (bar + 8 * (QB + (q)))
#define FULL(s) (bar + 8 * (2 * QB + (s)))
#define EMPTY(s) (bar + 8 * (2 * QB + ST + (s)))
#define K_STAGE(s) (base + L::K_OFF + (s) * 2 * L::KV_BYTES)

  const int n_qb = (Sq + BQ - 1) / BQ, n_kb = (Sk + BK - 1) / BK;
  const int n_items = n_qb * H * B, rep = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int q = 0; q < QB; ++q) {
      mbar_init(FULL_Q(q), 1);
      mbar_init(EMPTY_Q(q), 2);  // one thread of each consumer warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(FULL(s), 1);
      mbar_init(EMPTY(s), 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: for each item one warp loads Q and dO, classes the
    // KV tiles (32 at a time, a lane a tile) and sends those not skipped
    // through the ring in order (one thread issues every TMA copy), then
    // an end of item ----------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 0) return;
    int ring = 0, n = 0;  // stages sent, items sent
    for (int item; (item = item_of(n, blockIdx.x, gridDim.x)) < n_items;
         ++n) {
      // the forward's order: the rep heads of one KV head next to each
      // other, the query blocks of that KV head and batch row heaviest
      // (causal: last) first
      const int g = item / rep / n_qb;  // (batch row, KV head)
      const int hk = g % Hkv, b = g / Hkv;
      const int h = hk * rep + item % rep;
      const int q0 = (n_qb - 1 - item / rep % n_qb) * BQ;
      if (lane == 0) {
        const int q = n % QB;
        mbar_wait(EMPTY_Q(q), ((n / QB) & 1) ^ 1);
        islot[q] = make_int4(b, h, q0, 1);
        mbar_expect_tx(FULL_Q(q), 2 * L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < L::NB; ++c) {
          tma_load_4d(Q_BUF(q) + c * L::Q_BOX, &tm_q, FULL_Q(q), c * 64, h,
                      q0, b);
          tma_load_4d(Q_BUF(q) + L::Q_BYTES + c * L::Q_BOX, &tm_do,
                      FULL_Q(q), c * 64, h, q0, b);
        }
      }
      int qlo = INT_HI, qhi = INT_LO;  // the block's rows before Sq
#pragma unroll
      for (int e = 0; e < BQ / 32; ++e) {
        const int i = q0 + lane * (BQ / 32) + e;
        if (i < Sq) {
          const int qp = qpos[(long long)b * Sq + i];
          qlo = min(qlo, qp);
          qhi = max(qhi, qp);
        }
      }
      warp_range(qlo, qhi);
      // the KV tiles' classes, 32 at a time (a lane a tile), so that a
      // skipped tile costs no load of its own; then the sent ones in turn
      for (int c0 = 0; c0 < n_kb; c0 += 32) {
        int cl = TILE_SKIP;
        if (c0 + lane < n_kb) {
          const int j0 = (c0 + lane) * BK, keys_in = min(BK, Sk - j0);
          const int* kp_t = kpos + (long long)b * Sk + j0;
          int lo = INT_HI, hi = INT_LO;
          bool neg = keys_in < BK;  // keys past Sk
#pragma unroll 16
          for (int j = 0; j < BK; ++j) {
            if (j < keys_in) {
              const int kp = __ldg(kp_t + j);
              if (kp < 0) {
                neg = true;
              } else {
                lo = min(lo, kp);
                hi = max(hi, kp);
              }
            }
          }
          cl = tile_class(lo, hi, neg, qlo, qhi, causal, window);
        }
        const uint32_t part = __ballot_sync(0xffffffffu, cl == TILE_PARTIAL);
        for (uint32_t send = __ballot_sync(0xffffffffu, cl != TILE_SKIP);
             send; send &= send - 1) {
          const int t = c0 + __ffs(send) - 1;
          if (lane == 0) {
            const int s = ring % ST;
            mbar_wait(EMPTY(s), ((ring / ST) & 1) ^ 1);
            slot[s] = make_int2(t, (part >> (t - c0)) & 1u ? TILE_PARTIAL
                                                            : TILE_FULL);
            mbar_expect_tx(FULL(s), 2 * L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < L::NB; ++c) {
              tma_load_4d(K_STAGE(s) + c * L::K_BOX, &tm_k, FULL(s), c * 64,
                          hk, t * BK, b);
              tma_load_4d(K_STAGE(s) + L::KV_BYTES + c * L::K_BOX, &tm_v,
                          FULL(s), c * 64, hk, t * BK, b);
            }
          }
          __syncwarp();
          ++ring;
        }
      }
      if (lane == 0) {  // the end of the item
        const int s = ring % ST;
        mbar_wait(EMPTY(s), ((ring / ST) & 1) ^ 1);
        slot[s] = make_int2(-1, 0);  // published below
        mbar_arrive(FULL(s));
      }
      __syncwarp();
      ++ring;
    }
    if (lane == 0) {  // no more items
      const int q = n % QB;
      mbar_wait(EMPTY_Q(q), ((n / QB) & 1) ^ 1);
      islot[q] = make_int4(0, 0, 0, 0);
      mbar_arrive(FULL_Q(q));
    }
    return;
  }

  // ---- two consumer warpgroups, 64 query rows of each item each --------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = warp / 4 - 1, wl = warp & 3, tq = lane & 3;
  const int r0 = 64 * w + 16 * wl + (lane >> 2), r1 = r0 + 8;  // item rows
  const float sl = scale * LOG2E;  // scores in log2 units
  float dq[D / 2], s[32], dp[32];
  uint32_t sf[4][4];

  int ring = 0;  // stages consumed
  for (int n = 0;; ++n) {
    const int q = n % QB;
    mbar_wait(FULL_Q(q), (n / QB) & 1);
    const int4 it = islot[q];
    if (!it.w) break;
    const int b = it.x, h = it.y, q0 = it.z;
    const bool in0 = q0 + r0 < Sq, in1 = q0 + r1 < Sq;
    const long long lrow = ((long long)b * H + h) * Sq + q0;
    const int qp0 = in0 ? qpos[(long long)b * Sq + q0 + r0] : PAD_QPOS;
    const int qp1 = in1 ? qpos[(long long)b * Sq + q0 + r1] : PAD_QPOS;
    const float ls0 = in0 ? lse[lrow + r0] * LOG2E : pos_inf();
    const float ls1 = in1 ? lse[lrow + r1] * LOG2E : pos_inf();
    const float dd0 = in0 ? delta[lrow + r0] : 0.f;
    const float dd1 = in1 ? delta[lrow + r1] : 0.f;
    const int* kp_row = kpos + (long long)b * Sk;
    const uint32_t qa = Q_BUF(q) + w * 64 * 128;  // this warpgroup's rows
    const uint32_t da = qa + L::Q_BYTES;          // of Q and dO
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;

    int st;
    for (;;) {
      st = ring % ST;
      mbar_wait(FULL(st), (ring / ST) & 1);
      const int2 tile = slot[st];
      if (tile.x < 0) break;
      const uint32_t sk = K_STAGE(st), sv = sk + L::KV_BYTES;
      // S = Q K^T and dP = dO V^T: this warpgroup's 64 rows x 64 keys
      wgmma_fence();
      ss_64x64<D>(s, qa, L::Q_BOX, sk, L::K_BOX);
      wgmma_commit();
      ss_64x64<D>(dp, da, L::Q_BOX, sv, L::K_BOX);
      wgmma_commit();
      const uint32_t vis = tile.y == TILE_PARTIAL
                               ? dq_mask(kp_row, tile.x * BK, Sk, tq, qp0,
                                         qp1, causal, window)
                               : ~0u;
      wgmma_wait<1>();
      fence_regs<32>(s);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float p = ex2(fmaf(s[e], sl, -((e & 2) ? ls1 : ls0)));
        s[e] = (vis >> e) & 1u ? p : 0.f;
      }
      wgmma_wait<0>();
      fence_regs<32>(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e)
        dp[e] = s[e] * (dp[e] - ((e & 2) ? dd1 : dd0));
      pack_a(dp, sf);
      // dQ += dS K, K read MN-major
      fence_regs<D / 2>(dq);
      wgmma_fence();
      rs_64xD<D>(dq, sf, sk, L::K_BOX);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(dq);
      fence_af(sf);
      mbar_arrive(EMPTY(st));
      ++ring;
    }
    mbar_arrive(EMPTY(st));  // the end of the item holds no tile
    ++ring;

    // ---- epilogue: this warpgroup's rows of Q are read out: dQ (times
    // scale) takes their place, one TMA store ----------------------------
    stage_out<D>(gbase + q * 2 * L::Q_BYTES, BQ, r0, tq, dq, scale);
    fence_proxy_async();
    wg_sync(w);
    if ((tid & 127) == 0) {
      if (q0 + 64 * w < Sq) {
#pragma unroll
        for (int c = 0; c < L::NB; ++c)
          tma_store_4d(&tm_dq, qa + c * L::Q_BOX, c * 64, h, q0 + 64 * w, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      mbar_arrive(EMPTY_Q(q));  // the buffer may load the next item
    }
  }
#undef Q_BUF
#undef FULL_Q
#undef EMPTY_Q
#undef FULL
#undef EMPTY
#undef K_STAGE
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, full float32 products; 32 x 32 tiles, four threads
// a row (r = tid / 4), each taking every fourth key or query and column
// ---------------------------------------------------------------------------
constexpr int F_B = 32, F_PS = F_B + 1;

template <int DK, int DV>
constexpr int f32_dkdv_smem() {
  return (2 * F_B * (DK + 1) + 2 * F_B * (DV + 1) + 2 * F_B * F_PS +
          4 * F_B) * 4;
}

template <int DK, int DV>
constexpr int f32_dq_smem() {
  return (2 * F_B * (DK + 1) + 2 * F_B * (DV + 1) + F_B * F_PS + 2 * F_B) *
         4;
}

// dK and dV of 32 keys of a KV head.  V's rows are `ldv` apart (DK where V
// is K's first DV columns).  FOLD (V is K's prefix): dV is added into
// dK's first DV columns and dv is not written.
template <int DK, int DV, bool FOLD>
__global__ void __launch_bounds__(128, 1) fa_bwd_dkdv_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H,
    int Hkv, float scale, int causal, int window, int ldv) {
  constexpr int RK = DK + 1, RV = DV + 1;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  float* k_s = reinterpret_cast<float*>(bwd_smem);  // [32][DK+1]
  float* q_s = k_s + F_B * RK;                       // [32][DK+1]
  float* v_s = q_s + F_B * RK;                       // [32][DV+1]
  float* do_s = v_s + F_B * RV;                      // [32][DV+1]
  float* p_s = do_s + F_B * RV;  // [key][query]
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
  for (int e = tid; e < F_B * DK; e += 128) {
    const int j = e / DK, d = e % DK;
    k_s[j * RK + d] =
        k0 + j < Sk ? k[(((long long)b * Sk + k0 + j) * Hkv + hk) * DK + d]
                    : 0.f;
  }
  for (int e = tid; e < F_B * DV; e += 128) {
    const int j = e / DV, d = e % DV;
    v_s[j * RV + d] =
        k0 + j < Sk ? v[(((long long)b * Sk + k0 + j) * Hkv + hk) * ldv + d]
                    : 0.f;
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

  float dka[DK / 4], dva[DV / 4];
#pragma unroll
  for (int t = 0; t < DK / 4; ++t) dka[t] = 0.f;
#pragma unroll
  for (int t = 0; t < DV / 4; ++t) dva[t] = 0.f;

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
      for (int e = tid; e < F_B * DK; e += 128) {
        const int i = e / DK, d = e % DK;
        q_s[i * RK + d] =
            q0 + i < Sq ? q[(((long long)b * Sq + q0 + i) * H + h) * DK + d]
                        : 0.f;
      }
      for (int e = tid; e < F_B * DV; e += 128) {
        const int i = e / DV, d = e % DV;
        do_s[i * RV + d] =
            q0 + i < Sq
                ? dout[(((long long)b * Sq + q0 + i) * H + h) * DV + d]
                : 0.f;
      }
      __syncthreads();
      // P^T and dS^T for key r and queries c, c + 4, ..., c + 28
#pragma unroll
      for (int ii = 0; ii < F_B / 4; ++ii) {
        const int i = c + 4 * ii;
        float sd = 0.f, gd = 0.f;
#pragma unroll 8
        for (int d = 0; d < DK; ++d)
          sd = fmaf(k_s[r * RK + d], q_s[i * RK + d], sd);
#pragma unroll 8
        for (int d = 0; d < DV; ++d)
          gd = fmaf(v_s[r * RV + d], do_s[i * RV + d], gd);
        const bool vis = !partial || visible(qp_s[i], kp, causal, window);
        const float p = vis ? expf(sd * scale - lse_s[i]) : 0.f;
        p_s[r * F_PS + i] = p;
        ds_s[r * F_PS + i] = p * (gd - dd_s[i]);
      }
      __syncwarp();  // the row's P and dS (written by its quad) are visible
#pragma unroll
      for (int t = 0; t < DK / 4; ++t) {
        const int d = c + 4 * t;
        float sq = 0.f;
#pragma unroll 8
        for (int i = 0; i < F_B; ++i)
          sq = fmaf(ds_s[r * F_PS + i], q_s[i * RK + d], sq);
        dka[t] += sq;
      }
#pragma unroll
      for (int t = 0; t < DV / 4; ++t) {
        const int d = c + 4 * t;
        float pv = 0.f;
#pragma unroll 8
        for (int i = 0; i < F_B; ++i)
          pv = fmaf(p_s[r * F_PS + i], do_s[i * RV + d], pv);
        dva[t] += pv;
      }
      __syncwarp();
    }
  }

  if (k0 + r < Sk) {
    const long long row = ((long long)b * Sk + k0 + r) * Hkv + hk;
#pragma unroll
    for (int t = 0; t < DK / 4; ++t) {
      float x = dka[t] * scale;
      if constexpr (FOLD) {
        if (t < DV / 4) x += dva[t];
      }
      dk[row * DK + c + 4 * t] = x;
    }
    if constexpr (!FOLD) {
#pragma unroll
      for (int t = 0; t < DV / 4; ++t) dv[row * DV + c + 4 * t] = dva[t];
    }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(128, 1) fa_bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    float* __restrict__ dq, int Sq, int Sk, int H, int Hkv, float scale,
    int causal, int window, int ldv) {
  constexpr int RK = DK + 1, RV = DV + 1;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  float* q_s = reinterpret_cast<float*>(bwd_smem);  // [32][DK+1]
  float* k_s = q_s + F_B * RK;                       // [32][DK+1]
  float* do_s = k_s + F_B * RK;                      // [32][DV+1]
  float* v_s = do_s + F_B * RV;                      // [32][DV+1]
  float* ds_s = v_s + F_B * RV;  // [query][key]
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
  for (int e = tid; e < F_B * DK; e += 128) {
    const int i = e / DK, d = e % DK;
    q_s[i * RK + d] =
        q0 + i < Sq ? q[(((long long)b * Sq + q0 + i) * H + h) * DK + d]
                    : 0.f;
  }
  for (int e = tid; e < F_B * DV; e += 128) {
    const int i = e / DV, d = e % DV;
    do_s[i * RV + d] =
        q0 + i < Sq ? dout[(((long long)b * Sq + q0 + i) * H + h) * DV + d]
                    : 0.f;
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

  float dqa[DK / 4];
#pragma unroll
  for (int t = 0; t < DK / 4; ++t) dqa[t] = 0.f;

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
    for (int e = tid; e < F_B * DK; e += 128) {
      const int j = e / DK, d = e % DK;
      k_s[j * RK + d] =
          k0 + j < Sk ? k[(((long long)b * Sk + k0 + j) * Hkv + hk) * DK + d]
                      : 0.f;
    }
    for (int e = tid; e < F_B * DV; e += 128) {
      const int j = e / DV, d = e % DV;
      v_s[j * RV + d] =
          k0 + j < Sk
              ? v[(((long long)b * Sk + k0 + j) * Hkv + hk) * ldv + d]
              : 0.f;
    }
    __syncthreads();
    // dS for row r and keys c, c + 4, ..., c + 28
#pragma unroll
    for (int jj = 0; jj < F_B / 4; ++jj) {
      const int j = c + 4 * jj;
      float sd = 0.f, gd = 0.f;
#pragma unroll 8
      for (int d = 0; d < DK; ++d)
        sd = fmaf(q_s[r * RK + d], k_s[j * RK + d], sd);
#pragma unroll 8
      for (int d = 0; d < DV; ++d)
        gd = fmaf(do_s[r * RV + d], v_s[j * RV + d], gd);
      const bool vis = !partial || visible(qp, kp_s[j], causal, window);
      const float p = vis ? expf(sd * scale - lr) : 0.f;
      ds_s[r * F_PS + j] = p * (gd - ddr);
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < DK / 4; ++t) {
      const int d = c + 4 * t;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < F_B; ++j)
        acc = fmaf(ds_s[r * F_PS + j], k_s[j * RK + d], acc);
      dqa[t] += acc;
    }
    __syncwarp();
  }

  if (in) {
    float* row = dq + (((long long)b * Sq + q0 + r) * H + h) * DK;
#pragma unroll
    for (int t = 0; t < DK / 4; ++t) row[c + 4 * t] = dqa[t] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16 at (32, 16), (32, 32) and (80, 64): mma.sync m16n8k16 kernels, one
// template for both gradients
// ---------------------------------------------------------------------------
// A CTA of 8 warps holds one resident tile of 64 rows and streams units
// of 32 rows past it, two units in flight (cp.async into a double
// buffer); a unit with no visible pair is never loaded (`tile_class`):
//
// - dK (and dV): resident 64 keys of one KV head (K, and V unless V is
//   K's prefix), streamed units of 32 (query, head) rows of the KV head's
//   rep query heads in q's own layout (row rr is query rr / rep of head
//   hk * rep + rr % rep: the rep heads share each K tile), Q and dO;
// - dQ: resident 64 (query, head) rows (Q and dO), streamed units of 32
//   keys (K, and V unless it is K's prefix).
//
// Each unit takes two steps.  (1) S = R1 S1^T (depth Dk) and dP = R2
// S2^T (depth Dv) for the 64 x 32 pairs, a 16 x 16 block a warp, with P
// and dS formed in registers and written as bf16 to shared memory.  (2)
// The output tile (64 rows x Dk, float32 in registers) takes dS times the
// unit's rows of K (dQ) or Q (dK) and, for dK, P times the unit's dO into
// dV, or into dK's first Dv columns where V is K's prefix (FOLD).  The
// output's columns are split across the warps, two column halves by four
// row quarters.  B operands are read with ldmatrix (.trans where the
// product runs along the unit's rows), so nothing is transposed in
// memory.
//
// Where the scale enters: with FOLD one accumulator takes dS^T Q and P^T
// dO, so dS is scaled before its bf16 rounding, bf16(scale dS), and the
// same rounded dS gives dQ = bf16(scale dS) K; without FOLD dS is rounded
// unscaled and the outputs are scaled once (`ref.attention_bwd`).
template <int DK, int DV>
struct MmaBwd {
  static constexpr int BR = 64, BS = 32;       // resident rows, unit rows
  static constexpr int WN = 2, WM = 4;  // warps across columns, rows
  static constexpr int MTW = 4 / WM;           // m16 tiles a warp
  static constexpr int NTW = DK / 8 / WN;      // n8 tiles a warp (dK, dQ)
  static constexpr int NTV = DV / 8 / WN;      // n8 tiles a warp (dV)
  static constexpr int SK = DK + 8, SV = DV + 8, SP = BS + 8;  // strides
  static_assert(DK % 16 == 0 && DV % 16 == 0 && DK >= DV, "head sizes");
  static_assert((DK / 8) % WN == 0 && (DV / 8) % WN == 0, "column split");
  // shared memory (bytes): the resident tiles, the two stages of the
  // streamed ones, P and dS, the unit classes and the per-row scalars
  static constexpr int R1 = BR * SK * 2, R2 = BR * SV * 2;
  static constexpr int U1 = BS * SK * 2, U2 = BS * SV * 2;
  static constexpr int PT = BR * SP * 2;
  static constexpr int bytes(bool dq, bool fold) {
    return R1 + (!dq && fold ? 0 : R2) + 2 * U1 + (dq && fold ? 0 : 2 * U2) +
           (dq ? 1 : 2) * PT + 256 + BR * 4 + 2 * BS * 12;
  }
};

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_t2(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}
// The lane's address of an ldmatrix over the 16 x 16 block at (r0, c0) of
// a row-major tile: `at_a` gives with ldsm the A fragment of rows r0..
// along k = c0.., and with ldsm_t the B fragments of k rows r0.. for the
// n8 tiles c0 and c0 + 8 (ldsm_t2: c0 alone); `at_b` gives with ldsm the
// B fragments of n rows r0.. and r0 + 8 along k = c0...
__device__ __forceinline__ const bf16* at_a(const bf16* t, int stride,
                                            int r0, int c0) {
  const int l = threadIdx.x & 31;
  return t + (r0 + (l & 15)) * stride + c0 + (l >> 4) * 8;
}
__device__ __forceinline__ const bf16* at_b(const bf16* t, int stride,
                                            int r0, int c0) {
  const int l = threadIdx.x & 31;
  return t + (r0 + (l & 7) + (l >> 4) * 8) * stride + c0 +
         ((l >> 3) & 1) * 8;
}
__device__ __forceinline__ void cp16(bf16* dst, const bf16* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// acc[i][t] += A_i B_t over 16 of the depth, for the warp's MT m16 tiles
// (A fragments `a`) and n8 tiles t = 0.. NT - 1 starting at column `c0`
// of the row-major tile `bt` (stride `ld`, k rows from `k0`): the B
// fragments by ldmatrix.trans, two n8 tiles a load.  Only the tiles below
// column `lim` (a multiple of 8, uniform across the warp) are taken.
template <int MT, int NT>
__device__ __forceinline__ void mma_rows(float (*acc)[NT][4],
                                         const uint32_t (*a)[4],
                                         const bf16* bt, int ld, int k0,
                                         int c0, int lim) {
#pragma unroll
  for (int t = 0; t < NT; t += 2) {
    const int c = c0 + 8 * t;
    if (t + 1 < NT && c + 8 < lim) {
      uint32_t b[4];
      ldsm_t(b, at_a(bt, ld, k0, c));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16(acc[i][t], a[i], b[0], b[1]);
        mma_bf16(acc[i][t + 1], a[i], b[2], b[3]);
      }
    } else if (c < lim) {
      uint32_t b[2];
      ldsm_t2(b, at_a(bt, ld, k0, c));
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_bf16(acc[i][t], a[i], b[0], b[1]);
    }
  }
}

// The gradient's kernel body: DQ picks dQ (else dK and dV); FOLD: V is
// K's first DV columns (v == k, rows DK apart), dV goes into dK and `o2`
// is unused.  o1 is dq or dk, o2 dv.
template <int DK, int DV, bool FOLD, bool DQ>
__device__ __forceinline__ void bwd_mma_body(
    uint8_t* smem, const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    bf16* __restrict__ o1, bf16* __restrict__ o2, int Sq, int Sk, int H,
    int Hkv, float scale, int causal, int window) {
  using C = MmaBwd<DK, DV>;
  constexpr int BR = C::BR, BS = C::BS, SK = C::SK, SV = C::SV, SP = C::SP;
  constexpr int MTW = C::MTW, NTW = C::NTW, NTV = C::NTV;
  constexpr bool R2_OWN = !(!DQ && FOLD), U2_OWN = !(DQ && FOLD);
  // strides of the second resident and streamed operands (V or dO)
  constexpr int SR2 = R2_OWN ? SV : SK, SU2 = U2_OWN ? SV : SK;
  constexpr int ldv = FOLD ? DK : DV;

  bf16* r1 = reinterpret_cast<bf16*>(smem);
  bf16* r2 = R2_OWN ? r1 + BR * SK : r1;
  bf16* u1 = reinterpret_cast<bf16*>(smem + C::R1 + (R2_OWN ? C::R2 : 0));
  bf16* u2 = U2_OWN ? u1 + 2 * BS * SK : u1;
  bf16* ds_s = reinterpret_cast<bf16*>(
      reinterpret_cast<uint8_t*>(u1) + 2 * C::U1 + (U2_OWN ? 2 * C::U2 : 0));
  bf16* p_s = ds_s + BR * SP;  // dK only
  uint8_t* cls_s = reinterpret_cast<uint8_t*>(ds_s) + (DQ ? 1 : 2) * C::PT;
  int* rp_s = reinterpret_cast<int*>(cls_s + 256);  // resident positions
  int* up_s = rp_s + BR;                            // [2][BS] unit positions
  float* ul_s = reinterpret_cast<float*>(up_s + 2 * BS);  // [2][BS] lse
  float* ud_s = ul_s + 2 * BS;                            // [2][BS] D

  const int rep = H / Hkv, rows = Sq * rep;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const float sl = scale * LOG2E;
  // the resident block: 64 keys (dK, lightest last) or 64 rows (dQ,
  // heaviest first)
  const int n_res = DQ ? (rows + BR - 1) / BR : (Sk + BR - 1) / BR;
  const int r0 = (DQ ? n_res - 1 - (int)blockIdx.x : (int)blockIdx.x) * BR;
  const int n_units = DQ ? (Sk + BS - 1) / BS : (rows + BS - 1) / BS;

  // a (query, head) row's global row of q / dout, and a key's of k / v
  auto qrow = [&](int rr) -> long long {
    return ((long long)b * Sq + rr / rep) * H + hk * rep + rr % rep;
  };
  auto krow = [&](int j) -> long long {
    return ((long long)b * Sk + j) * Hkv + hk;
  };
  // 16-byte copies of `n` rows from `first` on: `dst` (stride ds), `src`
  // rows of `cols` elements (global stride gs), zeros past the end
  auto load_rows = [&](bf16* dst, int ds, const bf16* src, long long gs,
                       int cols, int first, int n, bool keys) {
    const int chunks = cols / 8;
    for (int e = tid; e < n * chunks; e += 256) {
      const int r = e / chunks, c = (e % chunks) * 8, x = first + r;
      const bool in = keys ? x < Sk : x < rows;
      const long long g = in ? (keys ? krow(x) : qrow(x)) : 0;
      cp16(dst + r * ds + c, src + g * gs + c, in);
    }
  };

  // ---- the resident tile, its positions and its position range ---------
  if constexpr (DQ) {
    load_rows(r1, SK, q, DK, DK, r0, BR, false);
    load_rows(r2, SV, dout, DV, DV, r0, BR, false);
  } else {
    load_rows(r1, SK, k, DK, DK, r0, BR, true);
    if constexpr (R2_OWN) load_rows(r2, SV, v, ldv, DV, r0, BR, true);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (tid < BR) {
    const int x = r0 + tid;
    rp_s[tid] = DQ ? (x < rows ? qpos[(long long)b * Sq + x / rep] : PAD_QPOS)
                   : (x < Sk ? kpos[(long long)b * Sk + x] : -1);
  }
  __syncthreads();
  int lo = INT_HI, hi = INT_LO;
  bool neg = false;
  for (int x = 0; x < BR; ++x) {
    const int p = rp_s[x];
    if (DQ ? r0 + x < rows : p >= 0) {
      lo = min(lo, p);
      hi = max(hi, p);
    } else {
      neg = true;
    }
  }
  // this thread's resident rows in step (1): m-tile warp & 3
  const int m0 = 16 * (warp & 3) + gr, m1 = m0 + 8;
  const int rp0 = rp_s[m0], rp1 = rp_s[m1];
  float rl0 = 0.f, rl1 = 0.f, rd0 = 0.f, rd1 = 0.f;  // dQ: lse (log2), D
  if constexpr (DQ) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int rr = r0 + (x ? m1 : m0);
      float l2 = pos_inf(), d = 0.f;
      if (rr < rows) {
        const long long li =
            ((long long)b * H + hk * rep + rr % rep) * Sq + rr / rep;
        l2 = lse[li] * LOG2E;
        d = delta[li];
      }
      (x ? rl1 : rl0) = l2;
      (x ? rd1 : rd0) = d;
    }
  }

  // ---- the units' classes, 256 at a time, a thread a unit ---------------
  int chunk0 = INT_LO / 2;
  auto classify = [&](int c0) {
    __syncthreads();  // every thread is done with the last chunk
    const int u = c0 + tid;
    uint8_t cl = TILE_SKIP;
    if (u < n_units) {
      if constexpr (DQ) {  // 32 keys against the resident rows
        int kmin = INT_HI, kmax = INT_LO;
        bool kneg = false;
        for (int j = u * BS; j < u * BS + BS; ++j) {
          const int p = j < Sk ? __ldg(kpos + (long long)b * Sk + j) : -1;
          if (p < 0) {
            kneg = true;
          } else {
            kmin = min(kmin, p);
            kmax = max(kmax, p);
          }
        }
        cl = tile_class(kmin, kmax, kneg, lo, hi, causal, window);
      } else {  // 32 rows (their queries) against the resident keys
        int qmin = INT_HI, qmax = INT_LO;
        const int last = min(u * BS + BS, rows) - 1;
        for (int i = u * BS / rep; i <= last / rep; ++i) {
          const int p = __ldg(qpos + (long long)b * Sq + i);
          qmin = min(qmin, p);
          qmax = max(qmax, p);
        }
        cl = tile_class(lo, hi, neg, qmin, qmax, causal, window);
      }
    }
    cls_s[tid] = cl;
    __syncthreads();
    chunk0 = c0;
  };
  // the first unit from u on that some pair sees (n_units: none), and its
  // class
  auto next_unit = [&](int u, uint8_t* cl) -> int {
    for (; u < n_units; ++u) {
      if (u >= chunk0 + 256) classify(u);
      const uint8_t c = cls_s[u - chunk0];
      if (c != TILE_SKIP) {
        *cl = c;
        return u;
      }
    }
    return n_units;
  };
  // a unit's tiles into stage s, and its rows' positions (and lse, D)
  auto prefetch = [&](int u, int s) {
    const int first = u * BS;
    if constexpr (DQ) {
      load_rows(u1 + s * BS * SK, SK, k, DK, DK, first, BS, true);
      if constexpr (U2_OWN)
        load_rows(u2 + s * BS * SV, SV, v, ldv, DV, first, BS, true);
    } else {
      load_rows(u1 + s * BS * SK, SK, q, DK, DK, first, BS, false);
      load_rows(u2 + s * BS * SV, SV, dout, DV, DV, first, BS, false);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (tid < BS) {
      const int x = first + tid;
      if constexpr (DQ) {
        up_s[s * BS + tid] =
            x < Sk ? __ldg(kpos + (long long)b * Sk + x) : -1;
      } else {
        int p = PAD_QPOS;
        float l2 = pos_inf(), d = 0.f;
        if (x < rows) {
          const long long li =
              ((long long)b * H + hk * rep + x % rep) * Sq + x / rep;
          p = __ldg(qpos + (long long)b * Sq + x / rep);
          l2 = __ldg(lse + li) * LOG2E;
          d = __ldg(delta + li);
        }
        up_s[s * BS + tid] = p;
        ul_s[s * BS + tid] = l2;
        ud_s[s * BS + tid] = d;
      }
    }
  };

  // ---- the output tile: m16 tiles wm * MTW.., n8 tiles wn * NTW.. -------
  const int wm = warp / C::WN, wn = warp % C::WN;
  float acc[MTW][NTW][4];
  float accv[MTW][(DQ || FOLD) ? 1 : NTV][4];
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
#pragma unroll
    for (int t = 0; t < NTW; ++t)
      acc[i][t][0] = acc[i][t][1] = acc[i][t][2] = acc[i][t][3] = 0.f;
#pragma unroll
    for (int t = 0; t < ((DQ || FOLD) ? 1 : NTV); ++t)
      accv[i][t][0] = accv[i][t][1] = accv[i][t][2] = accv[i][t][3] = 0.f;
  }

  uint8_t cl_cur = TILE_SKIP, cl_nxt = TILE_SKIP;
  int cur = next_unit(0, &cl_cur);
  if (cur < n_units) prefetch(cur, 0);
  for (int it = 0; cur < n_units; ++it) {
    const int nxt = next_unit(cur + 1, &cl_nxt);
    const int s = it & 1;
    if (nxt < n_units) {
      prefetch(nxt, s ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const bf16* t1 = u1 + s * BS * SK;
    const bf16* t2 = U2_OWN ? u2 + s * BS * SV : t1;

    // (1) S and dP for 16 resident rows x 16 unit rows a warp
    {
      const int mr = 16 * (warp & 3), nr = 16 * (warp >> 2);
      float sc[2][4] = {}, dp[2][4] = {};
#pragma unroll 4
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm(a, at_a(r1, SK, mr, 16 * kk));
        ldsm(bb, at_b(t1, SK, nr, 16 * kk));
        mma_bf16(sc[0], a, bb[0], bb[1]);
        mma_bf16(sc[1], a, bb[2], bb[3]);
      }
#pragma unroll 4
      for (int kk = 0; kk < DV / 16; ++kk) {
        uint32_t a[4], bb[4];
        ldsm(a, at_a(r2, SR2, mr, 16 * kk));
        ldsm(bb, at_b(t2, SU2, nr, 16 * kk));
        mma_bf16(dp[0], a, bb[0], bb[1]);
        mma_bf16(dp[1], a, bb[2], bb[3]);
      }
      const bool part = cl_cur == TILE_PARTIAL;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // rows m0 (h2 0) and m1
          float pv[2], dv_[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int n = nr + 8 * t + 2 * tq + x, e = 2 * h2 + x;
            float l2, d;
            int qp, kp;
            if constexpr (DQ) {
              l2 = h2 ? rl1 : rl0;
              d = h2 ? rd1 : rd0;
              qp = h2 ? rp1 : rp0;
              kp = up_s[s * BS + n];
            } else {
              l2 = ul_s[s * BS + n];
              d = ud_s[s * BS + n];
              qp = up_s[s * BS + n];
              kp = h2 ? rp1 : rp0;
            }
            const bool vis = !part || visible(qp, kp, causal, window);
            const float p = vis ? exp2f(fmaf(sc[t][e], sl, -l2)) : 0.f;
            const float g = p * (dp[t][e] - d);
            pv[x] = p;
            dv_[x] = FOLD ? g * scale : g;
          }
          const int m = h2 ? m1 : m0, n = nr + 8 * t + 2 * tq;
          *reinterpret_cast<uint32_t*>(ds_s + m * SP + n) =
              pack_bf16(dv_[0], dv_[1]);
          if constexpr (!DQ)
            *reinterpret_cast<uint32_t*>(p_s + m * SP + n) =
                pack_bf16(pv[0], pv[1]);
        }
      }
    }
    __syncthreads();

    // (2) the output tile takes dS (and P) times the unit's rows
    const int c0 = 8 * NTW * wn;
#pragma unroll
    for (int kk = 0; kk < BS / 16; ++kk) {
      uint32_t a[MTW][4];
#pragma unroll
      for (int i = 0; i < MTW; ++i)
        ldsm(a[i], at_a(ds_s, SP, 16 * (wm * MTW + i), 16 * kk));
      mma_rows<MTW, NTW>(acc, a, t1, SK, 16 * kk, c0, DK);
      if constexpr (!DQ) {
#pragma unroll
        for (int i = 0; i < MTW; ++i)
          ldsm(a[i], at_a(p_s, SP, 16 * (wm * MTW + i), 16 * kk));
        if constexpr (FOLD)
          mma_rows<MTW, NTW>(acc, a, t2, SU2, 16 * kk, c0, DV);
        else
          mma_rows<MTW, NTV>(accv, a, t2, SU2, 16 * kk, 8 * NTV * wn, DV);
      }
    }
    __syncthreads();  // stage s, P and dS are free
    cur = nxt;
    cl_cur = cl_nxt;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // ---- epilogue: bf16 pairs straight from the accumulators --------------
  const float os = FOLD ? 1.f : scale;
#pragma unroll
  for (int i = 0; i < MTW; ++i) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int x = r0 + 16 * (wm * MTW + i) + gr + 8 * h2;
      if (DQ ? x >= rows : x >= Sk) continue;
      const long long g = DQ ? qrow(x) : krow(x);
#pragma unroll
      for (int t = 0; t < NTW; ++t)
        *reinterpret_cast<uint32_t*>(o1 + g * DK + 8 * (NTW * wn + t) +
                                     2 * tq) =
            pack_bf16(acc[i][t][2 * h2] * os, acc[i][t][2 * h2 + 1] * os);
      if constexpr (!DQ && !FOLD) {
#pragma unroll
        for (int t = 0; t < NTV; ++t)
          *reinterpret_cast<uint32_t*>(o2 + g * DV + 8 * (NTV * wn + t) +
                                       2 * tq) =
              pack_bf16(accv[i][t][2 * h2], accv[i][t][2 * h2 + 1]);
      }
    }
  }
}

template <int DK, int DV, bool FOLD>
__global__ void __launch_bounds__(256, 1) fa_bwd_dkdv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
    int Hkv, float scale, int causal, int window) {
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bwd_mma_body<DK, DV, FOLD, false>(mma_smem, q, k, v, dout, lse, delta,
                                    qpos, kpos, dk, dv, Sq, Sk, H, Hkv,
                                    scale, causal, window);
}

template <int DK, int DV, bool FOLD>
__global__ void __launch_bounds__(256, 1) fa_bwd_dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos,
    bf16* __restrict__ dq, int Sq, int Sk, int H, int Hkv, float scale,
    int causal, int window) {
  extern __shared__ __align__(16) uint8_t mma_smem[];
  bwd_mma_body<DK, DV, FOLD, true>(mma_smem, q, k, v, dout, lse, delta,
                                   qpos, kpos, dq, nullptr, Sq, Sk, H, Hkv,
                                   scale, causal, window);
}

// ---------------------------------------------------------------------------
// bf16 at MLA's (576, 512), V as K's first 512 columns: TMA, wgmma,
// warp-specialised persistent CTAs
// ---------------------------------------------------------------------------
// Both kernels have the shape of the MLA forward (flash_attention.cu,
// `fa_mla_wgmma_kernel`): a persistent CTA an SM walks work items heaviest
// first (`item_of`); a producer warp (setmaxnreg 40) loads each item's
// resident tile by TMA into one buffer, classes the item's streamed units
// 32 at a time (a lane a unit, `tile_class`) and sends those some pair
// sees through a two-stage ring guarded by full/empty mbarriers; two
// consumer warpgroups (232 registers) share every product of each unit.
// All tiles are TMA's 128-byte swizzle, boxes of 64 columns (576 = 9
// boxes, V's 512 the first 8, the rope columns box 8), so one K tile
// serves K and V, and the products read Q, dO and K K-major (S, dP) or
// MN-major (the outputs) without a transpose in memory:
//
// - `fa_bwd_dkdv_mla`: an item is 64 keys of one (batch row, KV head),
//   K resident (72 KB); the units are 32 (query, head) rows of the KV
//   head's rep query heads in q's own order (row rr: query rr / rep of
//   head hk * rep + rr % rep), Q (36 KB) and dO (32 KB) by TMA when a
//   unit is one box of q (rep divides 32, or 32 divides rep), else copied
//   by the producer warp into the same layout, with the rows' lse, D and
//   positions, the item's last unit first: the CTAs on the items of one
//   (batch row, KV head) then read each unit at about the same time, and
//   it comes from L2 (first unit first, each unit came again from device
//   memory for every key block: at deepseek-v2-lite's training shape on
//   an H100 the ring alone, with D, took 2.72 ms against 1.68 last unit
//   first, attention_bwd_ablation.py's `mla_dkdv_ring_only`).  Consumer
//   0 forms S^T = K Q^T (m64n32k16, depth 576) and P^T, consumer 1 dP^T =
//   V dO^T (depth 512) and, once P^T is there, dS^T = P^T (dP^T - D)
//   scaled before its bf16 rounding (the folded contract, as the mma.sync
//   template).  Then each adds bf16(scale
//   dS^T) Q + P^T dO into its own columns of dK (dV folded in): consumer
//   0 boxes 0-4 (320 columns, 160 float32 registers), consumer 1 boxes
//   5-8 (256 columns, 128 registers; box 8 takes no P^T dO).  Consumer 0
//   issues its P^T dO while consumer 1 forms dS^T.  dK is stored once an
//   item, through the K buffer and TMA stores; the next item's K waits for
//   those stores (one buffer: 72 KB, about two items a CTA at
//   deepseek-v2-lite's training shape).
// - `fa_bwd_dq_mla`: an item is 64 (query, head) rows of a KV head, Q (72
//   KB) and dO (64 KB) resident, by TMA when the rows are one box of q
//   (rep divides 64, or 64 divides rep), else copied by the producer; the
//   units are 32-key K tiles (36 KB; V is their first 8 boxes).  Consumer
//   0 forms S = Q K^T and P, consumer 1 dP = dO V^T and dS; both add
//   bf16(scale dS) K into dQ's boxes 0-4 / 5-8, K read MN-major, the sum
//   over tiles in their fixed order.  dQ is stored once an item through
//   the Q buffer (TMA, or 16-byte stores of the rows before the end), and
//   the next item's Q and dO wait for it.
//
// The two consumers hand P and dS to each other through shared memory,
// thread t of one to thread t of the other (both hold the same
// accumulator positions): P in float32, which dS takes as the plain
// version does, and dS as its bf16 A fragments; named barriers order the
// hand-offs (P ready: consumer 0 arrives, 1 waits; dS ready: the other
// way).  S and dP are recomputed in both kernels (7680 FLOP a visible
// triple against the bound's 5504), and being m64n32 with both operands
// in shared memory, they read 3 KB a k-step for 16 tensor-core cycles:
// shared memory, not the FLOP, bounds them at about 2/3 of the rate.
struct MlaDkLayout {
  static constexpr int BK = 64, BQ = 32, STAGES = 2;  // keys, unit rows
  static constexpr int NBK = 9, NBV = 8;              // boxes of Q, dO
  static constexpr int K_BOX = BK * 128, U_BOX = BQ * 128;
  static constexpr int K_BYTES = NBK * K_BOX;
  static constexpr int Q_BYTES = NBK * U_BOX, DO_BYTES = NBV * U_BOX;
  static constexpr int U_OFF = K_BYTES;  // stage s: Q, then dO
  static constexpr int XP_OFF = U_OFF + STAGES * (Q_BYTES + DO_BYTES);
  static constexpr int XS_OFF = XP_OFF + 16 * 128 * 4;  // P: 16 a thread
  static constexpr int ROW_OFF = XS_OFF + 8 * 128 * 4;  // dS: 8 words
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 3 * BQ * 4;
  static constexpr int ISLOT_OFF = BAR_OFF + 8 * (2 + 2 * STAGES);
  static constexpr int SLOT_OFF = ISLOT_OFF + 16;
  static constexpr int BYTES = 1024 + SLOT_OFF + 16 * STAGES;
};

struct MlaDqLayout {
  static constexpr int BQ = 64, BK = 32, STAGES = 2;  // item rows, keys
  static constexpr int NBK = 9, NBV = 8;
  static constexpr int Q_BOX = BQ * 128, K_BOX = BK * 128;
  static constexpr int Q_BYTES = NBK * Q_BOX, DO_BYTES = NBV * Q_BOX;
  static constexpr int TILE_BYTES = NBK * K_BOX;
  static constexpr int K_OFF = Q_BYTES + DO_BYTES;  // stage s: a K tile
  static constexpr int XP_OFF = K_OFF + STAGES * TILE_BYTES;
  static constexpr int XS_OFF = XP_OFF + 16 * 128 * 4;
  static constexpr int KP_OFF = XS_OFF + 8 * 128 * 4;  // [ST][BK] positions
  static constexpr int BAR_OFF = KP_OFF + STAGES * BK * 4;
  static constexpr int ISLOT_OFF = BAR_OFF + 8 * (2 + 2 * STAGES);
  static constexpr int SLOT_OFF = ISLOT_OFF + 16;
  static constexpr int BYTES = 1024 + SLOT_OFF + 8 * STAGES;
};
static_assert(MlaDkLayout::BYTES <= 232448 && MlaDqLayout::BYTES <= 232448,
              "shared memory");

// Named barriers of the MLA kernels: P ready, dS ready (both consumer
// warpgroups, 256 threads), and each warpgroup alone (3 + w).
constexpr int MB_P = 1, MB_DS = 2;
__device__ __forceinline__ void mb_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void mb_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void mb_wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + w) : "memory");
}

template <int W>
struct MlaWg {
  static constexpr int value = W;
};

// x, opaque to the compiler: a shared address that does not change from
// unit to unit would otherwise have its 36 wgmma descriptors hoisted out
// of the loop (72 registers) and spilled.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// S = A B^T over NB boxes of depth for 64 rows and 32 columns, both
// K-major: A's boxes `abox` bytes apart, B's `bbox` (wgmma m64n32k16, SS).
template <int NB>
__device__ __forceinline__ void ss_64x32(float* s, uint32_t a, int abox,
                                         uint32_t b, int bbox) {
#pragma unroll
  for (int kk = 0; kk < NB * 4; ++kk)
    wgmma_ss_m64n32(s, sw128_desc(a + (kk / 4) * abox + (kk % 4) * 32, 16,
                                  1024),
                    sw128_desc(b + (kk / 4) * bbox + (kk % 4) * 32, 16, 1024),
                    kk > 0);
}

// acc += A B over a depth of 32 rows: A (64 x 32) from registers, two
// 16-wide slices; B MN-major at `b` (rows 128 bytes, boxes `bbox` apart).
// W 0: boxes 0-4 of B into acc[0..159] (m64n256 over boxes 0-3, m64n64 box
// 4); W 1: boxes 5-7 (m64n192) into acc[0..95] and, with `rope`, box 8
// (m64n64) into acc[96..127].
template <int W>
__device__ __forceinline__ void rs_mla(float* acc, uint32_t (*af)[4],
                                       uint32_t b, int bbox, bool rope) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint32_t bk = b + kk * 16 * 128;
    if constexpr (W == 0) {
      wgmma_rs_m64n256(acc, af[kk], sw128_desc(bk, bbox, 1024));
      wgmma_rs_m64n64(acc + 128, af[kk], sw128_desc(bk + 4 * bbox, bbox,
                                                    1024));
    } else {
      wgmma_rs_m64n192(acc, af[kk], sw128_desc(bk + 5 * bbox, bbox, 1024));
      if (rope)
        wgmma_rs_m64n64(acc + 96, af[kk], sw128_desc(bk + 8 * bbox, bbox,
                                                     1024));
    }
  }
}

// Rows of a tile copied by one warp into TMA's 128-byte-swizzle layout
// (NB boxes of `box_rows` rows of 128 bytes at `dst`), 16 bytes a lane a
// step: tile row r is row `row_of(r)` of `src` (`ld` elements apart), or
// zeros where that is negative.  Then the copies are fenced for wgmma.
template <int NB, typename RowOf>
__device__ __forceinline__ void warp_copy_rows(uint8_t* dst, int box_rows,
                                               const bf16* __restrict__ src,
                                               int ld, RowOf row_of,
                                               int lane) {
#pragma unroll 1
  for (int e = lane; e < box_rows * NB * 8; e += 32) {
    const int r = e / (NB * 8), c = e % (NB * 8);
    const long long g = row_of(r);
    const uint4 val =
        g >= 0 ? __ldg(reinterpret_cast<const uint4*>(src + g * ld + c * 8))
               : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + (c / 8) * box_rows * 128 + r * 128 +
                              (((c & 7) ^ (r & 7)) << 4)) = val;
  }
  fence_proxy_async();
}

// A partial unit's element mask for the MLA dK kernel (m64n32): bit e for
// the accumulator's element e (key row kp0 or kp1, unit row acc_col).
__device__ __forceinline__ uint32_t mla_dk_mask(const int* qp_s, int tq,
                                                int kp0, int kp1, int causal,
                                                int window) {
  uint32_t vis = 0u;
#pragma unroll
  for (int e = 0; e < 16; ++e)
    vis |= static_cast<uint32_t>(visible(qp_s[acc_col(e, tq)],
                                         (e & 2) ? kp1 : kp0, causal,
                                         window))
           << e;
  return vis;
}

// The same for the MLA dQ kernel: rows qp0 / qp1, the tile's keys' staged
// positions.
__device__ __forceinline__ uint32_t mla_dq_mask(const int* kp_s, int tq,
                                                int qp0, int qp1, int causal,
                                                int window) {
  uint32_t vis = 0u;
#pragma unroll
  for (int e = 0; e < 16; ++e)
    vis |= static_cast<uint32_t>(visible((e & 2) ? qp1 : qp0,
                                         kp_s[acc_col(e, tq)], causal,
                                         window))
           << e;
  return vis;
}

// The positions of 32 keys from j0 (a lane's unit or tile): their range
// [lo, hi] past -1, and whether one is masked or past Sk.
__device__ __forceinline__ void key_range(const int* __restrict__ kp_row,
                                          int j0, int n, int Sk, int& lo,
                                          int& hi, bool& neg) {
  lo = INT_HI;
  hi = INT_LO;
  neg = false;
#pragma unroll 8
  for (int e = 0; e < n; ++e) {
    const int j = j0 + e;
    const int kp = j < Sk ? __ldg(kp_row + j) : -1;
    neg |= kp < 0;
    lo = kp < 0 ? lo : min(lo, kp);
    hi = kp < 0 ? hi : max(hi, kp);
  }
}

__global__ void __launch_bounds__(384, 1) fa_bwd_dkdv_mla(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_dk, const bf16* __restrict__ q,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qpos,
    const int* __restrict__ kpos, int Sq, int Sk, int H, int Hkv, int B,
    float scale, int causal, int window, int u_tma) {
  using L = MlaDkLayout;
  constexpr int BK = L::BK, BQ = L::BQ, ST = L::STAGES;
  extern __shared__ uint8_t mla_dk_smem[];
  const uint32_t raw = smem_u32(mla_dk_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // K; the ring follows
  uint8_t* gbase = mla_dk_smem + (base - raw);
  const uint32_t bar = base + L::BAR_OFF;
  int4* islot = reinterpret_cast<int4*>(gbase + L::ISLOT_OFF);
  int4* slot = reinterpret_cast<int4*>(gbase + L::SLOT_OFF);
  float* rows_s = reinterpret_cast<float*>(gbase + L::ROW_OFF);
  float* xp = reinterpret_cast<float*>(gbase + L::XP_OFF);
  uint32_t* xs = reinterpret_cast<uint32_t*>(gbase + L::XS_OFF);
#define FULL_K (bar)
#define EMPTY_K (bar + 8)
#define FULL(s) (bar + 8 * (2 + (s)))
#define EMPTY(s) (bar + 8 * (2 + ST + (s)))
#define U_STAGE(s) (base + L::U_OFF + (s) * (L::Q_BYTES + L::DO_BYTES))

  // rows: Sq * rep < 2^31 (the launcher checks)
  const int rep = H / Hkv, rows = Sq * rep;
  const int n_kb = (Sk + BK - 1) / BK, n_units = (rows + BQ - 1) / BQ;
  const int G = B * Hkv, n_items = n_kb * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(FULL_K, 1);
    mbar_init(EMPTY_K, 2);  // one thread of each consumer warpgroup
    for (int s = 0; s < ST; ++s) {
      mbar_init(FULL(s), 32);    // every lane of the producer warp
      mbar_init(EMPTY(s), 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: one warp loads each item's K, classes the units of
    // its KV head's rows (32 at a time, a lane a unit) and sends those
    // not skipped in order (Q and dO by TMA from lane 0, or copied by the
    // warp; each lane one row's lse, D and position), then an end of item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 0) return;
    int ring = 0, n = 0;  // stages sent, items sent
    for (int item; (item = item_of(n, blockIdx.x, gridDim.x)) < n_items;
         ++n) {
      // key blocks in order, the batch rows and KV heads within: causal,
      // the heaviest first
      const int k0 = item / G * BK, g = item % G;
      const int hk = g % Hkv, b = g / Hkv;
      if (lane == 0) {
        mbar_wait(EMPTY_K, (n & 1) ^ 1);
        islot[0] = make_int4(b, hk, k0, 1);
        mbar_expect_tx(FULL_K, L::K_BYTES);
#pragma unroll
        for (int c = 0; c < L::NBK; ++c)
          tma_load_4d(base + c * L::K_BOX, &tm_k, FULL_K, c * 64, hk, k0, b);
      }
      int klo, khi;
      bool neg;
      key_range(kpos + (long long)b * Sk, k0 + 2 * lane, 2, Sk, klo, khi,
                neg);
      warp_range(klo, khi);
      neg = __any_sync(0xffffffffu, neg);
      // the units from the last down, 32 at a time (the L2's reuse: the
      // section's comment)
      for (int c0 = (n_units - 1) / 32 * 32; c0 >= 0 && klo <= khi;
           c0 -= 32) {
        int cl = TILE_SKIP;
        if (c0 + lane < n_units) {
          const int rr = (c0 + lane) * BQ;
          const int last = (min(rr + BQ, rows) - 1) / rep;
          int qlo = INT_HI, qhi = INT_LO;
          for (int i = rr / rep; i <= last; ++i) {
            const int qp = __ldg(qpos + (long long)b * Sq + i);
            qlo = min(qlo, qp);
            qhi = max(qhi, qp);
          }
          cl = tile_class(klo, khi, neg, qlo, qhi, causal, window);
        }
        const uint32_t part = __ballot_sync(0xffffffffu, cl == TILE_PARTIAL);
        for (uint32_t send = __ballot_sync(0xffffffffu, cl != TILE_SKIP);
             send; send &= ~(1u << (31 - __clz(send)))) {
          const int t = 31 - __clz(send), rr0 = (c0 + t) * BQ;
          const int rr = rr0 + lane, i = rr / rep, h = hk * rep + rr % rep;
          const bool in = rr < rows;
          const long long li = ((long long)b * H + h) * Sq + i;
          const int qp = in ? qpos[(long long)b * Sq + i] : PAD_QPOS;
          const float l2 = in ? lse[li] * LOG2E : pos_inf();
          const float dd = in ? delta[li] : 0.f;
          const int s = ring % ST;
          mbar_wait(EMPTY(s), ((ring / ST) & 1) ^ 1);
          float* rs = rows_s + s * 3 * BQ;
          rs[lane] = l2;
          rs[BQ + lane] = dd;
          reinterpret_cast<int*>(rs)[2 * BQ + lane] = qp;
          if (lane == 0)
            slot[s] = make_int4(c0 + t,
                                (part >> t) & 1u ? TILE_PARTIAL : TILE_FULL,
                                0, 0);
          if (u_tma) {
            if (lane == 0) {
              mbar_expect_tx(FULL(s), L::Q_BYTES + L::DO_BYTES);
              const int hh = hk * rep + rr0 % rep, i0 = rr0 / rep;
#pragma unroll
              for (int c = 0; c < L::NBK; ++c)
                tma_load_4d(U_STAGE(s) + c * L::U_BOX, &tm_q, FULL(s),
                            c * 64, hh, i0, b);
#pragma unroll
              for (int c = 0; c < L::NBV; ++c)
                tma_load_4d(U_STAGE(s) + L::Q_BYTES + c * L::U_BOX, &tm_do,
                            FULL(s), c * 64, hh, i0, b);
            } else {
              mbar_arrive(FULL(s));
            }
          } else {  // rep neither divides nor is a multiple of 32
            auto row_of = [&](int r) -> long long {
              const int x = rr0 + r;
              return x < rows ? ((long long)b * Sq + x / rep) * H + hk * rep +
                                    x % rep
                              : -1;
            };
            uint8_t* us = gbase + (U_STAGE(s) - base);
            warp_copy_rows<L::NBK>(us, BQ, q, 576, row_of, lane);
            warp_copy_rows<L::NBV>(us + L::Q_BYTES, BQ, dout, 512, row_of,
                                   lane);
            mbar_arrive(FULL(s));
          }
          ++ring;
        }
      }
      const int s = ring % ST;  // the end of the item
      mbar_wait(EMPTY(s), ((ring / ST) & 1) ^ 1);
      if (lane == 0) slot[s] = make_int4(-1, 0, 0, 0);
      mbar_arrive(FULL(s));
      ++ring;
    }
    if (lane == 0) {  // no more items
      mbar_wait(EMPTY_K, (n & 1) ^ 1);
      islot[0] = make_int4(0, 0, 0, 0);
      mbar_arrive(FULL_K);
    }
    return;
  }

  // ---- two consumer warpgroups over all 64 keys of each item: consumer 0
  // S^T and P^T, consumer 1 dP^T and dS^T; dK's boxes 0-4 / 5-8 ---------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = warp / 4 - 1, wl = warp & 3, tq = lane & 3, ctid = tid & 127;
  const int r0 = 16 * wl + (lane >> 2), r1 = r0 + 8;  // the item's keys
  const float sl = scale * LOG2E;  // scores in log2 units
  auto consume = [&](auto which) {
    constexpr int W = decltype(which)::value;
    constexpr int B0 = W == 0 ? 0 : 5, NB = W == 0 ? 5 : 4;  // dK's boxes
    float dk[NB * 32], s[16];
    uint32_t pf[2][4], sf[2][4];
    int ring = 0;  // stages consumed
    for (int n = 0;; ++n) {
      mbar_wait(FULL_K, n & 1);
      const int4 it = islot[0];
      if (!it.w) break;
      const int b = it.x, hk = it.y, k0 = it.z;
      const int kp0 = k0 + r0 < Sk ? kpos[(long long)b * Sk + k0 + r0] : -1;
      const int kp1 = k0 + r1 < Sk ? kpos[(long long)b * Sk + k0 + r1] : -1;
#pragma unroll
      for (int e = 0; e < NB * 32; ++e) dk[e] = 0.f;
      int st;
      for (;;) {
        st = ring % ST;
        mbar_wait(FULL(st), (ring / ST) & 1);
        const int4 tile = slot[st];
        if (tile.x < 0) break;
        const uint32_t sq = U_STAGE(st), sdo = sq + L::Q_BYTES;
        const float* rs = rows_s + st * 3 * BQ;
        const uint32_t ka = opaque(base);  // K
        if constexpr (W == 0) {
          // S^T = K Q^T: the item's 64 keys x the unit's 32 rows
          wgmma_fence();
          ss_64x32<L::NBK>(s, ka, L::K_BOX, sq, L::U_BOX);
          wgmma_commit();
          const uint32_t vis =
              tile.y == TILE_PARTIAL
                  ? mla_dk_mask(reinterpret_cast<const int*>(rs + 2 * BQ),
                                tq, kp0, kp1, causal, window)
                  : ~0u;
          wgmma_wait<0>();
          fence_regs<16>(s);
          // P^T = exp2(S^T scale log2(e) - lse), lse in log2 units a column
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float p = ex2(fmaf(s[e], sl, -rs[acc_col(e, tq)]));
            s[e] = (vis >> e) & 1u ? p : 0.f;
            xp[e * 128 + ctid] = s[e];
          }
          mb_arrive(MB_P);
          pack_a<2>(s, pf);
          // dK[:, 0:320] += P^T dO while consumer 1 forms dS^T
          fence_regs<NB * 32>(dk);
          wgmma_fence();
          rs_mla<0>(dk, pf, sdo, L::U_BOX, false);
          wgmma_commit();
          mb_sync(MB_DS);
#pragma unroll
          for (int x = 0; x < 8; ++x) sf[x / 4][x % 4] = xs[x * 128 + ctid];
          wgmma_fence();
          rs_mla<0>(dk, sf, sq, L::U_BOX, true);
          wgmma_commit();
        } else {
          // dP^T = V dO^T, V the K tile's first 8 boxes
          wgmma_fence();
          ss_64x32<L::NBV>(s, ka, L::K_BOX, sdo, L::U_BOX);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<16>(s);
          mb_sync(MB_P);
          // dS^T = P^T (dP^T - D), scaled before its bf16 rounding
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int e = 8 * kk + 2 * j;
              const float p0 = xp[e * 128 + ctid];
              const float p1 = xp[(e + 1) * 128 + ctid];
              const float d0 =
                  p0 * (s[e] - rs[BQ + acc_col(e, tq)]) * scale;
              const float d1 =
                  p1 * (s[e + 1] - rs[BQ + acc_col(e + 1, tq)]) * scale;
              pf[kk][j] = pack_bf16(p0, p1);
              sf[kk][j] = pack_bf16(d0, d1);
              xs[(4 * kk + j) * 128 + ctid] = sf[kk][j];
            }
          }
          mb_arrive(MB_DS);
          // dK[:, 320:576] += bf16(scale dS^T) Q, dK[:, 320:512] += P^T dO
          fence_regs<NB * 32>(dk);
          wgmma_fence();
          rs_mla<1>(dk, pf, sdo, L::U_BOX, false);
          rs_mla<1>(dk, sf, sq, L::U_BOX, true);
          wgmma_commit();
        }
        wgmma_wait<0>();
        fence_regs<NB * 32>(dk);
        fence_af<2>(pf);
        fence_af<2>(sf);
        mbar_arrive(EMPTY(st));
        ++ring;
      }
      mbar_arrive(EMPTY(st));  // the end of the item holds no unit
      ++ring;

      // ---- epilogue: this consumer's boxes of K are read out (its own
      // products are done, and the other's S^T or dP^T of the last unit
      // came before the hand-off this one waited for): dK takes their
      // place, then TMA stores; the buffer is released for the next item
      stage_out<NB * 64>(gbase + B0 * L::K_BOX, BK, r0, tq, dk, 1.f);
      fence_proxy_async();
      mb_wg_sync(W);
      if (ctid == 0) {
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_store_4d(&tm_dk, base + (B0 + c) * L::K_BOX, 64 * (B0 + c), hk,
                       k0, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(EMPTY_K);
      }
    }
  };
  if (w == 0)
    consume(MlaWg<0>{});
  else
    consume(MlaWg<1>{});
#undef FULL_K
#undef EMPTY_K
#undef FULL
#undef EMPTY
#undef U_STAGE
}

__global__ void __launch_bounds__(384, 1) fa_bwd_dq_mla(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_dq, const bf16* __restrict__ q,
    const bf16* __restrict__ dout, bf16* __restrict__ dq,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ qpos, const int* __restrict__ kpos, int Sq,
    int Sk, int H, int Hkv, int B, float scale, int causal, int window,
    int q_tma) {
  using L = MlaDqLayout;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES;
  extern __shared__ uint8_t mla_dq_smem[];
  const uint32_t raw = smem_u32(mla_dq_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;  // Q, dO; the ring follows
  uint8_t* gbase = mla_dq_smem + (base - raw);
  const uint32_t bar = base + L::BAR_OFF;
  int4* islot = reinterpret_cast<int4*>(gbase + L::ISLOT_OFF);
  int2* slot = reinterpret_cast<int2*>(gbase + L::SLOT_OFF);
  int* kps = reinterpret_cast<int*>(gbase + L::KP_OFF);
  float* xp = reinterpret_cast<float*>(gbase + L::XP_OFF);
  uint32_t* xs = reinterpret_cast<uint32_t*>(gbase + L::XS_OFF);
#define FULL_Q (bar)
#define EMPTY_Q (bar + 8)
#define FULL(s) (bar + 8 * (2 + (s)))
#define EMPTY(s) (bar + 8 * (2 + ST + (s)))
#define K_STAGE(s) (base + L::K_OFF + (s) * L::TILE_BYTES)

  // rows: Sq * rep < 2^31 (the launcher checks)
  const int rep = H / Hkv, rows = Sq * rep;
  const int n_blk = (rows + BQ - 1) / BQ, n_kt = (Sk + BK - 1) / BK;
  const int G = B * Hkv, n_items = n_blk * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(FULL_Q, 32);  // every lane of the producer warp
    mbar_init(EMPTY_Q, 2);  // one thread of each consumer warpgroup
    for (int s = 0; s < ST; ++s) {
      mbar_init(FULL(s), 32);
      mbar_init(EMPTY(s), 256);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: for each item one warp loads Q and dO (TMA from lane
    // 0, or copied by the warp), classes the 32-key tiles (32 at a time, a
    // lane a tile) and sends those not skipped in order, each with its
    // keys' positions (a lane a key), then an end of item -----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 0) return;
    int ring = 0, n = 0;  // stages sent, items sent
    for (int item; (item = item_of(n, blockIdx.x, gridDim.x)) < n_items;
         ++n) {
      // the forward's order: the heaviest (causal: last) row block first
      // across the batch rows and KV heads
      const int g = item % G, hk = g % Hkv, b = g / Hkv;
      const int rr0 = (n_blk - 1 - item / G) * BQ;
      mbar_wait(EMPTY_Q, (n & 1) ^ 1);
      if (lane == 0) islot[0] = make_int4(b, hk, rr0, 1);
      if (q_tma) {
        if (lane == 0) {
          mbar_expect_tx(FULL_Q, L::Q_BYTES + L::DO_BYTES);
          const int hh = hk * rep + rr0 % rep, i0 = rr0 / rep;
#pragma unroll
          for (int c = 0; c < L::NBK; ++c)
            tma_load_4d(base + c * L::Q_BOX, &tm_q, FULL_Q, c * 64, hh, i0,
                        b);
#pragma unroll
          for (int c = 0; c < L::NBV; ++c)
            tma_load_4d(base + L::Q_BYTES + c * L::Q_BOX, &tm_do, FULL_Q,
                        c * 64, hh, i0, b);
        } else {
          mbar_arrive(FULL_Q);
        }
      } else {  // rep neither divides nor is a multiple of 64
        auto row_of = [&](int r) -> long long {
          const int x = rr0 + r;
          return x < rows
                     ? ((long long)b * Sq + x / rep) * H + hk * rep + x % rep
                     : -1;
        };
        warp_copy_rows<L::NBK>(gbase, BQ, q, 576, row_of, lane);
        warp_copy_rows<L::NBV>(gbase + L::Q_BYTES, BQ, dout, 512, row_of,
                               lane);
        mbar_arrive(FULL_Q);
      }
      int qlo = INT_HI, qhi = INT_LO;  // the block's rows before the end
      for (int r = lane; r < BQ; r += 32) {
        if (rr0 + r < rows) {
          const int qp = qpos[(long long)b * Sq + (rr0 + r) / rep];
          qlo = min(qlo, qp);
          qhi = max(qhi, qp);
        }
      }
      warp_range(qlo, qhi);
      const int* kp_row = kpos + (long long)b * Sk;
      for (int c0 = 0; c0 < n_kt; c0 += 32) {
        int cl = TILE_SKIP;
        if (c0 + lane < n_kt) {
          int lo, hi;
          bool neg;
          key_range(kp_row, (c0 + lane) * BK, BK, Sk, lo, hi, neg);
          cl = tile_class(lo, hi, neg, qlo, qhi, causal, window);
        }
        const uint32_t part = __ballot_sync(0xffffffffu, cl == TILE_PARTIAL);
        for (uint32_t send = __ballot_sync(0xffffffffu, cl != TILE_SKIP);
             send; send &= send - 1) {
          const int t = c0 + __ffs(send) - 1, j = t * BK + lane;
          const int kp = j < Sk ? kp_row[j] : -1;
          const int s = ring % ST;
          mbar_wait(EMPTY(s), ((ring / ST) & 1) ^ 1);
          kps[s * BK + lane] = kp;
          if (lane == 0) {
            slot[s] = make_int2(t, (part >> (t - c0)) & 1u ? TILE_PARTIAL
                                                            : TILE_FULL);
            mbar_expect_tx(FULL(s), L::TILE_BYTES);
#pragma unroll
            for (int c = 0; c < L::NBK; ++c)
              tma_load_4d(K_STAGE(s) + c * L::K_BOX, &tm_k, FULL(s), c * 64,
                          hk, t * BK, b);
          } else {
            mbar_arrive(FULL(s));
          }
          ++ring;
        }
      }
      const int s = ring % ST;  // the end of the item
      mbar_wait(EMPTY(s), ((ring / ST) & 1) ^ 1);
      if (lane == 0) slot[s] = make_int2(-1, 0);
      mbar_arrive(FULL(s));
      ++ring;
    }
    mbar_wait(EMPTY_Q, (n & 1) ^ 1);  // no more items
    if (lane == 0) islot[0] = make_int4(0, 0, 0, 0);
    mbar_arrive(FULL_Q);
    return;
  }

  // ---- two consumer warpgroups over all 64 rows of each item: consumer 0
  // S and P, consumer 1 dP and dS; dQ's boxes 0-4 / 5-8 -------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = warp / 4 - 1, wl = warp & 3, tq = lane & 3, ctid = tid & 127;
  const int r0 = 16 * wl + (lane >> 2), r1 = r0 + 8;  // the item's rows
  const float sl = scale * LOG2E;  // scores in log2 units
  auto consume = [&](auto which) {
    constexpr int W = decltype(which)::value;
    constexpr int B0 = W == 0 ? 0 : 5, NB = W == 0 ? 5 : 4;  // dQ's boxes
    float dqa[NB * 32], s[16];
    uint32_t sf[2][4];
    int ring = 0;  // stages consumed
    for (int n = 0;; ++n) {
      mbar_wait(FULL_Q, n & 1);
      const int4 it = islot[0];
      if (!it.w) break;
      const int b = it.x, hk = it.y, rr0 = it.z;
      // this thread's rows: consumer 0 their positions and lse (log2
      // units), consumer 1 their D
      int qp0 = PAD_QPOS, qp1 = PAD_QPOS;
      float x0 = W == 0 ? pos_inf() : 0.f, x1 = x0;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int rr = rr0 + (x ? r1 : r0);
        if (rr < rows) {
          const int i = rr / rep;
          const long long li = ((long long)b * H + hk * rep + rr % rep) * Sq +
                               i;
          if constexpr (W == 0) {
            (x ? qp1 : qp0) = qpos[(long long)b * Sq + i];
            (x ? x1 : x0) = lse[li] * LOG2E;
          } else {
            (x ? x1 : x0) = delta[li];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < NB * 32; ++e) dqa[e] = 0.f;
      int st;
      for (;;) {
        st = ring % ST;
        mbar_wait(FULL(st), (ring / ST) & 1);
        const int2 tile = slot[st];
        if (tile.x < 0) break;
        const uint32_t sk = K_STAGE(st);
        const uint32_t qa = opaque(base);  // Q, then dO
        if constexpr (W == 0) {
          // S = Q K^T: the item's 64 rows x the tile's 32 keys
          wgmma_fence();
          ss_64x32<L::NBK>(s, qa, L::Q_BOX, sk, L::K_BOX);
          wgmma_commit();
          const uint32_t vis = tile.y == TILE_PARTIAL
                                   ? mla_dq_mask(kps + st * BK, tq, qp0,
                                                 qp1, causal, window)
                                   : ~0u;
          wgmma_wait<0>();
          fence_regs<16>(s);
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float p = ex2(fmaf(s[e], sl, -((e & 2) ? x1 : x0)));
            s[e] = (vis >> e) & 1u ? p : 0.f;
            xp[e * 128 + ctid] = s[e];
          }
          mb_arrive(MB_P);
          mb_sync(MB_DS);
#pragma unroll
          for (int x = 0; x < 8; ++x) sf[x / 4][x % 4] = xs[x * 128 + ctid];
        } else {
          // dP = dO V^T, V the K tile's first 8 boxes
          wgmma_fence();
          ss_64x32<L::NBV>(s, qa + L::Q_BYTES, L::Q_BOX, sk, L::K_BOX);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<16>(s);
          mb_sync(MB_P);
          // dS = P (dP - D), scaled before its bf16 rounding
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int e = 8 * kk + 2 * j;
              const float dd = (e & 2) ? x1 : x0;  // the row's D
              const float d0 = xp[e * 128 + ctid] * (s[e] - dd) * scale;
              const float d1 = xp[(e + 1) * 128 + ctid] * (s[e + 1] - dd) *
                               scale;
              sf[kk][j] = pack_bf16(d0, d1);
              xs[(4 * kk + j) * 128 + ctid] = sf[kk][j];
            }
          }
          mb_arrive(MB_DS);
        }
        // dQ += bf16(scale dS) K, K read MN-major
        fence_regs<NB * 32>(dqa);
        wgmma_fence();
        rs_mla<W>(dqa, sf, sk, L::K_BOX, true);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NB * 32>(dqa);
        fence_af<2>(sf);
        mbar_arrive(EMPTY(st));
        ++ring;
      }
      mbar_arrive(EMPTY(st));  // the end of the item holds no tile
      ++ring;

      // ---- epilogue: this consumer's boxes of Q are read out (consumer
      // 1's once consumer 0's last S came before the P hand-off): dQ takes
      // their place, then a TMA store or 16-byte stores of the rows before
      // the end; the buffer is released for the next item
      stage_out<NB * 64>(gbase + B0 * L::Q_BOX, BQ, r0, tq, dqa, 1.f);
      fence_proxy_async();
      mb_wg_sync(W);
      if (q_tma) {
        if (ctid == 0) {
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_store_4d(&tm_dq, base + (B0 + c) * L::Q_BOX, 64 * (B0 + c),
                         hk * rep + rr0 % rep, rr0 / rep, b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
      } else {  // each row's bytes of this consumer's columns, coalesced
        for (int e = ctid; e < BQ * NB * 8; e += 128) {
          const int r = e / (NB * 8), c = e % (NB * 8), rr = rr0 + r;
          if (rr < rows) {
            const uint4 val = *reinterpret_cast<const uint4*>(
                gbase + (B0 + c / 8) * L::Q_BOX + r * 128 +
                (((c & 7) ^ (r & 7)) << 4));
            const long long row =
                ((long long)b * Sq + rr / rep) * H + hk * rep + rr % rep;
            *reinterpret_cast<uint4*>(dq + row * 576 + 64 * B0 + c * 8) =
                val;
          }
        }
        mb_wg_sync(W);
      }
      if (ctid == 0) mbar_arrive(EMPTY_Q);
    }
  };
  if (w == 0)
    consume(MlaWg<0>{});
  else
    consume(MlaWg<1>{});
#undef FULL_Q
#undef EMPTY_Q
#undef FULL
#undef EMPTY
#undef K_STAGE
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

// A persistent grid: one CTA per SM, or per item if there are fewer.
cudaError_t persistent_grid(long long items, unsigned* grid) {
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  *grid = static_cast<unsigned>(items < sms ? items : sms);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_bf16(const BwdArgs& a) {
  using KL = DkdvLayout<D>;
  using QL = DqLayout<D>;
  cudaError_t err = launch_delta<bf16, D>(a);
  if (err != cudaSuccess) return err;
  // tensor maps: Q and dO in 64-row tiles (dK/dV) and 128-row items (dQ),
  // K and V in 128-key items (dK/dV) and 64-key tiles (dQ), the outputs in
  // a warpgroup's 64 rows
  CUtensorMap q64, do64, k128, v128, dk64, dv64, q128, do128, k64, v64, dq64;
  if ((err = make_map(&q64, a.q, a.B, a.Sq, a.H, D, KL::BQ)) != cudaSuccess ||
      (err = make_map(&do64, a.dout, a.B, a.Sq, a.H, D, KL::BQ)) !=
          cudaSuccess ||
      (err = make_map(&k128, a.k, a.B, a.Sk, a.Hkv, D, KL::BK)) !=
          cudaSuccess ||
      (err = make_map(&v128, a.v, a.B, a.Sk, a.Hkv, D, KL::BK)) !=
          cudaSuccess ||
      (err = make_map(&dk64, a.dk, a.B, a.Sk, a.Hkv, D, 64)) != cudaSuccess ||
      (err = make_map(&dv64, a.dv, a.B, a.Sk, a.Hkv, D, 64)) != cudaSuccess ||
      (err = make_map(&q128, a.q, a.B, a.Sq, a.H, D, QL::BQ)) !=
          cudaSuccess ||
      (err = make_map(&do128, a.dout, a.B, a.Sq, a.H, D, QL::BQ)) !=
          cudaSuccess ||
      (err = make_map(&k64, a.k, a.B, a.Sk, a.Hkv, D, QL::BK)) !=
          cudaSuccess ||
      (err = make_map(&v64, a.v, a.B, a.Sk, a.Hkv, D, QL::BK)) !=
          cudaSuccess ||
      (err = make_map(&dq64, a.dq, a.B, a.Sq, a.H, D, 64)) != cudaSuccess)
    return err;
  unsigned grid = 0;
  const long long kv_items =
      (long long)((a.Sk + KL::BK - 1) / KL::BK) * a.Hkv * a.B;
  if ((err = persistent_grid(kv_items, &grid)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dkdv_wgmma<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  KL::BYTES)) != cudaSuccess)
    return err;
  fa_bwd_dkdv_wgmma<D><<<grid, 384, KL::BYTES, a.stream>>>(
      q64, do64, k128, v128, dk64, dv64, a.lse, a.delta, a.qpos, a.kpos,
      a.Sq, a.Sk, a.H, a.Hkv, a.B, a.scale, a.causal, a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long q_items =
      (long long)((a.Sq + QL::BQ - 1) / QL::BQ) * a.H * a.B;
  if ((err = persistent_grid(q_items, &grid)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dq_wgmma<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  QL::BYTES)) != cudaSuccess)
    return err;
  fa_bwd_dq_wgmma<D><<<grid, 384, QL::BYTES, a.stream>>>(
      q128, do128, k64, v64, dq64, a.lse, a.delta, a.qpos, a.kpos, a.Sq,
      a.Sk, a.H, a.Hkv, a.B, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

template <int DK, int DV, bool FOLD>
cudaError_t launch_f32(const BwdArgs& a) {
  cudaError_t err = launch_delta<float, DV>(a);
  if (err != cudaSuccess) return err;
  constexpr int s1 = f32_dkdv_smem<DK, DV>(), s2 = f32_dq_smem<DK, DV>();
  if ((err = cudaFuncSetAttribute(fa_bwd_dkdv_f32<DK, DV, FOLD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dq_f32<DK, DV>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s2)) != cudaSuccess)
    return err;
  const float *q = static_cast<const float*>(a.q),
              *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v),
              *g = static_cast<const float*>(a.dout);
  const int ldv = a.v == a.k ? DK : DV;
  fa_bwd_dkdv_f32<DK, DV, FOLD><<<dim3((a.Sk + F_B - 1) / F_B, a.Hkv, a.B),
                                  128, s1, a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.qpos, a.kpos, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal,
      a.window, ldv);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_f32<DK, DV><<<dim3((a.Sq + F_B - 1) / F_B, a.H, a.B), 128, s2,
                          a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.qpos, a.kpos, static_cast<float*>(a.dq),
      a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal, a.window, ldv);
  return cudaGetLastError();
}

template <int DK, int DV, bool FOLD>
cudaError_t launch_mma(const BwdArgs& a) {
  using C = MmaBwd<DK, DV>;
  const long long rows = (long long)a.Sq * (a.H / a.Hkv);
  if (rows > 0x7fffffffLL - C::BR) return cudaErrorInvalidValue;
  cudaError_t err = launch_delta<bf16, DV>(a);
  if (err != cudaSuccess) return err;
  constexpr int s1 = C::bytes(false, FOLD), s2 = C::bytes(true, FOLD);
  if ((err = cudaFuncSetAttribute(fa_bwd_dkdv_mma<DK, DV, FOLD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s1)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dq_mma<DK, DV, FOLD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  s2)) != cudaSuccess)
    return err;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v),
             *g = static_cast<const bf16*>(a.dout);
  fa_bwd_dkdv_mma<DK, DV, FOLD><<<dim3((a.Sk + C::BR - 1) / C::BR, a.Hkv,
                                       a.B),
                                  256, s1, a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.qpos, a.kpos, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal,
      a.window);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  fa_bwd_dq_mma<DK, DV, FOLD><<<dim3(static_cast<unsigned>(
                                         (rows + C::BR - 1) / C::BR),
                                     a.Hkv, a.B),
                                256, s2, a.stream>>>(
      q, k, v, g, a.lse, a.delta, a.qpos, a.kpos, static_cast<bf16*>(a.dq),
      a.Sq, a.Sk, a.H, a.Hkv, a.scale, a.causal, a.window);
  return cudaGetLastError();
}

// bf16 (576, 512) with V as K's first 512 columns (v == k): D, then the
// MLA dK and dQ kernels.  A unit or item of (query, head) rows is one box
// of q when rep divides its rows or its rows divide rep; otherwise the
// producer copies its rows (the maps passed are then unused).
cudaError_t launch_mla_bwd(const BwdArgs& a) {
  using KL = MlaDkLayout;
  using QL = MlaDqLayout;
  if (a.v != a.k) return cudaErrorInvalidValue;
  const int rep = a.H / a.Hkv;
  const long long rows = (long long)a.Sq * rep;
  if (rows > 0x7fffffffLL - QL::BQ) return cudaErrorInvalidValue;
  cudaError_t err = launch_delta<bf16, 512>(a);
  if (err != cudaSuccess) return err;
  const int u_tma = KL::BQ % rep == 0 || rep % KL::BQ == 0;
  const int q_tma = QL::BQ % rep == 0 || rep % QL::BQ == 0;
  CUtensorMap k64, dk64, k32, qu, dou, qi, doi, dqi;
  if ((err = make_map(&k64, a.k, a.B, a.Sk, a.Hkv, 576, KL::BK)) !=
          cudaSuccess ||
      (err = make_map(&dk64, a.dk, a.B, a.Sk, a.Hkv, 576, KL::BK)) !=
          cudaSuccess ||
      (err = make_map(&k32, a.k, a.B, a.Sk, a.Hkv, 576, QL::BK)) !=
          cudaSuccess)
    return err;
  qu = dou = qi = doi = dqi = k64;
  const int uh = rep < KL::BQ ? rep : KL::BQ, ih = rep < QL::BQ ? rep : QL::BQ;
  if (u_tma &&
      ((err = make_map(&qu, a.q, a.B, a.Sq, a.H, 576, KL::BQ / uh, uh)) !=
           cudaSuccess ||
       (err = make_map(&dou, a.dout, a.B, a.Sq, a.H, 512, KL::BQ / uh, uh)) !=
           cudaSuccess))
    return err;
  if (q_tma &&
      ((err = make_map(&qi, a.q, a.B, a.Sq, a.H, 576, QL::BQ / ih, ih)) !=
           cudaSuccess ||
       (err = make_map(&doi, a.dout, a.B, a.Sq, a.H, 512, QL::BQ / ih, ih)) !=
           cudaSuccess ||
       (err = make_map(&dqi, a.dq, a.B, a.Sq, a.H, 576, QL::BQ / ih, ih)) !=
           cudaSuccess))
    return err;
  const bf16 *q = static_cast<const bf16*>(a.q),
             *g = static_cast<const bf16*>(a.dout);
  unsigned grid = 0;
  const long long kv_items =
      (long long)((a.Sk + KL::BK - 1) / KL::BK) * a.Hkv * a.B;
  if ((err = persistent_grid(kv_items, &grid)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dkdv_mla,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  KL::BYTES)) != cudaSuccess)
    return err;
  fa_bwd_dkdv_mla<<<grid, 384, KL::BYTES, a.stream>>>(
      qu, dou, k64, dk64, q, g, a.lse, a.delta, a.qpos, a.kpos, a.Sq, a.Sk,
      a.H, a.Hkv, a.B, a.scale, a.causal, a.window, u_tma);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long q_items = (rows + QL::BQ - 1) / QL::BQ * a.Hkv * a.B;
  if ((err = persistent_grid(q_items, &grid)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fa_bwd_dq_mla,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  QL::BYTES)) != cudaSuccess)
    return err;
  fa_bwd_dq_mla<<<grid, 384, QL::BYTES, a.stream>>>(
      qi, doi, k32, dqi, q, g, static_cast<bf16*>(a.dq), a.lse, a.delta,
      a.qpos, a.kpos, a.Sq, a.Sk, a.H, a.Hkv, a.B, a.scale, a.causal,
      a.window, q_tma);
  return cudaGetLastError();
}

enum BwdVariant {
  BV_NONE = -1, BV_WGMMA = 0, BV_MMA_SYNC = 1, BV_MLA = 2, BV_F32 = 3
};

// The fixed rule (flash_attention.py's docstring states it, and its
// BWD_HEAD_DIMS and BWD_KERNELS mirror it): bf16 at (64, 64), (80, 80)
// and (128, 128) -> the wgmma kernels; bf16 at (32, 16), (32, 32) and
// (80, 64) -> the mma.sync kernels; bf16 at (576, 512) -> the MLA wgmma
// kernels (V must be K's prefix); float32 at every size but (576, 512) ->
// the CUDA-core kernels.
int bwd_variant_of(int bf16_, int dk, int dv) {
  const bool wgmma = (dk == 64 && dv == 64) || (dk == 80 && dv == 80) ||
                     (dk == 128 && dv == 128);
  const bool narrow = (dk == 32 && dv == 16) || (dk == 32 && dv == 32) ||
                      (dk == 80 && dv == 64);
  const bool mla = (dk == 576 && dv == 512);
  if (bf16_)
    return wgmma ? BV_WGMMA : narrow ? BV_MMA_SYNC : mla ? BV_MLA : BV_NONE;
  return wgmma || narrow ? BV_F32 : BV_NONE;
}

// A bf16 kernel's stages, dynamic shared memory and, from the compiled
// kernel, registers a thread at launch and local (spill) bytes.
cudaError_t func_info(const void* fn, int stages, int bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  out[0] = stages;
  out[1] = bytes;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}

template <int D>
cudaError_t wgmma_info(int which, int* out) {
  return which == 0
             ? func_info(reinterpret_cast<const void*>(fa_bwd_dkdv_wgmma<D>),
                         DkdvLayout<D>::STAGES, DkdvLayout<D>::BYTES, out)
             : func_info(reinterpret_cast<const void*>(fa_bwd_dq_wgmma<D>),
                         DqLayout<D>::STAGES, DqLayout<D>::BYTES, out);
}

cudaError_t mla_info(int which, int* out) {
  return which == 0
             ? func_info(reinterpret_cast<const void*>(fa_bwd_dkdv_mla),
                         MlaDkLayout::STAGES, MlaDkLayout::BYTES, out)
             : func_info(reinterpret_cast<const void*>(fa_bwd_dq_mla),
                         MlaDqLayout::STAGES, MlaDqLayout::BYTES, out);
}

template <int DK, int DV, bool FOLD>
cudaError_t mma_info(int which, int* out) {
  using C = MmaBwd<DK, DV>;
  return which == 0
             ? func_info(reinterpret_cast<const void*>(
                             fa_bwd_dkdv_mma<DK, DV, FOLD>),
                         2, C::bytes(false, FOLD), out)
             : func_info(reinterpret_cast<const void*>(
                             fa_bwd_dq_mma<DK, DV, FOLD>),
                         2, C::bytes(true, FOLD), out);
}

}  // namespace

extern "C" {

int fa_bwd_variant(int is_bf16, int dk, int dv) {
  return bwd_variant_of(is_bf16, dk, dv);
}

// dq [B,Sq,H,Dk], dk [B,Sk,Hkv,Dk] and dv [B,Sk,Hkv,Dv] in the inputs'
// dtype; delta is float32 [B,H,Sq] scratch (D of the recompute), written
// here.  dv null: V is K's first Dv < Dk columns (v == k, rows Dk apart)
// and dk takes dV in its first Dv columns (`ref.attention_bwd`'s folded
// contract); bf16 (576, 512) takes only that.
int fa_backward(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, const void* qpos,
                const void* kpos, void* dq, void* dk, void* dv, void* delta,
                int B, int Sq, int Sk, int H, int Hkv, int dk_, int dv_,
                int bf16_, float scale, int causal, int window,
                void* stream) {
  const int var = bwd_variant_of(bf16_, dk_, dv_);
  const bool fold = dv == nullptr;
  if (var == BV_NONE || Hkv < 1 || H % Hkv != 0 ||
      (fold && (v != k || dv_ >= dk_)) ||
      (!fold && v == k && dv_ < dk_) || (var == BV_MLA && !fold))
    return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse),
                  static_cast<const int*>(qpos),
                  static_cast<const int*>(kpos), dq, dk, dv,
                  static_cast<float*>(delta), B, Sq, Sk, H, Hkv, scale,
                  causal, window, static_cast<cudaStream_t>(stream)};
  switch (var) {
    case BV_WGMMA:
      if (dk_ == 80) return launch_bf16<80>(a);
      return dk_ == 64 ? launch_bf16<64>(a) : launch_bf16<128>(a);
    case BV_MLA:
      return launch_mla_bwd(a);
    case BV_MMA_SYNC:
      if (dk_ == 80)
        return fold ? launch_mma<80, 64, true>(a)
                    : launch_mma<80, 64, false>(a);
      if (dv_ == 32) return launch_mma<32, 32, false>(a);
      return fold ? launch_mma<32, 16, true>(a)
                  : launch_mma<32, 16, false>(a);
    case BV_F32:
      if (dk_ == 64) return launch_f32<64, 64, false>(a);
      if (dk_ == 128) return launch_f32<128, 128, false>(a);
      if (dk_ == 80) {
        if (dv_ == 80) return launch_f32<80, 80, false>(a);
        return fold ? launch_f32<80, 64, true>(a)
                    : launch_f32<80, 64, false>(a);
      }
      if (dv_ == 32) return launch_f32<32, 32, false>(a);
      return fold ? launch_f32<32, 16, true>(a)
                  : launch_f32<32, 16, false>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// out[4] = {stages, dynamic shared bytes, registers a thread, local bytes}
// of the bf16 dK/dV (which = 0) or dQ (which = 1) kernel at (dk, dv), of
// its variant's kernels (the mma.sync ones with a separate V).
int fa_bwd_kernel_info(int which, int dk, int dv, int* out) {
  if (which != 0 && which != 1) return cudaErrorInvalidValue;
  switch (bwd_variant_of(1, dk, dv)) {
    case BV_WGMMA:
      if (dk == 80) return wgmma_info<80>(which, out);
      return dk == 64 ? wgmma_info<64>(which, out)
                      : wgmma_info<128>(which, out);
    case BV_MLA:
      return mla_info(which, out);
    case BV_MMA_SYNC:
      if (dk == 80) return mma_info<80, 64, false>(which, out);
      return dv == 16 ? mma_info<32, 16, false>(which, out)
                      : mma_info<32, 32, false>(which, out);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* fa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
