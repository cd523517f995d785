// GQA flash attention for Hopper (sm_90a): online softmax over KV tiles,
// positional masks (causal, sliding window, kv_pos < 0 padding), KV tiles
// with no visible key skipped, Dk != Dv.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py (flash_attention, :93; pallas_call
// :127).  Contract: `ref.attention` of the port (q [B,Sq,H,Dk],
// k [B,Sk,Hkv,Dk], v [B,Sk,Hkv,Dv] -> out [B,Sq,H,Dv] in q's dtype; m, l
// and the accumulator in float32; P rounded to V's dtype before the PV
// product; a query that sees no key returns 0).
//
// What bounds it: at the models' prefill shape (B 8, S 2048, H 16, Hkv 8,
// D 128, causal) the visible pairs need 137.5 GFLOP of bf16 products
// against 201 MB of q/k/v/out, so the tensor cores bound it (0.139 ms on
// an H100 SXM at 989 TFLOP/s), not memory (0.06 ms); at MLA's prefill
// (deepseek-v2-lite: B 8, S 2048, H 16, Hkv 1, Dk 576, Dv 512, causal) the
// 268.6 M visible pairs need 584 GFLOP (0.59 ms) against 589 MB (0.18 ms;
// V is K's first 512 columns).
// Four kernels, one picked by a fixed rule from (dtype, Dk, Dv)
// (`variant_of`):
//
// - bf16 at (64, 64) and (128, 128), the models' head sizes:
//   `fa_wgmma_kernel`, built from Hopper's asynchronous units.  A
//   persistent grid (one CTA per SM) walks the work items, one per (query
//   block of 128, head, batch), in a snake over rounds of the grid so that
//   the causal work evens out.  Each CTA has three warpgroups: a producer
//   (registers cut to 40 with setmaxnreg) whose one warp classes each KV
//   tile as it comes and whose one thread issues every TMA copy, and two
//   consumer warpgroups (232 registers) of 64 query rows each.  Q is
//   double-buffered, so the next item's Q loads during this one; K and V
//   tiles of 128 keys go through a ring guarded by full/empty mbarriers,
//   and a slot per stage names the tile it holds.  S = Q K^T is wgmma
//   m64n128k16 with both operands K-major in shared memory; O += P V
//   takes P from registers (the S accumulator rounded to bf16 is wgmma's A
//   fragment) and reads V MN-major, so V is never transposed.  Each
//   consumer issues tile i's S product with tile i-1's PV product and runs
//   tile i's softmax while the PV runs; the two consumers take turns at
//   issuing (named barriers), so one's softmax overlaps the other's
//   products.  TMA writes every tile with 128-byte swizzle in 64-column
//   boxes, the layout the wgmma descriptors name.  A KV tile is skipped
//   (not loaded), full (no mask) or partial (the element mask) from its
//   position range against the block's; the softmax is one FFMA and an
//   exp2 per score on full tiles.  Ragged Sq and Sk come from the tensor
//   maps: rows past the end load as zeros, keys past Sk are masked, and
//   the TMA store of O writes no row past Sq.  Tensor maps are built per
//   call with cuTensorMapEncodeTiled, found through
//   cudaGetDriverEntryPoint.
// - bf16 at (32, 16), (32, 32), (80, 64) and (80, 80): `fa_bf16_kernel`, 4
//   warps x 16 query rows, mma.sync m16n8k16 with K and a transposed V
//   staged in padded shared memory.
// - bf16 at (576, 512), MLA's latent heads: `fa_mla_wgmma_kernel`, the
//   same shape of persistent CTA over 64 (query, head) rows of one KV
//   head, V taken from the K tiles (V must be K's first 512 columns), S
//   split by keys and O by columns between the two consumers (see its
//   section).
// - float32: `fa_f32_kernel`, full float32 products on the CUDA cores (no
//   TF32), 32 query rows x 32 keys per tile, 4 threads per query row.
//
// The mma.sync and CUDA-core kernels launch one CTA per (query block,
// head, batch), heaviest query block first (causal: the last block sees
// the most keys), with the rep = H/Hkv CTAs of one KV head next to each
// other so their K/V tiles are read from L2; the wgmma kernel's items keep
// that order within each KV head, and the MLA kernel's items hold the rep
// heads themselves.  Those two skip a KV tile with no visible (query, key)
// pair before loading it (`pl.when(jnp.any(valid))`, :61) and mask ragged
// Sq and Sk in the kernel: a query row past Sq has position 2^30 and is
// not stored, a key past Sk has position -1 (the TPU wrapper's padding,
// :105-112).  None of the four needs the wrapper to copy anything: where
// v == k, V is K's first Dv columns (its rows Dk apart), as MLA passes it.
//
// Every kernel also writes each row's log-sum-exp when training asks for
// it (fa_forward_lse), the output unchanged.
//
// Plain C interface, loaded with ctypes: fa_forward returns a cudaError_t,
// fa_variant names the kernel it runs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fa_common.cuh"
#include "fa_hopper.cuh"
#include "mbarrier.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
template <int DK, int DV>
__global__ void __launch_bounds__(128) fa_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
    const int* __restrict__ kpos, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, float scale,
    int causal, int window, int ldv) {
  constexpr int BQ = 64, BK = 64;
  constexpr int KS = DK + 8;  // row stride of the K tile (bf16)
  constexpr int VS = BK + 8;  // row stride of the transposed V tile
  __shared__ __align__(16) __nv_bfloat16 k_s[BK * KS];
  __shared__ __align__(16) __nv_bfloat16 vt_s[DV * VS];
  __shared__ int qp_s[BQ];
  __shared__ int kp_s[BK];

  const int n_qb = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qb - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;

  if (tid < BQ) {
    const int i = q0 + tid;
    qp_s[tid] = i < Sq ? qpos[(long long)b * Sq + i] : PAD_QPOS;
  }

  // this warp's 16 query rows: r0 = warp*16 + gr and r1 = r0 + 8
  const int r0 = warp * 16 + gr, r1 = r0 + 8;
  uint32_t qf[DK / 16][4];
  {
    const long long row0 = ((long long)b * Sq + q0 + r0) * H + h;
    const long long row1 = ((long long)b * Sq + q0 + r1) * H + h;
    const bool in0 = q0 + r0 < Sq, in1 = q0 + r1 < Sq;
#pragma unroll
    for (int ks = 0; ks < DK / 16; ++ks) {
      const int c = ks * 16 + 2 * tq;
      const uint32_t* p0 = reinterpret_cast<const uint32_t*>(q + row0 * DK + c);
      const uint32_t* p1 = reinterpret_cast<const uint32_t*>(q + row1 * DK + c);
      qf[ks][0] = in0 ? p0[0] : 0u;
      qf[ks][1] = in1 ? p1[0] : 0u;
      qf[ks][2] = in0 ? p0[4] : 0u;
      qf[ks][3] = in1 ? p1[4] : 0u;
    }
  }
  __syncthreads();
  const int qp0 = qp_s[r0], qp1 = qp_s[r1];

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float o[DV / 8][4];
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt)
    o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  const int n_kb = (Sk + BK - 1) / BK;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile is read out
    if (tid < BK) {
      const int j = k0 + tid;
      kp_s[tid] = j < Sk ? kpos[(long long)b * Sk + j] : -1;
    }
    __syncthreads();
    // does any (query, key) pair of this tile see each other?
    bool any = false;
    {
      const int qp = qp_s[tid & (BQ - 1)];
      const int j0 = (tid / BQ) * (BK * BQ / 128);
      for (int jj = 0; jj < BK * BQ / 128; ++jj)
        any |= visible(qp, kp_s[j0 + jj], causal, window);
    }
    if (!__syncthreads_or(any)) continue;

    // stage K (row-major) and V (transposed), 16 bytes per load
    for (int e = tid; e < BK * DK / 8; e += 128) {
      const int r = e / (DK / 8), c8 = (e % (DK / 8)) * 8;
      const int j = k0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j < Sk)
        val = *reinterpret_cast<const uint4*>(
            k + (((long long)b * Sk + j) * Hkv + hk) * DK + c8);
      *reinterpret_cast<uint4*>(k_s + r * KS + c8) = val;
    }
    for (int e = tid; e < BK * DV / 8; e += 128) {
      const int r = e / (DV / 8), c8 = (e % (DV / 8)) * 8;
      const int j = k0 + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (j < Sk)
        val = *reinterpret_cast<const uint4*>(
            v + (((long long)b * Sk + j) * Hkv + hk) * ldv + c8);
      const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int t = 0; t < 8; ++t) vt_s[(c8 + t) * VS + r] = vv[t];
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DK / 16; ++ks) {
        const __nv_bfloat16* kr = k_s + (nt * 8 + gr) * KS + ks * 16 + 2 * tq;
        mma_bf16(s[nt], qf[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // scale, mask, row maxima (each row is spread over the 4 lanes of a quad)
    uint32_t vis = 0u;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = kp_s[nt * 8 + 2 * tq + e];
        const bool v0 = visible(qp0, kp, causal, window);
        const bool v1 = visible(qp1, kp, causal, window);
        vis |= (v0 ? 1u : 0u) << (nt * 4 + e);
        vis |= (v1 ? 1u : 0u) << (nt * 4 + 2 + e);
        s[nt][e] = v0 ? s[nt][e] * scale : NEG_INF;
        s[nt][2 + e] = v1 ? s[nt][2 + e] * scale : NEG_INF;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
    const float ms0 = mn0 <= NEG_INF ? 0.f : mn0;
    const float ms1 = mn1 <= NEG_INF ? 0.f : mn1;
    const float corr0 = m[0] <= NEG_INF ? 0.f : expf(m[0] - ms0);
    const float corr1 = m[1] <= NEG_INF ? 0.f : expf(m[1] - ms1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ms = e < 2 ? ms0 : ms1;
        s[nt][e] = (vis >> (nt * 4 + e)) & 1u ? expf(s[nt][e] - ms) : 0.f;
      }
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l[0] = l[0] * corr0 + sum0;
    l[1] = l[1] * corr1 + sum1;
    m[0] = mn0;
    m[1] = mn1;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
      o[nt][0] *= corr0;
      o[nt][1] *= corr0;
      o[nt][2] *= corr1;
      o[nt][3] *= corr1;
    }
    // O += P V, with P rounded to bf16: S's accumulator layout is the A
    // fragment layout of the next product
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < DV / 8; ++nt) {
        const __nv_bfloat16* vr = vt_s + (nt * 8 + gr) * VS + kk * 16 + 2 * tq;
        mma_bf16(o[nt], a, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 8));
      }
    }
  }

  const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
  const bool in0 = q0 + r0 < Sq, in1 = q0 + r1 < Sq;
  // training's log-sum-exp, natural units (+inf: the row sees no key)
  if (lse != nullptr && tq == 0) {
    float* lrow = lse + ((long long)b * H + h) * Sq + q0;
    if (in0) lrow[r0] = l[0] > 0.f ? m[0] + logf(l[0]) : pos_inf();
    if (in1) lrow[r1] = l[1] > 0.f ? m[1] + logf(l[1]) : pos_inf();
  }
  __nv_bfloat16* o0 = out + (((long long)b * Sq + q0 + r0) * H + h) * DV;
  __nv_bfloat16* o1 = out + (((long long)b * Sq + q0 + r1) * H + h) * DV;
#pragma unroll
  for (int nt = 0; nt < DV / 8; ++nt) {
    const int c = nt * 8 + 2 * tq;
    if (in0)
      *reinterpret_cast<uint32_t*>(o0 + c) =
          pack_bf16(o[nt][0] / l0, o[nt][1] / l0);
    if (in1)
      *reinterpret_cast<uint32_t*>(o1 + c) =
          pack_bf16(o[nt][2] / l1, o[nt][3] / l1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, full float32 products
// ---------------------------------------------------------------------------
constexpr int F_BQ = 32, F_BK = 32;

template <int DK, int DV>
constexpr int f32_smem_bytes() {
  return (F_BQ * (DK + 1) + F_BK * (DK + 1) + F_BK * DV + F_BQ * (F_BK + 1)) *
             4 + (F_BQ + F_BK) * 4;
}

template <int DK, int DV>
__global__ void __launch_bounds__(128) fa_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ qpos,
    const int* __restrict__ kpos, float* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hkv, float scale,
    int causal, int window, int ldv) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                          // [BQ][DK+1]
  float* k_s = q_s + F_BQ * (DK + 1);         // [BK][DK+1]
  float* v_s = k_s + F_BK * (DK + 1);         // [BK][DV]
  float* p_s = v_s + F_BK * DV;               // [BQ][BK+1]
  int* qp_s = reinterpret_cast<int*>(p_s + F_BQ * (F_BK + 1));
  int* kp_s = qp_s + F_BQ;

  const int n_qb = (Sq + F_BQ - 1) / F_BQ;
  const int q0 = (n_qb - 1 - blockIdx.x) * F_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;  // query row, lane within its quad

  if (tid < F_BQ) {
    const int i = q0 + tid;
    qp_s[tid] = i < Sq ? qpos[(long long)b * Sq + i] : PAD_QPOS;
  }
  for (int e = tid; e < F_BQ * DK; e += 128) {
    const int i = e / DK, d = e % DK;
    q_s[i * (DK + 1) + d] =
        q0 + i < Sq ? q[(((long long)b * Sq + q0 + i) * H + h) * DK + d] : 0.f;
  }
  __syncthreads();
  const int qp = qp_s[r];

  float m = NEG_INF, l = 0.f;
  float acc[DV / 4];
#pragma unroll
  for (int i = 0; i < DV / 4; ++i) acc[i] = 0.f;

  const int n_kb = (Sk + F_BK - 1) / F_BK;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * F_BK;
    __syncthreads();
    if (tid < F_BK) {
      const int j = k0 + tid;
      kp_s[tid] = j < Sk ? kpos[(long long)b * Sk + j] : -1;
    }
    __syncthreads();
    bool any = false;
    {
      const int qpi = qp_s[tid & (F_BQ - 1)];
      const int j0 = (tid / F_BQ) * (F_BK * F_BQ / 128);
      for (int jj = 0; jj < F_BK * F_BQ / 128; ++jj)
        any |= visible(qpi, kp_s[j0 + jj], causal, window);
    }
    if (!__syncthreads_or(any)) continue;

    for (int e = tid; e < F_BK * DK; e += 128) {
      const int j = e / DK, d = e % DK;
      k_s[j * (DK + 1) + d] =
          k0 + j < Sk ? k[(((long long)b * Sk + k0 + j) * Hkv + hk) * DK + d]
                      : 0.f;
    }
    for (int e = tid; e < F_BK * DV; e += 128) {
      const int j = e / DV, d = e % DV;
      v_s[j * DV + d] =
          k0 + j < Sk ? v[(((long long)b * Sk + k0 + j) * Hkv + hk) * ldv + d]
                      : 0.f;
    }
    __syncthreads();

    // scores of keys c, c+4, ..., c+28 for query row r
    float s[F_BK / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < F_BK / 4; ++jj) {
      const int j = c + 4 * jj;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DK; ++d)
        dot = fmaf(q_s[r * (DK + 1) + d], k_s[j * (DK + 1) + d], dot);
      const bool vj = visible(qp, kp_s[j], causal, window);
      s[jj] = vj ? dot * scale : NEG_INF;
      mx = fmaxf(mx, s[jj]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float msafe = mn <= NEG_INF ? 0.f : mn;
    const float corr = m <= NEG_INF ? 0.f : expf(m - msafe);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < F_BK / 4; ++jj) {
      const int j = c + 4 * jj;
      const float p = visible(qp, kp_s[j], causal, window)
                          ? expf(s[jj] - msafe) : 0.f;
      sum += p;
      p_s[r * (F_BK + 1) + j] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * corr + sum;
    m = mn;
    __syncwarp();  // the row's p values (written by its quad) are visible
#pragma unroll
    for (int i = 0; i < DV / 4; ++i) {
      const int d = c + 4 * i;
      float pv = 0.f;
#pragma unroll 8
      for (int j = 0; j < F_BK; ++j)
        pv = fmaf(p_s[r * (F_BK + 1) + j], v_s[j * DV + d], pv);
      acc[i] = acc[i] * corr + pv;
    }
    __syncwarp();
  }

  if (q0 + r < Sq) {
    const float lr = fmaxf(l, 1e-30f);
    float* orow = out + (((long long)b * Sq + q0 + r) * H + h) * DV;
#pragma unroll
    for (int i = 0; i < DV / 4; ++i) orow[c + 4 * i] = acc[i] / lr;
    // training's log-sum-exp, natural units (+inf: the row sees no key)
    if (lse != nullptr && c == 0)
      lse[((long long)b * H + h) * Sq + q0 + r] =
          l > 0.f ? m + logf(l) : pos_inf();
  }
}

// ---------------------------------------------------------------------------
// bf16, (Dk, Dv) in {(64, 64), (128, 128)}: TMA, wgmma, a warp-specialised
// producer
// ---------------------------------------------------------------------------
// A partial tile's element mask: bit 4j + e (row qp0) and 4j + 2 + e (row
// qp1) for key 8j + 2tq + e of the tile starting at key k0, the layout of
// wgmma's m64n128 accumulator.
__device__ __forceinline__ uint64_t tile_mask(const int* kp_row, int k0,
                                              int Sk, int tq, int qp0,
                                              int qp1, int causal,
                                              int window) {
  uint64_t vis = 0ull;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + 2 * tq + e;
      const int kp = col < Sk ? __ldg(kp_row + col) : -1;
      vis |= static_cast<uint64_t>(visible(qp0, kp, causal, window))
             << (4 * j + e);
      vis |= static_cast<uint64_t>(visible(qp1, kp, causal, window))
             << (4 * j + 2 + e);
    }
  }
  return vis;
}


// The online softmax of one 128-key tile for this thread's two rows: S's
// registers 4j..4j+3 hold keys 8j + 2tq + {0, 1} of row 0 (4j, 4j+1) and
// row 1 (4j+2, 4j+3).  Turns s into P (float32), updates m (log2 units)
// and this thread's share of l, and gives each row's rescale factor.
// Scores are scaled by sl = scale * log2(e); a full tile takes one FFMA
// and one exp2 per score, a partial one applies `vis` first.  Maxima and
// sums run as four independent chains per row.
__device__ __forceinline__ void softmax_tile(float* s, bool partial,
                                             uint64_t vis, float sl,
                                             float* m, float* l,
                                             float* corr) {
  float mx[2][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) mx[0][a] = mx[1][a] = NEG_INF;
  if (partial) {
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      s[e] = (vis >> e) & 1ull ? s[e] * sl : NEG_INF;
      mx[(e >> 1) & 1][(e >> 2) & 3] = fmaxf(mx[(e >> 1) & 1][(e >> 2) & 3],
                                             s[e]);
    }
  } else {  // max(s * sl) = max(s) * sl, or max(-s) * -sl if sl < 0
    if (sl >= 0.f) {
#pragma unroll
      for (int e = 0; e < 64; ++e)
        mx[(e >> 1) & 1][(e >> 2) & 3] =
            fmaxf(mx[(e >> 1) & 1][(e >> 2) & 3], s[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 64; ++e)
        mx[(e >> 1) & 1][(e >> 2) & 3] =
            fmaxf(mx[(e >> 1) & 1][(e >> 2) & 3], -s[e]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      mx[0][a] *= fabsf(sl);
      mx[1][a] *= fabsf(sl);
    }
  }
  float mx0 = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
  float mx1 = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m[0], mx0), mn1 = fmaxf(m[1], mx1);
  const float ms0 = mn0 <= NEG_INF ? 0.f : mn0;
  const float ms1 = mn1 <= NEG_INF ? 0.f : mn1;
  corr[0] = m[0] <= NEG_INF ? 0.f : ex2(m[0] - ms0);
  corr[1] = m[1] <= NEG_INF ? 0.f : ex2(m[1] - ms1);
  if (partial) {
#pragma unroll
    for (int e = 0; e < 64; ++e)
      s[e] = (vis >> e) & 1ull ? ex2(s[e] - ((e & 2) ? ms1 : ms0)) : 0.f;
  } else {
#pragma unroll
    for (int e = 0; e < 64; ++e)
      s[e] = ex2(fmaf(s[e], sl, -((e & 2) ? ms1 : ms0)));
  }
  float sm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int e = 0; e < 64; ++e) sm[(e >> 1) & 1][(e >> 2) & 3] += s[e];
  l[0] = l[0] * corr[0] + ((sm[0][0] + sm[0][1]) + (sm[0][2] + sm[0][3]));
  l[1] = l[1] * corr[1] + ((sm[1][0] + sm[1][1]) + (sm[1][2] + sm[1][3]));
  m[0] = mn0;
  m[1] = mn1;
}

// P rounded to bf16 as wgmma's register A operand: keys 16kk..16kk+15 are
// S's column groups 2kk and 2kk + 1, in mma's A fragment order.
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*pf)[4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pf[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pf[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pf[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pf[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = Q K^T for one warpgroup's 64 rows: both operands K-major in shared
// memory, 16 columns of the depth per step, 64-column boxes 16 KB apart.
template <int D>
__device__ __forceinline__ void qk_issue(float* s, uint32_t qa,
                                         uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * 128 * 128 + (kk % 4) * 32;
    wgmma_ss_m64n128(s, sw128_desc(qa + off, 16, 1024),
                     sw128_desc(sk + off, 16, 1024), kk > 0);
  }
}


// Keeps P's registers, wgmma's A operand, from reuse until the product
// that reads them has been waited for.
__device__ __forceinline__ void fence_pf(uint32_t (*pf)[4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pf[kk][e])::"memory");
}

// O += P V for a 128-key tile: P from registers, V MN-major in shared
// memory (transposed by wgmma), 16 keys per step, 8-key groups 1024 bytes
// apart (SBO) and 64-column boxes 16 KB apart (LBO).
template <int D>
__device__ __forceinline__ void pv_issue(float* o, uint32_t (*pf)[4],
                                         uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t dv = sw128_desc(sv + kk * 16 * 128, 128 * 128, 1024);
    if constexpr (D == 128)
      wgmma_rs_m64n128(o, pf[kk], dv);
    else
      wgmma_rs_m64n64(o, pf[kk], dv);
  }
}

// The consumer warpgroups' turns at the tensor cores: warpgroup w waits on
// named barrier 3 + w until the other has passed it the turn.
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int to) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + to) : "memory");
}

// Shared memory of the wgmma kernel, from a 1024-byte aligned base: two Q
// buffers (one item's Q while the next one's loads), a ring of STAGES K
// and V tiles, the mbarriers (Q full and Q empty per buffer; K full,
// V full, K empty and V empty per stage), one slot per Q buffer naming
// its item (b, h, q0; w = 0 ends the work) and one per stage naming the
// tile it holds (index and class; index -1 ends the item).  Each tile is
// D / 64 boxes of 128 rows x 128 bytes.
template <int D>
struct WgLayout {
  // D = 128: 2 x 32 KB of Q and 2 x 64 KB of K and V, 192 KB; D = 64:
  // four stages, 160 KB.  (At D = 128, three stages with one Q buffer
  // measured no faster.)
  static constexpr int BQ = 128, BK = 128, BOX = 128 * 128;
  static constexpr int STAGES = D == 128 ? 2 : 4, QBUF = 2;
  static constexpr int Q_BYTES = BQ * D * 2, KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = QBUF * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int ISLOT_OFF = BAR_OFF + 8 * (2 * QBUF + 4 * STAGES);
  static constexpr int SLOT_OFF = ISLOT_OFF + 16 * QBUF;
  static constexpr int BYTES = 1024 + SLOT_OFF + 8 * STAGES;
};

// The work items in order: the rep = H / Hkv heads of one KV head next to
// each other, then the query blocks of that KV head and batch row,
// heaviest first, then the next KV head, so that the CTAs at work read the
// K/V tiles of a few KV heads, which stay in L2.  CTA j of P takes items
// j, 2P - 1 - j, 2P + j, 4P - 1 - j, ... (`item_of`, a snake over the
// rounds of P, which evens out the CTAs' causal work).
template <int D>
__global__ void __launch_bounds__(384, 1) fa_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, const int* __restrict__ qpos,
    const int* __restrict__ kpos, float* __restrict__ lse, int Sq, int Sk,
    int H, int Hkv, int B, float scale, int causal, int window) {
  using L = WgLayout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES, QB = L::QBUF;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t bar = base + L::BAR_OFF;
  int4* islot = reinterpret_cast<int4*>(gbase + L::ISLOT_OFF);
  int2* slot = reinterpret_cast<int2*>(gbase + L::SLOT_OFF);
#define Q_BUF(q) (base + (q) * L::Q_BYTES)
#define FULL_Q(q) (bar + 8 * (q))
#define EMPTY_Q(q) (bar + 8 * (QB + (q)))
#define FULL_K(s) (bar + 8 * (2 * QB + (s)))
#define FULL_V(s) (bar + 8 * (2 * QB + ST + (s)))
#define EMPTY_K(s) (bar + 8 * (2 * QB + 2 * ST + (s)))
#define EMPTY_V(s) (bar + 8 * (2 * QB + 3 * ST + (s)))

  const int n_qb = (Sq + BQ - 1) / BQ, n_kb = (Sk + BK - 1) / BK;
  const int n_items = n_qb * H * B, rep = H / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int q = 0; q < QB; ++q) {
      mbar_init(FULL_Q(q), 1);
      mbar_init(EMPTY_Q(q), 2);  // one thread of each consumer warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(FULL_K(s), 1);
      mbar_init(FULL_V(s), 1);
      mbar_init(EMPTY_K(s), 256);  // every consumer thread releases K
      mbar_init(EMPTY_V(s), 256);  // and V of the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: for each item one warp loads Q, classes
    // each KV tile as it comes and sends the tiles that are not skipped
    // through the ring (one thread issues every TMA copy), then an end of
    // item; the slots tell the consumers what each buffer holds ----------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 0) return;
    int ring = 0, n = 0;  // stages sent, items sent
    for (int item; (item = item_of(n, blockIdx.x, gridDim.x)) < n_items;
         ++n) {
      const int g = item / rep / n_qb;  // (batch row, KV head)
      const int hk = g % Hkv, b = g / Hkv;
      const int h = hk * rep + item % rep;
      const int q0 = (n_qb - 1 - item / rep % n_qb) * BQ;
      if (lane == 0) {
        const int q = n % QB;
        mbar_wait(EMPTY_Q(q), ((n / QB) & 1) ^ 1);
        islot[q] = make_int4(b, h, q0, 1);
        mbar_expect_tx(FULL_Q(q), L::Q_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(Q_BUF(q) + c * L::BOX, &tm_q, FULL_Q(q), c * 64, h, q0,
                      b);
      }
      int qmin = INT_HI, qmax = INT_LO;  // the block's rows before Sq
#pragma unroll
      for (int e = 0; e < BQ / 32; ++e) {
        const int i = q0 + lane * (BQ / 32) + e;
        if (i < Sq) {
          const int qp = qpos[(long long)b * Sq + i];
          qmin = min(qmin, qp);
          qmax = max(qmax, qp);
        }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
        qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
      }
      for (int t = 0; t <= n_kb; ++t) {
        int cl = TILE_SKIP;
        if (t < n_kb) {
          int lo = INT_HI, hi = INT_LO;
          bool neg = false;
#pragma unroll
          for (int e = 0; e < BK / 32; ++e) {
            const int j = t * BK + lane * (BK / 32) + e;
            const int kp = j < Sk ? kpos[(long long)b * Sk + j] : -1;
            if (kp < 0) {
              neg = true;
            } else {
              lo = min(lo, kp);
              hi = max(hi, kp);
            }
          }
#pragma unroll
          for (int off = 16; off; off >>= 1) {
            lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
            hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
          }
          neg = __any_sync(0xffffffffu, neg);
          cl = tile_class(lo, hi, neg, qmin, qmax, causal, window);
          if (cl == TILE_SKIP) continue;
        }
        if (lane == 0) {  // tile t, or (t == n_kb) the end of the item
          const int s = ring % ST;
          const uint32_t par = ((ring / ST) & 1) ^ 1;
          const uint32_t sk = base + L::K_OFF + s * L::KV_BYTES;
          const uint32_t sv = base + L::V_OFF + s * L::KV_BYTES;
          mbar_wait(EMPTY_K(s), par);
          slot[s] = make_int2(t < n_kb ? t : -1, cl);  // published below
          if (t < n_kb) {
            mbar_expect_tx(FULL_K(s), L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              tma_load_4d(sk + c * L::BOX, &tm_k, FULL_K(s), c * 64, hk,
                          t * BK, b);
          } else {
            mbar_arrive(FULL_K(s));
          }
          mbar_wait(EMPTY_V(s), par);
          if (t < n_kb) {
            mbar_expect_tx(FULL_V(s), L::KV_BYTES);
#pragma unroll
            for (int c = 0; c < D / 64; ++c)
              tma_load_4d(sv + c * L::BOX, &tm_v, FULL_V(s), c * 64, hk,
                          t * BK, b);
          } else {
            mbar_arrive(FULL_V(s));
          }
        }
        __syncwarp();
        ++ring;
      }
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
  const int w = warp / 4 - 1, wl = warp & 3;
  const int tq = lane & 3;
  const int r0 = 64 * w + 16 * wl + (lane >> 2), r1 = r0 + 8;  // block rows
  const float sl = scale * 1.4426950408889634f;  // scores in log2 units
  float o[D / 2];
  float s[BK / 2];
  uint32_t pf[BK / 16][4];

  int ring = 0;  // stages consumed
  for (int n = 0;; ++n) {
    const int q = n % QB;
    mbar_wait(FULL_Q(q), (n / QB) & 1);
    const int4 it = islot[q];
    if (!it.w) break;
    const int b = it.x, h = it.y, q0 = it.z;
    const int qp0 =
        q0 + r0 < Sq ? qpos[(long long)b * Sq + q0 + r0] : PAD_QPOS;
    const int qp1 =
        q0 + r1 < Sq ? qpos[(long long)b * Sq + q0 + r1] : PAD_QPOS;
    const int* kp_row = kpos + (long long)b * Sk;
    const uint32_t qa = Q_BUF(q) + w * 64 * 128;  // this warpgroup's rows

    // m (in log2 units) and this thread's share of l, for rows r0 and r1
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;

    // Software pipeline over the item's tiles: tile i's S = Q K^T is
    // issued with tile i-1's O += P V, and tile i's softmax runs while
    // that product is in flight.  The two warpgroups take turns to issue
    // their products (named barriers 3 and 4, warpgroup 0 first), so one's
    // softmax overlaps the other's products.  The first tile (no PV yet)
    // and the last PV are peeled, so no wait is conditional.
    int st = ring % ST;
    uint32_t ph = (ring / ST) & 1;
    mbar_wait(FULL_K(st), ph);
    int2 tile = slot[st];
    if (tile.x >= 0) {
      bool part = tile.y == TILE_PARTIAL;
      uint64_t vis = part ? tile_mask(kp_row, tile.x * BK, Sk, tq, qp0, qp1,
                                      causal, window)
                          : ~0ull;
      if (w == 1) turn_pass(0);
      turn_wait(w);
      wgmma_fence();
      qk_issue<D>(s, qa, base + L::K_OFF + st * L::KV_BYTES);
      wgmma_commit();
      turn_pass(1 - w);
      wgmma_wait<0>();
      fence_regs<BK / 2>(s);
      mbar_arrive(EMPTY_K(st));
      softmax_tile(s, part, vis, sl, m, l, corr);
      pack_p(s, pf);

      int pst = st;  // the previous tile's stage and phase
      uint32_t pph = ph;
      for (;;) {
        ++ring;
        st = ring % ST;
        ph = (ring / ST) & 1;
        mbar_wait(FULL_K(st), ph);
        tile = slot[st];
        if (tile.x < 0) break;
        part = tile.y == TILE_PARTIAL;
        vis = part ? tile_mask(kp_row, tile.x * BK, Sk, tq, qp0, qp1, causal,
                               window)
                   : ~0ull;
        mbar_wait(FULL_V(pst), pph);
        turn_wait(w);
        fence_regs<D / 2>(o);
        wgmma_fence();
        qk_issue<D>(s, qa, base + L::K_OFF + st * L::KV_BYTES);
        wgmma_commit();
        pv_issue<D>(o, pf, base + L::V_OFF + pst * L::KV_BYTES);
        wgmma_commit();
        turn_pass(1 - w);
        wgmma_wait<1>();   // S is ready; the PV product runs on
        fence_regs<BK / 2>(s);
        mbar_arrive(EMPTY_K(st));
        softmax_tile(s, part, vis, sl, m, l, corr);
        wgmma_wait<0>();   // the previous tile's PV is done: V, P are free
        fence_regs<D / 2>(o);
        fence_pf(pf);
        mbar_arrive(EMPTY_V(pst));
#pragma unroll
        for (int e = 0; e < D / 8; ++e) {
          o[4 * e] *= corr[0];
          o[4 * e + 1] *= corr[0];
          o[4 * e + 2] *= corr[1];
          o[4 * e + 3] *= corr[1];
        }
        pack_p(s, pf);
        pst = st;
        pph = ph;
      }
      // the last tile's O += P V
      mbar_wait(FULL_V(pst), pph);
      turn_wait(w);
      fence_regs<D / 2>(o);
      wgmma_fence();
      pv_issue<D>(o, pf, base + L::V_OFF + pst * L::KV_BYTES);
      wgmma_commit();
      if (w == 0) turn_pass(1);
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      fence_pf(pf);
      mbar_arrive(EMPTY_V(pst));
    }
    // the end of the item holds no tile: release its stage
    mbar_arrive(EMPTY_K(st));
    mbar_arrive(EMPTY_V(st));
    ++ring;

    // ---- epilogue: O / l in bf16 through shared memory, one TMA store --
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
    }
    const float l0 = fmaxf(l[0], 1e-30f), l1 = fmaxf(l[1], 1e-30f);
    // training's log-sum-exp in natural units, from m (log2 units, the
    // scale folded in) and l; +inf where the row sees no key
    if (lse != nullptr && tq == 0) {
      float* lrow = lse + ((long long)b * H + h) * Sq + q0;
      if (q0 + r0 < Sq)
        lrow[r0] = l[0] > 0.f ? (m[0] + log2f(l[0])) * 0.6931471805599453f
                              : pos_inf();
      if (q0 + r1 < Sq)
        lrow[r1] = l[1] > 0.f ? (m[1] + log2f(l[1])) * 0.6931471805599453f
                              : pos_inf();
    }
    // this warpgroup's rows of Q are read out: O takes their place, in the
    // 128-byte swizzle the output's tensor map expects
    uint8_t* qg = gbase + q * L::Q_BYTES;
#pragma unroll
    for (int e = 0; e < D / 8; ++e) {
      const int box = e / 8, ch = e % 8;
      uint8_t* p0 = qg + box * L::BOX + r0 * 128 + ((ch ^ (r0 & 7)) << 4);
      uint8_t* p1 = qg + box * L::BOX + r1 * 128 + ((ch ^ (r1 & 7)) << 4);
      *reinterpret_cast<uint32_t*>(p0 + 4 * tq) =
          pack_bf16(o[4 * e] / l0, o[4 * e + 1] / l0);
      *reinterpret_cast<uint32_t*>(p1 + 4 * tq) =
          pack_bf16(o[4 * e + 2] / l1, o[4 * e + 3] / l1);
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
    if ((tid & 127) == 0) {
      if (q0 + 64 * w < Sq) {
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_store_4d(&tm_o, qa + c * L::BOX, c * 64, h, q0 + 64 * w, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      mbar_arrive(EMPTY_Q(q));  // the Q buffer may load the next item
    }
  }
#undef Q_BUF
#undef FULL_Q
#undef EMPTY_Q
#undef FULL_K
#undef FULL_V
#undef EMPTY_K
#undef EMPTY_V
}

// ---------------------------------------------------------------------------
// bf16, (Dk, Dv) = (576, 512): MLA's latent attention (DeepSeek-V2: keys of
// 512 latent + 64 rope columns, the 512 latent columns as values, one KV
// head): TMA, wgmma, a warp-specialised persistent CTA, K tiles that also
// serve as V
// ---------------------------------------------------------------------------
// In MLA the value is the key's first 512 columns (k = [c_kv ; k_rope],
// v = c_kv), so the kernel takes V as a view of K (the launcher refuses
// any other v) and one K tile in shared memory feeds both products.  A 64-
// row float32 O of width 512 is 256 registers a thread for one warpgroup,
// so two consumer warpgroups share each item's 64 rows and split O by
// columns.  Consumer 0 alone computes S for each 64-key tile (wgmma
// m64n64k16, 36 steps over the depth of 576, Q and K K-major in shared
// memory, so Q is read once a tile) and its online softmax (a full tile
// takes no mask: one FFMA and one exp2 a score), writes P in bf16 into
// the tile's rope box (box 8, which only S reads) and each row's rescale
// beside it, and arrives on a named barrier (one a stage); consumer 1
// waits there.  Each then rescales its O (skipped where no row of the
// warp has a new maximum) and adds P V (wgmma m64n128k16 / m64n256k16, P
// K-major from its box, V read MN-major from the K tile's first 8 boxes,
// so it is never transposed).  Consumer 0, whose S and softmax are the
// critical path, owns O's first 128 columns (64 registers a thread),
// consumer 1 the other 384 (192 registers): consumer 0 goes on to the
// next tile's S while consumer 1 finishes this tile's PV.  (Splitting S by
// keys between the two instead reads Q twice a tile and needs a row-maxima
// exchange; a 256 / 256 split of O keeps consumer 0 longer on each tile:
// both measured slower, PERF.md.)
//
// A work item is 64 rows of one KV head's (query, head) pairs in q's own
// order (query-major, its rep = H / Hkv heads within): at Hkv = 1, 4
// queries x 16 heads, contiguous in q and out, all sharing every K tile.
// The grid is persistent (one CTA an SM) and walks the items heaviest
// query block first across the batch rows and KV heads, in item_of's
// snake.  A producer warpgroup (setmaxnreg 40) has one warp at work: it
// classes an item's KV tiles 32 at a time (a lane a tile, tile_class) and
// sends the tiles some pair sees through a two-stage ring of 64-key tiles
// (one thread issues the TMA copies: 9 boxes of 64 keys x 128 bytes,
// 128-byte swizzle), each with a slot naming the tile, its class and
// whether it is the item's last (an item with no visible tile sends one
// empty slot).  Q is loaded once an item: by TMA when the item's rows are
// a box of q (rep divides 64: a (64, rep, 64 / rep) box of the (576, H,
// Sq, B) map), issued after the item's first tile and once consumer 0
// has finished the previous item's last S product; otherwise the
// consumers copy it with cp.async into the same layout.  A tile holds its
// stage through S and PV; while one tile is computed the next one loads
// into the other stage (Q takes 72 KB, so two 72 KB stages are all that
// fit; three 48-key stages with part of Q in registers measured no
// faster).  The last tile's stage stages O's epilogue (O / l in bf16, 128-
// byte swizzle) for a TMA store, or for 16-byte stores of the rows before
// the end when Q came by cp.async; rows past the end are never written.
// A full tile is not masked; a partial one takes the element mask from
// its key positions; rows past the end have position 2^30.  Shared
// memory: Q 72 KB, the ring 2 x 72 KB, 217 KB in all.
struct MlaLayout {
  static constexpr int DK = 576, DV = 512;
  static constexpr int BQ = 64, BK = 64, STAGES = 2;
  static constexpr int BOX = 64 * 128;  // 64 rows x 128 bytes
  static constexpr int TILE_BYTES = DK / 64 * BOX;  // Q, or a K tile
  static constexpr int K_OFF = TILE_BYTES;
  static constexpr int CX_OFF = K_OFF + STAGES * TILE_BYTES;  // [ST][64] f32
  static constexpr int LX_OFF = CX_OFF + STAGES * 64 * 4;     // [2][64] f32
  static constexpr int BAR_OFF = LX_OFF + 2 * 64 * 4;
  static constexpr int SLOT_OFF = BAR_OFF + 8 * (2 + 2 * STAGES);
  static constexpr int BYTES = 1024 + SLOT_OFF + 16 * STAGES;
};

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_ss_m64n256_tb(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_m64n128_tb(float* d, uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S = Q K^T for a 64-key tile: Q (64 rows) and the keys K-major in shared
// memory, 16 columns of the depth a step, 64-column boxes 8 KB apart.
__device__ __forceinline__ void mla_qk(float* s, uint32_t qa, uint32_t kb) {
#pragma unroll
  for (int kk = 0; kk < MlaLayout::DK / 16; ++kk) {
    const uint32_t off = (kk / 4) * MlaLayout::BOX + (kk % 4) * 32;
    wgmma_ss_m64n64(s, sw128_desc(qa + off, 16, 1024),
                    sw128_desc(kb + off, 16, 1024), kk > 0);
  }
}

// O += P V for one consumer's NB 64-column boxes of a 64-key tile (2:
// m64n128; 6: m64n256 and m64n128): P K-major in its shared-memory box, V
// MN-major in the K tile (8-key groups 1024 bytes apart, 64-column boxes
// 8 KB apart).
template <int NB>
__device__ __forceinline__ void mla_pv(float* o, uint32_t pa, uint32_t sv) {
  static_assert(NB == 2 || NB == 6, "O's boxes");
#pragma unroll
  for (int kk = 0; kk < MlaLayout::BK / 16; ++kk) {
    const uint64_t da = sw128_desc(pa + kk * 32, 16, 1024);
    const uint32_t v = sv + kk * 16 * 128;
    if constexpr (NB == 6)
      wgmma_ss_m64n256_tb(o, da, sw128_desc(v, MlaLayout::BOX, 1024), 1);
    wgmma_ss_m64n128_tb(o + (NB - 2) * 32, da,
                        sw128_desc(v + (NB - 2) * MlaLayout::BOX,
                                   MlaLayout::BOX, 1024),
                        1);
  }
}

// The consumers' split of O: consumer 0 (S, the softmax) owns the first
// MLA_C0_BOXES 64-column boxes, consumer 1 the rest.
constexpr int MLA_C0_BOXES = 2;
template <int W>
struct MlaConsumer {
  static constexpr int value = W;
};

// A partial tile's element mask: bit 4j + x (row qp0) and 4j + 2 + x (row
// qp1) for key k0 + 8j + 2tq + x, the layout of wgmma's m64n64
// accumulator.
__device__ __forceinline__ uint32_t mla_mask(const int* kp_row, int k0,
                                             int Sk, int tq, int qp0,
                                             int qp1, int causal,
                                             int window) {
  uint32_t vis = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int col = k0 + 8 * j + 2 * tq + x;
      const int kp = col < Sk ? __ldg(kp_row + col) : -1;
      vis |= static_cast<uint32_t>(visible(qp0, kp, causal, window))
             << (4 * j + x);
      vis |= static_cast<uint32_t>(visible(qp1, kp, causal, window))
             << (4 * j + 2 + x);
    }
  }
  return vis;
}

// Named barriers: a tile's P is ready (1 + its stage: consumer 0 arrives,
// consumer 1 waits), the item's 1 / l (5, both), one consumer alone
// (3 + w).
constexpr int MLA_BAR_P = 1, MLA_BAR_ITEM = 5;
__device__ __forceinline__ void mla_bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void mla_bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void mla_wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + w) : "memory");
}

// Item `item`: its batch row, KV head and block of 64 (query, head) rows,
// heaviest block first across the batch rows and KV heads.
struct MlaItem {
  int b, hk, blk;
};
__device__ __forceinline__ MlaItem mla_item(int item, int Hkv, int G,
                                            int n_blk) {
  const int g = item % G;
  return {g / Hkv, g % Hkv, n_blk - 1 - item / G};
}

__global__ void __launch_bounds__(384, 1) fa_mla_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_o,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int* __restrict__ qpos,
    const int* __restrict__ kpos, int Sq, int Sk, int H, int Hkv, int B,
    float scale, int causal, int window, int q_tma) {
  using L = MlaLayout;
  constexpr int BQ = L::BQ, BK = L::BK, ST = L::STAGES, BOX = L::BOX;
  extern __shared__ uint8_t smem_mla[];
  const uint32_t raw = smem_u32(smem_mla);
  const uint32_t base = (raw + 1023u) & ~1023u;  // Q; K stages follow
  uint8_t* gbase = smem_mla + (base - raw);
  const uint32_t bar = base + L::BAR_OFF;
  float* cx_s = reinterpret_cast<float*>(gbase + L::CX_OFF);
  float* lx_s = reinterpret_cast<float*>(gbase + L::LX_OFF);
  int4* slot = reinterpret_cast<int4*>(gbase + L::SLOT_OFF);
#define FULL_Q (bar)
#define EMPTY_Q (bar + 8)
#define FULL_K(s) (bar + 8 * (2 + (s)))
#define EMPTY_K(s) (bar + 8 * (2 + ST + (s)))
#define K_STAGE(s) (base + L::K_OFF + (s) * L::TILE_BYTES)

  // rows: Sq * rep < 2^31 (the launcher checks)
  const int rep = H / Hkv, rows = Sq * rep;
  const int n_blk = (rows + BQ - 1) / BQ, n_kb = (Sk + BK - 1) / BK;
  const int G = B * Hkv, n_items = n_blk * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(FULL_Q, 1);
    mbar_init(EMPTY_Q, 128);  // consumer 0's threads, after its last S
    for (int s = 0; s < ST; ++s) {
      mbar_init(FULL_K(s), 1);
      mbar_init(EMPTY_K(s), 256);  // every consumer thread, after its PV
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one warp classes each item's KV tiles and
    // one thread of it sends the visible ones through the ring, then Q --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != 0) return;
    int ring = 0;  // stages sent
    for (int n = 0;; ++n) {
      const int item = item_of(n, blockIdx.x, gridDim.x);
      if (item >= n_items) break;
      const MlaItem it = mla_item(item, Hkv, G, n_blk);
      const int* kp_row = kpos + (long long)it.b * Sk;
      int qmin = INT_HI, qmax = INT_LO;  // the block's rows before the end
      for (int r = lane; r < BQ; r += 32) {
        const int rr = it.blk * BQ + r;
        if (rr < rows) {
          const int qp = qpos[(long long)it.b * Sq + rr / rep];
          qmin = min(qmin, qp);
          qmax = max(qmax, qp);
        }
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
        qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
      }
      // Tiles r0..r0+31 classed at once, a lane a tile: bit t - r0 of vb
      // (some pair sees the tile) and pb (it takes the element mask).
      int r0 = 0;
      uint32_t vb = 0u, pb = 0u;
      auto classify = [&](int from) {
        r0 = from;
        const int t = from + lane;
        int cl = TILE_SKIP;
        if (t < n_kb) {
          int lo = INT_HI, hi = INT_LO;
          bool neg = false;
          if ((Sk & 3) == 0 &&  // 16-byte loads: 4 keys in or past Sk
              (reinterpret_cast<uintptr_t>(kpos) & 15) == 0) {
#pragma unroll 4
            for (int e = 0; e < BK; e += 4) {
              const int j = t * BK + e;
              const int4 kp4 =
                  j < Sk ? __ldg(reinterpret_cast<const int4*>(kp_row + j))
                         : make_int4(-1, -1, -1, -1);
              const int kps[4] = {kp4.x, kp4.y, kp4.z, kp4.w};
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                neg |= kps[x] < 0;
                lo = kps[x] < 0 ? lo : min(lo, kps[x]);
                hi = kps[x] < 0 ? hi : max(hi, kps[x]);
              }
            }
          } else {
#pragma unroll 8
            for (int e = 0; e < BK; ++e) {
              const int j = t * BK + e;
              const int kp = j < Sk ? __ldg(kp_row + j) : -1;
              neg |= kp < 0;
              lo = kp < 0 ? lo : min(lo, kp);
              hi = kp < 0 ? hi : max(hi, kp);
            }
          }
          cl = tile_class(lo, hi, neg, qmin, qmax, causal, window);
        }
        vb = __ballot_sync(0xffffffffu, cl != TILE_SKIP);
        pb = __ballot_sync(0xffffffffu, cl == TILE_PARTIAL);
      };
      // the first tile from t on that some pair sees, or n_kb
      auto find = [&](int t) -> int {
        while (t < n_kb) {
          if (t >= r0 + 32) classify(t);
          const uint32_t m = vb >> (t - r0);
          if (m) return t + __ffs(m) - 1;
          t = r0 + 32;
        }
        return n_kb;
      };
      classify(0);
      int t = find(0);
      bool q_sent = !q_tma;
      do {  // tile t, or (t == n_kb: none is visible) an empty slot
        int cl = TILE_PARTIAL, tn = n_kb;
        if (t < n_kb) {
          cl = (pb >> (t - r0)) & 1u ? TILE_PARTIAL : TILE_FULL;
          tn = find(t + 1);
        }
        if (lane == 0) {
          const int s = ring % ST;
          mbar_wait(EMPTY_K(s), ((ring / ST) & 1) ^ 1);
          slot[s] = make_int4(t < n_kb ? t : -1, cl, tn == n_kb, 0);
          const bool load_k = t < n_kb;  // the tile's TMA copies
          if (load_k) {
            mbar_expect_tx(FULL_K(s), L::TILE_BYTES);
#pragma unroll
            for (int c = 0; c < L::DK / 64; ++c)
              tma_load_4d(K_STAGE(s) + c * BOX, &tm_k, FULL_K(s), c * 64,
                          it.hk, t * BK, it.b);
          } else {
            mbar_arrive(FULL_K(s));
          }
          if (!q_sent) {  // Q, once the consumers are done with the last
            mbar_wait(EMPTY_Q, (n & 1) ^ 1);
            mbar_expect_tx(FULL_Q, L::TILE_BYTES);
#pragma unroll
            for (int c = 0; c < L::DK / 64; ++c)
              tma_load_4d(base + c * BOX, &tm_q, FULL_Q, c * 64,
                          it.hk * rep, it.blk * (BQ / rep), it.b);
          }
        }
        __syncwarp();
        q_sent = true;
        ++ring;
        t = tn;
      } while (t < n_kb);
    }
    return;
  }

  // ---- two consumer warpgroups over all 64 rows of each item: consumer 0
  // computes each tile's S and softmax and writes P (bf16) into the
  // tile's rope box, free once S has read it, and each row's rescale
  // beside it; each consumer adds P V into its share of O's columns:
  // consumer 0, on the critical path, MLA_C0_BOXES of the 8 64-column
  // boxes, consumer 1 the rest --------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int w = warp / 4 - 1, wl = warp & 3, ctid = tid & 127;
  const int tq = lane & 3;
  const int r0 = 16 * wl + (lane >> 2), r1 = r0 + 8;  // the item's rows
  const float sl = scale * 1.4426950408889634f;  // scores in log2 units
  auto consume = [&](auto which) {
    constexpr int W = decltype(which)::value;
    constexpr int B0 = W == 0 ? 0 : MLA_C0_BOXES;  // O's first box, and
    constexpr int NB = W == 0 ? MLA_C0_BOXES : 8 - MLA_C0_BOXES;  // count
    float o[NB * 32];
    float s[64 / 2];

    int ring = 0;  // stages consumed
    for (int n = 0;; ++n) {
      const int item = item_of(n, blockIdx.x, gridDim.x);
      if (item >= n_items) break;
      const MlaItem it = mla_item(item, Hkv, G, n_blk);
      const int rr0 = it.blk * BQ;
      const int qp0 = rr0 + r0 < rows
                          ? qpos[(long long)it.b * Sq + (rr0 + r0) / rep]
                          : PAD_QPOS;
      const int qp1 = rr0 + r1 < rows
                          ? qpos[(long long)it.b * Sq + (rr0 + r1) / rep]
                          : PAD_QPOS;
      const int* kp_row = kpos + (long long)it.b * Sk;
      if (q_tma) {
        if (W == 0) mbar_wait(FULL_Q, n & 1);
      } else {  // 64 rows x 72 chunks of 16 bytes, zeros past the end
        for (int e = tid - 128; e < BQ * (L::DK / 8); e += 256) {
          const int r = e / (L::DK / 8), c = e % (L::DK / 8), rr = rr0 + r;
          const long long row =
              rr < rows ? ((long long)it.b * Sq + rr / rep) * H + it.hk * rep +
                              rr % rep
                        : 0;
          cp_async16(
              base + (c / 8) * BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4),
              q + row * L::DK + c * 8, rr < rows);
        }
        cp_async_commit();
        cp_async_wait<0>();
        fence_proxy_async();
        mla_bar_sync(MLA_BAR_ITEM);
      }

      // m (in log2 units) and this thread's share of l, for rows r0 and r1
      // (consumer 0's)
      float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
#pragma unroll
      for (int e = 0; e < NB * 32; ++e) o[e] = 0.f;
      int st;
      for (;;) {
        st = ring % ST;
        mbar_wait(FULL_K(st), (ring / ST) & 1);
        const int4 tile = slot[st];
        ++ring;
        if (tile.x < 0) {  // no visible tile: O = 0
          if (q_tma && W == 0) mbar_arrive(EMPTY_Q);
          break;
        }
        const uint32_t kst = K_STAGE(st), pbox = kst + 8 * BOX;
        float* cx = cx_s + st * 64;  // each row's rescale for this tile
        float c0, c1;
        if constexpr (W == 0) {
          wgmma_fence();
          mla_qk(s, base, kst);
          wgmma_commit();
          const uint32_t vis =
              tile.y == TILE_PARTIAL
                  ? mla_mask(kp_row, tile.x * BK, Sk, tq, qp0, qp1, causal,
                             window)
                  : 0xffffffffu;
          wgmma_wait<0>();
          fence_regs<32>(s);
          if (tile.z && q_tma) mbar_arrive(EMPTY_Q);  // Q is read out

          // scale and mask; row maxima over the quad.  A full tile takes no
          // mask, and one FFMA and one exp2 a score: max(s * sl) = max(s) *
          // sl, or max(-s) * -sl if sl < 0
          const bool part = tile.y == TILE_PARTIAL;
          float mx0 = NEG_INF, mx1 = NEG_INF;
          if (part) {
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              s[e] = (vis >> e) & 1u ? s[e] * sl : NEG_INF;
              if (e & 2)
                mx1 = fmaxf(mx1, s[e]);
              else
                mx0 = fmaxf(mx0, s[e]);
            }
          } else {
            const float sg = sl >= 0.f ? 1.f : -1.f;
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              if (e & 2)
                mx1 = fmaxf(mx1, s[e] * sg);
              else
                mx0 = fmaxf(mx0, s[e] * sg);
            }
            mx0 *= fabsf(sl);
            mx1 *= fabsf(sl);
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
          }
          const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
          const float ms0 = mn0 <= NEG_INF ? 0.f : mn0;
          const float ms1 = mn1 <= NEG_INF ? 0.f : mn1;
          c0 = m0 <= NEG_INF ? 0.f : ex2(m0 - ms0);
          c1 = m1 <= NEG_INF ? 0.f : ex2(m1 - ms1);
          float sum0 = 0.f, sum1 = 0.f;
          if (part) {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              s[e] = (vis >> e) & 1u ? ex2(s[e] - ((e & 2) ? ms1 : ms0)) : 0.f;
          } else {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              s[e] = ex2(fmaf(s[e], sl, -((e & 2) ? ms1 : ms0)));
          }
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            if (e & 2)
              sum1 += s[e];
            else
              sum0 += s[e];
          }
          l0 = l0 * c0 + sum0;
          l1 = l1 * c1 + sum1;
          m0 = mn0;
          m1 = mn1;
          // P in bf16 into the rope box: wgmma's K-major A operand, 128-byte
          // swizzle (keys 8j..8j+7 of a row are its 16-byte chunk j)
          uint8_t* pg = gbase + (pbox - base);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            *reinterpret_cast<uint32_t*>(pg + r0 * 128 + ((j ^ (r0 & 7)) << 4) +
                                         4 * tq) =
                pack_bf16(s[4 * j], s[4 * j + 1]);
            *reinterpret_cast<uint32_t*>(pg + r1 * 128 + ((j ^ (r1 & 7)) << 4) +
                                         4 * tq) =
                pack_bf16(s[4 * j + 2], s[4 * j + 3]);
          }
          if (tq == 0) {
            cx[r0] = c0;
            cx[r1] = c1;
          }
          fence_proxy_async();
          mla_bar_arrive(MLA_BAR_P + st);
        } else {
          mla_bar_sync(MLA_BAR_P + st);
          c0 = cx[r0];
          c1 = cx[r1];
        }
        // O's rescale, unless no row of the warp has a new maximum
        if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
          for (int e = 0; e < NB * 8; ++e) {
            o[4 * e] *= c0;
            o[4 * e + 1] *= c0;
            o[4 * e + 2] *= c1;
            o[4 * e + 3] *= c1;
          }
        }
        fence_regs<NB * 32>(o);
        wgmma_fence();
        mla_pv<NB>(o, pbox, kst + B0 * BOX);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NB * 32>(o);
        if (tile.z) break;  // the last tile's stage stages the epilogue
        mbar_arrive(EMPTY_K(st));
      }

      // ---- epilogue: 1 / l from consumer 0 (by item parity: the other may
      // still read the last item's); O / l in bf16 into the held stage (this
      // consumer's V boxes, which only its own PV read), then a TMA store or
      // 16-byte stores; the stage is released ------------------------------
      float* lx = lx_s + (n & 1) * 64;
      if constexpr (W == 0) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, off);
          l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        if (tq == 0) {
          lx[r0] = 1.f / fmaxf(l0, 1e-30f);
          lx[r1] = 1.f / fmaxf(l1, 1e-30f);
          // training's log-sum-exp in natural units, from m (log2 units,
          // the scale folded in) and l; +inf where the row sees no key
          if (lse != nullptr) {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int rr = rr0 + (x ? r1 : r0);
              const float lx_ = x ? l1 : l0, mx_ = x ? m1 : m0;
              if (rr < rows)
                lse[((long long)it.b * H + it.hk * rep + rr % rep) * Sq +
                    rr / rep] = lx_ > 0.f
                                    ? (mx_ + log2f(lx_)) * 0.6931471805599453f
                                    : pos_inf();
            }
          }
        }
      }
      mla_bar_sync(MLA_BAR_ITEM);
      const float i0 = lx[r0], i1 = lx[r1];
      const uint32_t ob = K_STAGE(st) + B0 * BOX;
      uint8_t* og = gbase + (ob - base);
#pragma unroll
      for (int e = 0; e < NB * 8; ++e) {
        const int box = e / 8, ch = e % 8;
        uint8_t* p0 = og + box * BOX + r0 * 128 + ((ch ^ (r0 & 7)) << 4);
        uint8_t* p1 = og + box * BOX + r1 * 128 + ((ch ^ (r1 & 7)) << 4);
        *reinterpret_cast<uint32_t*>(p0 + 4 * tq) =
            pack_bf16(o[4 * e] * i0, o[4 * e + 1] * i0);
        *reinterpret_cast<uint32_t*>(p1 + 4 * tq) =
            pack_bf16(o[4 * e + 2] * i1, o[4 * e + 3] * i1);
      }
      fence_proxy_async();
      mla_wg_sync(W);
      if (q_tma) {
        if (ctid == 0) {
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_store_4d(&tm_o, ob + c * BOX, 64 * (B0 + c), it.hk * rep,
                         it.blk * (BQ / rep), it.b);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        }
        mla_wg_sync(W);
      } else {  // each row's bytes of this consumer's columns, coalesced
        for (int e = ctid; e < BQ * NB * 8; e += 128) {
          const int r = e / (NB * 8), c = e % (NB * 8), rr = rr0 + r;
          if (rr < rows) {
            const uint4 val = *reinterpret_cast<const uint4*>(
                og + (c / 8) * BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4));
            const long long row =
                ((long long)it.b * Sq + rr / rep) * H + it.hk * rep + rr % rep;
            *reinterpret_cast<uint4*>(out + row * L::DV + 64 * B0 + c * 8) =
                val;
          }
        }
      }
      mbar_arrive(EMPTY_K(st));
    }
  };
  if (w == 0)
    consume(MlaConsumer<0>{});
  else
    consume(MlaConsumer<1>{});
#undef FULL_Q
#undef EMPTY_Q
#undef FULL_K
#undef EMPTY_K
#undef K_STAGE
}


template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* qpos, const int* kpos, void* out,
                         float* lse, int B, int Sq, int Sk, int H, int Hkv,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  using L = WgLayout<D>;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, Sq, H, D, L::BQ)) != cudaSuccess ||
      (err = make_map(&tk, k, B, Sk, Hkv, D, L::BK)) != cudaSuccess ||
      (err = make_map(&tv, v, B, Sk, Hkv, D, L::BK)) != cudaSuccess ||
      (err = make_map(&to, out, B, Sq, H, D, 64)) != cudaSuccess)
    return err;
  // persistent: one CTA per SM (or per item, if fewer)
  const long long items = (long long)((Sq + L::BQ - 1) / L::BQ) * H * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(fa_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  fa_wgmma_kernel<D><<<grid, 384, L::BYTES, stream>>>(
      tq, tk, tv, to, qpos, kpos, lse, Sq, Sk, H, Hkv, B, scale, causal,
      window);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_mma_sync(const void* q, const void* k, const void* v,
                            const int* qpos, const int* kpos, void* out,
                            float* lse, int B, int Sq, int Sk, int H,
                            int Hkv, float scale, int causal, int window,
                            int ldv, cudaStream_t stream) {
  const dim3 grid((Sq + 63) / 64, H, B);
  fa_bf16_kernel<DK, DV><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qpos, kpos,
      static_cast<__nv_bfloat16*>(out), lse, Sq, Sk, H, Hkv, scale, causal,
      window, ldv);
  return cudaGetLastError();
}

// V must be K's first 512 columns (v == k, K's strides): the kernel reads
// it from the K tiles.
cudaError_t launch_mla(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* out,
                       float* lse, int B, int Sq, int Sk, int H, int Hkv,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  using L = MlaLayout;
  if (v != k) return cudaErrorInvalidValue;
  const int rep = H / Hkv;
  const long long rows = (long long)Sq * rep;
  if (rows > 0x7fffffffLL - L::BQ) return cudaErrorInvalidValue;
  const long long items = (rows + L::BQ - 1) / L::BQ * Hkv * B;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  // Q and O by TMA when an item's rows are one (64, rep, 64 / rep) box
  const int q_tma = L::BQ % rep == 0;
  CUtensorMap tq, tk, to;
  cudaError_t err = make_map(&tk, k, B, Sk, Hkv, L::DK, L::BK);
  if (err != cudaSuccess) return err;
  tq = to = tk;
  if (q_tma &&
      ((err = make_map(&tq, q, B, Sq, H, L::DK, L::BQ / rep, rep)) !=
           cudaSuccess ||
       (err = make_map(&to, out, B, Sq, H, L::DV, L::BQ / rep, rep)) !=
           cudaSuccess))
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  err = cudaFuncSetAttribute(fa_mla_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(items < sms ? items : sms);
  fa_mla_wgmma_kernel<<<grid, 384, L::BYTES, stream>>>(
      tq, tk, to, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(out), lse, qpos, kpos, Sq, Sk, H, Hkv, B,
      scale, causal, window, q_tma);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* out,
                       float* lse, int B, int Sq, int Sk, int H, int Hkv,
                       float scale, int causal, int window, int ldv,
                       cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
  fa_f32_kernel<DK, DV><<<grid, 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qpos, kpos, static_cast<float*>(out), lse,
      Sq, Sk, H, Hkv, scale, causal, window, ldv);
  return cudaGetLastError();
}

enum Variant {
  V_NONE = -1, V_WGMMA = 0, V_MMA_SYNC = 1, V_F32 = 2, V_MLA = 3
};

// The fixed rule (flash_attention.py's docstring states it): bf16 at
// (64, 64) and (128, 128) -> the wgmma kernel; bf16 at (32, 16), (32, 32),
// (80, 64) and (80, 80) -> the mma.sync kernel; bf16 at (576, 512) -> the
// MLA kernel; float32 at any compiled head size -> the CUDA-core kernel.
int variant_of(int bf16, int dk, int dv) {
  const bool wide = (dk == 64 && dv == 64) || (dk == 128 && dv == 128);
  const bool narrow = (dk == 32 && (dv == 16 || dv == 32)) ||
                      (dk == 80 && (dv == 64 || dv == 80));
  const bool mla = dk == 576 && dv == 512;
  if (bf16)
    return wide ? V_WGMMA : narrow ? V_MMA_SYNC : mla ? V_MLA : V_NONE;
  return wide || narrow || mla ? V_F32 : V_NONE;
}

}  // namespace

extern "C" {

int fa_variant(int bf16, int dk, int dv) { return variant_of(bf16, dk, dv); }

}  // extern "C"

namespace {

// The launch of the variant's kernel; every kernel writes `lse` (float32
// [B, H, Sq]) unless it is null, and computes the same output either way.
cudaError_t forward(const void* q, const void* k, const void* v,
                    const void* qpos, const void* kpos, void* out, float* lse,
                    int B, int Sq, int Sk, int H, int Hkv, int dk, int dv,
                    int bf16, float scale, int causal, int window,
                    void* stream) {
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // v == k: V is K's first dv columns, rows dk apart (MLA's latent values)
  const int ldv = v == k ? dk : dv;
#define FA_LSE_ARGS q, k, v, qp, kp, out, lse, B, Sq, Sk, H, Hkv, scale, \
    causal, window
  switch (variant_of(bf16, dk, dv)) {
    case V_WGMMA:
      return dk == 64 ? launch_wgmma<64>(FA_LSE_ARGS, st)
                      : launch_wgmma<128>(FA_LSE_ARGS, st);
    case V_MMA_SYNC:
      if (dk == 80)
        return dv == 64 ? launch_mma_sync<80, 64>(FA_LSE_ARGS, ldv, st)
                        : launch_mma_sync<80, 80>(FA_LSE_ARGS, ldv, st);
      return dv == 16 ? launch_mma_sync<32, 16>(FA_LSE_ARGS, ldv, st)
                      : launch_mma_sync<32, 32>(FA_LSE_ARGS, ldv, st);
    case V_MLA:
      return launch_mla(FA_LSE_ARGS, st);
    case V_F32:
      if (dk == 32)
        return dv == 16 ? launch_f32<32, 16>(FA_LSE_ARGS, ldv, st)
                        : launch_f32<32, 32>(FA_LSE_ARGS, ldv, st);
      if (dk == 80)
        return dv == 64 ? launch_f32<80, 64>(FA_LSE_ARGS, ldv, st)
                        : launch_f32<80, 80>(FA_LSE_ARGS, ldv, st);
      if (dk == 576) return launch_f32<576, 512>(FA_LSE_ARGS, ldv, st);
      return dk == 64 ? launch_f32<64, 64>(FA_LSE_ARGS, ldv, st)
                      : launch_f32<128, 128>(FA_LSE_ARGS, ldv, st);
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_LSE_ARGS
}

}  // namespace

extern "C" {

// Serving: the output alone.
int fa_forward(const void* q, const void* k, const void* v, const void* qpos,
               const void* kpos, void* out, int B, int Sq, int Sk, int H,
               int Hkv, int dk, int dv, int bf16, float scale, int causal,
               int window, void* stream) {
  return forward(q, k, v, qpos, kpos, out, nullptr, B, Sq, Sk, H, Hkv, dk,
                 dv, bf16, scale, causal, window, stream);
}

// Training: the output and each row's log-sum-exp (float32 [B, H, Sq],
// natural units, +inf for a row that sees no key), which the backward
// (flash_attention_bwd.cu) recomputes P from.
int fa_forward_lse(const void* q, const void* k, const void* v,
                   const void* qpos, const void* kpos, void* out, void* lse,
                   int B, int Sq, int Sk, int H, int Hkv, int dk, int dv,
                   int bf16, float scale, int causal, int window,
                   void* stream) {
  if (lse == nullptr) return cudaErrorInvalidValue;
  return forward(q, k, v, qpos, kpos, out, static_cast<float*>(lse), B, Sq,
                 Sk, H, Hkv, dk, dv, bf16, scale, causal, window, stream);
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
