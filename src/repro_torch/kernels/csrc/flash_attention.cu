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
// 268.6 M visible pairs need 584 GFLOP (0.59 ms) against 606 MB (0.18 ms).
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
// - bf16 at (576, 512), MLA's latent heads: `fa_mla_kernel`, 8 warps over
//   64 (query, head) rows of one KV head, mma.sync with Dv split across
//   the two warps of each 16-row group, Q resident in shared memory and
//   cp.async double-buffered K/V tiles of 32 keys (see its section).
// - float32: `fa_f32_kernel`, full float32 products on the CUDA cores (no
//   TF32), 32 query rows x 32 keys per tile, 4 threads per query row.
//
// The mma.sync and CUDA-core kernels launch one CTA per (query block,
// head, batch), heaviest query block first (causal: the last block sees
// the most keys), with the rep = H/Hkv CTAs of one KV head next to each
// other so their K/V tiles are read from L2; the wgmma kernel's items keep
// that order within each KV head, and the MLA kernel's blocks hold the rep
// heads themselves.  Those two skip a KV tile with no visible (query, key)
// pair before loading it (`pl.when(jnp.any(valid))`, :61) and mask ragged
// Sq and Sk in the kernel: a query row past Sq has position 2^30 and is
// not stored, a key past Sk has position -1 (the TPU wrapper's padding,
// :105-112).  None of the four needs the wrapper to copy anything.
//
// Plain C interface, loaded with ctypes: fa_forward returns a cudaError_t,
// fa_variant names the kernel it runs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr float NEG_INF = -0x1.fffffep+126f;   // float32 min / 2
constexpr int PAD_QPOS = 1 << 30;

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
template <int DK, int DV>
__global__ void __launch_bounds__(128) fa_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
    const int* __restrict__ kpos, __nv_bfloat16* __restrict__ out, int Sq,
    int Sk, int H, int Hkv, float scale, int causal, int window) {
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
            v + (((long long)b * Sk + j) * Hkv + hk) * DV + c8);
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
    const int* __restrict__ kpos, float* __restrict__ out, int Sq, int Sk,
    int H, int Hkv, float scale, int causal, int window) {
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
          k0 + j < Sk ? v[(((long long)b * Sk + k0 + j) * Hkv + hk) * DV + d]
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
  }
}

// ---------------------------------------------------------------------------
// bf16, (Dk, Dv) in {(64, 64), (128, 128)}: TMA, wgmma, a warp-specialised
// producer
// ---------------------------------------------------------------------------
// Hopper's asynchronous units, through PTX: mbarriers (mbarrier.cuh), TMA
// copies between device memory and shared memory, and warpgroup products
// (wgmma).

// One box of a 4-d tensor map into shared memory; completion is counted in
// bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// One box from shared memory into a 4-d tensor map; rows outside the
// tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory operand with 128-byte swizzle, as TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes it: rows of 128 bytes, 8-row groups of
// 1024 bytes, every tile 1024-byte aligned.  K-major operands (Q, K) step
// 32 bytes per 16-wide slice of the depth inside a 64-column box; the
// MN-major operand (V) steps 8-row groups along the depth (SBO) and
// 64-column boxes along N (LBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_ss_m64n128(float* d, uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

__device__ __forceinline__ void wgmma_rs_m64n128(float* d, const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

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

// 2^x on the special-function unit, subnormal results flushed to zero
// (a weight below 2^-126 adds nothing a bf16 P can hold).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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
// j, 2P - 1 - j, 2P + j, 4P - 1 - j, ... (a snake over the rounds of P,
// which evens out the CTAs' causal work).
__device__ __forceinline__ int item_of(int k, int j, int P) {
  return k * P + ((k & 1) ? P - 1 - j : j);
}

template <int D>
__global__ void __launch_bounds__(384, 1) fa_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_o, const int* __restrict__ qpos,
    const int* __restrict__ kpos, int Sq, int Sk, int H, int Hkv, int B,
    float scale, int causal, int window) {
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
// head), mma.sync with the value columns split across warps
// ---------------------------------------------------------------------------
// A 64-row float32 O of width 512 is 256 registers a thread for one
// warpgroup, so neither the wgmma kernel nor fa_bf16_kernel (all of Dv in
// each warp) takes this shape.  A CTA of 8 warps takes 64 rows of one KV
// head's (query, head) pairs, in q's own order (query-major, its rep = H /
// Hkv heads within), so that all 64 rows share every K/V tile (at Hkv = 1,
// 4 queries x 16 heads, contiguous in q and out).  Warps 2g and 2g + 1
// hold rows 16g..16g+15: each computes S for its half of a 32-key tile (16
// keys over the whole depth of 576) and owns half of O's columns (256: 32
// mma n-tiles, 128 float32 registers).  The pair swaps its row maxima and
// its P fragments (bf16, in mma's A layout) through shared memory, keeps
// its own share of l, and adds the two shares at the end.  Q [64, 576]
// stays in shared memory; K and V tiles of 32 keys are double-buffered with
// cp.async (rows past Sk zero-filled); ldmatrix feeds the tensor cores (V
// through ldmatrix.trans, so it is never transposed in memory).  Rows are
// padded by 16 bytes so that ldmatrix's 8 rows fall on 8 distinct bank
// groups: 73 KB of Q, 2 x (37 + 33) KB of K and V, 216 KB in all.  A KV
// tile is skipped (not loaded) when its key range cannot meet the block's
// query range (tile_class, 256 tiles classed at a time, a thread a tile,
// into a bitmap), and masked element by element otherwise, its key
// positions loaded beside it; rows past the end have position 2^30 and
// are not stored.  One CTA fits an SM, so each warp's S runs as four
// independent mma chains (the depth's even and odd steps apart).
template <int DK, int DV>
struct MlaLayout {
  static constexpr int BQ = 64, BK = 32, WARPS = 8;
  static constexpr int QS = DK + 8, VS = DV + 8;  // row strides (bf16)
  static constexpr int Q_BYTES = BQ * QS * 2;
  static constexpr int K_BYTES = BK * QS * 2, V_BYTES = BK * VS * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + 2 * K_BYTES;
  static constexpr int MX_OFF = V_OFF + 2 * V_BYTES;     // [WARPS][16] f32
  static constexpr int PF_OFF = MX_OFF + WARPS * 16 * 4;  // [WARPS][32] x 16 B
  static constexpr int KP_OFF = PF_OFF + WARPS * 32 * 16;  // [2][BK] int
  static constexpr int VIS_OFF = KP_OFF + 2 * BK * 4;      // [WARPS] u32
  static constexpr int BYTES = VIS_OFF + WARPS * 4;
};

// 16 bytes from global to shared memory, asynchronously; zeros when !valid
// (nothing is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory (lanes 8i..8i+7 address the
// rows of matrix i), as mma fragments; `_t` transposes each.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The two warps of row group g (named barrier 1 + g).
__device__ __forceinline__ void pair_sync(int g) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + g) : "memory");
}

template <int DK, int DV>
__global__ void __launch_bounds__(256, 1) fa_mla_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
    const int* __restrict__ kpos, __nv_bfloat16* __restrict__ out, int Sq,
    int Sk, int H, int Hkv, float scale, int causal, int window) {
  using L = MlaLayout<DK, DV>;
  constexpr int BQ = L::BQ, BK = L::BK, QS = L::QS, VS = L::VS;
  constexpr int DKC = DK / 8, DVC = DV / 8;  // 16-byte chunks of a row
  constexpr int NT = DV / 16;                // O's n-tiles per warp
  constexpr int ROUND = L::WARPS * 32;       // tiles classed at a time
  static_assert(DK % 32 == 0 && DV % 32 == 0 && BK == 32, "head sizes");
  extern __shared__ __align__(16) uint8_t smem_mla[];
  const uint32_t q_s = smem_u32(smem_mla);
  const uint32_t k_s = q_s + L::K_OFF, v_s = q_s + L::V_OFF;
  float* mx_s = reinterpret_cast<float*>(smem_mla + L::MX_OFF);
  uint4* pf_s = reinterpret_cast<uint4*>(smem_mla + L::PF_OFF);
  const int* kp_s = reinterpret_cast<const int*>(smem_mla + L::KP_OFF);
  uint32_t* vis_s = reinterpret_cast<uint32_t*>(smem_mla + L::VIS_OFF);

  // rows: Sq * rep < 2^31 (the launcher checks)
  const int rep = H / Hkv, rows = Sq * rep;
  const int n_blk = (rows + BQ - 1) / BQ;
  const int rr0 = (n_blk - 1 - blockIdx.x) * BQ;  // heaviest block first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int g = warp >> 1, half = warp & 1;
  const int* kp_row = kpos + (long long)b * Sk;
  // block row r's pair: its row of q / out ([B, Sq, H] rows), or -1
  auto pair_row = [&](int r, int* qp) -> long long {
    const int rr = rr0 + r;
    if (rr >= rows) {
      *qp = PAD_QPOS;
      return -1;
    }
    const int i = rr / rep, j = rr - i * rep;
    *qp = qpos[(long long)b * Sq + i];
    return ((long long)b * Sq + i) * H + hk * rep + j;
  };

  for (int e = tid; e < BQ * DKC; e += 256) {
    const int r = e / DKC, c = e % DKC;
    int qp;
    const long long row = pair_row(r, &qp);
    cp_async16(q_s + (r * QS + c * 8) * 2,
               row < 0 ? q : q + row * DK + c * 8, row >= 0);
  }
  int qp0, qp1;
  const long long orow0 = pair_row(16 * g + gr, &qp0);
  const long long orow1 = pair_row(16 * g + gr + 8, &qp1);

  // the block's query range (rows past the end left out), in every warp
  int qmin = INT_HI, qmax = INT_LO;
  for (int r = lane; r < BQ; r += 32) {
    int qp;
    if (pair_row(r, &qp) >= 0) {
      qmin = min(qmin, qp);
      qmax = max(qmax, qp);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }
  // Which KV tiles some pair may see, ROUND tiles at a time (a thread a
  // tile, a bit each in vis_s); next_tile(t) is the first from t on.
  // Every thread calls it with the same t, so the round's barriers are
  // uniform.
  const int n_kb = (Sk + BK - 1) / BK;
  int round0 = -ROUND;
  auto next_tile = [&](int t) -> int {
    for (; t < n_kb; ++t) {
      if (t >= round0 + ROUND) {
        round0 = t;
        __syncthreads();  // the last round's bits are read out
        const int tt = t + tid;
        bool vis = false;
        if (tt < n_kb) {
          int lo = INT_HI, hi = INT_LO;
          bool neg = false;
#pragma unroll 8
          for (int e = 0; e < BK; ++e) {
            const int j = tt * BK + e;
            const int kp = j < Sk ? kp_row[j] : -1;
            neg |= kp < 0;
            lo = kp < 0 ? lo : min(lo, kp);
            hi = kp < 0 ? hi : max(hi, kp);
          }
          vis = tile_class(lo, hi, neg, qmin, qmax, causal, window) !=
                TILE_SKIP;
        }
        const uint32_t bits = __ballot_sync(0xffffffffu, vis);
        if (lane == 0) vis_s[warp] = bits;
        __syncthreads();
      }
      const int o = t - round0;
      if ((vis_s[o >> 5] >> (o & 31)) & 1u) break;
    }
    return t;
  };
  // tile t's K, V and key positions into buffer buf, asynchronously
  auto load_kv = [&](int t, int buf) {
    const uint32_t kd = k_s + buf * L::K_BYTES, vd = v_s + buf * L::V_BYTES;
    for (int e = tid; e < BK * DKC; e += 256) {
      const int r = e / DKC, c = e % DKC, j = t * BK + r;
      cp_async16(kd + (r * QS + c * 8) * 2,
                 j < Sk ? k + (((long long)b * Sk + j) * Hkv + hk) * DK + c * 8
                        : k,
                 j < Sk);
    }
    for (int e = tid; e < BK * DVC; e += 256) {
      const int r = e / DVC, c = e % DVC, j = t * BK + r;
      cp_async16(vd + (r * VS + c * 8) * 2,
                 j < Sk ? v + (((long long)b * Sk + j) * Hkv + hk) * DV + c * 8
                        : v,
                 j < Sk);
    }
    if (tid < BK) {
      const int j = t * BK + tid;
      cp_async4(smem_u32(kp_s + buf * BK + tid), j < Sk ? kp_row + j : kp_row,
                j < Sk);
    }
  };

  const float sl = scale * 1.4426950408889634f;  // scores in log2 units
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  // ldmatrix row addresses: A (Q rows of the group), B (K: this half's 16
  // keys), V (16 keys x this half's columns, transposed)
  const uint32_t qa = q_s + ((16 * g + (lane & 15)) * QS + (lane >> 4) * 8) * 2;
  const uint32_t ko =
      ((16 * half + (lane >> 4) * 8 + (lane & 7)) * QS + ((lane >> 3) & 1) * 8) *
      2;
  const uint32_t vo = ((lane & 15) * VS + half * (DV / 2) + (lane >> 4) * 8) * 2;

  int t = next_tile(0), buf = 0;
  if (t < n_kb) load_kv(t, 0);
  cp_async_commit();  // Q and the first tile
  while (t < n_kb) {
    const int tn = next_tile(t + 1);
    if (tn < n_kb) load_kv(tn, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed
    __syncthreads();

    // S = Q K^T: the group's 16 rows x this half's 16 keys, the depth's
    // even and odd 16-column steps in two accumulators (four independent
    // mma chains a warp)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const uint32_t kb = k_s + buf * L::K_BYTES + ko;
#pragma unroll 2
    for (int ks = 0; ks < DK / 16; ks += 2) {
      uint32_t a[4], bb[4], a2[4], bb2[4];
      ldsm_x4(a, qa + ks * 32);
      ldsm_x4(bb, kb + ks * 32);
      ldsm_x4(a2, qa + ks * 32 + 32);
      ldsm_x4(bb2, kb + ks * 32 + 32);
      mma_bf16(s[0], a, bb[0], bb[1]);
      mma_bf16(s[1], a, bb[2], bb[3]);
      mma_bf16(s2[0], a2, bb2[0], bb2[1]);
      mma_bf16(s2[1], a2, bb2[2], bb2[3]);
    }
    // scale and mask; row maxima over the quad, then over the pair
    const int* kpt = kp_s + buf * BK;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 16 * half + nt * 8 + 2 * tq + e;
        const int kp = t * BK + c < Sk ? kpt[c] : -1;
        s[nt][e] = visible(qp0, kp, causal, window)
                       ? (s[nt][e] + s2[nt][e]) * sl : NEG_INF;
        s[nt][2 + e] = visible(qp1, kp, causal, window)
                           ? (s[nt][2 + e] + s2[nt][2 + e]) * sl : NEG_INF;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (tq == 0) {
      mx_s[warp * 16 + gr] = mx0;
      mx_s[warp * 16 + gr + 8] = mx1;
    }
    pair_sync(g);
    mx0 = fmaxf(mx0, mx_s[(warp ^ 1) * 16 + gr]);
    mx1 = fmaxf(mx1, mx_s[(warp ^ 1) * 16 + gr + 8]);
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = mn0 <= NEG_INF ? 0.f : mn0;
    const float ms1 = mn1 <= NEG_INF ? 0.f : mn1;
    const float c0 = m0 <= NEG_INF ? 0.f : ex2(m0 - ms0);
    const float c1 = m1 <= NEG_INF ? 0.f : ex2(m1 - ms1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = s[nt][e] <= NEG_INF ? 0.f : ex2(s[nt][e] - ms0);
        s[nt][2 + e] = s[nt][2 + e] <= NEG_INF ? 0.f : ex2(s[nt][2 + e] - ms1);
        sum0 += s[nt][e];
        sum1 += s[nt][2 + e];
      }
    }
    l0 = l0 * c0 + sum0;  // this thread's share of l
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
    // P in bf16 as mma's A fragment of this half's 16 keys; the pair swaps
    const uint4 mine = make_uint4(pack_bf16(s[0][0], s[0][1]),
                                  pack_bf16(s[0][2], s[0][3]),
                                  pack_bf16(s[1][0], s[1][1]),
                                  pack_bf16(s[1][2], s[1][3]));
    pf_s[warp * 32 + lane] = mine;
    pair_sync(g);
    const uint4 other = pf_s[(warp ^ 1) * 32 + lane];
    const uint4 p0 = half ? other : mine, p1 = half ? mine : other;
    const uint32_t pa[2][4] = {{p0.x, p0.y, p0.z, p0.w},
                               {p1.x, p1.y, p1.z, p1.w}};
    // O = O * corr + P V over this half's columns
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= c0;
      o[nt][1] *= c0;
      o[nt][2] *= c1;
      o[nt][3] *= c1;
    }
    const uint32_t vb = v_s + buf * L::V_BYTES + vo;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bb[4];
        ldsm_x4_t(bb, vb + (kk * 16 * VS + np * 16) * 2);
        mma_bf16(o[2 * np], pa[kk], bb[0], bb[1]);
        mma_bf16(o[2 * np + 1], pa[kk], bb[2], bb[3]);
      }
    }
    __syncthreads();  // buffer `buf` and the exchange slots are read out
    buf ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

  // l: the quad's shares, then the pair's
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (tq == 0) {
    mx_s[warp * 16 + gr] = l0;
    mx_s[warp * 16 + gr + 8] = l1;
  }
  pair_sync(g);
  l0 = fmaxf(l0 + mx_s[(warp ^ 1) * 16 + gr], 1e-30f);
  l1 = fmaxf(l1 + mx_s[(warp ^ 1) * 16 + gr + 8], 1e-30f);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = half * (DV / 2) + nt * 8 + 2 * tq;
    if (orow0 >= 0)
      *reinterpret_cast<uint32_t*>(out + orow0 * DV + c) =
          pack_bf16(o[nt][0] / l0, o[nt][1] / l0);
    if (orow1 >= 0)
      *reinterpret_cast<uint32_t*>(out + orow1 * DV + c) =
          pack_bf16(o[nt][2] / l1, o[nt][3] / l1);
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A contiguous bf16 [B, S, heads, D] tensor as a 4-d map over (D, heads,
// S, B) with its own strides, boxes of 64 columns x `rows` rows of one
// head, 128-byte swizzle; rows outside [0, S) read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int S,
                     int heads, int D, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const int* qpos, const int* kpos, void* out, int B,
                         int Sq, int Sk, int H, int Hkv, float scale,
                         int causal, int window, cudaStream_t stream) {
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
      tq, tk, tv, to, qpos, kpos, Sq, Sk, H, Hkv, B, scale, causal, window);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_mma_sync(const void* q, const void* k, const void* v,
                            const int* qpos, const int* kpos, void* out,
                            int B, int Sq, int Sk, int H, int Hkv,
                            float scale, int causal, int window,
                            cudaStream_t stream) {
  const dim3 grid((Sq + 63) / 64, H, B);
  fa_bf16_kernel<DK, DV><<<grid, 128, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qpos, kpos,
      static_cast<__nv_bfloat16*>(out), Sq, Sk, H, Hkv, scale, causal, window);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_mla(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* out, int B,
                       int Sq, int Sk, int H, int Hkv, float scale,
                       int causal, int window, cudaStream_t stream) {
  using L = MlaLayout<DK, DV>;
  const long long rows = (long long)Sq * (H / Hkv);
  if (rows > 0x7fffffffLL - L::BQ) return cudaErrorInvalidValue;
  const long long blocks = (rows + L::BQ - 1) / L::BQ;
  cudaError_t err = cudaFuncSetAttribute(
      fa_mla_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), Hkv, B);
  fa_mla_kernel<DK, DV><<<grid, 256, L::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), qpos, kpos,
      static_cast<__nv_bfloat16*>(out), Sq, Sk, H, Hkv, scale, causal, window);
  return cudaGetLastError();
}

template <int DK, int DV>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* out, int B,
                       int Sq, int Sk, int H, int Hkv, float scale,
                       int causal, int window, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_f32_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
  fa_f32_kernel<DK, DV><<<grid, 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), qpos, kpos, static_cast<float*>(out), Sq,
      Sk, H, Hkv, scale, causal, window);
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

int fa_forward(const void* q, const void* k, const void* v, const void* qpos,
               const void* kpos, void* out, int B, int Sq, int Sk, int H,
               int Hkv, int dk, int dv, int bf16, float scale, int causal,
               int window, void* stream) {
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_ARGS q, k, v, qp, kp, out, B, Sq, Sk, H, Hkv, scale, causal, window, st
  switch (variant_of(bf16, dk, dv)) {
    case V_WGMMA:
      return dk == 64 ? launch_wgmma<64>(FA_ARGS) : launch_wgmma<128>(FA_ARGS);
    case V_MMA_SYNC:
      if (dk == 80)
        return dv == 64 ? launch_mma_sync<80, 64>(FA_ARGS)
                        : launch_mma_sync<80, 80>(FA_ARGS);
      return dv == 16 ? launch_mma_sync<32, 16>(FA_ARGS)
                      : launch_mma_sync<32, 32>(FA_ARGS);
    case V_MLA:
      return launch_mla<576, 512>(FA_ARGS);
    case V_F32:
      if (dk == 32) return dv == 16 ? launch_f32<32, 16>(FA_ARGS)
                                    : launch_f32<32, 32>(FA_ARGS);
      if (dk == 80) return dv == 64 ? launch_f32<80, 64>(FA_ARGS)
                                    : launch_f32<80, 80>(FA_ARGS);
      if (dk == 576) return launch_f32<576, 512>(FA_ARGS);
      return dk == 64 ? launch_f32<64, 64>(FA_ARGS)
                      : launch_f32<128, 128>(FA_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_ARGS
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
