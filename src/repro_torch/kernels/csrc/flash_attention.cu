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
// an H100 SXM at 989 TFLOP/s), not memory (0.06 ms).  The design keeps the
// products on the tensor cores and off device memory:
//
// - One CTA per (query block, head, batch), i.e. per (b*H, q-block), not
//   per (b*Hkv, q-block) as the TPU kernel does: the CTA's shape then does
//   not depend on rep = H/Hkv (any GQA ratio), and the rep CTAs of one KV
//   head are launched next to each other, so their K/V tiles are read from
//   L2 rather than device memory.  Query blocks run heaviest first
//   (causal: the last block sees the most keys).
// - bf16: 4 warps x 16 query rows; S = Q K^T and O += P V on the tensor
//   cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); Q's fragments
//   stay in registers, K is staged in shared memory row-major and V
//   transposed, both with 8 elements of padding per row so fragment reads
//   hit 32 distinct banks.  P is rounded to bf16 for the PV product, as the
//   TPU kernel does (flash_attention.py:80-81).
// - f32: the products run in full float32 on the CUDA cores (no TF32): 32
//   query rows x 32 keys per tile, 4 threads per query row.
// - A KV tile with no visible (query, key) pair in the CTA is skipped
//   before it is loaded (`pl.when(jnp.any(valid))`, :61).
// - Ragged Sq and Sk are masked here: a query row past Sq has position
//   2^30 and is not stored, a key past Sk has position -1 (what the TPU
//   wrapper's padding, :105-112, gives), so the wrapper copies nothing.
//
// Plain C interface, loaded with ctypes: fa_forward returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qpos, const int* kpos, void* out, int B, int Sq,
                   int Sk, int H, int Hkv, int bf16, float scale, int causal,
                   int window, cudaStream_t stream) {
  if (bf16) {
    const dim3 grid((Sq + 63) / 64, H, B);
    fa_bf16_kernel<DK, DV><<<grid, 128, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), qpos, kpos,
        static_cast<__nv_bfloat16*>(out), Sq, Sk, H, Hkv, scale, causal,
        window);
  } else {
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
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fa_forward(const void* q, const void* k, const void* v, const void* qpos,
               const void* kpos, void* out, int B, int Sq, int Sk, int H,
               int Hkv, int dk, int dv, int bf16, float scale, int causal,
               int window, void* stream) {
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_CASE(DK, DV)                                                     \
  if (dk == DK && dv == DV)                                                 \
    return launch<DK, DV>(q, k, v, qp, kp, out, B, Sq, Sk, H, Hkv, bf16,   \
                          scale, causal, window, st);
  // the head sizes compiled in (flash_attention.HEAD_DIMS)
  FA_CASE(32, 16)
  FA_CASE(32, 32)
  FA_CASE(64, 64)
  FA_CASE(128, 128)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
