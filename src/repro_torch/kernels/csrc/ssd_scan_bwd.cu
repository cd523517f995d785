// The backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a): dx,
// ddt, dA, dB and dC of ssd_scan.cu's forward for the cotangents dy of y
// and dstate of the final state (none in training: the mamba block drops
// the state).  Per (b, h) and chunk c of length L, with x_bar = dt x,
// cum = cumsum(dt A) inside the chunk, S_c the state entering chunk c and
// G_c the gradient of the state leaving it (G_{nc-1} = dstate,
// G_{c-1} = e^{cum_{L-1}} G_c + sum_i e^{cum_i} dy_i (x) C_i):
//
//   dx_bar_j = sum_{i>=j} (C_i.B_j) e^{cum_i-cum_j} dy_i
//              + e^{cum_{L-1}-cum_j} G_c B_j
//   dC_i     = sum_{j<=i} e^{cum_i-cum_j} (dy_i.x_bar_j) B_j + e^{cum_i} S_c^T dy_i
//   dB_j     = sum_{i>=j} e^{cum_i-cum_j} (dy_i.x_bar_j) C_i
//              + e^{cum_{L-1}-cum_j} G_c^T x_bar_j
//   dcum     from the pair terms t_ij = (C_i.B_j) e^{cum_i-cum_j} (dy_i.x_bar_j)
//            (+ to row i, - to column j; halved where cum_i == cum_j
//            exactly, i > j: the gradient of JAX's minimum(., 0)), the
//            inter-chunk term dy_i.y_inter_i, the state term u_j (- to j,
//            + to L-1) and e^{cum_{L-1}} <S_c, G_c> (+ to L-1);
//   d(da)    the reverse cumsum of dcum; ddt = d(da) A + sum_p dx_bar x;
//   dx = dx_bar dt; dA = sum d(da) dt; dB, dC summed over each group's
//   h / g heads.
//
// Replaces no Pallas kernel: the TPU's train step takes this gradient by
// XLA's autodiff of the reference scan (src/repro/train/state.py:52,
// jax.value_and_grad, through src/repro/models/mamba2.py:91,
// src/repro/kernels/ops.py:116 and src/repro/kernels/ref.py:247), since
// the Pallas kernel (src/repro/kernels/ssd_scan.py:79) defines no
// custom_vjp.  Contract: `ref.ssd_bwd` of the port (x [b,s,h,p], dt
// [b,s,h] f32, A [h] f32, B/C [b,s,g,n], dy [b,s,h,p], dstate [b,h,p,n]
// f32 or none; everything in float32 from the inputs as given).
//
// What bounds it: at mamba2-130m's training shape (b 8, s 2048, h 24, p
// 64, g 3, n 128, chunk 128) a (b, h, chunk) needs ~3.2 MFLOP of scores
// (C B^T, dy x^T) and ~15.8 MFLOP of products with one float32 operand
// (W^T dy, DS B, DS^T C, the three state terms and the two walks), ~58
// GFLOP in all, against ~0.2 GB of inputs and gradients.  Every product
// has an operand that is exactly bf16 in the bf16 path, so the float32
// operand splits exactly into three bf16 pieces (hi = bf16(v), mid =
// bf16(v - hi), lo = v - hi - mid: 24 significand bits in three of 8,
// exact for |v| >= 2^-110) and the product is three bf16 tensor-core
// passes into one float32 accumulator, each partial product exact (no
// TF32, no rounded operand): the tensor cores bound it (0.157 ms at 989
// TFLOP/s).  Every product is mma.sync, not wgmma: a warp's state term and
// pair terms of one 16-row block share one register accumulator, stored
// once, and the split and decayed score tiles are A fragments straight
// from the accumulators (a wgmma variant of the forward's scores ran 1.4x
// slower).  What holds it back is latency at 8 warps an SM (one CTA of
// 217.6 KB of shared memory and 254 registers): `ssd_bwd_ablation.py`
// splits the time by part.
//
// Two paths, by dtype:
//
// `tc::` (bf16; every product on mma.sync.m16n8k16, bf16 -> float32):
//
// - `ssd_bwd_states_tc` / `ssd_bwd_dstates_tc`: one CTA of 8 warps per
//   (b, h, 32-wide slice of p) walks the chunks, its [32, n] slice of the
//   state in mma accumulators across chunks (a warp two 16 x 16 tiles).
//   Per chunk its w rows, its rows of the slice and dt go in by cp.async
//   at once, and the float32 rows x_bar_j e^{cum_{L-1}-cum_j} (forward)
//   or dy_i e^{cum_i} (reverse) are split into three bf16 planes in
//   shared memory.  The state entering (leaving) each chunk is written
//   split, as bf16 [b, h, nc, 3, p, n] (1.5x the bytes of float32: 151 MB
//   a walk at the training shape), so the chunk kernel copies it as it
//   is; it goes out through the planes' place in 16-byte runs (scattered
//   4-byte stores from the fragments took over half the walk's time).
//   Three 73 KB CTAs an SM (384 CTAs at the training shape: one wave):
//   one CTA's loads and one-thread cumsum overlap the others' products.
// - `ssd_bwd_chunk_tc`: one CTA of 8 warps per (b, group, chunk) walks
//   the group's h / g heads in order.  B and C go in once by cp.async;
//   per head, x, dy (and the next head's dt) in a first group, G_c's
//   planes in a second that an mbarrier counts, so G_c lands while the
//   warps compute the dC pass; once every warp is done with S_c (a second
//   mbarrier) the last warp copies the next head's S_c planes in its
//   place while the others run J1 and J2, and warp 1 takes the next
//   head's cumsum while warp 0 takes this one's reverse cumsum.  Warp w
//   owns rows [16w, 16w + 16) of the chunk in three passes, each output
//   held in registers from its state term through its pair terms:
//     I   dC_i  = e^{cum_i} dy_i S_c (+ C_i . that: dy_i . y_inter_i), then
//               over key blocks j <= i: C_i B_j^T and dy_i x_j^T (one pass
//               each), W, DS = (dy x^T) dt_j decay, t's row sums; DS split
//               in registers (the C fragments of two n8 tiles are the A
//               fragment of the next product) against B_j;
//     J1  dx_bar_j = e^{cum_{L-1}-cum_j} B_j G_c^T (u_j = x_bar_j . that),
//               then over query blocks i >= j: the transposed scores
//               B_j C_i^T, W^T split against dy_i;
//     J2  dB_j = dt_j e^{cum_{L-1}-cum_j} x_j G_c, then B_j C_i^T and
//               x_j dy_i^T, DS^T split against C_i, t's column sums.
//   The transposed score tiles are recomputed (a bf16 pass each) rather
//   than staged: W or DS in shared memory would cost 64 KB each.  A warp
//   takes w + 1 pair tiles in I and 8 - w in J1 and J2, so the warps'
//   shares differ by ~10 % at L = 128; no barrier separates the passes.
//   dB and dC are summed over the group's heads in float32 [b, s, g, n]:
//   each head's row block is added by the thread that owns it to what it
//   stored for the heads before (the lines stay in L2; no atomics), so
//   they leave the kernel once, and the wrapper only casts.  Holding the
//   sums in registers across heads would put dB's and dC's 128
//   accumulators beside dx_bar's, past the 255 registers a thread has.
//   Shared memory: 217.6 KB at L = n = 128, p = 64 (one CTA an SM); p =
//   128 there does not fit.
//
// The float32 path (float32 inputs only) keeps the CUDA-core design:
// exactness on the tensor cores would need more passes than it saves.
// `ssd_bwd_states` / `ssd_bwd_dstates` walk per (b, h, 32-wide slice of
// p) writing S_c and G_c as float32 [b, h, nc, p, n];
// `ssd_bwd_chunk` takes a (b, h, chunk) with 4 x 4 float32 register tiles
// read from shared memory, which holds B, C, x_bar, dy and one [L][L]
// float32 matrix (G_c and S_c, then W, then DS in place), dB and dC per
// head written, read back and summed with the pair terms.  A product
// whose lanes read one operand's rows along k takes rows eight apart a
// lane (consecutive lanes, consecutive rows: no bank conflict).
//
// Both paths: row and column sums of t in fixed trees, the reverse cumsum
// of dcum and dA's partial over the chunk on one thread (the bf16 path: a
// scan over one warp, in fixed trees), no atomics: two calls are
// bit-equal.  Rows past s read as x = 0, dt = 0, B = C = 0 and
// dy = 0 (the reference's padding) and are not stored.  cum is summed in
// order on one thread, each product and sum rounded on its own (torch's
// CUDA cumsum along a non-innermost dimension sums in the same order), so
// a tie from dt = 0 is a tie in both; t_ij is halved at an exact tie.
//
// Limits: chunk <= 128, n <= 128, p <= 128, the forward's p % 4, n % 16,
// chunk % 16, and the chunk kernel's shared memory (`ssd_bwd_smem_bytes`;
// float32 at L = n = 128, and p = 128 at L = n = 128, do not fit).
//
// Plain C interface, loaded with ctypes: ssd_backward returns a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PS = 32;  // the slice of p a walk's CTA takes
constexpr int MAX_L = 128, MAX_N = 128, MAX_P = 128;
constexpr unsigned FULL = 0xffffffffu;

struct Dims {
  int b, s, h, p, g, n, l, nc;
};

// Four consecutive values as float (16 bytes of float32 or 8 of bf16;
// rows in shared and device memory keep those alignments).
__device__ __forceinline__ void ld4(float (&o)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
__device__ __forceinline__ void ld4(float (&o)[4], const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  o[0] = __uint_as_float(u.x << 16), o[1] = __uint_as_float(u.x & 0xffff0000u);
  o[2] = __uint_as_float(u.y << 16), o[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
// Four elements copied as they are, or zeros where `src` is null.
__device__ __forceinline__ void cp4(float* d, const float* src) {
  *reinterpret_cast<float4*>(d) =
      src ? *reinterpret_cast<const float4*>(src) : make_float4(0, 0, 0, 0);
}

// The 4 x 4 register-tile products, k ascending (a fixed order of sums).
// NN: acc[a][c] += sum_k A[r0 + a][k] * Bm[k][c0 + c], k in [k0, k1), k
// a multiple of 4
__device__ __forceinline__ void mm_nn(float (&acc)[4][4], const float* A,
                                      int as, const float* Bm, int bs, int r0,
                                      int c0, int k0, int k1) {
  for (int k = k0; k < k1; k += 4) {
    float a[4][4], bm[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(a[i], A + (r0 + i) * as + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ld4(bm[kk], Bm + (k + kk) * bs + c0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][c] = fmaf(a[i][kk], bm[kk][c], acc[i][c]);
  }
}
// NT: acc[a][c] += sum_k A[ra[a]][k] * Bt[c0 + c][k], k in [0, k1): the
// pair products, whose lanes take rows of A eight apart (consecutive
// lanes, consecutive rows: no bank conflict) and share Bt's rows
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* A,
                                      int as, const int (&ra)[4],
                                      const float* Bt, int bs, int c0,
                                      int k1) {
  for (int k = 0; k < k1; k += 4) {
    float a[4][4], bt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ld4(a[i], A + ra[i] * as + k);
#pragma unroll
    for (int c = 0; c < 4; ++c) ld4(bt[c], Bt + (c0 + c) * bs + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][c] = fmaf(a[i][kk], bt[c][kk], acc[i][c]);
  }
}
// TN: acc[a][c] += sum_k At[k][r0 + a] * Bm[k][c0 + c], any k0
__device__ __forceinline__ void mm_tn(float (&acc)[4][4], const float* At,
                                      int as, const float* Bm, int bs, int r0,
                                      int c0, int k0, int k1) {
  for (int k = k0; k < k1; ++k) {
    float a[4], bm[4];
    ld4(a, At + k * as + r0);
    ld4(bm, Bm + k * bs + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], bm[c], acc[i][c]);
  }
}

// How a warp covers an output of `rows` x `width` (width <= 128) in 4 x 4
// tiles: `lpr` lanes (a power of two) take a group of 4 rows, all its
// column tiles, so a row's sum over its columns is a shuffle among them;
// a warp takes `rpw` such groups a row block, and warp w the row blocks
// w, w + WARPS, ...
struct Strip {
  int lpr, rpw, nrb;
  __device__ Strip(int rows, int width) {
    lpr = 1;
    while (4 * lpr < width) lpr <<= 1;
    rpw = 32 / lpr;
    nrb = (rows + 4 * rpw - 1) / (4 * rpw);
  }
  __device__ int r0(int rb, int lane) const { return (rb * rpw + lane / lpr) * 4; }
  __device__ int c0(int lane) const { return (lane % lpr) * 4; }
};

// the sum of v over the lpr lanes of a row group, in a fixed tree
__device__ __forceinline__ float row_sum(float v, int lpr) {
  for (int o = lpr >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The pair matrix's lower triangle in blocks of 32 rows x 16 columns,
// (rb, cb) with 16 cb <= 32 rb + 31; lane (rl, cq) = (lane % 8, lane / 8)
// of the warp that takes a block owns rows 32 rb + rl + 8 a and columns
// 16 cb + 4 cq + c (a, c < 4).
__device__ __forceinline__ int pair_rows(int rb, int L) {
  const int n = 2 * rb + 2;
  return n < L / 16 ? n : L / 16;
}
__device__ __forceinline__ int pair_blocks(int L) {
  int nb = 0;
  for (int rb = 0; 32 * rb < L; ++rb) nb += pair_rows(rb, L);
  return nb;
}
__device__ __forceinline__ void pair_block(int blk, int L, int& rb, int& cb) {
  rb = 0;
  while (blk >= pair_rows(rb, L)) blk -= pair_rows(rb++, L);
  cb = blk;
}

// cum of the chunk's rows, in order on one thread, each product and sum
// rounded on its own (the caller synchronizes)
__device__ __forceinline__ void cum_rows(float* cum, const float* dts,
                                         float A, int l) {
  float acc = 0.f;  // four rows a load (l % 16 == 0, 16-byte rows)
#pragma unroll 4
  for (int i = 0; i < l; i += 4) {
    const float4 d = *reinterpret_cast<const float4*>(dts + i);
    float4 c;
    c.x = acc = __fadd_rn(acc, __fmul_rn(d.x, A));
    c.y = acc = __fadd_rn(acc, __fmul_rn(d.y, A));
    c.z = acc = __fadd_rn(acc, __fmul_rn(d.z, A));
    c.w = acc = __fadd_rn(acc, __fmul_rn(d.w, A));
    *reinterpret_cast<float4*>(cum + i) = c;
  }
}
__device__ __forceinline__ void chunk_cum(float* cum, const float* dts,
                                          float A, int l) {
  if (threadIdx.x == 0) cum_rows(cum, dts, A, l);
}

// ---------------------------------------------------------------------------
// The two walks: one CTA per (b, h, 32-wide slice of p), its [PS][n]
// slice of the state in 4 x 4 register tiles (n <= 128: 256 tiles).
// Forward (REV false): S_0 = 0, S_{c+1} = e^{cum_{L-1}} S_c
// + sum_j (x_bar_j e^{cum_{L-1}-cum_j}) (x) B_j, writing S_c.  Reverse:
// from dstate (or 0), G_{c-1} = e^{cum_{L-1}} G_c + sum_i (dy_i e^{cum_i})
// (x) C_i, writing G_c.
// ---------------------------------------------------------------------------
__host__ __device__ inline int walk_smem(const Dims& d) {
  return 4 * (3 * d.l + d.l * (PS + 4) + d.l * (d.n + 4));
}

template <bool REV>
__device__ __forceinline__ void walk(const float* __restrict__ v,
                                     const float* __restrict__ dt,
                                     const float* __restrict__ A,
                                     const float* __restrict__ w,
                                     const float* __restrict__ init,
                                     float* __restrict__ out, const Dims d) {
  extern __shared__ __align__(16) unsigned char smem_walk[];
  const int L = d.l, ns = d.n + 4, vs = PS + 4;
  float* cum = reinterpret_cast<float*>(smem_walk);   // [L]
  float* dts = cum + L;                               // [L]
  float* wt = dts + L;                                // [L] the row weights
  float* v_s = wt + L;                                // [L][vs]
  float* w_s = v_s + L * vs;                          // [L][ns]

  const int nsl = (d.p + PS - 1) / PS;
  const int sl = blockIdx.x % nsl, hi = (blockIdx.x / nsl) % d.h,
            bi = blockIdx.x / (nsl * d.h);
  const int gi = hi / (d.h / d.g), p0 = sl * PS, tid = threadIdx.x;
  const float Ah = A[hi];
  const int nq = d.n / 4;
  const int pg = tid / nq, ng = tid % nq;
  const bool mine = pg < PS / 4;
  float st[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) st[a][c] = 0.f;
  if (mine && init != nullptr) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = p0 + 4 * pg + a;
      if (row < d.p)
        ld4(st[a], init + (((long long)bi * d.h + hi) * d.p + row) * d.n +
                       4 * ng);
    }
  }
  for (int k = 0; k < d.nc; ++k) {
    const int c = REV ? d.nc - 1 - k : k;
    const int t0 = c * L;
    __syncthreads();  // the previous chunk's tiles are read
    for (int i = tid; i < L; i += THREADS)
      dts[i] = t0 + i < d.s ? dt[((long long)bi * d.s + t0 + i) * d.h + hi]
                            : 0.f;
    for (int e = tid; e < L * nq; e += THREADS) {
      const int i = e / nq, q = e % nq, t = t0 + i;
      cp4(w_s + i * ns + 4 * q,
          t < d.s ? w + (((long long)bi * d.s + t) * d.g + gi) * d.n + 4 * q
                  : nullptr);
    }
    __syncthreads();
    chunk_cum(cum, dts, Ah, L);
    __syncthreads();
    for (int i = tid; i < L; i += THREADS)
      wt[i] = REV ? expf(cum[i]) : expf(cum[L - 1] - cum[i]);
    __syncthreads();
    for (int e = tid; e < L * (PS / 4); e += THREADS) {
      const int i = e / (PS / 4), q = e % (PS / 4), col = p0 + 4 * q,
                t = t0 + i;
      float vv[4] = {0.f, 0.f, 0.f, 0.f};
      if (t < d.s && col < d.p)
        ld4(vv, v + (((long long)bi * d.s + t) * d.h + hi) * d.p + col);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vv[j] = REV ? __fmul_rn(vv[j], wt[i])
                    : __fmul_rn(__fmul_rn(vv[j], dts[i]), wt[i]);
      st4(v_s + i * vs + 4 * q, vv);
    }
    if (mine) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int row = p0 + 4 * pg + a;
        if (row < d.p)
          st4(out + ((((long long)bi * d.h + hi) * d.nc + c) * d.p + row) *
                        d.n + 4 * ng,
              st[a]);
      }
    }
    __syncthreads();
    if (mine) {  // the decayed state, then the chunk's terms in order
      const float dec = expf(cum[L - 1]);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) st[a][cc] = __fmul_rn(st[a][cc], dec);
      mm_tn(st, v_s, vs, w_s, ns, 4 * pg, 4 * ng, 0, L);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_states(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   float* __restrict__ states, Dims d) {
  walk<false>(x, dt, A, Bm, nullptr, states, d);
}

__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_dstates(const float* __restrict__ dy,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ Cm,
                    const float* __restrict__ dstate,
                    float* __restrict__ gstates, Dims d) {
  walk<true>(dy, dt, A, Cm, dstate, gstates, d);
}

// ---------------------------------------------------------------------------
// The in-chunk gradients: one CTA per (b, h, chunk).
// ---------------------------------------------------------------------------
struct Layout {
  int ns, ps, ms, gs;              // row strides (elements)
  int b, c, x, dy, m, small, total;  // byte offsets
};

__host__ __device__ inline int al16(int v) { return (v + 15) & ~15; }

// B, C [L][ns], dy and x_bar [L][ps] and the matrix [L][ms] (or G_c
// [p][gs] beside S_c [p][gs], then G_c^T [n][ps]), all float32, then the
// per-row arrays, the pair blocks' row and column sums of t and the
// threads' <S, G> partials.
__host__ __device__ inline Layout chunk_layout_f32(const Dims& d) {
  Layout o;
  o.ns = d.n + 4, o.ps = d.p + 4, o.ms = d.l + 4, o.gs = d.n + 4;
  int off = 0;
  o.b = off, off += al16(d.l * o.ns * 4);
  o.c = off, off += al16(d.l * o.ns * 4);
  o.x = off, off += al16(d.l * o.ps * 4);
  o.dy = off, off += al16(d.l * o.ps * 4);
  const int m1 = d.l * o.ms, m2 = d.p * o.gs + d.n * o.ps;
  const int m3 = 2 * d.p * o.gs;
  const int m = m1 > m2 ? (m1 > m3 ? m1 : m3) : (m2 > m3 ? m2 : m3);
  o.m = off, off += al16(4 * m);
  const int nrb = (d.l + 31) / 32, ncb = d.l / 16;
  o.small = off, off += 4 * ((8 + nrb + ncb) * d.l + THREADS + 4);
  o.total = off;
  return o;
}

// The dx_bar tiles a thread keeps in registers (XT row blocks a warp).
__host__ __device__ inline int chunk_xt(int l, int p) {
  int lpr = 1;
  while (4 * lpr < p) lpr <<= 1;
  const int rows = 4 * (32 / lpr);
  const int nrb = (l + rows - 1) / rows;
  return (nrb + WARPS - 1) / WARPS;
}

template <int XT>
__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ gstates,
    float* __restrict__ dx, float* __restrict__ ddt, float* dBp, float* dCp,
    float* __restrict__ dAp, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_chunk[];
  const Layout ly = chunk_layout_f32(d);
  const int L = d.l, P = d.p, N = d.n, ns = ly.ns, ps = ly.ps, ms = ly.ms,
            gs = ly.gs;
  float* b_s = reinterpret_cast<float*>(smem_chunk + ly.b);
  float* c_s = reinterpret_cast<float*>(smem_chunk + ly.c);
  float* x_s = reinterpret_cast<float*>(smem_chunk + ly.x);
  float* dy_s = reinterpret_cast<float*>(smem_chunk + ly.dy);
  float* m_s = reinterpret_cast<float*>(smem_chunk + ly.m);
  float* g_s = m_s;            // [P][gs] G_c, then the matrix
  float* s_s = m_s + P * gs;   // [P][gs] S_c, then G_c^T [N][ps]
  float* cum = reinterpret_cast<float*>(smem_chunk + ly.small);
  float* dts = cum + L;
  float* ecum = dts + L;       // e^cum
  float* dte = ecum + L;       // e^(cum_{L-1} - cum)
  float* u = dte + L;          // the state term of dcum
  float* cin = u + L;          // dy_i . y_inter_i
  float* dcm = cin + L;        // dcum
  float* xd = dcm + L;         // sum_p dx_bar x
  float* colp = xd + L;        // [nrb][L] the row blocks' column sums of t
  float* rowp = colp + (L + 31) / 32 * L;  // [L / 16][L] the column
                                           // blocks' row sums of t
  float* red = rowp + L / 16 * L;  // [THREADS] partials of <S_c, G_c>
  float* scal = red + THREADS;     // [2] <S_c, G_c>, sum_j u_j

  const int hi = blockIdx.x % d.h, ch = (blockIdx.x / d.h) % d.nc,
            bi = blockIdx.x / (d.h * d.nc);
  const int gi = hi / (d.h / d.g), t0 = ch * L;
  const int nv = d.s - t0 < L ? d.s - t0 : L;  // rows of the chunk in s
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float Ah = A[hi];
  const long long row0 = (long long)bi * d.s + t0;  // (b, t) of chunk row 0
  const int nq = N / 4, pq = P / 4;

  // ---- the chunk's inputs -------------------------------------------------
  for (int i = tid; i < L; i += THREADS)
    dts[i] = i < nv ? dt[(row0 + i) * d.h + hi] : 0.f;
  for (int e = tid; e < ((L + 31) / 32 + L / 16) * L; e += THREADS)
    colp[e] = 0.f;  // the blocks above the diagonal add nothing
  for (int e = tid; e < L * nq; e += THREADS) {
    const int i = e / nq, q = e % nq;
    const long long src = ((row0 + i) * d.g + gi) * N + 4 * q;
    cp4(b_s + i * ns + 4 * q, i < nv ? Bm + src : nullptr);
    cp4(c_s + i * ns + 4 * q, i < nv ? Cm + src : nullptr);
  }
  for (int e = tid; e < L * pq; e += THREADS) {
    const int i = e / pq, q = e % pq;
    cp4(dy_s + i * ps + 4 * q,
        i < nv ? dy + ((row0 + i) * d.h + hi) * P + 4 * q : nullptr);
  }
  const long long sidx =
      (((long long)bi * d.h + hi) * d.nc + ch) * (long long)P * N;
  for (int e = tid; e < P * nq; e += THREADS) {
    const int r = e / nq, q = e % nq;
    cp4(g_s + r * gs + 4 * q, gstates + sidx + r * N + 4 * q);
    cp4(s_s + r * gs + 4 * q, states + sidx + r * N + 4 * q);
  }
  __syncthreads();
  chunk_cum(cum, dts, Ah, L);
  for (int e = tid; e < L * pq; e += THREADS) {
    const int i = e / pq, q = e % pq;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < nv) ld4(v, x + ((row0 + i) * d.h + hi) * P + 4 * q);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(v[j], dts[i]);
    st4(x_s + i * ps + 4 * q, v);
  }
  __syncthreads();
  for (int i = tid; i < L; i += THREADS) {
    ecum[i] = expf(cum[i]);
    dte[i] = expf(cum[L - 1] - cum[i]);
  }
  {
    float a = 0.f;
    for (int e = tid; e < P * N; e += THREADS) {
      const int r = e / N, k = e % N;
      a = fmaf(s_s[r * gs + k], g_s[r * gs + k], a);
    }
    red[tid] = a;
  }
  __syncthreads();

  const Strip sn(L, N), sp(L, P);
  // ---- the state terms: G_c and S_c in the matrix's place -----------------
  // dB_j = e^{cum_{L-1}-cum_j} G^T x_bar_j and dC_i = e^{cum_i} S^T dy_i
  // into the per-head outputs; dy_i . y_inter_i = C_i . dC_i
  for (int rb = warp; rb < sn.nrb; rb += WARPS) {
    const int r0 = sn.r0(rb, lane), c0 = sn.c0(lane);
    const bool act = r0 < L && c0 < N;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    if (act) {
      float acc[4][4] = {};
      mm_nn(acc, x_s, ps, g_s, gs, r0, c0, 0, P);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = __fmul_rn(acc[a][c], dte[r0 + a]);
        if (r0 + a < nv) st4(dBp + ((row0 + r0 + a) * d.h + hi) * N + c0, o);
      }
      float acc2[4][4] = {};
      mm_nn(acc2, dy_s, ps, s_s, gs, r0, c0, 0, P);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float cv[4], o[4];
        ld4(cv, c_s + (r0 + a) * ns + c0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o[c] = __fmul_rn(acc2[a][c], ecum[r0 + a]);
          part[a] = fmaf(cv[c], o[c], part[a]);
        }
        if (r0 + a < nv) st4(dCp + ((row0 + r0 + a) * d.h + hi) * N + c0, o);
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float v = row_sum(part[a], sn.lpr);
      if (act && sn.c0(lane) == 0) cin[r0 + a] = v;
    }
  }
  __syncthreads();  // S_c is read: G_c^T takes its place
  float* gt_s = s_s;  // [N][ps]
  for (int e = tid; e < P * N; e += THREADS) {
    const int k = e / P, r = e % P;
    gt_s[k * ps + r] = g_s[r * gs + k];
  }
  __syncthreads();
  // dx_bar_j's state term e^{cum_{L-1}-cum_j} G B_j (B_j against G^T's
  // rows, an NN product), kept in registers; u_j = x_bar_j . that term
  float dxr[XT][4][4];
#pragma unroll
  for (int it = 0; it < XT; ++it) {
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) dxr[it][a][c] = 0.f;
    const int rb = warp + it * WARPS;
    const int r0 = sp.r0(rb, lane), c0 = sp.c0(lane);
    const bool act = rb < sp.nrb && r0 < L && c0 < P;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    if (act) {
      mm_nn(dxr[it], b_s, ns, gt_s, ps, r0, c0, 0, N);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float xv[4];
        ld4(xv, x_s + (r0 + a) * ps + c0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          dxr[it][a][c] = __fmul_rn(dxr[it][a][c], dte[r0 + a]);
          part[a] = fmaf(xv[c], dxr[it][a][c], part[a]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float v = row_sum(part[a], sp.lpr);
      if (act && sp.c0(lane) == 0) u[r0 + a] = v;
    }
  }
  __syncthreads();  // G_c and S_c are read: the matrix takes their place

  // ---- W = (C B^T) o e^{min(cum_i - cum_j, 0)}, lower triangle ------------
  const int nblk = pair_blocks(L), rl = lane & 7, cq = lane >> 3;
  for (int blk = warp; blk < nblk; blk += WARPS) {
    int rb, cb;
    pair_block(blk, L, rb, cb);
    const int r0 = 32 * rb + rl, j0 = 16 * cb + 4 * cq;
    int ra[4];  // rows past L read row L - 1 and are not stored
#pragma unroll
    for (int a = 0; a < 4; ++a) ra[a] = min(r0 + 8 * a, L - 1);
    float acc[4][4] = {};
    mm_nt(acc, c_s, ns, ra, b_s, ns, j0, N);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = r0 + 8 * a;
      if (i >= L) continue;
      float w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        w[c] = j0 + c <= i ? acc[a][c] * expf(fminf(cum[i] - cum[j0 + c], 0.f))
                           : 0.f;
      st4(m_s + i * ms + j0, w);
    }
  }
  __syncthreads();

  // ---- dx_bar_j += sum_{i>=j} W_ij dy_i; dx, sum_p dx_bar x -----------------
#pragma unroll
  for (int it = 0; it < XT; ++it) {
    const int rb = warp + it * WARPS;
    const int r0 = sp.r0(rb, lane), c0 = sp.c0(lane);
    const bool act = rb < sp.nrb && r0 < L && c0 < P;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    if (act) {
      mm_tn(dxr[it], m_s, ms, dy_s, ps, r0, c0, r0, L);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int j = r0 + a;
        if (j < nv) {
          const long long at = ((row0 + j) * d.h + hi) * P + c0;
          float xv[4], o[4];
          ld4(xv, x + at);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            part[a] = fmaf(dxr[it][a][c], xv[c], part[a]);
            o[c] = __fmul_rn(dxr[it][a][c], dts[j]);
          }
          st4(dx + at, o);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float v = row_sum(part[a], sp.lpr);
      if (act && sp.c0(lane) == 0) xd[r0 + a] = v;
    }
  }
  __syncthreads();  // every read of W is done

  // ---- DS = (dy x_bar^T) o decay in place of W; t's row and column sums ---
  // per block: a row's 16 columns over the 4 lanes cq, a column's 32 rows
  // over the 8 lanes rl, each in a fixed tree
  for (int blk = warp; blk < nblk; blk += WARPS) {
    int rb, cb;
    pair_block(blk, L, rb, cb);
    const int r0 = 32 * rb + rl, j0 = 16 * cb + 4 * cq;
    int ra[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) ra[a] = min(r0 + 8 * a, L - 1);
    float dw[4][4] = {};
    mm_nt(dw, dy_s, ps, ra, x_s, ps, j0, P);
    float rowt[4] = {0.f, 0.f, 0.f, 0.f}, colt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = r0 + 8 * a;
      if (i >= L) continue;
      float w[4], ds[4];
      ld4(w, m_s + i * ms + j0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + c;
        const float dd = cum[i] - cum[j];
        ds[c] = j <= i ? dw[a][c] * expf(fminf(dd, 0.f)) : 0.f;
        const float f = dd < 0.f ? 1.f : (dd == 0.f ? 0.5f : 0.f);
        const float t = j < i ? dw[a][c] * w[c] * f : 0.f;
        rowt[a] += t;
        colt[c] += t;
      }
      st4(m_s + i * ms + j0, ds);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float v = rowt[a];
      v += __shfl_xor_sync(FULL, v, 8);
      v += __shfl_xor_sync(FULL, v, 16);
      if (cq == 0 && r0 + 8 * a < L) rowp[cb * L + r0 + 8 * a] = v;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = colt[c];
      v += __shfl_xor_sync(FULL, v, 1);
      v += __shfl_xor_sync(FULL, v, 2);
      v += __shfl_xor_sync(FULL, v, 4);
      if (rl == 0) colp[rb * L + j0 + c] = v;
    }
  }
  __syncthreads();

  // ---- dC_i += sum_{j<=i} DS_ij B_j;  dB_j += sum_{i>=j} DS_ij C_i ----------
  for (int rb = warp; rb < sn.nrb; rb += WARPS) {
    const int r0 = sn.r0(rb, lane), c0 = sn.c0(lane);
    if (r0 < L && c0 < N) {
      float acc[4][4] = {};
      mm_nn(acc, m_s, ms, b_s, ns, r0, c0, 0, r0 + 4);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (r0 + a >= nv) continue;
        float* at = dCp + ((row0 + r0 + a) * d.h + hi) * N + c0;
        float o[4];
        ld4(o, at);
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = acc[a][c] + o[c];
        st4(at, o);
      }
      float acc2[4][4] = {};
      mm_tn(acc2, m_s, ms, c_s, ns, r0, c0, r0, L);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (r0 + a >= nv) continue;
        float* at = dBp + ((row0 + r0 + a) * d.h + hi) * N + c0;
        float o[4];
        ld4(o, at);
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = acc2[a][c] + o[c];
        st4(at, o);
      }
    }
  }

  // ---- dcum, its reverse cumsum, ddt and dA's partial ----------------------
  for (int i = tid; i < L; i += THREADS) {
    float rsum = 0.f, csum = 0.f;
    for (int cb = 0; cb < L / 16; ++cb) rsum += rowp[cb * L + i];
    for (int rb = 0; 32 * rb < L; ++rb) csum += colp[rb * L + i];
    dcm[i] = rsum - csum + cin[i] - u[i];
  }
  if (warp == WARPS - 1) {  // <S_c, G_c> and sum_j u_j, each a fixed tree
    float a = 0.f, b = 0.f;
    for (int k = lane; k < THREADS; k += 32) a += red[k];
    for (int k = lane; k < L; k += 32) b += u[k];
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(FULL, a, o);
      b += __shfl_xor_sync(FULL, b, o);
    }
    if (lane == 0) scal[0] = a, scal[1] = b;
  }
  __syncthreads();
  if (tid == 0) {
    float acc = 0.f, da = 0.f;
    for (int i = L - 1; i >= 0; --i) {
      float dc = dcm[i];
      if (i == L - 1) dc += scal[1] + expf(cum[L - 1]) * scal[0];
      acc += dc;
      if (i < nv) ddt[(row0 + i) * d.h + hi] = fmaf(acc, Ah, xd[i]);
      da = fmaf(acc, dts[i], da);
    }
    dAp[((long long)bi * d.nc + ch) * d.h + hi] = da;
  }
}

template <int XT>
cudaError_t launch_chunk(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, const void* dy,
                         const void* st, const void* gst, void* dx, void* ddt,
                         void* dBp, void* dCp, void* dAp, const Dims& d,
                         cudaStream_t stream) {
  const int smem = chunk_layout_f32(d).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk<XT><<<d.b * d.h * d.nc, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(st), static_cast<const float*>(gst),
      static_cast<float*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dBp), static_cast<float*>(dCp),
      static_cast<float*>(dAp), d);
  return cudaGetLastError();
}

cudaError_t launch_all(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* dy,
                       const void* dstate, void* st, void* gst, void* dx,
                       void* ddt, void* dBp, void* dCp, void* dAp,
                       const Dims& d, cudaStream_t stream) {
  const int wsm = walk_smem(d);
  const int walks = d.b * d.h * ((d.p + PS - 1) / PS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states, cudaFuncAttributeMaxDynamicSharedMemorySize, wsm);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_bwd_dstates, cudaFuncAttributeMaxDynamicSharedMemorySize, wsm);
  if (err != cudaSuccess) return err;
  ssd_bwd_states<<<walks, THREADS, wsm, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(st), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dstates<<<walks, THREADS, wsm, stream>>>(
      static_cast<const float*>(dy), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(C),
      static_cast<const float*>(dstate), static_cast<float*>(gst), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (chunk_xt(d.l, d.p)) {
    case 1:
      return launch_chunk<1>(x, dt, A, B, C, dy, st, gst, dx, ddt, dBp, dCp,
                             dAp, d, stream);
    case 2:
      return launch_chunk<2>(x, dt, A, B, C, dy, st, gst, dx, ddt, dBp, dCp,
                             dAp, d, stream);
    case 3:
    case 4:
      return launch_chunk<4>(x, dt, A, B, C, dy, st, gst, dx, ddt, dBp, dCp,
                             dAp, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The bf16 path on the tensor cores.
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;
constexpr int WPS = 32;     // the slice of p a walk's CTA takes
constexpr int MAXT = 16;    // n8 tiles of a row block's output (128 wide)

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

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
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's address of an ldmatrix.x4 over the 16 x 16 block at (r0, c0)
// of a row-major tile: `at_a` gives the A fragment of rows r0.. along k =
// c0.. (ldsm), or with ldsm_t the B fragments of k rows r0.. and two n8
// tiles c0.., c0 + 8; `at_b` gives with ldsm the B fragments of n rows
// r0.. (two n8 tiles) along k = c0.., or with ldsm_t the A fragment of m
// = c0.. along k rows r0...
__device__ __forceinline__ const bf16* at_a(const bf16* t, int stride, int r0,
                                            int c0) {
  const int l = lane_id();
  return t + (r0 + (l & 15)) * stride + c0 + (l >> 4) * 8;
}
__device__ __forceinline__ const bf16* at_b(const bf16* t, int stride, int r0,
                                            int c0) {
  const int l = lane_id();
  return t + (r0 + (l & 7) + (l >> 4) * 8) * stride + c0 + ((l >> 3) & 1) * 8;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// The exact three-way split of two float32 values into bf16 pairs: hi =
// bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), each difference
// exact, so hi + mid + lo == v for |v| >= 2^-110 (`ref.bf16_split3`).
__device__ __forceinline__ void split2(float a, float b, uint32_t& h,
                                       uint32_t& m, uint32_t& lo) {
  const __nv_bfloat162 vh = __floats2bfloat162_rn(a, b);
  const float2 fh = __bfloat1622float2(vh);
  const float ra = __fsub_rn(a, fh.x), rb = __fsub_rn(b, fh.y);
  const __nv_bfloat162 vm = __floats2bfloat162_rn(ra, rb);
  const float2 fm = __bfloat1622float2(vm);
  h = bits(vh);
  m = bits(vm);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(ra, fm.x), __fsub_rn(rb, fm.y)));
}
// The A fragments (hi, mid, lo) of a 16 x 16 float32 tile held as the C
// fragments of two n8 tiles.
__device__ __forceinline__ void split_frag(const float (&v)[2][4],
                                           uint32_t (&fh)[4],
                                           uint32_t (&fm)[4],
                                           uint32_t (&fl)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    split2(v[q >> 1][(q & 1) * 2], v[q >> 1][(q & 1) * 2 + 1], fh[q], fm[q],
           fl[q]);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}
__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// cp.async of 16 or 8 bytes, zeros where `ok` is false
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4f(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[0..1] += rows [r0, r0 + 16) of `a` against rows [c0, c0 + 16) of
// `bm`, both k-contiguous, k in [0, K): a 16 x 16 score tile in one pass
// (two chains of mma, over the even and the odd k steps, summed at the
// end: the issue order keeps a product's next step from waiting on it)
__device__ __forceinline__ void tile_nt(float (&acc)[2][4], const bf16* a,
                                        int as, int r0, const bf16* bm,
                                        int bs, int c0, int K) {
  const bf16* pa = at_a(a, as, r0, 0);
  const bf16* pb = at_b(bm, bs, c0, 0);
  float odd[2][4] = {};
  int k = 0;
  for (; k + 16 < K; k += 32) {
    uint32_t fa[4], fb[4], ga[4], gb[4];
    ldsm(fa, pa + k);
    ldsm(fb, pb + k);
    ldsm(ga, pa + k + 16);
    ldsm(gb, pb + k + 16);
    mma(acc[0], fa, fb[0], fb[1]);
    mma(acc[1], fa, fb[2], fb[3]);
    mma(odd[0], ga, gb[0], gb[1]);
    mma(odd[1], ga, gb[2], gb[3]);
  }
  if (k < K) {
    uint32_t fa[4], fb[4];
    ldsm(fa, pa + k);
    ldsm(fb, pb + k);
    mma(acc[0], fa, fb[0], fb[1]);
    mma(acc[1], fa, fb[2], fb[3]);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] += odd[t][e];
}

// acc[t] += (hi + mid + lo) . bm[k0 .. k0 + 16)[8t .. 8t + 8) for t < nt
// (the pair products: a split tile against 16 rows of an input)
__device__ __forceinline__ void rs_split(float (&acc)[MAXT][4],
                                         const uint32_t (&fh)[4],
                                         const uint32_t (&fm)[4],
                                         const uint32_t (&fl)[4],
                                         const bf16* bm, int bs, int k0,
                                         int nt) {
  const bf16* pb = at_a(bm, bs, k0, 0);
  uint32_t fb[MAXT / 2][4];
#pragma unroll
  for (int np = 0; np < MAXT / 2; ++np)
    if (2 * np < nt) ldsm_t(fb[np], pb + 16 * np);
#pragma unroll
  for (int np = 0; np < MAXT / 2; ++np) {
    if (2 * np < nt) {
      mma(acc[2 * np], fh, fb[np][0], fb[np][1]);
      mma(acc[2 * np + 1], fh, fb[np][2], fb[np][3]);
    }
  }
#pragma unroll
  for (int np = 0; np < MAXT / 2; ++np) {
    if (2 * np < nt) {
      mma(acc[2 * np], fm, fb[np][0], fb[np][1]);
      mma(acc[2 * np + 1], fm, fb[np][2], fb[np][3]);
    }
  }
#pragma unroll
  for (int np = 0; np < MAXT / 2; ++np) {
    if (2 * np < nt) {
      mma(acc[2 * np], fl, fb[np][0], fb[np][1]);
      mma(acc[2 * np + 1], fl, fb[np][2], fb[np][3]);
    }
  }
}

// acc[t] += rows [r0, r0 + 16) of `a` (k-contiguous) against a state's
// three planes (each `plane` elements apart, row stride ps), k in [0, K):
// stored [k][N] (KN) or [N][k]; t < nt
template <bool KN>
__device__ __forceinline__ void state_product(float (&acc)[MAXT][4],
                                              const bf16* a, int as, int r0,
                                              const bf16* planes, int plane,
                                              int ps, int K, int nt) {
  const bf16* pa = at_a(a, as, r0, 0);
  const bf16* pb = KN ? at_a(planes, ps, 0, 0) : at_b(planes, ps, 0, 0);
  for (int k = 0; k < K; k += 16) {
    uint32_t fa[4];
    ldsm(fa, pa + k);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      uint32_t fb[MAXT / 2][4];
#pragma unroll
      for (int np = 0; np < MAXT / 2; ++np) {
        if (2 * np < nt) {
          if (KN)
            ldsm_t(fb[np], pb + q * plane + k * ps + 16 * np);
          else
            ldsm(fb[np], pb + q * plane + 16 * np * ps + k);
        }
      }
#pragma unroll
      for (int np = 0; np < MAXT / 2; ++np) {
        if (2 * np < nt) {
          mma(acc[2 * np], fa, fb[np][0], fb[np][1]);
          mma(acc[2 * np + 1], fa, fb[np][2], fb[np][3]);
        }
      }
    }
  }
}

// ---- the walks --------------------------------------------------------------
// The walk's chunk rows split into planes [3][L][WPS + 8], which also
// stage a state's split slice [3][WPS][n + 8] on its way out
__host__ __device__ inline int walk_planes(const Dims& d) {
  const int rows = 3 * d.l * (WPS + 8), state = 3 * WPS * (d.n + 8);
  return rows > state ? rows : state;
}
__host__ __device__ inline int walk_bytes(const Dims& d) {
  return 2 * (d.l * (d.n + 8) + walk_planes(d) + d.l * WPS) + 8 * d.l;
}

// The state tiles of a walk's warp, split, through the staging area stg
// (free: the caller synchronizes before) into o, the chunk's planes [3][p]
// [n], rows [p0, p0 + WPS): 16-byte stores, each row's in a run.
__device__ __forceinline__ void store_state(const float (&st)[2][2][4],
                                            bf16* stg, bf16* o, int p0,
                                            const Dims& d) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3, SN = d.n + 8, nq = d.n / 8;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int cb = (warp >> 1) + 4 * u;
    if (cb >= d.n / 16) continue;
#pragma unroll
    for (int tn = 0; tn < 2; ++tn)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (16 * (warp & 1) + gr + 8 * r) * SN + 16 * cb +
                       8 * tn + 2 * tq;
        uint32_t h, m, lo;
        split2(st[u][tn][2 * r], st[u][tn][2 * r + 1], h, m, lo);
        *reinterpret_cast<uint32_t*>(stg + at) = h;
        *reinterpret_cast<uint32_t*>(stg + WPS * SN + at) = m;
        *reinterpret_cast<uint32_t*>(stg + 2 * WPS * SN + at) = lo;
      }
  }
  __syncthreads();
  for (int e = tid; e < 3 * WPS * nq; e += THREADS) {
    const int pl = e / (WPS * nq), row = e / nq % WPS, q = e % nq;
    if (p0 + row < d.p)
      *reinterpret_cast<uint4*>(o + ((long long)pl * d.p + p0 + row) * d.n +
                                8 * q) =
          *reinterpret_cast<const uint4*>(stg + (pl * WPS + row) * SN + 8 * q);
  }
}

// One CTA per (b, h, 32-wide slice of p); warp w holds the state tiles
// (rows 16 (w % 2) .., columns 16 (w / 2 + 4u) ..), u = 0, 1.  Forward
// (REV false): S_0 = 0, S_{c+1} = e^{cum_{L-1}} S_c + sum_j (x_bar_j
// e^{cum_{L-1}-cum_j}) (x) B_j, writing S_c; reverse: from dstate (or 0),
// G_{c-1} = e^{cum_{L-1}} G_c + sum_i (dy_i e^{cum_i}) (x) C_i, writing
// G_c; each split into three bf16 planes [b, h, nc, 3, p, n].
template <bool REV>
__device__ __forceinline__ void walk(const bf16* __restrict__ v,
                                     const float* __restrict__ dt,
                                     const float* __restrict__ A,
                                     const bf16* __restrict__ w,
                                     const float* __restrict__ init,
                                     bf16* __restrict__ out, const Dims d) {
  extern __shared__ __align__(16) unsigned char smem_tc_walk[];
  const int L = d.l, NS = d.n + 8, VS = WPS + 8;
  bf16* w_s = reinterpret_cast<bf16*>(smem_tc_walk);  // [L][NS]
  bf16* v3 = w_s + L * NS;                            // [3][L][VS]
  bf16* xr = v3 + walk_planes(d);                     // [L][WPS] the rows
  float* dts = reinterpret_cast<float*>(xr + L * WPS);
  float* cum = dts + L;

  const int nsl = (d.p + WPS - 1) / WPS;
  const int sl = blockIdx.x % nsl, hi = (blockIdx.x / nsl) % d.h,
            bi = blockIdx.x / (nsl * d.h);
  const int gi = hi / (d.h / d.g), p0 = sl * WPS, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, gr = lane >> 2, tq = lane & 3;
  const float Ah = A[hi];
  const int rbk = warp & 1, ncb = d.n / 16, nq = d.n / 8;
  const long long bh = (long long)bi * d.h + hi;
  // chunk c's states in out
  auto chunk_out = [&](int c) {
    return out + ((bh * d.nc + c) * 3) * (long long)d.p * d.n;
  };

  float st[2][2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int tn = 0; tn < 2; ++tn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cb = (warp >> 1) + 4 * u;
        const int row = p0 + 16 * rbk + gr + 8 * (e >> 1),
                  col = 16 * cb + 8 * tn + 2 * tq + (e & 1);
        st[u][tn][e] = init != nullptr && cb < ncb && row < d.p
                           ? init[(bh * d.p + row) * d.n + col]
                           : 0.f;
      }
  // S_0 = 0 (G_{nc-1} = dstate); then each chunk's update gives the next
  store_state(st, v3, chunk_out(REV ? d.nc - 1 : 0), p0, d);
  for (int k = 0; k < d.nc; ++k) {
    const int c = REV ? d.nc - 1 - k : k;
    const int t0 = c * L, nv = d.s - t0 < L ? d.s - t0 : L;
    __syncthreads();  // the previous chunk's tiles and the state are read
    // the chunk's w rows, its rows of v in the slice and its dt, at once
    const long long r0 = (long long)bi * d.s + t0;
    const bf16* wc = w + (r0 * d.g + gi) * d.n;          // row 0 of the chunk
    const bf16* vc = v + (r0 * d.h + hi) * d.p + p0;
    const float* dc = dt + r0 * d.h + hi;
    const int ws = d.g * d.n, vs = d.h * d.p;
    for (int e = tid; e < L * nq; e += THREADS) {
      const int i = e / nq, q = e % nq;
      cp16(w_s + i * NS + 8 * q, wc + (i < nv ? i * ws + 8 * q : 0), i < nv);
    }
    for (int e = tid; e < L * (WPS / 4); e += THREADS) {
      const int i = e / (WPS / 4), q = e % (WPS / 4);
      const bool ok = i < nv && p0 + 4 * q < d.p;
      cp8(xr + i * WPS + 4 * q, vc + (ok ? i * vs + 4 * q : 0), ok);
    }
    for (int i = tid; i < L; i += THREADS)
      cp4f(dts + i, dc + (i < nv ? i * d.h : 0), i < nv);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    chunk_cum(cum, dts, Ah, L);
    __syncthreads();
    // the chunk's rows, weighted, split into three planes
    const float cl = cum[L - 1];
    for (int e = tid; e < L * (WPS / 4); e += THREADS) {
      const int i = e / (WPS / 4), q = e % (WPS / 4);
      float vv[4];
      ld4(vv, xr + i * WPS + 4 * q);
      const float wt = REV ? expf(cum[i]) : expf(cl - cum[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        vv[j] = REV ? __fmul_rn(vv[j], wt)
                    : __fmul_rn(__fmul_rn(vv[j], dts[i]), wt);
      uint32_t h[2], m[2], lo[2];
      split2(vv[0], vv[1], h[0], m[0], lo[0]);
      split2(vv[2], vv[3], h[1], m[1], lo[1]);
      bf16* dst = v3 + i * VS + 4 * q;
      *reinterpret_cast<uint2*>(dst) = make_uint2(h[0], h[1]);
      *reinterpret_cast<uint2*>(dst + L * VS) = make_uint2(m[0], m[1]);
      *reinterpret_cast<uint2*>(dst + 2 * L * VS) = make_uint2(lo[0], lo[1]);
    }
    __syncthreads();
    const float dec = expf(cl);
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int tn = 0; tn < 2; ++tn)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[u][tn][e] = __fmul_rn(st[u][tn][e], dec);
    // the chunk's terms: (rows^T) . w over the chunk's L rows
    const bool two = (warp >> 1) + 4 < ncb;  // the warp's second tile
    if ((warp >> 1) < ncb) {
      for (int ks = 0; ks < L; ks += 16) {
        uint32_t fb[2][4];
        ldsm_t(fb[0], at_a(w_s, NS, ks, 16 * (warp >> 1)));
        if (two) ldsm_t(fb[1], at_a(w_s, NS, ks, 16 * (warp >> 1) + 64));
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          uint32_t fa[4];
          ldsm_t(fa, at_b(v3 + q * L * VS, VS, ks, 16 * rbk));
          mma(st[0][0], fa, fb[0][0], fb[0][1]);
          mma(st[0][1], fa, fb[0][2], fb[0][3]);
          if (two) {
            mma(st[1][0], fa, fb[1][0], fb[1][1]);
            mma(st[1][1], fa, fb[1][2], fb[1][3]);
          }
        }
      }
    }
    // the state leaving (entering) this chunk: the next one's
    if (k + 1 < d.nc) {
      __syncthreads();  // every warp has read the planes
      store_state(st, v3, chunk_out(REV ? c - 1 : c + 1), p0, d);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 3)
    ssd_bwd_states_tc(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      bf16* __restrict__ states, Dims d) {
  walk<false>(x, dt, A, Bm, nullptr, states, d);
}

__global__ void __launch_bounds__(THREADS, 3)
    ssd_bwd_dstates_tc(const bf16* __restrict__ dy,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Cm,
                       const float* __restrict__ dstate,
                       bf16* __restrict__ gstates, Dims d) {
  walk<true>(dy, dt, A, Cm, dstate, gstates, d);
}

// ---- the in-chunk gradients -------------------------------------------------
// B, C [L][n + 8], x, dy [L][P + 8] (P: p rounded up to 16, zeros past
// p), S_c's and G_c's planes [3][P][n + 8], all bf16; then float32 dt,
// cum, e^cum, e^{cum_{L-1}-cum} [2][L] (this head's and the next's),
// dcum, sum_p dx_bar x, u [L], the <S, G> partials [THREADS], and three
// mbarriers.
struct CLayout {
  int P, ns, xs;
  int b, c, x, dy, s3, g3, f, bar, total;
};
__host__ __device__ inline CLayout chunk_layout(const Dims& d) {
  CLayout o;
  o.P = (d.p + 15) / 16 * 16, o.ns = d.n + 8, o.xs = o.P + 8;
  int off = 0;
  o.b = off, off += 2 * d.l * o.ns;
  o.c = off, off += 2 * d.l * o.ns;
  o.x = off, off += 2 * d.l * o.xs;
  o.dy = off, off += 2 * d.l * o.xs;
  o.s3 = off, off += 2 * 3 * o.P * o.ns;
  o.g3 = off, off += 2 * 3 * o.P * o.ns;
  o.f = off, off += 4 * (11 * d.l + THREADS);
  off = (off + 7) & ~7;
  o.bar = off, off += 24;
  o.total = off;
  return o;
}

// A row block's two rows (nt n8 tiles of acc, rows ok0 / ok1 in s) added
// to the group's sums, float32 [b, s, g, n]: the first head stores; a
// later one first reads back everything this thread stored (one round
// trip to L2, where the lines stay), then adds in head order and stores.
// No atomics: each element has one owner thread.
__device__ __forceinline__ void add_rows(float* o0, float* o1,
                                         const float (&acc)[MAXT][4],
                                         int nt, bool ok0, bool ok1, int hh) {
  float2 prev[MAXT][2];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    prev[t][0] = prev[t][1] = make_float2(0.f, 0.f);
    if (hh && t < nt) {
      if (ok0) prev[t][0] = *reinterpret_cast<const float2*>(o0 + 8 * t);
      if (ok1) prev[t][1] = *reinterpret_cast<const float2*>(o1 + 8 * t);
    }
  }
#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    if (t < nt) {
      if (ok0)
        *reinterpret_cast<float2*>(o0 + 8 * t) =
            make_float2(prev[t][0].x + acc[t][0], prev[t][0].y + acc[t][1]);
      if (ok1)
        *reinterpret_cast<float2*>(o1 + 8 * t) =
            make_float2(prev[t][1].x + acc[t][2], prev[t][1].y + acc[t][3]);
    }
  }
}

__device__ __forceinline__ void cp_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// One CTA per (b, group, chunk) walks the group's heads in order.
__global__ void __launch_bounds__(THREADS, 1) ssd_bwd_chunk_tc(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
    const bf16* __restrict__ states, const bf16* __restrict__ gstates,
    bf16* __restrict__ dx, float* __restrict__ ddt, float* dBg, float* dCg,
    float* __restrict__ dAp, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_tc_chunk[];
  const CLayout ly = chunk_layout(d);
  const int L = d.l, N = d.n, P = ly.P, NS = ly.ns, XS = ly.xs;
  bf16* b_s = reinterpret_cast<bf16*>(smem_tc_chunk + ly.b);
  bf16* c_s = reinterpret_cast<bf16*>(smem_tc_chunk + ly.c);
  bf16* x_s = reinterpret_cast<bf16*>(smem_tc_chunk + ly.x);
  bf16* dy_s = reinterpret_cast<bf16*>(smem_tc_chunk + ly.dy);
  bf16* s3 = reinterpret_cast<bf16*>(smem_tc_chunk + ly.s3);
  bf16* g3 = reinterpret_cast<bf16*>(smem_tc_chunk + ly.g3);
  // per head, double-buffered: dt, cum, e^cum, e^(cum_{L-1} - cum)
  float* rows = reinterpret_cast<float*>(smem_tc_chunk + ly.f);
  float* dcm = rows + 8 * L;  // dcum
  float* xd = dcm + L;        // sum_p dx_bar x
  float* uu = xd + L;         // u
  float* red = uu + L;        // [THREADS] partials of <S_c, G_c>
  // G_c landed (each thread's copies); S_c of the next head landed (the
  // last warp's copies); the warps are done with S_c
  const uint32_t gbar = smem_u32(smem_tc_chunk + ly.bar);
  const uint32_t sfull = gbar + 8, sfree = gbar + 16;

  const int gi = blockIdx.x % d.g, ch = (blockIdx.x / d.g) % d.nc,
            bi = blockIdx.x / (d.g * d.nc);
  const int rep = d.h / d.g, t0 = ch * L;
  const int nv = d.s - t0 < L ? d.s - t0 : L;  // rows of the chunk in s
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const long long row0 = (long long)bi * d.s + t0;  // (b, t) of chunk row 0
  const int nq = N / 8, pq = d.p / 4, nt = N / 8, ntp = P / 8;
  const int plane = P * NS;
  const long long sstride = (long long)d.nc * 3 * d.p * N;  // a head's states
  const long long sidx0 =
      (((long long)bi * d.h + gi * rep) * d.nc + ch) * 3LL * d.p * N;

  if (tid == 0) {
    mbar_init(gbar, THREADS);
    mbar_init(sfull, 32);
    mbar_init(sfree, WARPS);
  }
  // ---- the group's B and C, once; zeros past p (no copy lands there) ------
  for (int e = tid; e < L * nq; e += THREADS) {
    const int i = e / nq, q = e % nq;
    const long long src = ((row0 + (i < nv ? i : 0)) * d.g + gi) * N + 8 * q;
    cp16(b_s + i * NS + 8 * q, Bm + src, i < nv);
    cp16(c_s + i * NS + 8 * q, Cm + src, i < nv);
  }
  for (int e = tid; e < L * (P - d.p) / 4; e += THREADS) {
    const int i = e / ((P - d.p) / 4), q = e % ((P - d.p) / 4);
    *reinterpret_cast<uint2*>(x_s + i * XS + d.p + 4 * q) = make_uint2(0, 0);
    *reinterpret_cast<uint2*>(dy_s + i * XS + d.p + 4 * q) = make_uint2(0, 0);
  }
  for (int e = tid; e < 3 * (P - d.p) * nq; e += THREADS) {
    const int r = e / nq, q = e % nq, pl = r / (P - d.p),
              row = d.p + r % (P - d.p);
    *reinterpret_cast<uint4*>(s3 + pl * plane + row * NS + 8 * q) =
        make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(g3 + pl * plane + row * NS + 8 * q) =
        make_uint4(0, 0, 0, 0);
  }
  // the first head's S_c planes and dt
  for (int e = tid; e < 3 * d.p * nq; e += THREADS) {
    const int r = e / nq, q = e % nq;
    cp16(s3 + (r / d.p) * plane + (r % d.p) * NS + 8 * q,
         states + sidx0 + (long long)r * N + 8 * q, true);
  }
  for (int i = tid; i < L; i += THREADS)
    cp4f(rows + i, dt + (row0 + (i < nv ? i : 0)) * d.h + gi * rep, i < nv);

  // ---- the group's heads in order -------------------------------------------
  for (int hh = 0; hh < rep; ++hh) {
    const int hi = gi * rep + hh, cb = hh & 1;
    const float Ah = A[hi];
    const float* dts = rows + 4 * L * cb;
    const float* cum = dts + L;
    const float* ecum = cum + L;  // e^cum
    const float* dte = ecum + L;  // e^(cum_{L-1} - cum)
    const long long sidx = sidx0 + hh * sstride;
    // x and dy (16-byte copies where p % 8 == 0; and the next head's dt),
    // then G_c's planes
    if (d.p % 8 == 0) {
      for (int e = tid; e < L * (pq / 2); e += THREADS) {
        const int i = e / (pq / 2), q = e % (pq / 2);
        const long long src =
            ((row0 + (i < nv ? i : 0)) * d.h + hi) * d.p + 8 * q;
        cp16(x_s + i * XS + 8 * q, x + src, i < nv);
        cp16(dy_s + i * XS + 8 * q, dy + src, i < nv);
      }
    } else {
      for (int e = tid; e < L * pq; e += THREADS) {
        const int i = e / pq, q = e % pq;
        const long long src =
            ((row0 + (i < nv ? i : 0)) * d.h + hi) * d.p + 4 * q;
        cp8(x_s + i * XS + 4 * q, x + src, i < nv);
        cp8(dy_s + i * XS + 4 * q, dy + src, i < nv);
      }
    }
    if (hh + 1 < rep)
      for (int i = tid; i < L; i += THREADS)
        cp4f(rows + 4 * L * (cb ^ 1) + i,
             dt + (row0 + (i < nv ? i : 0)) * d.h + hi + 1, i < nv);
    cp_commit();
    for (int e = tid; e < 3 * d.p * nq; e += THREADS) {
      const int r = e / nq, q = e % nq;
      cp16(g3 + (r / d.p) * plane + (r % d.p) * NS + 8 * q,
           gstates + sidx + (long long)r * N + 8 * q, true);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // the first group, the zeros, the barriers' init
    cp_arrive(gbar);
    if (hh == 0) {
      float* c = rows + L;
      chunk_cum(c, rows, Ah, L);
      __syncthreads();
      for (int i = tid; i < L; i += THREADS) {
        c[L + i] = expf(c[i]);
        c[2 * L + i] = expf(c[L - 1] - c[i]);
      }
      __syncthreads();
    } else {
      mbar_wait(sfull, (hh - 1) & 1);  // S_c, copied by the last warp
    }

    const int rb = warp, r0 = 16 * rb;
    const bool act = r0 < L;
    const int ra0 = r0 + gr, ra1 = ra0 + 8;  // the lane's two rows
    const bool ok0 = ra0 < nv, ok1 = ra1 < nv;
    float cin[2] = {0.f, 0.f}, trow[2] = {0.f, 0.f}, tcol[2] = {0.f, 0.f},
          uj[2] = {0.f, 0.f}, xdj[2] = {0.f, 0.f};

    // ---- I: dC_i = e^{cum_i} dy_i S_c + sum_{j<=i} DS_ij B_j; t's row sums
    if (act) {
      float acc[MAXT][4];
#pragma unroll
      for (int t = 0; t < MAXT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      state_product<true>(acc, dy_s, XS, r0, s3, plane, NS, P, nt);
      const float e0 = ecum[ra0], e1 = ecum[ra1];
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if (t < nt) {
          const int col = 8 * t + 2 * tq;
          acc[t][0] = __fmul_rn(acc[t][0], e0);
          acc[t][1] = __fmul_rn(acc[t][1], e0);
          acc[t][2] = __fmul_rn(acc[t][2], e1);
          acc[t][3] = __fmul_rn(acc[t][3], e1);
          const float2 c0 = ld_bf2(c_s + ra0 * NS + col);
          const float2 c1 = ld_bf2(c_s + ra1 * NS + col);
          cin[0] = fmaf(c0.y, acc[t][1], fmaf(c0.x, acc[t][0], cin[0]));
          cin[1] = fmaf(c1.y, acc[t][3], fmaf(c1.x, acc[t][2], cin[1]));
        }
      }
      const float ci[2] = {cum[ra0], cum[ra1]};
      for (int jb = 0; jb <= rb; ++jb) {
        const int j0 = 16 * jb;
        float s1[2][4] = {}, s2[2][4] = {};
        tile_nt(s1, c_s, NS, r0, b_s, NS, j0, N);
        tile_nt(s2, dy_s, XS, r0, x_s, XS, j0, P);
        float ds[2][4];
#pragma unroll
        for (int tn = 0; tn < 2; ++tn)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int j = j0 + 8 * tn + 2 * tq + cc;
            const float cj = cum[j], dj = dts[j];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = r ? ra1 : ra0, e = 2 * r + cc;
              const float dd = ci[r] - cj;
              const float E = j <= i ? expf(fminf(dd, 0.f)) : 0.f;
              const float w = s1[tn][e] * E, dw = s2[tn][e] * dj;
              ds[tn][e] = dw * E;
              const float f = dd < 0.f ? 1.f : (dd == 0.f ? 0.5f : 0.f);
              trow[r] += j < i ? dw * w * f : 0.f;
            }
          }
        uint32_t fh[4], fm[4], fl[4];
        split_frag(ds, fh, fm, fl);
        rs_split(acc, fh, fm, fl, b_s, NS, j0, nt);
      }
      add_rows(dCg + ((row0 + ra0) * d.g + gi) * N + 2 * tq,
               dCg + ((row0 + ra1) * d.g + gi) * N + 2 * tq, acc, nt, ok0,
               ok1, hh);
    }

    // ---- G_c has landed: <S_c, G_c>; then S_c's place is free ---------------
    mbar_wait(gbar, hh & 1);
    {
      float a = 0.f;
      for (int e = tid; e < d.p * nq; e += THREADS) {
        const int at = (e / nq) * NS + 8 * (e % nq);
        uint4 sv[3], gv[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          sv[q] = *reinterpret_cast<const uint4*>(s3 + q * plane + at);
          gv[q] = *reinterpret_cast<const uint4*>(g3 + q * plane + at);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float2 sh = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(&sv[0])[k]);
          float2 sm = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(&sv[1])[k]);
          float2 sl = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(&sv[2])[k]);
          float2 gh = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(&gv[0])[k]);
          float2 gm = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(&gv[1])[k]);
          float2 gl = __bfloat1622float2(
              reinterpret_cast<const __nv_bfloat162*>(&gv[2])[k]);
          a = fmaf(__fadd_rn(__fadd_rn(sh.x, sm.x), sl.x),
                   __fadd_rn(__fadd_rn(gh.x, gm.x), gl.x), a);
          a = fmaf(__fadd_rn(__fadd_rn(sh.y, sm.y), sl.y),
                   __fadd_rn(__fadd_rn(gh.y, gm.y), gl.y), a);
        }
      }
      red[tid] = a;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(sfree);
    if (warp == WARPS - 1 && hh + 1 < rep) {
      // the last warp (the fewest pairs in J1 and J2) copies the next
      // head's S_c once every warp is done with this one's
      mbar_wait(sfree, hh & 1);
      for (int e = lane; e < 3 * d.p * nq; e += 32) {
        const int r = e / nq, q = e % nq;
        cp16(s3 + (r / d.p) * plane + (r % d.p) * NS + 8 * q,
             states + sidx + sstride + (long long)r * N + 8 * q, true);
      }
      cp_arrive(sfull);
      // and the next head's cum and decays (its dt came with x, dy)
      float* nd = rows + 4 * L * (cb ^ 1);
      float* nc = nd + L;
      if (lane == 0) cum_rows(nc, nd, A[hi + 1], L);
      __syncwarp();
      for (int i = lane; i < L; i += 32) {
        nc[L + i] = expf(nc[i]);
        nc[2 * L + i] = expf(nc[L - 1] - nc[i]);
      }
    }

    // ---- J1: dx_bar_j = e^{cum_{L-1}-cum_j} B_j G_c^T + sum_{i>=j} W_ij dy_i
    if (act) {
      float acc[MAXT][4];
#pragma unroll
      for (int t = 0; t < MAXT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      state_product<false>(acc, b_s, NS, r0, g3, plane, NS, N, ntp);
      const float d0 = dte[ra0], d1 = dte[ra1], t0v = dts[ra0], t1v = dts[ra1];
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if (t < ntp) {
          const int col = 8 * t + 2 * tq;
          acc[t][0] = __fmul_rn(acc[t][0], d0);
          acc[t][1] = __fmul_rn(acc[t][1], d0);
          acc[t][2] = __fmul_rn(acc[t][2], d1);
          acc[t][3] = __fmul_rn(acc[t][3], d1);
          const float2 x0 = ld_bf2(x_s + ra0 * XS + col);
          const float2 x1 = ld_bf2(x_s + ra1 * XS + col);
          uj[0] = fmaf(__fmul_rn(x0.y, t0v), acc[t][1],
                       fmaf(__fmul_rn(x0.x, t0v), acc[t][0], uj[0]));
          uj[1] = fmaf(__fmul_rn(x1.y, t1v), acc[t][3],
                       fmaf(__fmul_rn(x1.x, t1v), acc[t][2], uj[1]));
        }
      }
      const float cjr[2] = {cum[ra0], cum[ra1]};
      for (int ib = rb; 16 * ib < L; ++ib) {
        const int i0 = 16 * ib;
        float s1[2][4] = {};
        tile_nt(s1, b_s, NS, r0, c_s, NS, i0, N);
#pragma unroll
        for (int tn = 0; tn < 2; ++tn)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int i = i0 + 8 * tn + 2 * tq + cc;
            const float ci = cum[i];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = r ? ra1 : ra0, e = 2 * r + cc;
              s1[tn][e] =
                  i >= j ? s1[tn][e] * expf(fminf(ci - cjr[r], 0.f)) : 0.f;
            }
          }
        uint32_t fh[4], fm[4], fl[4];
        split_frag(s1, fh, fm, fl);
        rs_split(acc, fh, fm, fl, dy_s, XS, i0, ntp);
      }
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if (t < ntp) {
          const int col = 8 * t + 2 * tq;
          const float2 x0 = ld_bf2(x_s + ra0 * XS + col);
          const float2 x1 = ld_bf2(x_s + ra1 * XS + col);
          xdj[0] = fmaf(acc[t][1], x0.y, fmaf(acc[t][0], x0.x, xdj[0]));
          xdj[1] = fmaf(acc[t][3], x1.y, fmaf(acc[t][2], x1.x, xdj[1]));
          if (col < d.p) {
            if (ok0)
              *reinterpret_cast<__nv_bfloat162*>(
                  dx + ((row0 + ra0) * d.h + hi) * d.p + col) =
                  __floats2bfloat162_rn(__fmul_rn(acc[t][0], t0v),
                                        __fmul_rn(acc[t][1], t0v));
            if (ok1)
              *reinterpret_cast<__nv_bfloat162*>(
                  dx + ((row0 + ra1) * d.h + hi) * d.p + col) =
                  __floats2bfloat162_rn(__fmul_rn(acc[t][2], t1v),
                                        __fmul_rn(acc[t][3], t1v));
          }
        }
      }
    }

    // ---- J2: dB_j = dt_j e^{cum_{L-1}-cum_j} x_j G_c + sum_{i>=j} DS_ij C_i;
    // t's column sums ---------------------------------------------------------
    if (act) {
      float acc[MAXT][4];
#pragma unroll
      for (int t = 0; t < MAXT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
      state_product<true>(acc, x_s, XS, r0, g3, plane, NS, P, nt);
      const float t0v = dts[ra0], t1v = dts[ra1], d0 = dte[ra0], d1 = dte[ra1];
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        if (t < nt) {
          acc[t][0] = __fmul_rn(__fmul_rn(acc[t][0], t0v), d0);
          acc[t][1] = __fmul_rn(__fmul_rn(acc[t][1], t0v), d0);
          acc[t][2] = __fmul_rn(__fmul_rn(acc[t][2], t1v), d1);
          acc[t][3] = __fmul_rn(__fmul_rn(acc[t][3], t1v), d1);
        }
      }
      const float cjr[2] = {cum[ra0], cum[ra1]}, djr[2] = {t0v, t1v};
      for (int ib = rb; 16 * ib < L; ++ib) {
        const int i0 = 16 * ib;
        float s1[2][4] = {}, s2[2][4] = {};
        tile_nt(s1, b_s, NS, r0, c_s, NS, i0, N);
        tile_nt(s2, x_s, XS, r0, dy_s, XS, i0, P);
        float ds[2][4];
#pragma unroll
        for (int tn = 0; tn < 2; ++tn)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int i = i0 + 8 * tn + 2 * tq + cc;
            const float ci = cum[i];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int j = r ? ra1 : ra0, e = 2 * r + cc;
              const float dd = ci - cjr[r];
              const float E = i >= j ? expf(fminf(dd, 0.f)) : 0.f;
              const float w = s1[tn][e] * E, dw = s2[tn][e] * djr[r];
              ds[tn][e] = dw * E;
              const float f = dd < 0.f ? 1.f : (dd == 0.f ? 0.5f : 0.f);
              tcol[r] += i > j ? dw * w * f : 0.f;
            }
          }
        uint32_t fh[4], fm[4], fl[4];
        split_frag(ds, fh, fm, fl);
        rs_split(acc, fh, fm, fl, c_s, NS, i0, nt);
      }
      add_rows(dBg + ((row0 + ra0) * d.g + gi) * N + 2 * tq,
               dBg + ((row0 + ra1) * d.g + gi) * N + 2 * tq, acc, nt, ok0,
               ok1, hh);
    }

    // ---- dcum, its reverse cumsum, ddt and dA's partial --------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cin[r] = quad_sum(cin[r]);
      trow[r] = quad_sum(trow[r]);
      tcol[r] = quad_sum(tcol[r]);
      uj[r] = quad_sum(uj[r]);
      xdj[r] = quad_sum(xdj[r]);
    }
    if (act && tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? ra1 : ra0;
        dcm[i] = trow[r] - tcol[r] + cin[r] - uj[r];
        xd[i] = xdj[r];
        uu[i] = uj[r];
      }
    }
    __syncthreads();
    if (warp == 0) {
      // <S_c, G_c> and sum_j u_j, each a fixed tree; then d(da), the
      // reverse cumsum of dcum, as a scan over the warp: lane l takes rows
      // [4l, 4l + 4) (L <= 128), their suffix sums in order, then the
      // lanes' totals in a fixed tree
      float a = 0.f, b = 0.f;
      for (int k = lane; k < THREADS; k += 32) a += red[k];
      for (int k = lane; k < L; k += 32) b += uu[k];
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(FULL, a, o);
        b += __shfl_xor_sync(FULL, b, o);
      }
      float v[4], tot = 0.f;
#pragma unroll
      for (int k = 3; k >= 0; --k) {
        const int i = 4 * lane + k;
        float dc = i < L ? dcm[i] : 0.f;
        if (i == L - 1) dc += b + expf(cum[L - 1]) * a;
        tot += dc;
        v[k] = tot;
      }
      float after = 0.f;  // the sum over the lanes above this one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_down_sync(FULL, tot + after, o);
        if (lane + o < 32) after += up;
      }
      float da = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * lane + k;
        const float acc = v[k] + after;
        if (i < nv) ddt[(row0 + i) * d.h + hi] = fmaf(acc, Ah, xd[i]);
        if (i < L) da = fmaf(acc, dts[i], da);
      }
      for (int o = 16; o > 0; o >>= 1) da += __shfl_xor_sync(FULL, da, o);
      if (lane == 0) dAp[((long long)bi * d.nc + ch) * d.h + hi] = da;
    }
    __syncthreads();  // this head's tiles and rows are read
  }
}

cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* dy,
                   const void* dstate, void* st, void* gst, void* dx,
                   void* ddt, void* dBp, void* dCp, void* dAp, const Dims& d,
                   cudaStream_t stream) {
  const int wsm = walk_bytes(d), csm = chunk_layout(d).total;
  const int walks = d.b * d.h * ((d.p + WPS - 1) / WPS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, wsm);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_bwd_dstates_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, wsm);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_bwd_chunk_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, csm);
  if (err != cudaSuccess) return err;
  ssd_bwd_states_tc<<<walks, THREADS, wsm, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(B),
      static_cast<bf16*>(st), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dstates_tc<<<walks, THREADS, wsm, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(C),
      static_cast<const float*>(dstate), static_cast<bf16*>(gst), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk_tc<<<d.b * d.g * d.nc, THREADS, csm, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(B),
      static_cast<const bf16*>(C), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(st), static_cast<const bf16*>(gst),
      static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dBp), static_cast<float*>(dCp),
      static_cast<float*>(dAp), d);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// Shared memory of one CTA of the chunk kernel (the walks need less).
long long ssd_bwd_smem_bytes(int p, int n, int l, int bf16) {
  const Dims d{1, 1, 1, p, 1, n, l, 1};
  return bf16 ? tc::chunk_layout(d).total : chunk_layout_f32(d).total;
}

// The chunk kernel's instance: 0 for the bf16 kernel on the tensor cores,
// else the float32 kernel's dx_bar tiles a thread keeps (1, 2, 4).
int ssd_bwd_instance(int l, int p, int bf16) {
  if (bf16) return 0;
  const int xt = chunk_xt(l, p);
  return xt <= 2 ? xt : 4;
}

// dstate may be null (the final state takes no gradient).  states and
// gstates are scratch: bf16 [b, h, nc, 3, p, n] (the split planes) for
// bf16 inputs, float32 [b, h, nc, p, n] for float32; dBp and dCp float32,
// the group sums [b, s, g, n] for bf16 inputs, per head [b, s, h, n] for
// float32; dAp float32 [b, nc, h].
int ssd_backward(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* dy, const void* dstate,
                 void* states, void* gstates, void* dx, void* ddt, void* dBp,
                 void* dCp, void* dAp, int b, int s, int h, int p, int g,
                 int n, int l, int bf16, void* stream) {
  if (l > MAX_L || n > MAX_N || p > MAX_P) return cudaErrorInvalidValue;
  const Dims d{b, s, h, p, g, n, l, (s + l - 1) / l};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return tc::launch(x, dt, A, B, C, dy, dstate, states, gstates, dx, ddt,
                      dBp, dCp, dAp, d, st);
  return launch_all(x, dt, A, B, C, dy, dstate, states, gstates, dx, ddt,
                    dBp, dCp, dAp, d, st);
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
