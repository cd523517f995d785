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
// 64, g 3, n 128, chunk 128) a (b, h, chunk) needs ~2.1 MFLOP of bf16
// scores and ~16.8 MFLOP of float32 products (dy x_bar^T, W^T dy, DS B,
// DS^T C, three state products and the two walks), ~52 GFLOP in all,
// against ~0.2 GB of inputs and gradients: the CUDA cores' float32 rate
// bounds it (~0.77 ms at 67 TFLOP/s), as in the forward.
//
// Three kernels, launched in turn on the caller's stream; a simple design
// that is right first (every product a 4 x 4 float32 register tile on the
// CUDA cores, read from shared memory):
//
// - `ssd_bwd_states`: one CTA per (b, h, 32-wide slice of p) walks the
//   chunks in order, the forward's state update, and writes S_c, the
//   state entering each chunk, as float32 [b, h, nc, p, n] (recomputed
//   here rather than kept by the tuned forward, so the serving path is
//   unchanged);
// - `ssd_bwd_dstates`: the same walk in reverse from dstate, writing G_c;
// - `ssd_bwd_chunk`: one CTA per (b, h, chunk) computes the in-chunk
//   gradients.  Shared memory holds the chunk's B and C (input dtype),
//   x_bar (float32), dy and one [L][L] float32 matrix, which holds G_c
//   and S_c for the state terms first (then G_c^T in S_c's place), then
//   W = (C B^T) o decay, then DS = (dy x_bar^T) o decay in place
//   (199,696 bytes at L = n = 128, p = 64, bf16).  dx_bar stays in registers from its
//   state term through its pair term (XT tiles of 4 x 4 a thread).  dB
//   and dC are written per head as float32 [b, s, h, n]: the state terms
//   first, then read back and summed with the pair terms by the same CTA;
//   the wrapper sums each group's heads in a fixed order (no atomics).
//   A product whose lanes read one operand's rows along k (both operands
//   k-contiguous) takes rows eight apart a lane, so a warp's lanes read
//   consecutive rows: with the lanes' rows four apart, as a 4 x 4 output
//   tile would have them, they fell into 4-8 of the 32 banks.  So the
//   pair products (C B^T, dy x_bar^T) run over blocks of 32 rows x 16
//   columns of the lower triangle, and G B_j reads G^T (an NN product).
//   Row and column sums of t are shuffles in fixed trees within a block,
//   then over the blocks in order; the reverse cumsum of dcum and dA's
//   partial over the chunk run on one thread: two calls are bit-equal.
//
// Rows past s read as x = 0, dt = 0, B = C = 0 and dy = 0 (the
// reference's padding) and are not stored.  cum is summed in order on one
// thread, each product and sum rounded on its own (torch's CUDA cumsum
// along a non-innermost dimension sums in the same order), so a tie from
// dt = 0 is a tie in both.
//
// Limits: chunk <= 128, n <= 128, p <= 128 (the warp shuffles take a
// row's column tiles in one warp), the forward's p % 4, n % 16,
// chunk % 16, and the chunk kernel's shared memory (`ssd_bwd_smem_bytes`;
// float32 at L = n = 128, and p = 128 at L = n = 128, do not fit).
//
// Plain C interface, loaded with ctypes: ssd_backward returns a
// cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
// Four elements copied as they are, or zeros where `src` is null.
__device__ __forceinline__ void cp4(float* d, const float* src) {
  *reinterpret_cast<float4*>(d) =
      src ? *reinterpret_cast<const float4*>(src) : make_float4(0, 0, 0, 0);
}
__device__ __forceinline__ void cp4(__nv_bfloat16* d, const __nv_bfloat16* src) {
  *reinterpret_cast<uint2*>(d) =
      src ? *reinterpret_cast<const uint2*>(src) : make_uint2(0, 0);
}

// The 4 x 4 register-tile products, k ascending (a fixed order of sums).
// NN: acc[a][c] += sum_k A[r0 + a][k] * Bm[k][c0 + c], k in [k0, k1), k
// a multiple of 4
template <typename TA, typename TB>
__device__ __forceinline__ void mm_nn(float (&acc)[4][4], const TA* A, int as,
                                      const TB* Bm, int bs, int r0, int c0,
                                      int k0, int k1) {
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
template <typename TA, typename TB>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const TA* A, int as,
                                      const int (&ra)[4], const TB* Bt,
                                      int bs, int c0, int k1) {
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
template <typename TA, typename TB>
__device__ __forceinline__ void mm_tn(float (&acc)[4][4], const TA* At, int as,
                                      const TB* Bm, int bs, int r0, int c0,
                                      int k0, int k1) {
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
__device__ __forceinline__ void chunk_cum(float* cum, const float* dts,
                                          float A, int l) {
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < l; ++i) {
      acc = __fadd_rn(acc, __fmul_rn(dts[i], A));
      cum[i] = acc;
    }
  }
}

// ---------------------------------------------------------------------------
// The two walks: one CTA per (b, h, 32-wide slice of p), its [PS][n]
// slice of the state in 4 x 4 register tiles (n <= 128: 256 tiles).
// Forward (REV false): S_0 = 0, S_{c+1} = e^{cum_{L-1}} S_c
// + sum_j (x_bar_j e^{cum_{L-1}-cum_j}) (x) B_j, writing S_c.  Reverse:
// from dstate (or 0), G_{c-1} = e^{cum_{L-1}} G_c + sum_i (dy_i e^{cum_i})
// (x) C_i, writing G_c.
// ---------------------------------------------------------------------------
__host__ __device__ inline int walk_smem(const Dims& d, int tsz) {
  return 4 * (3 * d.l + d.l * (PS + 4)) + d.l * (d.n + 4) * tsz;
}

template <typename T, bool REV>
__device__ __forceinline__ void walk(const T* __restrict__ v,
                                     const float* __restrict__ dt,
                                     const float* __restrict__ A,
                                     const T* __restrict__ w,
                                     const float* __restrict__ init,
                                     float* __restrict__ out, const Dims d) {
  extern __shared__ __align__(16) unsigned char smem_walk[];
  const int L = d.l, ns = d.n + 4, vs = PS + 4;
  float* cum = reinterpret_cast<float*>(smem_walk);   // [L]
  float* dts = cum + L;                               // [L]
  float* wt = dts + L;                                // [L] the row weights
  float* v_s = wt + L;                                // [L][vs]
  T* w_s = reinterpret_cast<T*>(v_s + L * vs);        // [L][ns]

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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_states(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ states, Dims d) {
  walk<T, false>(x, dt, A, Bm, nullptr, states, d);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    ssd_bwd_dstates(const T* __restrict__ dy, const float* __restrict__ dt,
                    const float* __restrict__ A, const T* __restrict__ Cm,
                    const float* __restrict__ dstate,
                    float* __restrict__ gstates, Dims d) {
  walk<T, true>(dy, dt, A, Cm, dstate, gstates, d);
}

// ---------------------------------------------------------------------------
// The in-chunk gradients: one CTA per (b, h, chunk).
// ---------------------------------------------------------------------------
struct Layout {
  int ns, ps, ms, gs;              // row strides (elements)
  int b, c, x, dy, m, small, total;  // byte offsets
};

__host__ __device__ inline int al16(int v) { return (v + 15) & ~15; }

// B, C [L][ns] and dy [L][ps] in the input dtype, x_bar [L][ps] and the
// matrix [L][ms] (or G_c [p][gs] beside S_c [p][gs], then G_c^T [n][ps])
// in float32, then the per-row arrays, the pair blocks' row and column
// sums of t and the threads' <S, G> partials.
__host__ __device__ inline Layout chunk_layout(const Dims& d, int tsz) {
  Layout o;
  o.ns = d.n + 4, o.ps = d.p + 4, o.ms = d.l + 4, o.gs = d.n + 4;
  int off = 0;
  o.b = off, off += al16(d.l * o.ns * tsz);
  o.c = off, off += al16(d.l * o.ns * tsz);
  o.x = off, off += al16(d.l * o.ps * 4);
  o.dy = off, off += al16(d.l * o.ps * tsz);
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

template <typename T, int XT>
__global__ void __launch_bounds__(THREADS) ssd_bwd_chunk(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const T* __restrict__ dy,
    const float* __restrict__ states, const float* __restrict__ gstates,
    T* __restrict__ dx, float* __restrict__ ddt, float* dBp, float* dCp,
    float* __restrict__ dAp, Dims d) {
  extern __shared__ __align__(16) unsigned char smem_chunk[];
  const Layout ly = chunk_layout(d, sizeof(T));
  const int L = d.l, P = d.p, N = d.n, ns = ly.ns, ps = ly.ps, ms = ly.ms,
            gs = ly.gs;
  T* b_s = reinterpret_cast<T*>(smem_chunk + ly.b);
  T* c_s = reinterpret_cast<T*>(smem_chunk + ly.c);
  float* x_s = reinterpret_cast<float*>(smem_chunk + ly.x);
  T* dy_s = reinterpret_cast<T*>(smem_chunk + ly.dy);
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

template <typename T, int XT>
cudaError_t launch_chunk(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, const void* dy,
                         const void* st, const void* gst, void* dx, void* ddt,
                         void* dBp, void* dCp, void* dAp, const Dims& d,
                         cudaStream_t stream) {
  const int smem = chunk_layout(d, sizeof(T)).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk<T, XT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_chunk<T, XT><<<d.b * d.h * d.nc, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(dy),
      static_cast<const float*>(st), static_cast<const float*>(gst),
      static_cast<T*>(dx), static_cast<float*>(ddt), static_cast<float*>(dBp),
      static_cast<float*>(dCp), static_cast<float*>(dAp), d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, const void* dy,
                       const void* dstate, void* st, void* gst, void* dx,
                       void* ddt, void* dBp, void* dCp, void* dAp,
                       const Dims& d, cudaStream_t stream) {
  const int wsm = walk_smem(d, sizeof(T));
  const int walks = d.b * d.h * ((d.p + PS - 1) / PS);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, wsm);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      ssd_bwd_dstates<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, wsm);
  if (err != cudaSuccess) return err;
  ssd_bwd_states<T><<<walks, THREADS, wsm, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<float*>(st), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dstates<T><<<walks, THREADS, wsm, stream>>>(
      static_cast<const T*>(dy), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(C),
      static_cast<const float*>(dstate), static_cast<float*>(gst), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (chunk_xt(d.l, d.p)) {
    case 1:
      return launch_chunk<T, 1>(x, dt, A, B, C, dy, st, gst, dx, ddt, dBp,
                                dCp, dAp, d, stream);
    case 2:
      return launch_chunk<T, 2>(x, dt, A, B, C, dy, st, gst, dx, ddt, dBp,
                                dCp, dAp, d, stream);
    case 3:
    case 4:
      return launch_chunk<T, 4>(x, dt, A, B, C, dy, st, gst, dx, ddt, dBp,
                                dCp, dAp, d, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory of one CTA of the chunk kernel (the walks need less).
long long ssd_bwd_smem_bytes(int p, int n, int l, int bf16) {
  const Dims d{1, 1, 1, p, 1, n, l, 1};
  return chunk_layout(d, bf16 ? 2 : 4).total;
}

// The chunk kernel's instance: the dx_bar tiles a thread keeps (1, 2, 4).
int ssd_bwd_instance(int l, int p) {
  const int xt = chunk_xt(l, p);
  return xt <= 2 ? xt : 4;
}

// dstate may be null (the final state takes no gradient).  states and
// gstates are float32 [b, h, nc, p, n] scratch; dBp and dCp float32
// [b, s, h, n]; dAp float32 [b, nc, h].
int ssd_backward(const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* dy, const void* dstate,
                 void* states, void* gstates, void* dx, void* ddt, void* dBp,
                 void* dCp, void* dAp, int b, int s, int h, int p, int g,
                 int n, int l, int bf16, void* stream) {
  if (l > MAX_L || n > MAX_N || p > MAX_P) return cudaErrorInvalidValue;
  const Dims d{b, s, h, p, g, n, l, (s + l - 1) / l};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_all<__nv_bfloat16>(x, dt, A, B, C, dy, dstate, states,
                                     gstates, dx, ddt, dBp, dCp, dAp, d, st);
  return launch_all<float>(x, dt, A, B, C, dy, dstate, states, gstates, dx,
                           ddt, dBp, dCp, dAp, d, st);
}

const char* ssd_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
