// Hopper (sm_90a) kernel for the MF-SGD dense-block update.
//
// Replaces the TPU kernel repro/kernels/mf_sgd.py::mf_sgd_block (:87; its
// two pallas_calls, _dl_kernel at :97 and _dr_kernel at :117).  On L[N,K],
// R[K,M], ratings D[N,M] (float32, row-major) observed where mask[N,M]
// (bool) is set:
//
//   E    = mask ? D - L R : 0          (selected: a NaN of D never enters)
//   dL   = gamma (E R^T - (lam rowcount) L)
//   dR   = gamma (L^T E - (lam colcount) R)
//   loss = sum E^2 / max(sum mask, 1)
//
// The plain PyTorch version, which states the contract, is mf_sgd_block in
// kernels/ref.py; the launch wrapper in kernels/mf_sgd.py checks shapes,
// types and devices and allocates the outputs and the scratch below before
// calling the extern "C" entry points.
//
// Bound.  Only the observed entries carry work: 6 K nnz operations (the
// residual, then its share of E R^T and L^T E) against the mask's N M
// bytes, the observed ratings, the factors and the outputs.  At the
// Netflix shape (K = 100, N = 32,768, M = 17,770, 1.17 % observed) that is
// bound by the mask's bytes: 0.19 ms at 3.35 TB/s.  This design reads the
// mask once for both passes; what bounds it in practice is the factor
// vectors each observed entry reads from L2, nnz K 4 bytes a pass (2.7 GB
// at that shape).
//
// Design.  A dense-block design spends 98.8 % of its products on entries
// the mask then zeroes, and reads the mask a byte at a time.  Here:
//   - mf_pack reads the mask once, in 16-byte loads whatever a row's
//     alignment, and writes it as 64-bit words twice: by rows (rowbits) and
//     by columns (colbits), 1/8 of its bytes each;
//   - pass ROWS (mf_rows): warp o owns row o of dL.  It walks the row's
//     words, lists the observed columns 32 at a time in shared memory, reads
//     their ratings (D only where observed), and takes the entries eight at
//     a time: lane l holds k = l + 32 j of L[o] in registers and reads the
//     same slice of each entry's column of R (a row of R^T, from L2), forms
//     its part of the eight dot products, and one tree of shuffles reduces
//     all eight; e = D - dot; the row's sum takes e R[:, x] in column order
//     in registers, and the squares of e are summed.  The end of the row
//     writes dL[o] = gamma (sum - (lam count) L[o]) and its count;
//   - pass COLS (mf_cols): the same with warp o owning column o of R, the
//     column's words, rows of L from L2; it writes dR^T, which
//     mf_transpose turns into dR;
//   - mf_loss sums the rows' squares and counts.
// Each sum has one owner, so there are no atomics and no partial sums, and
// every order is fixed by the data and the shape.  All products are
// float32 fmaf on the CUDA cores (no TF32).  A warp needs a few hundred
// nanoseconds of L2 latency per eight entries; 24 warps an SM at K = 100
// (80 registers) keep the L2 busy.  The residual is recomputed in the
// second pass (2 K nnz operations).  Limit: 1 <= K <= 256 (a lane holds
// ceil(K / 32) of each vector).
//
// Rounding: the products and sums are fmaf chains and fixed trees; the
// residual is __fsub_rn(D, dot); the epilogue rounds lam * (float)count, its
// product with L (R), the difference and the product with gamma each once
// (__fmul_rn / __fsub_rn, never contracted), as the reference does; the
// loss is the IEEE quotient __fdiv_rn by (float)max(count, 1).  The loss's
// longest chain of additions: a tree of eight squares, at most 256 such
// sums in order within 2048 columns, one sum per 2048 columns in order
// along a row (9 at M = 17,770), then runs of 64 rows and a tree over 1024
// threads in mf_loss.  Two calls on the same inputs are bit-equal.
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int WARPS = 8;                 // owners (rows or columns) a CTA
constexpr int THREADS = 32 * WARPS;
constexpr int BATCH = 8;                 // entries whose residuals one tree
                                         // reduces
constexpr int WORDS = 32;                // bit words a warp reads at once
constexpr int LOSS_RUN = 64;             // loss terms summed in runs of 64
constexpr int FIN_THREADS = 1024;
constexpr int MAX_K = 256;
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int words_of(int n) { return (n + 63) / 64; }

// bit n of the result: byte n of x is not 0
__device__ __forceinline__ unsigned nz4(unsigned x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned nz16(uint4 v) {
  return nz4(v.x) | (nz4(v.y) << 4) | (nz4(v.z) << 8) | (nz4(v.w) << 12);
}

// A 32 x 32 bit matrix, row r in lane r (bit c: column c), transposed:
// lane c ends with column c (bit r: row r).  Five rounds swap the
// off-diagonal halves of ever smaller blocks with the lane j apart.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const unsigned m = 0xFFFFFFFFu / ((1u << j) + 1u);   // 0x0000FFFF, ...
    const unsigned y = __shfl_xor_sync(FULL, x, j);
    x = (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y << j) & ~m);
  }
  return x;
}

// The mask as bits, read once for both passes: rowbits[r][t] holds
// mask[r][64 t .. 64 t + 63] (bit c: column 64 t + c) and colbits[c][h]
// holds mask[64 h .. 64 h + 63][c] (bit r: row 64 h + r).  A CTA takes
// rows [R0, R0 + 256) x columns [C0, C0 + 512).  A warp reads a row's 512
// bytes as the 16-byte aligned chunks that cover them, one a lane (a row
// starts at any byte); lane t < 8 assembles word t from the bits of chunks
// 4 t .. 4 t + 4, shifted by the row's offset in its first chunk.  Then
// each 64 x 64 block of row words is transposed as four 32 x 32 bit
// matrices across the lanes; both kinds of word go out through shared
// memory, a row's (a column's) words contiguous.
__global__ void __launch_bounds__(256)
mf_pack(const unsigned char* __restrict__ mask, u64* __restrict__ rowbits,
        u64* __restrict__ colbits, int N, int M) {
  constexpr int PR = 256, PC = 512;
  __shared__ u64 rw[PR][PC / 64 + 1];   // [row][word]
  __shared__ u64 cw[PC][PR / 64 + 1];   // [column][row band]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int R0 = blockIdx.y * PR, C0 = blockIdx.x * PC;
  const int wv = min(PC, M - C0);       // this CTA's columns
#pragma unroll 4
  for (int i = w; i < PR; i += WARPS) {
    u64 word = 0;
    if (R0 + i < N) {
      const uintptr_t start =
          (uintptr_t)(mask + (long long)(R0 + i) * M + C0);
      const int off = (int)(start & 15);
      const uint4* base = reinterpret_cast<const uint4*>(start - off);
      const int nch = (off + wv + 15) >> 4;   // 33 at most
      const uint4 zero = make_uint4(0, 0, 0, 0);
      const unsigned bits = nz16(lane < nch ? __ldcs(base + lane) : zero);
      const unsigned extra =
          nz16(lane == 0 && nch > 32 ? __ldcs(base + 32) : zero);
      const int t = lane & 7;
      const u64 c0 = __shfl_sync(FULL, bits, 4 * t);
      const u64 c1 = __shfl_sync(FULL, bits, 4 * t + 1);
      const u64 c2 = __shfl_sync(FULL, bits, 4 * t + 2);
      const u64 c3 = __shfl_sync(FULL, bits, 4 * t + 3);
      // chunk 32 is lane 0's extra; chunks 4 .. 28 their lanes' own
      const u64 c4 =
          __shfl_sync(FULL, lane == 0 ? extra : bits, (4 * t + 4) & 31);
      const u64 lo = c0 | (c1 << 16) | (c2 << 32) | (c3 << 48);
      word = (lo >> off) | (off ? c4 << (64 - off) : 0ull);
      const int valid = wv - 64 * t;     // columns of word t in range
      if (valid <= 0)
        word = 0;
      else if (valid < 64)
        word &= (1ull << valid) - 1;
    }
    if (lane < PC / 64) rw[i][lane] = word;
  }
  __syncthreads();
  for (int blk = w; blk < (PR / 64) * (PC / 64); blk += WARPS) {
    const int hb = blk / (PC / 64), t = blk % (PC / 64);
    // the block's four 32 x 32 quarters, each transposed
    const u64 x0 = rw[64 * hb + lane][t], x1 = rw[64 * hb + 32 + lane][t];
    const unsigned t00 = transpose32((unsigned)x0, lane);
    const unsigned t01 = transpose32((unsigned)(x0 >> 32), lane);
    const unsigned t10 = transpose32((unsigned)x1, lane);
    const unsigned t11 = transpose32((unsigned)(x1 >> 32), lane);
    cw[64 * t + lane][hb] = t00 | ((u64)t10 << 32);        // column lane
    cw[64 * t + 32 + lane][hb] = t01 | ((u64)t11 << 32);   // lane + 32
  }
  __syncthreads();
  const int W = words_of(M), H = words_of(N);
  for (int idx = threadIdx.x; idx < PR * (PC / 64); idx += 256) {
    const int i = idx / (PC / 64), q = idx % (PC / 64);
    const int t = C0 / 64 + q;
    if (R0 + i < N && t < W) rowbits[(long long)(R0 + i) * W + t] = rw[i][q];
  }
  for (int idx = threadIdx.x; idx < PC * (PR / 64); idx += 256) {
    const int c = idx / (PR / 64), q = idx % (PR / 64);
    const int h = R0 / 64 + q;
    if (C0 + c < M && h < H) colbits[(long long)(C0 + c) * H + h] = cw[c][q];
  }
}

// dst [cols][rows] = src [rows][cols]^T, in 32 x 32 tiles through shared
// memory (R^T from R before the passes, dR from dR^T after them).
__global__ void __launch_bounds__(256)
mf_transpose(const float* __restrict__ src, float* __restrict__ dst,
             int rows, int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8)
    if (r0 + r < rows && c0 + tx < cols)
      tile[r][tx] = src[(long long)(r0 + r) * cols + c0 + tx];
  __syncthreads();
  for (int r = ty; r < 32; r += 8)
    if (c0 + r < cols && r0 + tx < rows)
      dst[(long long)(c0 + r) * rows + r0 + tx] = tile[tx][r];
}

// One pass: warp w of CTA x owns index o = WARPS x + w of the owned
// factor O [n_own][K] and walks its words bits[o][0 .. words_of(n_stream)),
// in the order of the stream index x.  Each observed entry (o, x), with
// its rating at D[dof + x dx] (ROWS: o M + x, COLS: x M + o), takes the
// streamed vector S[x][:] from L2 (S [n_stream][K]).  Eight entries at a
// time: each lane forms its k-slice of the eight dot products, one tree
// of shuffles reduces all eight (lanes 4 g .. 4 g + 3 end with entry g's),
// e = D - dot, and the owner's sum takes e S[x][:] in entry order.  At the
// end out[o][k] = gamma (sum - (lam count) O[o][k]) with the reference's
// roundings, the count to cnt[o] and (ROWS) the row's sum of e^2 to
// lossp[o]: eight squares a tree, their sums added in order within each
// 2048 stream indices, and those sums added in order.
template <int KJ, bool ROWS>
__device__ __forceinline__ void mf_pass(
    const float* __restrict__ O, const float* __restrict__ S,
    const float* __restrict__ D, const u64* __restrict__ bits,
    float* __restrict__ out, int* __restrict__ cnt_out,
    float* __restrict__ lossp, int n_own, int n_stream, int M, int K,
    float gamma, float lam) {
  __shared__ int lst[WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int o = blockIdx.x * WARPS + w;
  if (o >= n_own) return;
  int* ls = lst[w];
  const bool last_ok = lane + 32 * (KJ - 1) < K;
  float a[KJ], acc[KJ];
#pragma unroll
  for (int q = 0; q < KJ; ++q) {
    a[q] = (q < KJ - 1 || last_ok) ? O[(long long)o * K + lane + 32 * q]
                                   : 0.f;
    acc[q] = 0.f;
  }
  const int nw = words_of(n_stream);
  const long long dof = ROWS ? (long long)o * M : o;
  const long long dx = ROWS ? 1 : M;
  // the lanes of group g = lane / 4 end the tree with entry g's sum; the
  // tree's three halving steps split on lane bits 4, 3, 2
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  int cnt = 0;
  float lrow = 0.f;   // e^2 of the row: one term per 2048 stream indices
  for (int wb = 0; wb < nw; wb += WORDS) {
    const int t = wb + lane;
    const u64 word = t < nw ? __ldcs(bits + (long long)o * nw + t) : 0ull;
    const int c = __popcll(word);
    int incl = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    cnt += total;
    float lsum = 0.f;   // e^2 of these 2048 stream indices
    for (int r0 = 0; r0 < total; r0 += 32) {
      // the stream indices of entries r0 .. r0 + 31, in order, to ls
      if (incl > r0 && incl - c < r0 + 32) {
        int r = incl - c;
        for (u64 rest = word; rest; rest &= rest - 1, ++r)
          if (r >= r0 && r < r0 + 32) ls[r - r0] = 64 * t + __ffsll(rest) - 1;
      }
      __syncwarp();
      const int nr = min(32, total - r0);
      const int x = ls[lane < nr ? lane : 0];
      const float dv = lane < nr ? __ldcs(D + dof + x * dx) : 0.f;
      __syncwarp();
      for (int b = 0; b < nr; b += BATCH) {
        float s[BATCH][KJ], p[BATCH];
#pragma unroll
        for (int e = 0; e < BATCH; ++e) {
          const int xe = __shfl_sync(FULL, x, b + e < nr ? b + e : 0);
          const float* sv = S + (long long)xe * K + lane;
          p[e] = 0.f;
#pragma unroll
          for (int q = 0; q < KJ; ++q) {
            s[e][q] = (q < KJ - 1 || last_ok) ? __ldg(sv + 32 * q) : 0.f;
            p[e] = __fmaf_rn(a[q], s[e][q], p[e]);
          }
        }
        // the eight sums in one tree: halve the set of sums a lane holds
        // three times across lanes 16, 8, 4 apart, then sum the last
        // across lanes 2 and 1 apart
        float u4[4], u2[2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          u4[i] = __fadd_rn(h4 ? p[4 + i] : p[i],
                            __shfl_xor_sync(FULL, h4 ? p[i] : p[4 + i], 16));
#pragma unroll
        for (int i = 0; i < 2; ++i)
          u2[i] = __fadd_rn(h3 ? u4[2 + i] : u4[i],
                            __shfl_xor_sync(FULL, h3 ? u4[i] : u4[2 + i], 8));
        float v = __fadd_rn(h2 ? u2[1] : u2[0],
                            __shfl_xor_sync(FULL, h2 ? u2[0] : u2[1], 4));
        v = __fadd_rn(v, __shfl_xor_sync(FULL, v, 2));
        v = __fadd_rn(v, __shfl_xor_sync(FULL, v, 1));
        const int g = b + (lane >> 2);
        const float dg = __shfl_sync(FULL, dv, g < nr ? g : 0);
        const float ev = g < nr ? __fsub_rn(dg, v) : 0.f;
        if (ROWS) {
          // the eight squares: a fixed tree over the groups
          float q2 = (lane & 3) == 0 ? __fmul_rn(ev, ev) : 0.f;
          q2 = __fadd_rn(q2, __shfl_xor_sync(FULL, q2, 4));
          q2 = __fadd_rn(q2, __shfl_xor_sync(FULL, q2, 8));
          q2 = __fadd_rn(q2, __shfl_xor_sync(FULL, q2, 16));
          lsum = __fadd_rn(lsum, q2);
        }
#pragma unroll
        for (int e = 0; e < BATCH; ++e) {
          const float ee = __shfl_sync(FULL, ev, 4 * e);
          if (b + e < nr) {
#pragma unroll
            for (int q = 0; q < KJ; ++q)
              acc[q] = __fmaf_rn(ee, s[e][q], acc[q]);
          }
        }
      }
    }
    lrow = __fadd_rn(lrow, lsum);
  }
  if (ROWS && lane == 0) lossp[o] = lrow;
  const float lc = __fmul_rn(lam, (float)cnt);
#pragma unroll
  for (int q = 0; q < KJ; ++q)
    if (q < KJ - 1 || last_ok)
      out[(long long)o * K + lane + 32 * q] =
          __fmul_rn(gamma, __fsub_rn(acc[q], __fmul_rn(lc, a[q])));
  if (lane == 0) cnt_out[o] = cnt;
}

// pass ROWS: dL from L, R^T and the row words
template <int KJ>
__global__ void __launch_bounds__(THREADS, KJ <= 4 ? 3 : 2)
mf_rows(const float* __restrict__ L, const float* __restrict__ Rt,
        const float* __restrict__ D, const u64* __restrict__ rowbits,
        float* __restrict__ dL, int* __restrict__ cnt,
        float* __restrict__ lossp, int N, int M, int K, float gamma,
        float lam) {
  mf_pass<KJ, true>(L, Rt, D, rowbits, dL, cnt, lossp, N, M, M, K, gamma,
                    lam);
}

// pass COLS: dR^T from R^T, L and the column words
template <int KJ>
__global__ void __launch_bounds__(THREADS, KJ <= 4 ? 3 : 2)
mf_cols(const float* __restrict__ L, const float* __restrict__ Rt,
        const float* __restrict__ D, const u64* __restrict__ colbits,
        float* __restrict__ dRt, int* __restrict__ cnt, int N, int M, int K,
        float gamma, float lam) {
  mf_pass<KJ, false>(Rt, L, D, colbits, dRt, cnt, nullptr, M, N, M, K,
                     gamma, lam);
}

// The loss: the terms in runs of LOSS_RUN a thread (each run summed in
// order, the runs added in order), then a tree over the threads; the count
// of observed entries summed as integers; the IEEE quotient.
__global__ void __launch_bounds__(FIN_THREADS)
mf_loss(const float* __restrict__ lossp, int n_lossp,
        const int* __restrict__ cnt_r, int N, float* __restrict__ loss) {
  __shared__ float fs[FIN_THREADS];
  __shared__ long long cs[FIN_THREADS];
  const int tid = threadIdx.x;
  float v = 0.f;
  for (int base = tid; base < n_lossp; base += LOSS_RUN * FIN_THREADS) {
    float run = 0.f;
    for (int q = 0; q < LOSS_RUN; ++q) {
      const int i = base + q * FIN_THREADS;
      if (i >= n_lossp) break;
      run = __fadd_rn(run, lossp[i]);
    }
    v = __fadd_rn(v, run);
  }
  long long c = 0;
  for (int i = tid; i < N; i += FIN_THREADS) c += cnt_r[i];
  fs[tid] = v;
  cs[tid] = c;
  __syncthreads();
  for (int half = FIN_THREADS / 2; half > 0; half >>= 1) {
    if (tid < half) {
      fs[tid] = __fadd_rn(fs[tid], fs[tid + half]);
      cs[tid] += cs[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) *loss = __fdiv_rn(fs[0], (float)(cs[0] > 1 ? cs[0] : 1));
}

struct Args {
  const float *L, *R, *D;
  const unsigned char* mask;
  float* rt;
  u64 *rowbits, *colbits;
  float *drt, *lossp;
  int *cnt_r, *cnt_c;
  float *dL, *dR, *loss;
  int N, M, K;
  float gamma, lam;
  cudaStream_t stream;
};


template <int KJ>
int run(const Args& a) {
  const int N = a.N, M = a.M, K = a.K;
  mf_pack<<<dim3((M + 511) / 512, (N + 255) / 256), 256, 0, a.stream>>>(
      a.mask, a.rowbits, a.colbits, N, M);
  mf_transpose<<<dim3((M + 31) / 32, (K + 31) / 32), 256, 0, a.stream>>>(
      a.R, a.rt, K, M);
  mf_rows<KJ><<<(N + WARPS - 1) / WARPS, THREADS, 0, a.stream>>>(
      a.L, a.rt, a.D, a.rowbits, a.dL, a.cnt_r, a.lossp, N, M, K, a.gamma,
      a.lam);
  mf_cols<KJ><<<(M + WARPS - 1) / WARPS, THREADS, 0, a.stream>>>(
      a.L, a.rt, a.D, a.colbits, a.drt, a.cnt_c, N, M, K, a.gamma, a.lam);
  mf_transpose<<<dim3((K + 31) / 32, (M + 31) / 32), 256, 0, a.stream>>>(
      a.drt, a.dR, M, K);
  mf_loss<<<1, FIN_THREADS, 0, a.stream>>>(a.lossp, N, a.cnt_r, N,
                                           a.loss);
  return (int)cudaGetLastError();
}

int run_for(const Args& a) {
  switch ((a.K + 31) / 32) {
    case 1: return run<1>(a);
    case 2: return run<2>(a);
    case 3: return run<3>(a);
    case 4: return run<4>(a);
    case 5: return run<5>(a);
    case 6: return run<6>(a);
    case 7: return run<7>(a);
    default: return run<8>(a);
  }
}

bool valid(int N, int M, int K) {
  return N >= 1 && M >= 1 && K >= 1 && K <= MAX_K;
}

}  // namespace

extern "C" {

// Scratch (from the wrapper): rt and drt [M, K], rowbits
// [N, ceil(M / 64)] and colbits [M, ceil(N / 64)] (64-bit words), lossp
// [N], cnt_r [N], cnt_c [M].  Outputs dL [N, K], dR [K, M], loss [1].
int mf_sgd_block(const float* L, const float* R, const float* D,
                 const unsigned char* mask, float* rt, u64* rowbits,
                 u64* colbits, float* drt, float* lossp, int* cnt_r,
                 int* cnt_c, float* dL, float* dR, float* loss, int N, int M,
                 int K, float gamma, float lam, cudaStream_t stream) {
  if (!valid(N, M, K)) return (int)cudaErrorInvalidValue;
  Args a{L, R, D, mask, rt, rowbits, colbits, drt, lossp, cnt_r, cnt_c,
         dL, dR, loss, N, M, K, gamma, lam, stream};
  return run_for(a);
}

const char* mf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
