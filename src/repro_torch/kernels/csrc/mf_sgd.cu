// Hopper (sm_90a) kernel for the MF-SGD dense-block update.
//
// Replaces the TPU kernel repro/kernels/mf_sgd.py::mf_sgd_block (its two
// pallas_calls, _dl_kernel and _dr_kernel).  On L[N,K], R[K,M], ratings
// D[N,M] (float32, row-major) observed where mask[N,M] (bool) is set:
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
// Bound.  As a dense-block product the work is 6 K N M float32 operations
// (one product for the residual, then E R^T and L^T E) against 4 N M + N M
// bytes of D and mask: bound by operations (5.2 ms on the H100 SXM's
// 67 TFLOP/s at the paper's Netflix shape, K = 100, N = 32,768,
// M = 17,770).  Only the observed entries carry work, so at the Netflix
// density (0.0118) what the data needs is the mask, the observed ratings
// and the factors: bound by bytes.  This first design computes the dense
// products; skipping unobserved tiles or entries is later work.
//
// Design.  The TPU ran two passes over transposed grids only because a
// TPU output tile may accumulate only across consecutive grid steps.
// Here each of the two passes owns its output outright, so the sums need
// no atomics and are deterministic:
//   - pass ROWS: a CTA owns a block of B rows of L (kept in shared memory)
//     and walks a range of B-column tiles: S = L_i R_j on the CUDA cores
//     (full float32 FMAs, no TF32, no library GEMM), E selected by the
//     mask, then dL_i += E R_j^T in registers; it also counts its rows'
//     observed entries and sums E^2;
//   - pass COLS: a CTA owns a block of B columns of R and walks a range of
//     row tiles: the same S and E, then dR_j += L_i^T E, and the column
//     counts;
//   - when a pass has too few owned blocks to fill the card, the walk is
//     split over gridDim.y CTAs whose partial sums go to scratch, and
//   - mf_finalize adds the partials in split order, applies
//     gamma (X - (lam count) L) with the reference's roundings, and sums
//     the loss partials in a fixed order.
// E is recomputed in the second pass (8 K N M operations instead of 6): it
// is never written to memory, and each pass reads D and the mask once.
// Each thread holds a TI x TI tile of S (rows ty*4 + 64h + u, columns
// tx + 16j: coalesced loads of D and the mask, float4 shared loads of L)
// and a KT x TI tile of its pass's output (k = ty + 16t, owned rows or
// columns tx*4 + 64h + u, read as float4 from E in shared memory).
// K is padded to KP = 16 KT with zeros; ragged N and M are masked in the
// kernel (no entry past N or M is read or counted).  Every load of D,
// mask, L and R is a scalar load, so rows of any length and alignment work
// (at M = 17,770 every other row of D starts 8 bytes off a 16-byte line).
// Limit: 1 <= K <= 256 (K <= 128 takes 128-wide tiles, above that 64).
//
// Rounding: the products and sums are fmaf chains; the epilogue rounds
// lam * (float)count, its product with L, the difference and the product
// with gamma each once (__fmul_rn / __fsub_rn, never contracted), as the
// reference does; the loss is the IEEE quotient __fdiv_rn by
// (float)max(count, 1).  Two calls on the same inputs are bit-equal: the
// split of each pass is a function of the shape and the device only.
//
// The entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: tx = tid % 16, ty = tid / 16
constexpr int MODE_ROWS = 0, MODE_COLS = 1;
constexpr int MAX_K = 256;
constexpr int MAX_SPLIT = 32;

template <int TI, int KT>
struct Tile {
  static constexpr int B = 16 * TI;   // rows and columns of a tile
  static constexpr int P = B + 4;     // shared row stride (float4-aligned)
  static constexpr int KP = 16 * KT;  // K padded with zeros
  static constexpr int FLOATS = 2 * KP * P + B * P;
  static constexpr size_t SMEM = (size_t)FLOATS * 4 + B * 4 + 32 * 4;
};

// Lt[k][r] = L[row0 + r][k]: a warp covers 8 k by 4 rows, so it reads
// four 32-byte runs of L and stores to 32 distinct banks.
template <int TI, int KT>
__device__ __forceinline__ void load_L(float* Lt, const float* __restrict__ L,
                                       int N, int K, int row0) {
  using T = Tile<TI, KT>;
  constexpr int KC = T::KP / 8;
  for (int idx = threadIdx.x; idx < T::KP * T::B; idx += THREADS) {
    const int w = idx >> 5, l = idx & 31;
    const int k = (w % KC) * 8 + (l & 7);
    const int r = (w / KC) * 4 + (l >> 3);
    const int row = row0 + r;
    Lt[k * T::P + r] =
        (row < N && k < K) ? __ldg(L + (long long)row * K + k) : 0.f;
  }
}

// Rs[k][c] = R[k][col0 + c].
template <int TI, int KT>
__device__ __forceinline__ void load_R(float* Rs, const float* __restrict__ R,
                                       int M, int K, int col0) {
  using T = Tile<TI, KT>;
  for (int idx = threadIdx.x; idx < T::KP * T::B; idx += THREADS) {
    const int k = idx / T::B, c = idx % T::B;
    const int col = col0 + c;
    Rs[k * T::P + c] =
        (k < K && col < M) ? __ldg(R + (long long)k * M + col) : 0.f;
  }
}

// One pass.  MODE_ROWS: blockIdx.x owns rows [B x, B x + B), and split
// blockIdx.y walks its share of the column tiles, writing the partial dL
// sum to part[y][N][K], the row counts to cnt[y][N] and the sum of E^2 to
// lossp[y * gridDim.x + x].  MODE_COLS: blockIdx.x owns columns, the split
// walks row tiles, part[y][K][M] and cnt[y][M]; no loss.
template <int MODE, int TI, int KT>
__global__ void __launch_bounds__(THREADS, 1)
mf_pass(const float* __restrict__ L, const float* __restrict__ R,
        const float* __restrict__ D, const unsigned char* __restrict__ mask,
        float* __restrict__ part, int* __restrict__ cnt,
        float* __restrict__ lossp, int N, int M, int K) {
  using T = Tile<TI, KT>;
  constexpr int B = T::B, P = T::P, TH = TI / 4;
  extern __shared__ __align__(16) float smem[];
  float* Lt = smem;                      // [KP][P]  L rows, k-major
  float* Rs = smem + T::KP * P;          // [KP][P]  R columns, k-major
  float* Eb = smem + 2 * T::KP * P;      // [B][P]   E, streamed-index-major
  int* cnt_s = reinterpret_cast<int*>(smem + T::FLOATS);   // [B]
  float* red = smem + T::FLOATS + B;                        // [32]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int own0 = blockIdx.x * B;
  const int n_stream = MODE == MODE_ROWS ? M : N;
  const int n_tiles = (n_stream + B - 1) / B;
  const int t_begin = (int)((long long)blockIdx.y * n_tiles / gridDim.y);
  const int t_end = (int)((long long)(blockIdx.y + 1) * n_tiles / gridDim.y);

  for (int i = tid; i < B; i += THREADS) cnt_s[i] = 0;
  if (MODE == MODE_ROWS)
    load_L<TI, KT>(Lt, L, N, K, own0);
  else
    load_R<TI, KT>(Rs, R, M, K, own0);
  __syncthreads();

  float acc[KT][TI];             // [t][h*4 + u]: k = ty + 16t, own tx*4+64h+u
#pragma unroll
  for (int t = 0; t < KT; ++t)
#pragma unroll
    for (int q = 0; q < TI; ++q) acc[t][q] = 0.f;
  int c_own[TI];                 // observed entries per S row (ROWS) / col
#pragma unroll
  for (int q = 0; q < TI; ++q) c_own[q] = 0;
  float lsum = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int s0 = tile * B;
    const int row0 = MODE == MODE_ROWS ? own0 : s0;
    const int col0 = MODE == MODE_ROWS ? s0 : own0;
    if (MODE == MODE_ROWS)
      load_R<TI, KT>(Rs, R, M, K, col0);
    else
      load_L<TI, KT>(Lt, L, N, K, row0);
    __syncthreads();

    // S[h*4+u][j] = (L R)[row0 + ty*4 + 64h + u][col0 + tx + 16j]
    float s[TI][TI];
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      float a[TI], b[TI];
#pragma unroll
      for (int h = 0; h < TH; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(Lt + k * P + ty * 4 + 64 * h);
        a[4 * h] = v.x; a[4 * h + 1] = v.y; a[4 * h + 2] = v.z;
        a[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TI; ++j) b[j] = Rs[k * P + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TI; ++i)
#pragma unroll
        for (int j = 0; j < TI; ++j) s[i][j] = __fmaf_rn(a[i], b[j], s[i][j]);
    }

    // E, selected by the mask; the counts and the loss; E to shared memory
    // (ROWS: Eb[c][r], COLS: Eb[r][c], c and r tile-local)
    float tsum = 0.f;
#pragma unroll
    for (int h = 0; h < TH; ++h) {
#pragma unroll
      for (int j = 0; j < TI; ++j) {
        const int c = tx + 16 * j, col = col0 + c;
        float e4[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = ty * 4 + 64 * h + u, row = row0 + r;
          const long long at = (long long)row * M + col;
          const bool m = row < N && col < M && mask[at] != 0;
          const float e = m ? __fsub_rn(__ldg(D + at), s[4 * h + u][j]) : 0.f;
          e4[u] = e;
          tsum = __fmaf_rn(e, e, tsum);
          if (MODE == MODE_ROWS)
            c_own[4 * h + u] += m;
          else
            c_own[j] += m;
          if (MODE == MODE_COLS) Eb[r * P + c] = e;
        }
        if (MODE == MODE_ROWS)
          *reinterpret_cast<float4*>(Eb + c * P + ty * 4 + 64 * h) =
              make_float4(e4[0], e4[1], e4[2], e4[3]);
      }
    }
    lsum += tsum;
    __syncthreads();

    // ROWS: dL[own][k] += sum_c R[k][c] E[own][c]  (Tb = Rs)
    // COLS: dR[k][own] += sum_r L[r][k] E[r][own]  (Tb = Lt)
    const float* Tb = MODE == MODE_ROWS ? Rs : Lt;
    const int xn = min(B, n_stream - s0);
#pragma unroll 2
    for (int x = 0; x < xn; ++x) {
      float ev[TI], tv[KT];
#pragma unroll
      for (int h = 0; h < TH; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(Eb + x * P + tx * 4 + 64 * h);
        ev[4 * h] = v.x; ev[4 * h + 1] = v.y; ev[4 * h + 2] = v.z;
        ev[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int t = 0; t < KT; ++t) tv[t] = Tb[(ty + 16 * t) * P + x];
#pragma unroll
      for (int t = 0; t < KT; ++t)
#pragma unroll
        for (int q = 0; q < TI; ++q)
          acc[t][q] = __fmaf_rn(tv[t], ev[q], acc[t][q]);
    }
    __syncthreads();
  }

  // partial sums of this split
  const int n_own = MODE == MODE_ROWS ? N : M;
  const int split = blockIdx.y;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int k = ty + 16 * t;
    if (k >= K) continue;
#pragma unroll
    for (int q = 0; q < TI; ++q) {
      const int o = own0 + tx * 4 + 64 * (q >> 2) + (q & 3);
      if (o >= n_own) continue;
      if (MODE == MODE_ROWS)
        part[((long long)split * N + o) * K + k] = acc[t][q];
      else
        part[((long long)split * K + k) * M + o] = acc[t][q];
    }
  }
  // counts: integer sums, so their order does not matter
#pragma unroll
  for (int q = 0; q < TI; ++q) {
    const int o = MODE == MODE_ROWS ? ty * 4 + 64 * (q >> 2) + (q & 3)
                                    : tx + 16 * q;
    atomicAdd(cnt_s + o, c_own[q]);
  }
  __syncthreads();
  for (int i = tid; i < B; i += THREADS)
    if (own0 + i < n_own) cnt[(long long)split * n_own + own0 + i] = cnt_s[i];
  if (MODE == MODE_ROWS) {
    // the CTA's sum of E^2: a fixed butterfly in each warp, then the warps
    // in order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if ((tid & 31) == 0) red[tid >> 5] = lsum;
    __syncthreads();
    if (tid == 0) {
      float v = red[0];
      for (int w = 1; w < THREADS / 32; ++w) v += red[w];
      lossp[(long long)split * gridDim.x + blockIdx.x] = v;
    }
  }
}

// Blocks [0, nb_dl) write dL, [nb_dl, nb_dl + nb_dr) write dR, and the last
// block the loss.
__global__ void __launch_bounds__(THREADS)
mf_finalize(const float* __restrict__ L, const float* __restrict__ R,
            const float* __restrict__ part_l, const float* __restrict__ part_r,
            const int* __restrict__ cnt_r, const int* __restrict__ cnt_c,
            const float* __restrict__ lossp, int n_lossp, float* __restrict__ dL,
            float* __restrict__ dR, float* __restrict__ loss, int N, int M,
            int K, int split_r, int split_c, float gamma, float lam,
            int nb_dl, int nb_dr) {
  const int b = blockIdx.x, tid = threadIdx.x;
  if (b < nb_dl) {
    const long long n = (long long)N * K;
    for (long long i = (long long)b * THREADS + tid; i < n;
         i += (long long)nb_dl * THREADS) {
      const int row = (int)(i / K);
      float x = part_l[i];
      int c = cnt_r[row];
      for (int s = 1; s < split_r; ++s) {
        x = __fadd_rn(x, part_l[(long long)s * n + i]);
        c += cnt_r[(long long)s * N + row];
      }
      const float y = __fmul_rn(__fmul_rn(lam, (float)c), L[i]);
      dL[i] = __fmul_rn(gamma, __fsub_rn(x, y));
    }
  } else if (b < nb_dl + nb_dr) {
    const long long n = (long long)K * M;
    for (long long i = (long long)(b - nb_dl) * THREADS + tid; i < n;
         i += (long long)nb_dr * THREADS) {
      const int col = (int)(i % M);
      float x = part_r[i];
      int c = cnt_c[col];
      for (int s = 1; s < split_c; ++s) {
        x = __fadd_rn(x, part_r[(long long)s * n + i]);
        c += cnt_c[(long long)s * M + col];
      }
      const float y = __fmul_rn(__fmul_rn(lam, (float)c), R[i]);
      dR[i] = __fmul_rn(gamma, __fsub_rn(x, y));
    }
  } else {
    __shared__ float fs[THREADS];
    __shared__ long long cs[THREADS];
    float v = 0.f;
    for (int i = tid; i < n_lossp; i += THREADS) v += lossp[i];
    long long c = 0;
    const long long nc = (long long)split_r * N;
    for (long long i = tid; i < nc; i += THREADS) c += cnt_r[i];
    fs[tid] = v;
    cs[tid] = c;
    __syncthreads();
    for (int half = THREADS / 2; half > 0; half >>= 1) {
      if (tid < half) {
        fs[tid] += fs[tid + half];
        cs[tid] += cs[tid + half];
      }
      __syncthreads();
    }
    if (tid == 0)
      *loss = __fdiv_rn(fs[0], (float)(cs[0] > 1 ? cs[0] : 1));
  }
}

// The split s of a pass with `blocks` owned blocks over `tiles` streamed
// tiles, on `slots` resident CTAs: the one that makes ceil(blocks s /
// slots) / s, the time of the waves for one split's share of work, least,
// with s <= tiles; a larger s must gain 5 % over the best so far,
// since each split adds a partial sum to scratch.
int choose_split(int blocks, int tiles, int slots) {
  int best = 1;
  double best_cost = (double)((blocks + slots - 1) / slots);
  const int top = tiles < MAX_SPLIT ? tiles : MAX_SPLIT;
  for (int s = 2; s <= top; ++s) {
    const long long ctas = (long long)blocks * s;
    const double cost = (double)((ctas + slots - 1) / slots) / s;
    if (cost < 0.95 * best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// Blocks of mf_finalize for n outputs: four a thread, at most 2048.
int finalize_blocks(long long n) {
  const long long b = (n + THREADS * 4 - 1) / (THREADS * 4);
  return (int)(b < 2048 ? b : 2048);
}

struct Args {
  const float *L, *R, *D;
  const unsigned char* mask;
  float *part_l, *part_r, *lossp, *dL, *dR, *loss;
  int *cnt_r, *cnt_c;
  int N, M, K, split_r, split_c;
  float gamma, lam;
  cudaStream_t stream;
};

// plan[0..3]: split of the ROWS pass, split of the COLS pass, tile width B,
// loss partials (ROWS blocks x its split).
template <int TI, int KT>
int plan(int N, int M, int K, int* out) {
  using T = Tile<TI, KT>;
  int dev = 0, sms = 0, occ_r = 0, occ_c = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto kr = mf_pass<MODE_ROWS, TI, KT>;
  auto kc = mf_pass<MODE_COLS, TI, KT>;
  cudaFuncSetAttribute(kr, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)T::SMEM);
  cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)T::SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_r, kr, THREADS, T::SMEM);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_c, kc, THREADS, T::SMEM);
  const int bn = (N + T::B - 1) / T::B, bm = (M + T::B - 1) / T::B;
  const int sr = choose_split(bn, bm, (occ_r > 0 ? occ_r : 1) * sms);
  const int sc = choose_split(bm, bn, (occ_c > 0 ? occ_c : 1) * sms);
  out[0] = sr;
  out[1] = sc;
  out[2] = T::B;
  out[3] = bn * sr;
  return (int)cudaGetLastError();
}

template <int TI, int KT>
int run(const Args& a) {
  using T = Tile<TI, KT>;
  auto kr = mf_pass<MODE_ROWS, TI, KT>;
  auto kc = mf_pass<MODE_COLS, TI, KT>;
  cudaFuncSetAttribute(kr, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)T::SMEM);
  cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)T::SMEM);
  const int bn = (a.N + T::B - 1) / T::B, bm = (a.M + T::B - 1) / T::B;
  mf_pass<MODE_ROWS, TI, KT><<<dim3(bn, a.split_r), THREADS, T::SMEM,
                               a.stream>>>(
      a.L, a.R, a.D, a.mask, a.part_l, a.cnt_r, a.lossp, a.N, a.M, a.K);
  mf_pass<MODE_COLS, TI, KT><<<dim3(bm, a.split_c), THREADS, T::SMEM,
                               a.stream>>>(
      a.L, a.R, a.D, a.mask, a.part_r, a.cnt_c, nullptr, a.N, a.M, a.K);
  const int nb_dl = finalize_blocks((long long)a.N * a.K);
  const int nb_dr = finalize_blocks((long long)a.K * a.M);
  mf_finalize<<<nb_dl + nb_dr + 1, THREADS, 0, a.stream>>>(
      a.L, a.R, a.part_l, a.part_r, a.cnt_r, a.cnt_c, a.lossp,
      bn * a.split_r, a.dL, a.dR, a.loss, a.N, a.M, a.K, a.split_r,
      a.split_c, a.gamma, a.lam, nb_dl, nb_dr);
  return (int)cudaGetLastError();
}

// The tile plan for K: 128-wide tiles and KT = ceil(K / 16) up to K = 128;
// 64-wide tiles with K padded to 192 or 256 above.
int plan_for(int N, int M, int K, int* out) {
  switch ((K + 15) / 16) {
    case 1: return plan<8, 1>(N, M, K, out);
    case 2: return plan<8, 2>(N, M, K, out);
    case 3: return plan<8, 3>(N, M, K, out);
    case 4: return plan<8, 4>(N, M, K, out);
    case 5: return plan<8, 5>(N, M, K, out);
    case 6: return plan<8, 6>(N, M, K, out);
    case 7: return plan<8, 7>(N, M, K, out);
    case 8: return plan<8, 8>(N, M, K, out);
    case 9: case 10: case 11: case 12: return plan<4, 12>(N, M, K, out);
    default: return plan<4, 16>(N, M, K, out);
  }
}

int run_for(const Args& a) {
  switch ((a.K + 15) / 16) {
    case 1: return run<8, 1>(a);
    case 2: return run<8, 2>(a);
    case 3: return run<8, 3>(a);
    case 4: return run<8, 4>(a);
    case 5: return run<8, 5>(a);
    case 6: return run<8, 6>(a);
    case 7: return run<8, 7>(a);
    case 8: return run<8, 8>(a);
    case 9: case 10: case 11: case 12: return run<4, 12>(a);
    default: return run<4, 16>(a);
  }
}

bool valid(int N, int M, int K) {
  return N >= 1 && M >= 1 && K >= 1 && K <= MAX_K;
}

}  // namespace

extern "C" {

// plan[4]: the split of each pass, the tile width and the number of loss
// partials for an [N, K] x [K, M] block on the current device; the
// wrapper sizes the scratch from it.
int mf_plan(int N, int M, int K, int* plan_out) {
  if (!valid(N, M, K)) return (int)cudaErrorInvalidValue;
  return plan_for(N, M, K, plan_out);
}

// Scratch (from the wrapper, sized by mf_plan): part_l [split_r, N, K],
// cnt_r [split_r, N], lossp [plan[3]], part_r [split_c, K, M],
// cnt_c [split_c, M].  Outputs dL [N, K], dR [K, M], loss [1].
int mf_sgd_block(const float* L, const float* R, const float* D,
                 const unsigned char* mask, float* part_l, int* cnt_r,
                 float* lossp, float* part_r, int* cnt_c, float* dL, float* dR,
                 float* loss, int N, int M, int K, int split_r, int split_c,
                 float gamma, float lam, cudaStream_t stream) {
  if (!valid(N, M, K) || split_r < 1 || split_c < 1 ||
      split_r > MAX_SPLIT || split_c > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  Args a{L, R, D, mask, part_l, part_r, lossp, dL, dR, loss, cnt_r, cnt_c,
         N, M, K, split_r, split_c, gamma, lam, stream};
  return run_for(a);
}

const char* mf_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
