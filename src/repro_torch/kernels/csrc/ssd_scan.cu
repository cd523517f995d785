// Mamba-2 SSD chunked scan for Hopper (sm_90a): the intra-chunk dual form
// (C B^T o decay o causal) x_bar, the inter-chunk contribution of the
// carried [p, n] state, and the state update, chunk after chunk.
//
// Replaces the Pallas TPU kernel `_kernel` of src/repro/kernels/ssd_scan.py
// (ssd, :79; pallas_call :98).  Contract: `ref.ssd_chunked` of the port
// (x [b,s,h,p], dt [b,s,h] f32, A [h] f32, B/C [b,s,g,n] with g | h ->
// y [b,s,h,p] in x's dtype and the final state [b,h,p,n] in float32).
//
// What bounds it: at mamba2-130m's prefill (b 8, s 2048, h 24, p 64, g 3,
// n 128, chunk 128) the causal scores are ~6.5 GFLOP of bf16 and the
// three float32 products (w x_bar, C state^T, the state update) ~16.1
// GFLOP against ~134 MB of inputs and outputs, so the float32 rate of the
// CUDA cores bounds it (0.241 ms at 67 TFLOP/s), not memory (~0.04 ms).
// The float32 products stay in full float32 on the CUDA cores (no TF32,
// no bf16 operands): the state limit (2e-5 of scale) would not survive
// TF32.
//
// Two kernels, picked by a fixed rule (`ssd_variant`):
//
// `split::split_kernel` (bf16, n <= 128, chunk <= 128: the models' path).
// The per-head kernel below lost its time to three things; the design:
//
// 1. Too few CTAs and warps (one 256-thread CTA per (b, h): 192 CTAs in
//    two waves on 132 SMs).  Row p of the state and column p of y depend
//    only on column p of x_bar, so a CTA takes one (b, h) and a 32-wide
//    slice of p: 384 CTAs of 8 warps at the prefill shape, 2.9 waves.
//    Each slice recomputes the bf16 scores and the decays; the state
//    never leaves the CTA.  CTAs are numbered slice first, then head
//    within the group, so the 16 CTAs that read one (b, group)'s B and C
//    run together and hit in L2.  Chunk-parallel state passing was not
//    taken: it would move the [b, h, nc, p, n] chunk states (100.7 MB in
//    float32) through device memory.
// 2. The float32 products fed 4x4 tiles with one scalar shared-memory
//    load (and a bf16 conversion) per 4 FMAs.  An SM's shared memory
//    delivers 128 bytes a clock to the lanes, broadcast or not, so a
//    16-byte load must feed at least 16 FMAs (32 here) for the FMA pipe,
//    not shared memory, to bound a product.  Every product is now a
//    register tile of 8 rows x 8 columns per lane, its K split over the
//    four lanes of a quad (lane tq owns k = 2tq, 2tq + 1 mod 8, as in the
//    mma fragments) and summed by 48 shuffles.  The scores never go
//    through shared memory: each warp's mma.sync accumulators, decayed and
//    masked in registers and gathered over its row quads by shuffles, are
//    the left operand of w x_bar; its C fragments that of C state^T, whose
//    rows are scaled by e^cum once at the end; the state update reads
//    x_tilde = x_bar e^(cum_last - cum), the JAX kernel's form.  A warp
//    takes row blocks b and l/8 - 1 - b of the chunk, and warps sharing a
//    scheduler take blocks whose causal score tiles add up the same.
// 3. Nothing overlapped (element-wise loads between barriers, a one-thread
//    cumsum, six barriers per chunk).  Chunk c+1's B, C, x and dt go into
//    a second buffer by cp.async while chunk c computes; the cumsum is a
//    warp scan that every warp runs (its order differs from the
//    reference's, which both limits cover), so x_bar and x_tilde are made
//    in one pass; two barriers per chunk.  With only 8 warps an SM
//    hides latency by independent work inside each warp: the key-tile
//    loop is split into branch-free loops, and at n = chunk = 128 (a
//    compile-time instance) the state update's key steps run interleaved
//    with C state^T's k steps.  The scores stay on mma.sync:
//    a variant with wgmma (A from registers, B by TMA) ran 1.4x slower
//    than the mma.sync kernel of the time, since reading its accumulator
//    by key tile forces the tile loop to be unrolled.
//
// `head::ssd_kernel` (float32, and bf16 past n 128 or chunk 128): one
// CTA per (b, h), the state in shared memory, the scores in shared memory
// a block of rows at a time (as many as fit), 4x4 float32 tiles.
//
// Both read rows past s as x = 0, dt = 0, B = C = 0 (the reference's
// padding, ref.py `_ssd_parts`: the state is left as it was) and do not
// store them; both sum in a fixed order, so two calls are bit-equal.
//
// Plain C interface, loaded with ctypes: ssd_forward returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float v) {
  d = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

namespace head {

constexpr int THREADS = 256;

struct Dims {
  int s, h, p, g, n, l, rb;
  int ns;  // row stride of the B and C tiles (n + 8)
  int ps;  // row stride of the transposed state (p + 4)
  int ws;  // row stride of the score block (l + 4)
};

// scores of rows [r0, r0 + rb) against keys [0, r0 + rb), decayed and
// causally masked, into w_s
template <typename T>
__device__ void chunk_scores(const T* b_s, const T* c_s, const float* cum,
                             float* w_s, int r0, const Dims& d);

template <>
__device__ void chunk_scores<__nv_bfloat16>(
    const __nv_bfloat16* b_s, const __nv_bfloat16* c_s, const float* cum,
    float* w_s, int r0, const Dims& d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int n_mt = d.rb / 16, n_nt = (r0 + d.rb) / 8;
  for (int u = warp; u < n_mt * n_nt; u += THREADS / 32) {
    const int mt = u / n_nt, nt = u % n_nt;
    const int i0 = r0 + mt * 16 + gr;       // rows i0 and i0 + 8
    const int j0 = nt * 8 + 2 * tq;         // keys j0 and j0 + 1
    if (nt * 8 > r0 + mt * 16 + 15) {       // above the diagonal: zeros
      for (int e = 0; e < 4; ++e)
        w_s[(i0 - r0 + (e >> 1) * 8) * d.ws + j0 + (e & 1)] = 0.f;
      continue;
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = 0; ks < d.n; ks += 16) {
      const __nv_bfloat16* ar0 = c_s + i0 * d.ns + ks + 2 * tq;
      const __nv_bfloat16* ar1 = ar0 + 8 * d.ns;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(ar0),
                             *reinterpret_cast<const uint32_t*>(ar1),
                             *reinterpret_cast<const uint32_t*>(ar0 + 8),
                             *reinterpret_cast<const uint32_t*>(ar1 + 8)};
      const __nv_bfloat16* br = b_s + (nt * 8 + gr) * d.ns + ks + 2 * tq;
      mma_bf16(acc, a, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
    }
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (e >> 1) * 8, j = j0 + (e & 1);
      w_s[(i - r0) * d.ws + j] =
          j <= i ? acc[e] * expf(fminf(cum[i] - cum[j], 0.f)) : 0.f;
    }
  }
}

template <>
__device__ void chunk_scores<float>(const float* b_s, const float* c_s,
                                    const float* cum, float* w_s, int r0,
                                    const Dims& d) {
  const int n_ti = d.rb / 4, n_tj = (r0 + d.rb) / 4;
  for (int t = threadIdx.x; t < n_ti * n_tj; t += THREADS) {
    const int i0 = r0 + (t / n_tj) * 4, j0 = (t % n_tj) * 4;
    if (j0 > i0 + 3) {
      for (int e = 0; e < 16; ++e)
        w_s[(i0 - r0 + (e >> 2)) * d.ws + j0 + (e & 3)] = 0.f;
      continue;
    }
    float acc[4][4] = {};
    for (int kk = 0; kk < d.n; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = c_s[(i0 + e) * d.ns + kk];
        bb[e] = b_s[(j0 + e) * d.ns + kk];
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(a[x], bb[y], acc[x][y]);
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int i = i0 + x, j = j0 + y;
        w_s[(i - r0) * d.ws + j] =
            j <= i ? acc[x][y] * expf(fminf(cum[i] - cum[j], 0.f)) : 0.f;
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, T* __restrict__ y, float* __restrict__ st_out,
    Dims d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* st_s = reinterpret_cast<float*>(smem_raw);      // [n][ps] state^T
  float* x_s = st_s + d.n * d.ps;                        // [l][p] x * dt
  float* w_s = x_s + d.l * d.p;                          // [rb][ws] scores
  float* cum = w_s + d.rb * d.ws;                        // [l]
  float* dts = cum + d.l;                                // [l]
  float* ecum = dts + d.l;                               // [l] e^cum
  float* dte = ecum + d.l;                               // [l] e^(last-cum)
  T* b_s = reinterpret_cast<T*>(dte + d.l);              // [l][ns]
  T* c_s = b_s + d.l * d.ns;                             // [l][ns]

  const int bi = blockIdx.x / d.h, hi = blockIdx.x % d.h;
  const int gi = hi / (d.h / d.g);
  const int tid = threadIdx.x;
  const float Ah = A[hi];

  for (int e = tid; e < d.n * d.ps; e += THREADS) st_s[e] = 0.f;

  const int n_chunks = (d.s + d.l - 1) / d.l;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * d.l;
    __syncthreads();  // the previous chunk is done with every tile
    for (int i = tid; i < d.l; i += THREADS) {
      const int t = t0 + i;
      dts[i] = t < d.s ? dt[((long long)bi * d.s + t) * d.h + hi] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // in order, each product and sum rounded on its own
      float acc = 0.f;
      for (int i = 0; i < d.l; ++i) {
        acc = __fadd_rn(acc, __fmul_rn(dts[i], Ah));
        cum[i] = acc;
      }
    }
    for (int e = tid; e < d.l * d.p; e += THREADS) {
      const int i = e / d.p, pp = e % d.p, t = t0 + i;
      const float xv =
          t < d.s ? to_f(x[(((long long)bi * d.s + t) * d.h + hi) * d.p + pp])
                  : 0.f;
      x_s[e] = __fmul_rn(xv, dts[i]);
    }
    for (int e = tid; e < d.l * d.n; e += THREADS) {
      const int i = e / d.n, kk = e % d.n, t = t0 + i;
      const long long src = (((long long)bi * d.s + t) * d.g + gi) * d.n + kk;
      b_s[i * d.ns + kk] = t < d.s ? Bm[src] : T(0.f);
      c_s[i * d.ns + kk] = t < d.s ? Cm[src] : T(0.f);
    }
    __syncthreads();
    for (int i = tid; i < d.l; i += THREADS) {
      ecum[i] = expf(cum[i]);
      dte[i] = expf(cum[d.l - 1] - cum[i]);
    }

    for (int r0 = 0; r0 < d.l; r0 += d.rb) {
      __syncthreads();  // w_s is free, ecum/dte are written
      chunk_scores<T>(b_s, c_s, cum, w_s, r0, d);
      __syncthreads();
      // y rows [r0, r0 + rb): 4 rows x 4 columns per thread
      const int n_tp = d.p / 4;
      for (int t = tid; t < (d.rb / 4) * n_tp; t += THREADS) {
        const int i0 = r0 + (t / n_tp) * 4, p0 = (t % n_tp) * 4;
        float inter[4][4] = {}, intra[4][4] = {};
        for (int kk = 0; kk < d.n; ++kk) {       // C state^T
          const float4 sv =
              *reinterpret_cast<const float4*>(st_s + kk * d.ps + p0);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float cv = to_f(c_s[(i0 + a) * d.ns + kk]);
            inter[a][0] = fmaf(cv, sv.x, inter[a][0]);
            inter[a][1] = fmaf(cv, sv.y, inter[a][1]);
            inter[a][2] = fmaf(cv, sv.z, inter[a][2]);
            inter[a][3] = fmaf(cv, sv.w, inter[a][3]);
          }
        }
        for (int j = 0; j <= i0 + 3; ++j) {     // w x_bar (causal)
          const float4 xv = *reinterpret_cast<const float4*>(x_s + j * d.p + p0);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float wv = w_s[(i0 + a - r0) * d.ws + j];
            intra[a][0] = fmaf(wv, xv.x, intra[a][0]);
            intra[a][1] = fmaf(wv, xv.y, intra[a][1]);
            intra[a][2] = fmaf(wv, xv.z, intra[a][2]);
            intra[a][3] = fmaf(wv, xv.w, intra[a][3]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int row = t0 + i0 + a;
          if (row >= d.s) continue;
          const float e = ecum[i0 + a];
          T* yr = y + (((long long)bi * d.s + row) * d.h + hi) * d.p + p0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            from_f(yr[c], intra[a][c] + __fmul_rn(inter[a][c], e));
        }
      }
    }
    __syncthreads();  // every read of the old state is done
    // state^T[k][p] = state^T[k][p] e^cum_last + sum_j B[j][k] x_bar[j][p] dte[j]
    {
      const float ecl = expf(cum[d.l - 1]);
      const int n_tp = d.p / 4;
      for (int t = tid; t < (d.n / 4) * n_tp; t += THREADS) {
        const int k0 = (t / n_tp) * 4, p0 = (t % n_tp) * 4;
        float acc[4][4] = {};
        for (int j = 0; j < d.l; ++j) {
          const float4 xv = *reinterpret_cast<const float4*>(x_s + j * d.p + p0);
          const float de = dte[j];
          const float xs[4] = {__fmul_rn(xv.x, de), __fmul_rn(xv.y, de),
                               __fmul_rn(xv.z, de), __fmul_rn(xv.w, de)};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float bv = to_f(b_s[j * d.ns + k0 + a]);
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(bv, xs[c], acc[a][c]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float4* sp = reinterpret_cast<float4*>(st_s + (k0 + a) * d.ps + p0);
          float4 sv = *sp;
          sv.x = __fmul_rn(sv.x, ecl) + acc[a][0];
          sv.y = __fmul_rn(sv.y, ecl) + acc[a][1];
          sv.z = __fmul_rn(sv.z, ecl) + acc[a][2];
          sv.w = __fmul_rn(sv.w, ecl) + acc[a][3];
          *sp = sv;
        }
      }
    }
  }
  __syncthreads();
  float* so = st_out + ((long long)bi * d.h + hi) * d.p * d.n;
  for (int e = tid; e < d.p * d.n; e += THREADS) {
    const int pp = e / d.n, kk = e % d.n;
    so[e] = st_s[kk * d.ps + pp];
  }
}

template <typename T>
long long smem_bytes(const Dims& d) {
  return 4LL * (d.n * d.ps + d.l * d.p + d.rb * d.ws + 4 * d.l) +
         (long long)sizeof(T) * 2 * d.l * d.ns;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* st, int b,
                   const Dims& d, cudaStream_t stream) {
  const long long smem = smem_bytes<T>(d);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T><<<b * d.h, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), static_cast<float*>(st),
      d);
  return cudaGetLastError();
}

Dims make_dims(int s, int h, int p, int g, int n, int l, int rb) {
  return Dims{s, h, p, g, n, l, rb, n + 8, p + 4, l + 4};
}
}  // namespace head

namespace split {

constexpr int PS = 32;        // the slice of p one CTA takes
constexpr int THREADS = 256;  // 8 warps
constexpr int MAX_L = 128;    // 8 warps x 16 rows of a chunk
constexpr int MAX_N = 128;    // 8 warps x 16 rows of state^T
// x_bar, x_tilde and state^T rows in shared memory: slice columns 0-15 at
// 0, 16-31 at HALF, so the lanes of a quarter warp, reading rows two apart
// in two column groups, hit distinct banks
constexpr int HALF = 20;
constexpr int XS = 36;        // their row stride (floats)
constexpr float LOG2E = 1.4426950408889634f;

struct Dims {
  int s, h, p, g, n, l;
  int nsl;  // slices of p: ceil(p / PS)
  int bs;   // row stride (bf16) of the B and C tiles: n + 8
};

// One chunk's inputs as cp.async lands them: B, C [l][bs] bf16, x [l][PS]
// bf16, dt [l] f32.
__host__ __device__ inline int raw_bytes(const Dims& d) {
  return 4 * d.l * d.bs + 2 * d.l * PS + 4 * d.l;
}

// Two raw buffers; x_bar and x_tilde [l][XS]; two state^T buffers
// [n][XS]; cum, e^cum, e^(cum_last - cum) [l] and e^cum_last.
__host__ __device__ inline int smem_bytes(const Dims& d) {
  return 2 * raw_bytes(d) + 4 * (2 * d.l * XS + 2 * d.n * XS + 3 * d.l + 4);
}

__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of `size` bytes; `ok` false fills them with zeros instead
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp8(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 8 : 0) : "memory");
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// The shared-memory column of slice column c (0 <= c < PS).
__device__ __forceinline__ int scol(int c) {
  return c < 16 ? c : c - 16 + HALF;
}

// acc[0..7] += w * (a, b): eight columns
__device__ __forceinline__ void fma8(float* acc, float w, const float4& a,
                                     const float4& b) {
  acc[0] = fmaf(w, a.x, acc[0]);
  acc[1] = fmaf(w, a.y, acc[1]);
  acc[2] = fmaf(w, a.z, acc[2]);
  acc[3] = fmaf(w, a.w, acc[3]);
  acc[4] = fmaf(w, b.x, acc[4]);
  acc[5] = fmaf(w, b.y, acc[5]);
  acc[6] = fmaf(w, b.z, acc[6]);
  acc[7] = fmaf(w, b.w, acc[7]);
}

// Sums an [8][8] tile (rows x columns) whose K the four lanes of a quad
// split; lane tq keeps rows 2x, 2x + 1, x = xq(tq), all eight columns, in
// a fixed order.
__device__ __forceinline__ int xq(int tq) {
  return 2 * (tq & 1) + (tq >> 1);
}
__device__ __forceinline__ void quad_sum(const float (&a)[8][8],
                                         float (&out)[2][8], int tq) {
  const bool odd = tq & 1, up = tq & 2;
  float h[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float send = odd ? a[r][i] : a[4 + r][i];
      const float keep = odd ? a[4 + r][i] : a[r][i];
      h[r][i] = keep + __shfl_xor_sync(FULL, send, 1);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float send = up ? h[r][i] : h[2 + r][i];
      const float keep = up ? h[2 + r][i] : h[r][i];
      out[r][i] = keep + __shfl_xor_sync(FULL, send, 2);
    }
}

// The scores of C rows rlo / rhi (the A fragments `af`) against keys
// 8t .. 8t + 7 as two partial sums (mma.sync chains over the even and the
// odd k steps), in the mma C fragment: [0], [1] row rlo, keys 8t + 2tq,
// +1; [2], [3] row rhi.
__device__ __forceinline__ void scores(float (&sc)[2][4],
                                       const uint32_t (&af)[8][4],
                                       const __nv_bfloat16* b_s, int t, int gr,
                                       int tq, int nk, int bs) {
#pragma unroll
  for (int e = 0; e < 4; ++e) sc[0][e] = sc[1][e] = 0.f;
  const __nv_bfloat16* br = b_s + (8 * t + gr) * bs + 2 * tq;
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    if (ks < nk)
      mma_bf16(sc[ks & 1], af[ks], ld32(br + 16 * ks),
               ld32(br + 16 * ks + 8));
}

// exp(min(ci - cj, 0)): the decay from key j to row i (ex2.approx: a
// relative error of ~2^-22, far inside y's limit)
__device__ __forceinline__ float decay(float ci, float cj) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(r)
      : "f"(fminf(ci - cj, 0.f) * LOG2E));
  return r;
}

// cum of chunk row i, from the warp's scan (lane l holds rows 4l .. 4l + 3
// in v); every lane of the warp must call it
__device__ __forceinline__ float row_cum(const float (&v)[4], int i) {
  float r = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float o = __shfl_sync(FULL, v[e], i >> 2);
    if ((i & 3) == e) r = o;
  }
  return r;
}

// v[x] = the value v of lane gr ^ x (same tq): the four lanes of a gr quad
__device__ __forceinline__ void quad_gather(float (&g)[4], float v) {
  g[0] = v;
  g[1] = __shfl_xor_sync(FULL, v, 4);
  g[2] = __shfl_xor_sync(FULL, v, 8);
  g[3] = __shfl_xor_sync(FULL, v, 12);
}
__device__ __forceinline__ void quad_gather(uint32_t (&g)[4], uint32_t v) {
  g[0] = v;
  g[1] = __shfl_xor_sync(FULL, v, 4);
  g[2] = __shfl_xor_sync(FULL, v, 8);
  g[3] = __shfl_xor_sync(FULL, v, 12);
}

// Chunk c's B, C, x and dt into the raw buffer at `rb` (one commit group).
__device__ __forceinline__ void load_chunk(
    int c, unsigned char* rb, const __nv_bfloat16* x, const float* dt,
    const __nv_bfloat16* Bm, const __nv_bfloat16* Cm, int bi, int gi, int hi,
    int p0, const Dims& d) {
  const uint32_t b_at = smem_u32(rb), c_at = b_at + 2 * d.l * d.bs,
                 x_at = c_at + 2 * d.l * d.bs, dt_at = x_at + 2 * d.l * PS;
  const int t0 = c * d.l;
  // 16 threads a row, one 16-byte piece each (n <= 128: at most 16 pieces)
  for (int i = threadIdx.x / 16; i < d.l; i += THREADS / 16) {
    const int q = threadIdx.x % 16, t = t0 + i;
    if (8 * q >= d.n) continue;
    const bool ok = t < d.s;
    const long long src =
        ok ? (((long long)bi * d.s + t) * d.g + gi) * d.n + 8 * q : 0;
    const uint32_t dst = 2 * (i * d.bs + 8 * q);
    cp16(b_at + dst, Bm + src, ok);
    cp16(c_at + dst, Cm + src, ok);
  }
  for (int e = threadIdx.x; e < d.l * (PS / 4); e += THREADS) {
    const int i = e / (PS / 4), q = e % (PS / 4), t = t0 + i,
              col = p0 + 4 * q;
    const bool ok = t < d.s && col < d.p;
    const long long src =
        ok ? (((long long)bi * d.s + t) * d.h + hi) * d.p + col : 0;
    cp8(x_at + 2 * (i * PS + 4 * q), x + src, ok);
  }
  for (int i = threadIdx.x; i < d.l; i += THREADS) {
    const int t = t0 + i;
    const bool ok = t < d.s;
    cp4(dt_at + 4 * i, dt + (ok ? ((long long)bi * d.s + t) * d.h + hi : 0),
        ok);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A warp's lanes: gr = lane / 4 (mma row group), tq = lane % 4 (each
// product's K is split over tq).  The four lanes gr = 4G .. 4G + 3 of a
// gr quad compute the same eight rows (for y: the lo and hi mma rows of
// the quad, gathered by shuffles; for state^T: eight consecutive k), lane
// m = gr % 4 taking slice columns cg(m) .. cg(m) + 7.  One 16-byte load of
// x_bar, x_tilde or state^T then feeds 32 FMAs.
__device__ __forceinline__ int cg(int m) {
  return 16 * (m & 1) + 8 * (m >> 1);
}

// acc += B[j][k0 .. k0 + 7]^T x_tilde[j][this lane's columns]: one key of
// the state update
__device__ __forceinline__ void state_step(float (&acc)[8][8],
                                           const __nv_bfloat16* b_s,
                                           const float* xt, int j, int k0,
                                           int cs, int bs) {
  const uint4 bq = *reinterpret_cast<const uint4*>(b_s + j * bs + k0);
  const float* xr = xt + j * XS + cs;
  const float4 a0 = *reinterpret_cast<const float4*>(xr);
  const float4 a1 = *reinterpret_cast<const float4*>(xr + 4);
  const uint32_t bp[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    fma8(acc[2 * i], bf_lo(bp[i]), a0, a1);
    fma8(acc[2 * i + 1], bf_hi(bp[i]), a0, a1);
  }
}

// state^T rows kr, kr + 1 (this lane's after the quad sum) = old e^last +
// the chunk's sum, into st_new and st_reg
__device__ __forceinline__ void state_store(const float (&acc)[8][8],
                                            float (&st_reg)[2][8],
                                            const float* st_old,
                                            float* st_new, float decay_,
                                            int kr, int cs, int tq) {
  float out[2][8];
  quad_sum(acc, out, tq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* so = st_old + (kr + r) * XS + cs;
    float* sn = st_new + (kr + r) * XS + cs;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      st_reg[r][i] = __fadd_rn(__fmul_rn(so[i], decay_), out[r][i]);
      sn[i] = st_reg[r][i];
    }
  }
}

// N, L: n and chunk fixed at compile time (the models' 128, 128), or 0:
// read from d.
template <int N, int L>
__global__ void __launch_bounds__(THREADS, 1) split_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
    float* __restrict__ st_out, Dims d) {
  if (N) {
    d.n = N;
    d.bs = N + 8;
  }
  if (L) d.l = L;
  extern __shared__ __align__(16) unsigned char smem[];
  const int raw = raw_bytes(d);
  float* xb = reinterpret_cast<float*>(smem + 2 * raw);  // [l][XS] x dt
  float* xt = xb + d.l * XS;                   // [l][XS] x dt e^(last-cum)
  float* st_buf = xt + d.l * XS;               // 2 x [n][XS]
  float* cum = st_buf + 2 * d.n * XS;          // [l]
  float* ecum = cum + d.l;                     // [l] e^cum
  float* dte = ecum + d.l;                     // [l] e^(last-cum)
  float* ecl = dte + d.l;                      // e^cum_last

  // slice fastest, then the head within its group, the group, the batch
  int id = blockIdx.x;
  const int sl = id % d.nsl;
  id /= d.nsl;
  const int rep = d.h / d.g, hh = id % rep;
  id /= rep;
  const int gi = id % d.g, bi = id / d.g, hi = gi * rep + hh, p0 = sl * PS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3, nk = d.n / 16;
  const int G = gr >> 2, m = gr & 3;
  const int cs = scol(cg(m));            // this lane's shared-memory column
  const int col = p0 + cg(m);            // its first column of y
  const float Ah = A[hi];
  const int n_chunks = (d.s + d.l - 1) / d.l;

  for (int e = tid; e < d.n * XS; e += THREADS) st_buf[e] = 0.f;
  load_chunk(0, smem, x, dt, Bm, Cm, bi, gi, hi, p0, d);
  float st_reg[2][8];  // state^T rows k0 + 2x(tq), +1, this lane's columns

  for (int ch = 0; ch < n_chunks; ++ch) {
    unsigned char* rb = smem + (ch & 1) * raw;
    const __nv_bfloat16* b_s = reinterpret_cast<const __nv_bfloat16*>(rb);
    const __nv_bfloat16* c_s = b_s + d.l * d.bs;
    const __nv_bfloat16* x_s = c_s + d.l * d.bs;
    const float* dt_s = reinterpret_cast<const float*>(x_s + d.l * PS);
    const float* st_old = st_buf + (ch & 1) * d.n * XS;
    float* st_new = st_buf + ((ch + 1) & 1) * d.n * XS;

    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk ch has landed; chunk ch - 1 is done everywhere
    if (ch + 1 < n_chunks)
      load_chunk(ch + 1, smem + ((ch + 1) & 1) * raw, x, dt, Bm, Cm, bi, gi,
                 hi, p0, d);

    // cum = cumsum(dt * A), in every warp (4 rows a lane, then a scan):
    // warp 0 stores it with e^cum, e^(last - cum) and e^last; every thread
    // reads it for the rows of x_bar and x_tilde it computes
    float v[4];
    {
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * lane + e;
        run = __fadd_rn(run, i < d.l ? __fmul_rn(dt_s[i], Ah) : 0.f);
        v[e] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl = __fadd_rn(incl, o);
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __fadd_rn(excl, v[e]);
    }
    const float last = row_cum(v, d.l - 1);
    if (warp == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * lane + e;
        if (i < d.l) {
          cum[i] = v[e];
          ecum[i] = expf(v[e]);
          dte[i] = expf(last - v[e]);
        }
      }
      if (lane == 0) ecl[0] = expf(last);
    }
    // x_bar = x dt and x_tilde = x_bar e^(last - cum); d.l * PS / 4 is a
    // multiple of 32, so every lane of a warp takes part in the shuffles
    for (int e = tid; e < d.l * (PS / 4); e += THREADS) {
      const int i = e / (PS / 4), c = scol(4 * (e % (PS / 4)));
      const uint2 u = *reinterpret_cast<const uint2*>(x_s + 4 * e);
      const float dv = dt_s[i], de = expf(last - row_cum(v, i));
      const float4 xv =
          make_float4(__fmul_rn(bf_lo(u.x), dv), __fmul_rn(bf_hi(u.x), dv),
                      __fmul_rn(bf_lo(u.y), dv), __fmul_rn(bf_hi(u.y), dv));
      *reinterpret_cast<float4*>(xb + i * XS + c) = xv;
      *reinterpret_cast<float4*>(xt + i * XS + c) =
          make_float4(__fmul_rn(xv.x, de), __fmul_rn(xv.y, de),
                      __fmul_rn(xv.z, de), __fmul_rn(xv.w, de));
    }
    __syncthreads();  // cum, the exponentials, x_bar and x_tilde are written

    if (warp < d.l / 16) {  // y rows of blocks bw and l/8 - 1 - bw
      // warps w and w + 4 share a scheduler: giving warp w + 4 block
      // l/16 - 1 - w gives every scheduler the same number of score tiles
      const int bw = warp < 4 ? warp : d.l / 16 + 3 - warp;
      // mma rows of this lane; the lane's eight rows are those of lane
      // gr ^ x of its quad, acc[2x] the one in block `bw`, acc[2x + 1]
      // the one in the mirror block
      const int rlo = 8 * bw + gr, rhi = d.l - 8 - 8 * bw + gr;
      const int lo0 = 8 * bw + 4 * G, hi0 = d.l - 8 - 8 * bw + 4 * G;
      uint32_t af[8][4];  // C rows rlo / rhi as mma A fragments
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        if (ks < nk) {
          const __nv_bfloat16* lo = c_s + rlo * d.bs + 16 * ks + 2 * tq;
          const __nv_bfloat16* hi_ = c_s + rhi * d.bs + 16 * ks + 2 * tq;
          af[ks][0] = ld32(lo);
          af[ks][1] = ld32(hi_);
          af[ks][2] = ld32(lo + 8);
          af[ks][3] = ld32(hi_ + 8);
        }
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
      // C state^T over this lane's k = 16ks + 8half + 2tq (+1); in the
      // compile-time instance (n = chunk) the state update's key steps run
      // interleaved with its k steps: two independent FMA streams (the
      // generic instance would spill with both accumulators live)
      const bool fused = N && L && L == N;  // then also warp < nk
      float acc_s[8][8];
      if (fused) {
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) acc_s[r][q] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        if (ks < nk) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            if (fused) {
#pragma unroll
              for (int e = 0; e < 2; ++e)
                state_step(acc_s, b_s, xt, 8 * (2 * ks + half) + 2 * tq + e,
                           16 * warp + 8 * G, cs, d.bs);
            }
            uint32_t u[2][4];  // [lo / hi][x]: C pairs of the eight rows
            quad_gather(u[0], af[ks][2 * half]);
            quad_gather(u[1], af[ks][2 * half + 1]);
            const float* s0 = st_old + (16 * ks + 8 * half + 2 * tq) * XS + cs;
            const float4 a0 = *reinterpret_cast<const float4*>(s0);
            const float4 a1 = *reinterpret_cast<const float4*>(s0 + 4);
            const float4 b0 = *reinterpret_cast<const float4*>(s0 + XS);
            const float4 b1 = *reinterpret_cast<const float4*>(s0 + XS + 4);
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              const uint32_t v = u[r & 1][r >> 1];
              fma8(acc[r], bf_lo(v), a0, a1);
              fma8(acc[r], bf_hi(v), b0, b1);
            }
          }
        }
      if (fused)
        state_store(acc_s, st_reg, st_old, st_new, ecl[0],
                    16 * warp + 8 * G + 2 * xq(tq), cs, tq);
#pragma unroll
      for (int r = 0; r < 8; ++r) {  // (C state^T) e^cum
        const float e = ecum[(r & 1 ? hi0 : lo0) + (m ^ (r >> 1))];
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] *= e;
      }
      // w x_bar over the key tiles up to the mirror block's diagonal (block
      // bw's ends at tile bw); tile t + 1's scores are issued before
      // tile t's products
      const float c_lo = cum[rlo], c_hi = cum[rhi];
      const int n_tiles = d.l / 8 - bw;
      float part[2][4];
      scores(part, af, b_s, 0, gr, tq, nk, d.bs);
      // tile t's products: the mirror block's rows, and block bw's while
      // its rows see the keys (t <= bw); tile t + 1's scores are issued
      // first
      auto tile = [&](int t, bool lo_rows) {
        float sc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[e] = part[0][e] + part[1][e];
        if (t + 1 < n_tiles) scores(part, af, b_s, t + 1, gr, tq, nk, d.bs);
        const int j0 = 8 * t + 2 * tq;  // this lane's keys j0, j0 + 1
        const float2 cj = *reinterpret_cast<const float2*>(cum + j0);
        const float* xr = xb + j0 * XS + cs;
        const float4 a0 = *reinterpret_cast<const float4*>(xr);
        const float4 a1 = *reinterpret_cast<const float4*>(xr + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(xr + XS);
        const float4 b1 = *reinterpret_cast<const float4*>(xr + XS + 4);
        float w_hi[2][4];  // [key][x]: the mirror-block rows' w
        quad_gather(w_hi[0], j0 <= rhi ? sc[2] * decay(c_hi, cj.x) : 0.f);
        quad_gather(w_hi[1],
                    j0 + 1 <= rhi ? sc[3] * decay(c_hi, cj.y) : 0.f);
#pragma unroll
        for (int x4 = 0; x4 < 4; ++x4) {
          fma8(acc[2 * x4 + 1], w_hi[0][x4], a0, a1);
          fma8(acc[2 * x4 + 1], w_hi[1][x4], b0, b1);
        }
        if (lo_rows) {
          float w_lo[2][4];
          quad_gather(w_lo[0],
                      j0 <= rlo ? sc[0] * decay(c_lo, cj.x) : 0.f);
          quad_gather(w_lo[1],
                      j0 + 1 <= rlo ? sc[1] * decay(c_lo, cj.y) : 0.f);
#pragma unroll
          for (int x4 = 0; x4 < 4; ++x4) {
            fma8(acc[2 * x4], w_lo[0][x4], a0, a1);
            fma8(acc[2 * x4], w_lo[1][x4], b0, b1);
          }
        }
      };
      int t = 0;
      for (; t <= bw; ++t) tile(t, true);
      for (; t < n_tiles; ++t) tile(t, false);
      float out[2][8];
      quad_sum(acc, out, tq);
      const int xr_ = m ^ xq(tq);  // the quad lane whose rows these are
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = ch * d.l + (r ? hi0 : lo0) + xr_;
        if (t >= d.s) continue;
        __nv_bfloat16* yr = y + (((long long)bi * d.s + t) * d.h + hi) * d.p;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (col + 4 * q < d.p) {
            const __nv_bfloat162 v0 =
                __floats2bfloat162_rn(out[r][4 * q], out[r][4 * q + 1]);
            const __nv_bfloat162 v1 =
                __floats2bfloat162_rn(out[r][4 * q + 2], out[r][4 * q + 3]);
            uint2 u;
            u.x = *reinterpret_cast<const uint32_t*>(&v0);
            u.y = *reinterpret_cast<const uint32_t*>(&v1);
            *reinterpret_cast<uint2*>(yr + col + 4 * q) = u;
          }
      }
    }

    if (warp < nk && !(N && L && L == N)) {  // state^T rows k0 .. k0 + 7
      const int k0 = 16 * warp + 8 * G;
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
#pragma unroll 2
      for (int jj = 0; jj < d.l / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          state_step(acc, b_s, xt, 8 * jj + 2 * tq + e, k0, cs, d.bs);
      }
      state_store(acc, st_reg, st_old, st_new, ecl[0], k0 + 2 * xq(tq), cs,
                  tq);
    }
  }
  if (warp < nk) {
    const int kr = 16 * warp + 8 * G + 2 * xq(tq);
    float* so = st_out + ((long long)bi * d.h + hi) * d.p * d.n + kr;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (col + i < d.p)
        *reinterpret_cast<float2*>(so + (long long)(col + i) * d.n) =
            make_float2(st_reg[0][i], st_reg[1][i]);
  }
}

template <int N, int L>
cudaError_t launch_as(const void* x, const void* dt, const void* A,
                      const void* B, const void* C, void* y, void* st, int b,
                      const Dims& d, cudaStream_t stream) {
  const int smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<N, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  split_kernel<N, L><<<b * d.h * d.nsl, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(st), d);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* st, int b,
                   const Dims& d, cudaStream_t stream) {
  if (d.n == 128 && d.l == 128)
    return launch_as<128, 128>(x, dt, A, B, C, y, st, b, d, stream);
  return launch_as<0, 0>(x, dt, A, B, C, y, st, b, d, stream);
}

Dims make_dims(int s, int h, int p, int g, int n, int l) {
  return Dims{s, h, p, g, n, l, (p + PS - 1) / PS, n + 8};
}

}  // namespace split

}  // namespace

extern "C" {

// The kernel ssd_forward runs: 0 the head-dim split kernel (bf16 at
// n <= 128 and chunk <= 128), 1 the per-head kernel (every other shape).
int ssd_variant(int bf16, int n, int l) {
  return bf16 && n <= split::MAX_N && l <= split::MAX_L ? 0 : 1;
}

// The shared memory a CTA may use on `device` (the opt-in limit).
int ssd_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Shared memory the per-head kernel needs for one CTA (the wrapper picks
// the largest score block `rb` that fits).
long long ssd_smem_bytes(int p, int n, int l, int rb, int bf16) {
  const head::Dims d = head::make_dims(0, 1, p, 1, n, l, rb);
  return bf16 ? head::smem_bytes<__nv_bfloat16>(d)
              : head::smem_bytes<float>(d);
}

// `rb` is read by the per-head kernel only.
int ssd_forward(const void* x, const void* dt, const void* A, const void* B,
                const void* C, void* y, void* st, int b, int s, int h, int p,
                int g, int n, int l, int rb, int bf16, void* stream) {
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (ssd_variant(bf16, n, l) == 0)
    return split::launch(x, dt, A, B, C, y, st, b,
                         split::make_dims(s, h, p, g, n, l), st_);
  const head::Dims d = head::make_dims(s, h, p, g, n, l, rb);
  if (bf16)
    return head::launch<__nv_bfloat16>(x, dt, A, B, C, y, st, b, d, st_);
  return head::launch<float>(x, dt, A, B, C, y, st, b, d, st_);
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
