// Mamba-2 SSD chunked scan for Hopper (sm_90a): the intra-chunk dual form
// (C B^T o decay o causal) x_bar, the inter-chunk contribution of the
// carried [p, n] state, and the state update, chunk after chunk.
//
// Replaces the Pallas TPU kernel `_kernel` of src/repro/kernels/ssd_scan.py
// (ssd, :79; pallas_call :98).  Contract: `ref.ssd_chunked` of the port
// (x [b,s,h,p], dt [b,s,h] f32, A [h] f32, B/C [b,s,g,n] with g | h ->
// y [b,s,h,p] in x's dtype and the final state [b,h,p,n] in float32).
//
// What bounds it: at the models' prefill shape (b 8, s 2048, h 24, p 64,
// g 3, n 128, chunk 128) the causal triangles and the state products need
// ~6.5 GFLOP of bf16 scores and ~16.1 GFLOP of float32 products against
// ~134 MB of inputs and outputs, so the float32 rate of the CUDA cores
// bounds it (~0.25 ms on an H100 SXM at 67 TFLOP/s), not memory
// (~0.04 ms).  The design:
//
// - One CTA per (b, h) walks the chunks in order (the TPU grid's
//   sequential chunk axis becomes a loop) and holds the state in shared
//   memory as float32, transposed ([n][p], so every product below reads
//   its right operand as rows).  B and C are read per group h / (h/g):
//   they are never repeated per head in memory, as the TPU wrapper does
//   (ssd_scan.py:93-94).
// - The chunk body is ssd_scan.py:44-76: an in-order cumsum of dt*A (one
//   thread, each product and sum rounded on its own, as the TPU kernel
//   does), the decay exponent clamped at 0, scores C B^T (bf16: mma.sync
//   m16n8k16 on the tensor cores with a float32 accumulator; f32: CUDA
//   cores), then y = w x_bar + e^cum (C state^T), and the state update
//   state e^cum_last + (x_bar e^(cum_last - cum))^T B, all three in
//   float32 on the CUDA cores (no TF32), 4x4 outputs per thread.
// - The score matrix is kept in shared memory a block of rows at a time
//   (the whole chunk for bf16 at these shapes; fewer rows where the
//   float32 operands leave less room), and only its causal part is
//   computed.
// - A ragged s is masked here: rows past s read x = 0, dt = 0, B = C = 0
//   (what the reference's padding, ref.py:260-268, gives: the state is
//   left as it was) and are not stored.
//
// Plain C interface, loaded with ctypes: ssd_forward returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

}  // namespace

extern "C" {

// The shared memory a CTA may use on `device` (the opt-in limit).
int ssd_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Shared memory the kernel needs for one CTA (the wrapper picks the
// largest score block `rb` that fits).
long long ssd_smem_bytes(int p, int n, int l, int rb, int bf16) {
  const Dims d = make_dims(0, 1, p, 1, n, l, rb);
  return bf16 ? smem_bytes<__nv_bfloat16>(d) : smem_bytes<float>(d);
}

int ssd_forward(const void* x, const void* dt, const void* A, const void* B,
                const void* C, void* y, void* st, int b, int s, int h, int p,
                int g, int n, int l, int rb, int bf16, void* stream) {
  const Dims d = make_dims(s, h, p, g, n, l, rb);
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, st, b, d, st_);
  return launch<float>(x, dt, A, B, C, y, st, b, d, st_);
}

const char* ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
