// Hopper (sm_90a) kernel for the comm substrate's shipment pack.
//
// Replaces the TPU kernel repro/kernels/delta_pack.py::delta_pack
// (_delta_pack_kernel).  Per producer row p of delta[P, d] (float32,
// row-major), with the row's magnitude threshold thresh[p] and int8 scale
// scale[p]:
//
//   mask     = |delta| >= thresh[p]
//   wire     = mask ? Q(delta) : 0
//   residual = mask ? delta - Q(delta) : delta      (f32: mask ? 0 : delta)
//
// The plain PyTorch version, which states the contract, is delta_pack in
// kernels/ref.py; the launch wrapper in kernels/delta_pack.py checks shapes,
// types and devices before calling the extern "C" entry point below.
//
// Bound: bytes.  delta is read once, wire and residual written once, and
// thresh and scale read once: 3*P*d*4 + 2*P*4 bytes (0.145 ms at P = 8,
// d = 5,053,800 over the H100 SXM's 3.35 TB/s); about six operations per
// element, far below the card's operation rate.  Design: a grid over
// (column chunk, row); each thread loads its row's threshold and scale once
// and packs one float4 (or one float where d % 4 != 0 or a pointer is not
// 16-byte aligned), so every block streams coalesced 16-byte loads and
// stores and the ragged tail of d is masked by the bound check.  Next step
// (a later change): fuse delta = acc + res and the selected-count reduction
// into this pass, so delta is never written to memory.
//
// Rounding, bit-equal to the plain version and to the JAX reference as XLA
// compiles it (the build passes neither --use_fast_math nor -ftz=true, and
// keeps -prec-div=true, but the intrinsics below pin every rounding anyway):
//   - the int8 quotient is the IEEE division __fdiv_rn(delta, s), rounded
//     half to even with rintf (not roundf) and clamped to +-127;
//   - the wire value is __fmul_rn(r, s), which the compiler may not
//     contract;
//   - the residual is __fmaf_rn(-r, s, delta), one rounding, as XLA
//     contracts delta - r*s into a fused multiply-add;
//   - bf16 rounds to nearest even with __float2bfloat16_rn, and
//     delta - Q(delta) is exact in float32;
//   - denormals are kept (no flush to zero).
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int QUANT_F32 = 0, QUANT_BF16 = 1, QUANT_INT8 = 2;

template <int QUANT>
__device__ __forceinline__ void pack1(float x, float t, float s, float& w,
                                      float& r) {
  const bool m = fabsf(x) >= t;
  if (QUANT == QUANT_F32) {
    w = m ? x : 0.f;
    r = m ? 0.f : x;
  } else if (QUANT == QUANT_BF16) {
    const float q = __bfloat162float(__float2bfloat16_rn(x));
    w = m ? q : 0.f;
    r = m ? __fsub_rn(x, q) : x;
  } else {
    const float k = fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f);
    w = m ? __fmul_rn(k, s) : 0.f;
    r = m ? __fmaf_rn(-k, s, x) : x;
  }
}

// One float4 of one row per thread: blockIdx.y is the row, n4 = d / 4.
template <int QUANT>
__global__ void __launch_bounds__(THREADS)
delta_pack_vec4(const float4* __restrict__ delta,
                const float* __restrict__ thresh,
                const float* __restrict__ scale, float4* __restrict__ wire,
                float4* __restrict__ res, long long n4) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n4) return;
  const int p = blockIdx.y;
  const float t = __ldg(thresh + p);
  const float s = QUANT == QUANT_INT8 ? __ldg(scale + p) : 1.f;
  const long long at = (long long)p * n4 + i;
  const float4 x = __ldg(delta + at);
  float4 w, r;
  pack1<QUANT>(x.x, t, s, w.x, r.x);
  pack1<QUANT>(x.y, t, s, w.y, r.y);
  pack1<QUANT>(x.z, t, s, w.z, r.z);
  pack1<QUANT>(x.w, t, s, w.w, r.w);
  wire[at] = w;
  res[at] = r;
}

// One float of one row per thread: any d, any alignment.
template <int QUANT>
__global__ void __launch_bounds__(THREADS)
delta_pack_scalar(const float* __restrict__ delta,
                  const float* __restrict__ thresh,
                  const float* __restrict__ scale, float* __restrict__ wire,
                  float* __restrict__ res, long long d) {
  const long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (j >= d) return;
  const int p = blockIdx.y;
  const float t = __ldg(thresh + p);
  const float s = QUANT == QUANT_INT8 ? __ldg(scale + p) : 1.f;
  const long long at = (long long)p * d + j;
  float w, r;
  pack1<QUANT>(__ldg(delta + at), t, s, w, r);
  wire[at] = w;
  res[at] = r;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <int QUANT>
void launch(const float* delta, const float* thresh, const float* scale,
            float* wire, float* res, int P, long long d,
            cudaStream_t stream) {
  if (d % 4 == 0 && aligned16(delta) && aligned16(wire) && aligned16(res)) {
    const long long n4 = d / 4;
    const dim3 grid((unsigned)((n4 + THREADS - 1) / THREADS), (unsigned)P);
    delta_pack_vec4<QUANT><<<grid, THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(delta), thresh, scale,
        reinterpret_cast<float4*>(wire), reinterpret_cast<float4*>(res), n4);
  } else {
    const dim3 grid((unsigned)((d + THREADS - 1) / THREADS), (unsigned)P);
    delta_pack_scalar<QUANT><<<grid, THREADS, 0, stream>>>(
        delta, thresh, scale, wire, res, d);
  }
}

}  // namespace

extern "C" {

// quant: 0 = f32, 1 = bf16, 2 = int8.  1 <= P <= 65535 and
// ceil(d / 256) < 2^31 (kernels/delta_pack.py checks both before a launch).
int dp_delta_pack(const float* delta, const float* thresh, const float* scale,
                  float* wire, float* res, int P, long long d, int quant,
                  cudaStream_t stream) {
  if (quant == QUANT_F32)
    launch<QUANT_F32>(delta, thresh, scale, wire, res, P, d, stream);
  else if (quant == QUANT_BF16)
    launch<QUANT_BF16>(delta, thresh, scale, wire, res, P, d, stream);
  else if (quant == QUANT_INT8)
    launch<QUANT_INT8>(delta, thresh, scale, wire, res, P, d, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* dp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
