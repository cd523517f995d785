// Hopper (sm_90a) kernels for the PS simulator's per-clock hot path.
//
// Both read the update ring uring[W, P, d] (slot, producer, column), float32,
// row-major, with the slot clocks uclock[W] (int32; < RING_INVALID when the
// slot is empty).  The plain PyTorch versions, which state the contracts, are
// in kernels/ref.py; the launch wrappers in kernels/ps_view.py check shapes,
// types and devices before calling the extern "C" entry points below.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RING_INVALID = -100000000;   // kernels/ref.py
constexpr int THREADS = 256;

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

long long blocks_for(long long work, long long cap) {
  long long b = (work + THREADS - 1) / THREADS;
  if (b > cap) b = cap;
  return b < 1 ? 1 : b;
}

// ---------------------------------------------------------------------------
// ring_view
//
// Replaces the TPU kernel repro/kernels/ps_view.py::ring_view
// (_ring_view_kernel): view[r, j] = base[j] + sum_{w,q visible to r}
// uring[w, q, j], visible iff RING_INVALID < uclock[w] <= cview[r, q].
//
// Bound: bytes.  The ring is read once and the views written once:
// (W*P*d + P*d + d) * 4 bytes for W*P*P*d adds, far below the card's
// operation rate; P (4-16) is far below any tensor-core tile, so the sums run
// on CUDA cores.  Design: the [P, W*P] visibility mask is reduced per block to
// one 64-bit reader mask per ring row (w, q) in shared memory, computed once
// per block; blocks then stride over the columns.  Each thread owns one
// column at a time, loads every visible ring row's value once (four rows in
// flight) and adds it into PMAX per-reader register accumulators in (w, q)
// order; base is added last, as in the plain version.  Ring rows that no
// reader sees are not read.  The ragged tail of d is masked by the column
// loop bound.  Next step (a later change): fuse with vap_suffix_norms so the
// ring is read once per clock for both.
template <int PMAX>
__global__ void __launch_bounds__(THREADS)
ring_view_kernel(const float* __restrict__ base, const float* __restrict__ uring,
                 const int* __restrict__ uclock, const int* __restrict__ cview,
                 float* __restrict__ out, int W, int P, long long d) {
  extern __shared__ unsigned long long vis[];          // [W*P] reader bits
  const int S = W * P;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int w = s / P, q = s - w * P;
    const int uc = uclock[w];
    unsigned long long m = 0ull;
    if (uc > RING_INVALID)
      for (int r = 0; r < P; ++r)
        if (uc <= cview[r * P + q]) m |= 1ull << r;
    vis[s] = m;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc[PMAX];
#pragma unroll
    for (int r = 0; r < PMAX; ++r) acc[r] = 0.f;
    const float* col = uring + j;
    int s = 0;
    for (; s + 4 <= S; s += 4) {
      const unsigned long long m0 = vis[s], m1 = vis[s + 1],
                               m2 = vis[s + 2], m3 = vis[s + 3];
      const float u0 = m0 ? __ldg(col + (long long)s * d) : 0.f;
      const float u1 = m1 ? __ldg(col + (long long)(s + 1) * d) : 0.f;
      const float u2 = m2 ? __ldg(col + (long long)(s + 2) * d) : 0.f;
      const float u3 = m3 ? __ldg(col + (long long)(s + 3) * d) : 0.f;
#pragma unroll
      for (int r = 0; r < PMAX; ++r) {
        if ((m0 >> r) & 1ull) acc[r] += u0;
        if ((m1 >> r) & 1ull) acc[r] += u1;
        if ((m2 >> r) & 1ull) acc[r] += u2;
        if ((m3 >> r) & 1ull) acc[r] += u3;
      }
    }
    for (; s < S; ++s) {
      const unsigned long long m = vis[s];
      if (!m) continue;
      const float u = __ldg(col + (long long)s * d);
#pragma unroll
      for (int r = 0; r < PMAX; ++r)
        if ((m >> r) & 1ull) acc[r] += u;
    }
    const float b = __ldg(base + j);
#pragma unroll
    for (int r = 0; r < PMAX; ++r)
      if (r < P) out[(long long)r * d + j] = b + acc[r];
  }
}

template <int PMAX>
void launch_ring_view(const float* base, const float* uring, const int* uclock,
                      const int* cview, float* out, int W, int P, long long d,
                      cudaStream_t stream) {
  const long long blocks = blocks_for(d, 8LL * sm_count());
  const size_t smem = sizeof(unsigned long long) * (size_t)W * P;
  ring_view_kernel<PMAX><<<(unsigned)blocks, THREADS, smem, stream>>>(
      base, uring, uclock, cview, out, W, P, d);
}

// ---------------------------------------------------------------------------
// vap_suffix_norms
//
// Replaces the TPU kernel repro/kernels/ps_view.py::vap_suffix_norms
// (_suffix_norms_kernel): norms[k, q] = max_j |sum_{i=1..k} u_q(c-i)[j]| for
// k = 1..W, where u_q(c') is the ring row of producer q in the slot holding
// clock c' (absent clocks add nothing); norms[0] = 0.
//
// Bound: bytes, W*P*d*4 (the ring, read once); the output is [W+1, P].
// Design: the TPU kernel carried the running max across its sequential grid
// by revisiting one output block; Hopper blocks run in no order, so each
// thread keeps its own per-k maxima in registers while it strides over
// columns of one producer (blockIdx.y), then the block folds them with warp
// shuffles and one atomicMax per warp and k on the float's bits.  That is
// valid because every norm is >= +0, whose int bit patterns order like the
// floats; NaN (0x7fc00000) orders above +inf, so a NaN propagates as it does
// through the plain version's max.  The wrapper zeroes the output.  The clock
// c arrives as a kernel argument, so no host sync is needed; the slot of
// clock c-k is found once per block.  Next step (a later change): fuse with
// ring_view so the ring is read once per clock for both.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

template <int WMAX>
__global__ void __launch_bounds__(THREADS)
vap_suffix_norms_kernel(const float* __restrict__ uring,
                        const int* __restrict__ uclock, int c,
                        float* __restrict__ norms, int W, int P, long long d) {
  __shared__ int slot_of[WMAX + 1];                   // slot of clock c-k
  for (int k = threadIdx.x; k <= WMAX; k += blockDim.x) {
    int found = -1;
    if (k >= 1 && k <= W)
      for (int w = 0; w < W; ++w)
        if (uclock[w] == c - k) found = w;
    slot_of[k] = found;
  }
  __syncthreads();

  const int q = blockIdx.y;
  float mx[WMAX + 1];
#pragma unroll
  for (int k = 0; k <= WMAX; ++k) mx[k] = 0.f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  const float* prod = uring + (long long)q * d;        // row (w=0, q)
  const long long slot_stride = (long long)P * d;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float suffix = 0.f;
#pragma unroll
    for (int k = 1; k <= WMAX; ++k) {
      if (k > W) break;
      const int w = slot_of[k];
      if (w >= 0) suffix += __ldg(prod + w * slot_stride + j);
      mx[k] = nan_max(mx[k], fabsf(suffix));
    }
  }

  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 1; k <= WMAX; ++k) {
    if (k > W) break;
    float v = mx[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0)
      atomicMax(reinterpret_cast<int*>(norms + k * P + q), __float_as_int(v));
  }
}

template <int WMAX>
void launch_vap_suffix_norms(const float* uring, const int* uclock, int c,
                             float* norms, int W, int P, long long d,
                             cudaStream_t stream) {
  long long cap = (8LL * sm_count() + P - 1) / P;
  const long long bx = blocks_for(d, cap);
  const dim3 grid((unsigned)bx, (unsigned)P);
  vap_suffix_norms_kernel<WMAX><<<grid, THREADS, 0, stream>>>(
      uring, uclock, c, norms, W, P, d);
}

}  // namespace

extern "C" {

// P <= 64 and W <= 64 (kernels/ps_view.py checks both before a launch).
int ps_ring_view(const float* base, const float* uring, const int* uclock,
                 const int* cview, float* out, int W, int P, long long d,
                 cudaStream_t stream) {
  if (P <= 8)
    launch_ring_view<8>(base, uring, uclock, cview, out, W, P, d, stream);
  else if (P <= 16)
    launch_ring_view<16>(base, uring, uclock, cview, out, W, P, d, stream);
  else if (P <= 32)
    launch_ring_view<32>(base, uring, uclock, cview, out, W, P, d, stream);
  else
    launch_ring_view<64>(base, uring, uclock, cview, out, W, P, d, stream);
  return (int)cudaGetLastError();
}

int ps_vap_suffix_norms(const float* uring, const int* uclock, int c,
                        float* norms, int W, int P, long long d,
                        cudaStream_t stream) {
  if (W <= 8)
    launch_vap_suffix_norms<8>(uring, uclock, c, norms, W, P, d, stream);
  else if (W <= 16)
    launch_vap_suffix_norms<16>(uring, uclock, c, norms, W, P, d, stream);
  else if (W <= 32)
    launch_vap_suffix_norms<32>(uring, uclock, c, norms, W, P, d, stream);
  else
    launch_vap_suffix_norms<64>(uring, uclock, c, norms, W, P, d, stream);
  return (int)cudaGetLastError();
}

const char* ps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
