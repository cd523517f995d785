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

#include "mbarrier.cuh"

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
// uring[w, q, j], visible iff RING_INVALID < uclock[w] <= cview[r, q], for
// R <= P readers: cview is [R, P] and out [R, d].  The simulator passes all
// P readers; a shard of the sharded runtime (psrun) passes its own reader
// rows over its own column block of the ring.
//
// Bound: bytes.  The ring is read once and the views written once:
// (W*P*d + R*d + d) * 4 bytes for W*P*R*d adds, far below the card's
// operation rate; R (4-16) is far below any tensor-core tile, so the sums run
// on CUDA cores.  Design: the [R, W*P] visibility mask is reduced per block to
// one 64-bit reader mask per ring row (w, q) in shared memory, computed once
// per block; blocks then stride over the columns.  Each thread owns one
// column at a time, loads every visible ring row's value once (four rows in
// flight) and adds it into RMAX per-reader register accumulators in (w, q)
// order; base is added last, as in the plain version.  A view element's
// adds therefore run in the same order whatever R, d and the column's
// offset are: a shard's views equal the same rows and columns of the whole
// matrix's bit for bit.  Ring rows that no reader sees are not read.  The
// ragged tail of d is masked by the column loop bound.  It is not fused with
// vap_suffix_norms: under VAP the views' clocks cview come from enforce_vap,
// which reads those norms (core/ps.py), so the norms of a clock must be
// complete before its views are read.
template <int RMAX>
__global__ void __launch_bounds__(THREADS)
ring_view_kernel(const float* __restrict__ base, const float* __restrict__ uring,
                 const int* __restrict__ uclock, const int* __restrict__ cview,
                 float* __restrict__ out, int W, int P, int R, long long d) {
  extern __shared__ unsigned long long vis[];          // [W*P] reader bits
  const int S = W * P;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int w = s / P, q = s - w * P;
    const int uc = uclock[w];
    unsigned long long m = 0ull;
    if (uc > RING_INVALID)
      for (int r = 0; r < R; ++r)
        if (uc <= cview[r * P + q]) m |= 1ull << r;
    vis[s] = m;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
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
      for (int r = 0; r < RMAX; ++r) {
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
      for (int r = 0; r < RMAX; ++r)
        if ((m >> r) & 1ull) acc[r] += u;
    }
    const float b = __ldg(base + j);
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < R) out[(long long)r * d + j] = b + acc[r];
  }
}

template <int RMAX>
void launch_ring_view(const float* base, const float* uring, const int* uclock,
                      const int* cview, float* out, int W, int P, int R,
                      long long d, cudaStream_t stream) {
  const long long blocks = blocks_for(d, 8LL * sm_count());
  const size_t smem = sizeof(unsigned long long) * (size_t)W * P;
  ring_view_kernel<RMAX><<<(unsigned)blocks, THREADS, smem, stream>>>(
      base, uring, uclock, cview, out, W, P, R, d);
}

// ---------------------------------------------------------------------------
// vap_suffix_norms
//
// Replaces the TPU kernel repro/kernels/ps_view.py::vap_suffix_norms
// (_suffix_norms_kernel): norms[k, q] = max_j |sum_{i=1..k} u_q(c-i)[j]| for
// k = 1..W, where u_q(c') is the ring row of producer q in the slot holding
// clock c' (absent clocks add nothing); norms[0] = 0.  The suffix is a
// float32 running sum taken in k order for each column, as in the plain
// version and the TPU kernel, so all three agree exactly.
//
// Bound: bytes, slots*P*d*4: each slot that holds one of the clocks
// c-W..c-1 is read once (3.56 GB, 1.06 ms at 3.35 TB/s for the fault path's
// W = 22, P = 8, d = 5,053,800); the output is [W+1, P] and the work one add
// and one abs-and-max per element read.
//
// Design (vap_norms_bulk, every ring whose rows are 16-byte aligned): the
// card streams at its memory rate only with some 25-40 KB in flight per SM,
// whatever W is, so the loads are taken out of the threads' registers
// (a thread walking W slots with one load in flight reached 36 % of the
// bound at W = 22).  Persistent CTAs (at most VAP_CTAS_PER_SM an SM, so
// 64 KB in flight an SM) each take a contiguous run
// of work items (producer q, tile of VAP_TILE columns).  One thread of the
// producer warp issues, for each item and k = 1..W in order, one 1-D bulk
// async copy (TMA) of row (slot of clock c-k, q)'s tile into a ring of
// VAP_STAGES stages in shared memory, each with a full and an empty mbarrier;
// an absent clock issues no copy, and the ragged last tile copies only its
// columns.  Eight consumer warps hold the tile's running suffix in registers
// (two float4 a thread), add each stage as it arrives, release it (one
// arrive a warp), and fold max|suffix| into a per-thread maximum for each k
// kept in shared memory, since k is a runtime index.  Columns past the
// ragged tile's end are never read from the stage.  On the H100 the kernel
// takes as long as its copies alone, and 2, 4 or 8 stages, 1-3 CTAs an SM
// or tiles of 1024-4096 columns move it by under 3 % (vap_ablation.py).
// When a CTA's item moves
// to another producer, and at its end, each warp folds its maxima with
// shuffles and one atomicMax per k on the float's bits.  That fold is valid
// in any order because every norm is >= +0, whose int bit patterns order
// like the floats; NaN (0x7fc00000) orders above +inf, so a NaN propagates as
// it does through the plain version's max.  The wrapper zeroes the output.
// The clock c arrives as a kernel argument, so no host sync is needed; each
// CTA finds the slot of clock c-k once.
//
// Rows that are not 16-byte aligned (d % 4 != 0, or a ring that starts off
// a 16-byte boundary) cannot take a bulk copy; they go through
// vap_norms_regs, a thread per column that issues all W loads of its column
// before the adds, with the per-k maxima in registers (one instance per
// window class, W <= 8, 16, 32, 64).
//
// Not fused with ring_view: under VAP the views' clocks come from
// enforce_vap, which reads these norms (core/ps.py), so within a clock the
// norms must be complete before the views are read.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

constexpr int MAX_W = 64;         // kernels/ps_view.py checks it
constexpr int VAP_TILE = 2048;    // columns of a work item (ps_view.VAP_TILE)
constexpr int VAP_STAGES = 4;     // 8 KB stages in flight per CTA
constexpr int VAP_CTAS_PER_SM = 2;
constexpr int VAP_WARPS = 8;      // consumer warps
constexpr int VAP_CONSUMERS = 32 * VAP_WARPS;
constexpr int VAP_THREADS = VAP_CONSUMERS + 32;  // and one producer warp
constexpr int VAP_VEC = VAP_TILE / 4 / VAP_CONSUMERS;  // float4 a thread
static_assert(VAP_VEC * 4 * VAP_CONSUMERS == VAP_TILE, "tile split");

// `bytes` (a multiple of 16) from 16-byte aligned device memory into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Dynamic shared memory of vap_norms_bulk for window W: the stages, their
// full and empty mbarriers, and (W+1) maxima per consumer thread.
size_t vap_bulk_smem(int W) {
  return sizeof(float) * VAP_STAGES * VAP_TILE + 16 * VAP_STAGES +
         sizeof(float) * (size_t)(W + 1) * VAP_CONSUMERS;
}

__global__ void __launch_bounds__(VAP_THREADS)
vap_norms_bulk(const float* __restrict__ uring, const int* __restrict__ uclock,
               int c, float* __restrict__ norms, int W, int P, long long d) {
  extern __shared__ __align__(16) unsigned char vsm[];
  __shared__ int slot_of[MAX_W + 1];                 // slot of clock c-k
  float* stage = reinterpret_cast<float*>(vsm);
  const uint32_t bar = smem_u32(vsm + sizeof(float) * VAP_STAGES * VAP_TILE);
  float* mx = reinterpret_cast<float*>(vsm + sizeof(float) * VAP_STAGES *
                                                 VAP_TILE + 16 * VAP_STAGES);
#define VAP_FULL(s) (bar + 8 * (s))
#define VAP_EMPTY(s) (bar + 8 * (VAP_STAGES + (s)))
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int k = tid; k <= W; k += blockDim.x) {
    int found = -1;
    if (k >= 1)
      for (int w = 0; w < W; ++w)
        if (uclock[w] == c - k) found = w;
    slot_of[k] = found;
  }
  if (tid == 0) {
    for (int s = 0; s < VAP_STAGES; ++s) {
      mbar_init(VAP_FULL(s), 1);
      mbar_init(VAP_EMPTY(s), VAP_WARPS);   // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long n_tiles = (d + VAP_TILE - 1) / VAP_TILE;
  const long long n_items = n_tiles * P;
  const long long first = n_items * blockIdx.x / gridDim.x;
  const long long last = n_items * (blockIdx.x + 1) / gridDim.x;
  const long long slot_stride = (long long)P * d;

  if (warp == VAP_WARPS) {
    // ---- producer: one thread keeps the ring's stages in flight ----
    if (lane == 0) {
      uint32_t it = 0;                         // stages filled so far
      for (long long item = first; item < last; ++item) {
        const long long q = item / n_tiles;
        const long long j0 = (item - q * n_tiles) * VAP_TILE;
        const long long n = d - j0 < VAP_TILE ? d - j0 : VAP_TILE;
        const uint32_t bytes = (uint32_t)(n * sizeof(float));
        const float* src = uring + q * d + j0;
        for (int k = 1; k <= W; ++k) {
          const int w = slot_of[k];
          if (w < 0) continue;
          const int s = it % VAP_STAGES;
          mbar_wait(VAP_EMPTY(s), ((it / VAP_STAGES) & 1) ^ 1);
          mbar_expect_tx(VAP_FULL(s), bytes);
          bulk_load(smem_u32(stage + s * VAP_TILE), src + w * slot_stride,
                    bytes, VAP_FULL(s));
          ++it;
        }
      }
    }
    return;
  }

  // ---- consumers: the running suffix of the tile's columns ----
  float* my_mx = mx + tid;                     // my_mx[k * VAP_CONSUMERS]
  for (int k = 0; k <= W; ++k) my_mx[k * VAP_CONSUMERS] = 0.f;
  uint32_t it = 0;
  long long cur_q = -1;
  for (long long item = first; item <= last; ++item) {
    const long long q = item < last ? item / n_tiles : -1;
    if (q != cur_q && cur_q >= 0) {
      // fold this thread's maxima of producer cur_q into norms
      for (int k = 1; k <= W; ++k) {
        float v = my_mx[k * VAP_CONSUMERS];
        my_mx[k * VAP_CONSUMERS] = 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
        if (lane == 0)
          atomicMax(reinterpret_cast<int*>(norms + k * P + cur_q),
                    __float_as_int(v));
      }
    }
    if (item == last) break;
    cur_q = q;
    const long long j0 = (item - q * n_tiles) * VAP_TILE;
    const long long n = d - j0 < VAP_TILE ? d - j0 : VAP_TILE;
    float4 suf[VAP_VEC];
    bool live[VAP_VEC];
#pragma unroll
    for (int i = 0; i < VAP_VEC; ++i) {
      suf[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      live[i] = 4LL * (tid + i * VAP_CONSUMERS) < n;  // n % 4 == 0 here
    }
    for (int k = 1; k <= W; ++k) {
      if (slot_of[k] >= 0) {
        const int s = it % VAP_STAGES;
        mbar_wait(VAP_FULL(s), (it / VAP_STAGES) & 1);
        const float4* st =
            reinterpret_cast<const float4*>(stage + s * VAP_TILE);
#pragma unroll
        for (int i = 0; i < VAP_VEC; ++i) {
          if (live[i]) {
            const float4 u = st[tid + i * VAP_CONSUMERS];
            suf[i].x += u.x;
            suf[i].y += u.y;
            suf[i].z += u.z;
            suf[i].w += u.w;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(VAP_EMPTY(s));
        ++it;
      }
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < VAP_VEC; ++i) {
        m = nan_max(m, fabsf(suf[i].x));
        m = nan_max(m, fabsf(suf[i].y));
        m = nan_max(m, fabsf(suf[i].z));
        m = nan_max(m, fabsf(suf[i].w));
      }
      my_mx[k * VAP_CONSUMERS] = nan_max(my_mx[k * VAP_CONSUMERS], m);
    }
  }
#undef VAP_FULL
#undef VAP_EMPTY
}

template <int WMAX>
__global__ void __launch_bounds__(THREADS)
vap_norms_regs(const float* __restrict__ uring, const int* __restrict__ uclock,
               int c, float* __restrict__ norms, int W, int P, long long d) {
  __shared__ long long off_of[WMAX + 1];   // offset of clock c-k's row, or -1
  const long long slot_stride = (long long)P * d;
  for (int k = threadIdx.x; k <= WMAX; k += blockDim.x) {
    int found = -1;
    if (k >= 1 && k <= W)
      for (int w = 0; w < W; ++w)
        if (uclock[w] == c - k) found = w;
    off_of[k] = found < 0 ? -1LL : found * slot_stride;
  }
  __syncthreads();

  const int q = blockIdx.y;
  float mx[WMAX + 1];
#pragma unroll
  for (int k = 0; k <= WMAX; ++k) mx[k] = 0.f;

  const long long stride = (long long)gridDim.x * blockDim.x;
  const float* prod = uring + (long long)q * d;        // row (w=0, q)
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float u[WMAX];
#pragma unroll
    for (int k = 1; k <= WMAX; ++k) {          // every load before the adds
      const long long o = off_of[k];
      u[k - 1] = o >= 0 ? __ldg(prod + o + j) : 0.f;
    }
    float suffix = 0.f;
#pragma unroll
    for (int k = 1; k <= WMAX; ++k) {
      suffix += u[k - 1];
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
void launch_vap_regs(const float* uring, const int* uclock, int c,
                     float* norms, int W, int P, long long d,
                     cudaStream_t stream) {
  long long cap = (8LL * sm_count() + P - 1) / P;
  const long long bx = blocks_for(d, cap);
  const dim3 grid((unsigned)bx, (unsigned)P);
  vap_norms_regs<WMAX><<<grid, THREADS, 0, stream>>>(uring, uclock, c, norms,
                                                      W, P, d);
}

cudaError_t launch_vap_bulk(const float* uring, const int* uclock, int c,
                            float* norms, int W, int P, long long d,
                            cudaStream_t stream) {
  static int per_sm[MAX_W + 1];       // CTAs an SM holds, by window
  if (per_sm[W] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        vap_norms_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)vap_bulk_smem(MAX_W));
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, vap_norms_bulk, VAP_THREADS, vap_bulk_smem(W));
    if (err != cudaSuccess) return err;
    per_sm[W] = n < 1 ? 1 : (n > VAP_CTAS_PER_SM ? VAP_CTAS_PER_SM : n);
  }
  const long long n_items = (d + VAP_TILE - 1) / VAP_TILE * P;
  long long grid = (long long)per_sm[W] * sm_count();
  if (grid > n_items) grid = n_items;
  vap_norms_bulk<<<(unsigned)grid, VAP_THREADS, vap_bulk_smem(W), stream>>>(
      uring, uclock, c, norms, W, P, d);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// R <= P <= 64 and W <= 64 (kernels/ps_view.py checks them before a launch).
int ps_ring_view(const float* base, const float* uring, const int* uclock,
                 const int* cview, float* out, int W, int P, int R,
                 long long d, cudaStream_t stream) {
  if (R <= 8)
    launch_ring_view<8>(base, uring, uclock, cview, out, W, P, R, d, stream);
  else if (R <= 16)
    launch_ring_view<16>(base, uring, uclock, cview, out, W, P, R, d, stream);
  else if (R <= 32)
    launch_ring_view<32>(base, uring, uclock, cview, out, W, P, R, d, stream);
  else
    launch_ring_view<64>(base, uring, uclock, cview, out, W, P, R, d, stream);
  return (int)cudaGetLastError();
}

int ps_vap_suffix_norms(const float* uring, const int* uclock, int c,
                        float* norms, int W, int P, long long d,
                        cudaStream_t stream) {
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(uring) % 16 == 0) {
    const cudaError_t err =
        launch_vap_bulk(uring, uclock, c, norms, W, P, d, stream);
    if (err != cudaSuccess) return (int)err;
  } else if (W <= 8) {
    launch_vap_regs<8>(uring, uclock, c, norms, W, P, d, stream);
  } else if (W <= 16) {
    launch_vap_regs<16>(uring, uclock, c, norms, W, P, d, stream);
  } else if (W <= 32) {
    launch_vap_regs<32>(uring, uclock, c, norms, W, P, d, stream);
  } else {
    launch_vap_regs<64>(uring, uclock, c, norms, W, P, d, stream);
  }
  return (int)cudaGetLastError();
}

const char* ps_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
