// Gather-and-row-sum kernels of the gather probes, hand-written for Hopper
// (sm_90a).  They answer, on the card, the question the TPU probes answered
// for the TPU: how should a row gather from a (Z, w) table be laid out over
// threads and memory?
//
// Replaces the Pallas kernels of the three probes under tools/ (each a
// gather followed by a row sum, out[n] = sum_j table[idx[n], j], except
// the last, a row copy):
//   gather_rowsum_coop        tools/probe_gather.py:104 `kernel` (pallas_gather),
//                             tools/probe_pallas_gather.py:99 `takeB_kernel`,
//                             tools/probe_vmem_gather.py:106 `take_kernel` and
//                             :142 `taa_kernel` (jnp.take and take_along_axis
//                             differ only in how Mosaic lowers the gather; on
//                             Hopper the two are one kernel);
//   gather_rowsum_persistent  tools/probe_pallas_gather.py:74 `take1_kernel`
//                             (one grid step over the whole pool);
//   gather_rowsum_rowloop     tools/probe_gather.py:133 `kernel2` (a scalar
//                             loop over the rows, pallas_loop);
//   gather_rowsum_smem        tools/probe_pallas_gather.py:125 `dsB_kernel`
//                             (rows copied one by one into a scratch tile,
//                             then summed);
//   row_gather_rowloop        tools/probe_vmem_gather.py:178 `ds_kernel`
//                             (out[n, :] = table[idx[n], :], one row per step).
//
// Contract (the TPU kernels'): table (Z, w) float32, contiguous, 16-byte
// aligned, w a multiple of 4; idx (N,) int32 in [0, Z), unchecked; out (N,)
// float32 for a row sum, (N, w) for the row copy.  Every kernel masks its
// own ragged edge, so N need not be a multiple of any block.
//
// What bounds them on the H100: bytes.  At N = Z = 65,536, w = 32 and
// uniform indices about Z (1 - 1/e) = 41,400 distinct rows are read once:
// a row sum moves 5.30 MB of rows, 0.26 MB of indices and 0.26 MB of
// output, 1.74 us at 3.35 TB/s; the row copy writes 8.39 MB more, 4.17 us.
// Up to w = 128 (33.5 MB) the table fits the 50 MB L2; at w = 216 and 256
// (56.6 and 67.1 MB) it does not.  The designs differ in how the row's
// bytes reach a thread:
//   coop        g neighbouring lanes (a power of two, at most 32 and at most
//               w/4) take one row, stride over its float4s with __ldg and
//               reduce with __shfl_xor_sync: a warp reads 32/g whole rows
//               per load, each in 16 B pieces (at w = 216 the 54 float4s
//               fall unevenly on 32 lanes);
//   persistent  the same body, (SM count x resident blocks) CTAs walking the
//               rows with a grid-stride loop;
//   rowloop     one thread per row, w scalar __ldg loads in order j = 0..w-1:
//               a warp touches 32 rows with every 4-byte load;
//   smem        a CTA stages its indices in shared memory, copies the rows
//               of a tile with cp.async (16 B a lane, L1 bypassed), waits,
//               then one thread per row sums from shared memory in order;
//               the row pitch is padded to an odd number of float4s so that
//               eight neighbouring threads' float4 reads hit distinct banks;
//   row_gather_rowloop  one thread per row copies its w/4 float4s: the
//               stores of a warp land on 32 rows (compare with
//               row_gather.cu's one thread per float4).
//
// Interface: the plain C convention of row_gather.cu: an array of device
// pointers (table, idx, out), an array of double scalars (w; for smem also
// the rows per CTA), the row count N and the CUDA stream; returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// Dynamic shared memory a block may take without the opt-in attribute,
// less the static index tile of the smem kernel.
constexpr int SMEM_TILE_BYTES = 48 * 1024 - THREADS * (int)sizeof(int32_t);
constexpr int MAX_DEVICES = 64;

// Sum of the float4s q = lane, lane + g, ... < w4 of one row.
__device__ __forceinline__ float row_part(const float4 *__restrict__ row, int w4,
                                          int lane, int g) {
  float s = 0.0f;
  for (int q = lane; q < w4; q += g) {
    const float4 v = __ldg(row + q);
    s += (v.x + v.y) + (v.z + v.w);
  }
  return s;
}

// Thread t of the (row, lane) pairs: lane `t % G` of row `t / G`.  Groups
// are aligned inside a warp, and a thread past the last row still takes
// part in the shuffles.
template <int G>
__device__ __forceinline__ void coop_row(const float4 *__restrict__ table,
                                         const int32_t *__restrict__ idx,
                                         float *__restrict__ out, int n, int w4,
                                         int64_t t) {
  const int64_t row = t / G;
  const int lane = (int)(t & (G - 1));
  float s = 0.0f;
  if (row < n) s = row_part(table + (int64_t)__ldg(idx + row) * w4, w4, lane, G);
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (row < n && lane == 0) out[row] = s;
}

template <int G>
__global__ void __launch_bounds__(THREADS)
    rowsum_coop_kernel(const float4 *__restrict__ table, const int32_t *__restrict__ idx,
                       float *__restrict__ out, int n, int w4) {
  coop_row<G>(table, idx, out, n, w4, (int64_t)blockIdx.x * THREADS + threadIdx.x);
}

template <int G>
__global__ void __launch_bounds__(THREADS)
    rowsum_persistent_kernel(const float4 *__restrict__ table,
                             const int32_t *__restrict__ idx, float *__restrict__ out,
                             int n, int w4) {
  const int64_t total = (int64_t)n * G;
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  // the bound is block-uniform, so every warp runs its shuffles whole
  for (int64_t base = (int64_t)blockIdx.x * THREADS; base < total; base += stride)
    coop_row<G>(table, idx, out, n, w4, base + threadIdx.x);
}

__global__ void __launch_bounds__(THREADS)
    rowsum_rowloop_kernel(const float *__restrict__ table, const int32_t *__restrict__ idx,
                          float *__restrict__ out, int n, int w) {
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;
  const float *src = table + (int64_t)__ldg(idx + row) * w;
  float s = 0.0f;
  for (int j = 0; j < w; ++j) s += __ldg(src + j);
  out[row] = s;
}

__device__ __forceinline__ void cp_async16(void *smem_dst, const void *gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// CTA b sums rows [b * blk, (b + 1) * blk) in tiles of `tile` rows (at most
// THREADS): the tile's indices into shared memory, its rows after them by
// cp.async at a pitch of s4 float4s, then one thread per row.
__global__ void __launch_bounds__(THREADS)
    rowsum_smem_kernel(const float4 *__restrict__ table, const int32_t *__restrict__ idx,
                       float *__restrict__ out, int n, int w4, int s4, int blk, int tile) {
  extern __shared__ float4 rows[];
  __shared__ int32_t ids[THREADS];
  const int64_t first = (int64_t)blockIdx.x * blk;
  const int64_t end = first + blk < n ? first + blk : (int64_t)n;
  for (int64_t r0 = first; r0 < end; r0 += tile) {
    const int nr = (int)(end - r0 < tile ? end - r0 : tile);
    if ((int)threadIdx.x < nr) ids[threadIdx.x] = __ldg(idx + r0 + threadIdx.x);
    __syncthreads();
    for (int e = threadIdx.x; e < nr * w4; e += THREADS) {
      const int r = e / w4;
      const int q = e - r * w4;
      cp_async16(rows + r * s4 + q, table + (int64_t)ids[r] * w4 + q);
    }
    cp_async_wait_all();
    __syncthreads();
    if ((int)threadIdx.x < nr) {
      const float4 *row = rows + threadIdx.x * s4;
      float s = 0.0f;
      for (int q = 0; q < w4; ++q) {
        const float4 v = row[q];
        s += v.x;
        s += v.y;
        s += v.z;
        s += v.w;
      }
      out[r0 + threadIdx.x] = s;
    }
    __syncthreads();  // the next tile overwrites ids and rows
  }
}

__global__ void __launch_bounds__(THREADS)
    row_gather_rowloop_kernel(const float4 *__restrict__ table,
                              const int32_t *__restrict__ idx, float4 *__restrict__ out,
                              int n, int w4) {
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;
  const float4 *src = table + (int64_t)__ldg(idx + row) * w4;
  float4 *dst = out + row * w4;
  for (int q = 0; q < w4; ++q) dst[q] = __ldg(src + q);
}

unsigned blocks_for(int64_t threads) { return (unsigned)((threads + THREADS - 1) / THREADS); }

// The group width of coop/persistent: the largest power of two that is at
// most 32 and at most w4.
int group_for(int w4) {
  int g = 1;
  while (g < 32 && 2 * g <= w4) g *= 2;
  return g;
}

int sm_count() {
  static int count[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    cudaDeviceProp prop;
    err = cudaGetDeviceProperties(&prop, dev);
    if (err != cudaSuccess) return -(int)err;
    count[dev] = prop.multiProcessorCount;
  }
  return count[dev];
}

template <int G>
int launch_rowsum(void **ptrs, int n, int w4, bool persistent, cudaStream_t stream) {
  const float4 *table = (const float4 *)ptrs[0];
  const int32_t *idx = (const int32_t *)ptrs[1];
  float *out = (float *)ptrs[2];
  if (!persistent) {
    rowsum_coop_kernel<G><<<blocks_for((int64_t)n * G), THREADS, 0, stream>>>(table, idx, out,
                                                                              n, w4);
    return (int)cudaGetLastError();
  }
  static int per_sm = 0;  // resident blocks of this instance on one SM
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rowsum_persistent_kernel<G>, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
  }
  const int sms = sm_count();
  if (sms < 0) return -sms;
  rowsum_persistent_kernel<G><<<sms * per_sm, THREADS, 0, stream>>>(table, idx, out, n, w4);
  return (int)cudaGetLastError();
}

int dispatch_rowsum(void **ptrs, const double *scal, int n, void *stream, bool persistent) {
  const int w4 = (int)scal[0] / 4;
  if (n <= 0) return (int)cudaGetLastError();
  if (w4 <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group_for(w4)) {
    case 1: return launch_rowsum<1>(ptrs, n, w4, persistent, st);
    case 2: return launch_rowsum<2>(ptrs, n, w4, persistent, st);
    case 4: return launch_rowsum<4>(ptrs, n, w4, persistent, st);
    case 8: return launch_rowsum<8>(ptrs, n, w4, persistent, st);
    case 16: return launch_rowsum<16>(ptrs, n, w4, persistent, st);
    default: return launch_rowsum<32>(ptrs, n, w4, persistent, st);
  }
}

}  // namespace

extern "C" {

int gather_rowsum_coop_nptrs() { return 3; }
int gather_rowsum_coop_nscal() { return 1; }
int gather_rowsum_coop_launch(void **ptrs, const double *scal, int n, void *stream) {
  return dispatch_rowsum(ptrs, scal, n, stream, false);
}

int gather_rowsum_persistent_nptrs() { return 3; }
int gather_rowsum_persistent_nscal() { return 1; }
int gather_rowsum_persistent_launch(void **ptrs, const double *scal, int n, void *stream) {
  return dispatch_rowsum(ptrs, scal, n, stream, true);
}

int gather_rowsum_rowloop_nptrs() { return 3; }
int gather_rowsum_rowloop_nscal() { return 1; }
int gather_rowsum_rowloop_launch(void **ptrs, const double *scal, int n, void *stream) {
  if (n > 0)
    rowsum_rowloop_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const float *)ptrs[0], (const int32_t *)ptrs[1], (float *)ptrs[2], n, (int)scal[0]);
  return (int)cudaGetLastError();
}

int gather_rowsum_smem_nptrs() { return 3; }
int gather_rowsum_smem_nscal() { return 2; }
int gather_rowsum_smem_launch(void **ptrs, const double *scal, int n, void *stream) {
  const int w4 = (int)scal[0] / 4;
  const int blk = (int)scal[1];
  const int s4 = w4 | 1;  // odd pitch: conflict-free float4 reads
  const int fit = SMEM_TILE_BYTES / (s4 * (int)sizeof(float4));
  const int tile = fit < THREADS ? fit : THREADS;
  if (w4 <= 0 || blk <= 0 || tile <= 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    rowsum_smem_kernel<<<(unsigned)((n + (int64_t)blk - 1) / blk), THREADS,
                         (size_t)tile * s4 * sizeof(float4), (cudaStream_t)stream>>>(
        (const float4 *)ptrs[0], (const int32_t *)ptrs[1], (float *)ptrs[2], n, w4, s4, blk,
        tile);
  return (int)cudaGetLastError();
}

int row_gather_rowloop_nptrs() { return 3; }
int row_gather_rowloop_nscal() { return 1; }
int row_gather_rowloop_launch(void **ptrs, const double *scal, int n, void *stream) {
  if (n > 0)
    row_gather_rowloop_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const float4 *)ptrs[0], (const int32_t *)ptrs[1], (float4 *)ptrs[2], n,
        (int)scal[0] / 4);
  return (int)cudaGetLastError();
}

}  // extern "C"
