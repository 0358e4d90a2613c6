// The pool's order-preserving compaction, hand-written for Hopper (sm_90a):
// one block of 1,024 threads scans a bool mask and writes the first k set
// lanes in ascending order (compact_kernel), or packs the flagged rows of
// the event phase's staging buffer into the secondary ring in slot order
// (compact_rows_kernel<T>, float or double).
//
// No TPU kernel does this: the JAX engine's compact_idx is one XLA sort of
// the keys where(mask, lane, n) (grmonty_tpu/transport/engine.py:1956-1975),
// and the ring's pack a cumsum and a scatter (:2036 `process_scatters`).
// The port's plain versions (engine.compact_idx, engine.pack_rows_plain) do
// the same as torch ops; on the card the sort of 65,536 int64 keys is a
// radix sort of several launches, and the full phase runs three of them.
//
//   - compact (mask mode): mask (N,) bool -> valid (k,) bool, gi (k,) int64
//     and sidx (k,) int64: the r-th set lane for r below the set count
//     (valid, gi = sidx = the lane), then the pad (not valid, gi = N - 1,
//     sidx = N), bit for bit what the sort gives;
//   - compact_rows (rows mode): the staged rows (K, 16) and their flags
//     make (K,) -> the r-th flagged row into ring[count + r] where count + r
//     < cap; count += the rows kept, n_drop += the rows dropped.  The ring's
//     order is the slots' (the lanes' ascending order, as the cumsum gives
//     it): refill takes the ring last in, first out, so no atomic picks a
//     row's place.
//
// Design: every width on the path (N <= 65,536 lanes, K <= 8,192 slots) is
// one block.  Thread t owns a contiguous run of the mask of C bytes (C the
// bytes a thread rounded up to whole 16-byte units: 64 at 65,536 lanes) and
// counts its set bytes by 16-byte loads (byte loads where the run is short
// or the mask unaligned); a block-wide exclusive scan by warp shuffles (each
// warp's inclusive scan, the warps' totals scanned by warp 0 through shared
// memory) gives each thread the rank of its first set lane; it then walks
// its run again and puts each set lane whose rank is below k (rows mode:
// below the ring's room) into shared memory at its rank, 8,192 ranks a pass,
// and the block writes the pass out with consecutive ranks in consecutive
// threads (rows mode: a row's 16-byte units in consecutive threads), then
// the pad.  A thread that wrote its own set lanes straight out scattered a
// warp's stores over 32 places: 26 us at 65,536 lanes and k = 8,192, 63 at
// k = 32,768 (PERF.md).  What bounds it on an H100 80GB HBM3: at 65,536
// lanes and k = 8,192 it reads 64 KB and writes 139 KB (0.06 us at 3.35
// TB/s); one block's passes and its scan's barriers, not the card's rates,
// set its time.
//
// Interface: plain C entry points for ctypes, as the other kernels: compact
// (pointers mask, valid, gi, sidx; scalar k; the lane count N),
// compact_rows and compact_rows_f64 (pointers make, rows, ring, count,
// n_drop; scalar the ring's capacity; the slot count K), each with its
// <entry>_nptrs and _nscal; each returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned char u8;

namespace {

constexpr int CT = 1024;  // the block
constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW = 16;  // a staged or ring row (engine.ROW_WIDTH)

// The set bytes (nonzero) of a 16-byte unit.
__device__ __forceinline__ int set_bytes(uint4 v) {
  int c = 0;
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned b = w[q] | (w[q] >> 4);
    b |= b >> 2;
    b |= b >> 1;
    c += __popc(b & 0x01010101u);
  }
  return c;
}

// Thread t's run of the flags [lo, hi) and whether it reads it by 16-byte
// units: C bytes a thread, whole units of 16.
struct Run {
  int lo, hi;
  bool vec;
};

__device__ __forceinline__ Run run_of(const u8 *flags, int n) {
  const int c = (((n + CT - 1) / CT) + 15) & ~15;
  const int lo = min((int)threadIdx.x * c, n), hi = min(lo + c, n);
  return {lo, hi, ((uintptr_t)(flags + lo) & 15) == 0 && ((hi - lo) & 15) == 0};
}

// Call f(j) for each set flag j of the run, in ascending order, until f
// returns false.
template <typename F>
__device__ __forceinline__ void each_set(const u8 *flags, const Run &r, F f) {
  if (r.vec) {
    for (int q = r.lo; q < r.hi; q += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4 *>(flags + q));
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if ((w[b >> 2] >> (8 * (b & 3))) & 0xffu)
          if (!f(q + b)) return;
    }
  } else {
    for (int j = r.lo; j < r.hi; ++j)
      if (flags[j])
        if (!f(j)) return;
  }
}

// The run's set flags.
__device__ __forceinline__ int count_set(const u8 *flags, const Run &r) {
  int c = 0;
  if (r.vec) {
    for (int q = r.lo; q < r.hi; q += 16)
      c += set_bytes(__ldg(reinterpret_cast<const uint4 *>(flags + q)));
  } else {
    for (int j = r.lo; j < r.hi; ++j) c += flags[j] != 0;
  }
  return c;
}

// The block's exclusive scan of c: this thread's offset, and the total.
__device__ __forceinline__ int block_scan(int c, int &total) {
  __shared__ int warp_sum[CT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, v, d);
      if (lane >= d) v += y;
    }
    warp_sum[lane] = v;  // inclusive over the warps
  }
  __syncthreads();
  total = warp_sum[CT / 32 - 1];
  return x - c + (warp ? warp_sum[warp - 1] : 0);
}

// The ranks staged a pass: 32 KB of indices in shared memory.
constexpr int CHUNK = 8192;

// For each pass of CHUNK ranks below `limit`: the run's set flags whose rank
// falls in the pass go to shared memory at their rank (this thread's first
// set flag has rank `rank0`, its `cnt` of them ranks on from there), then
// every thread of the block calls out(base, end, at): ranks [base, end),
// the flag of rank base + q at at[q].  The writes that follow run over
// consecutive ranks in consecutive threads.
template <typename F>
__device__ __forceinline__ void by_rank(const u8 *flags, const Run &r, int rank0, int cnt,
                                        int limit, F out) {
  __shared__ int at[CHUNK];
  for (int base = 0; base < limit; base += CHUNK) {
    const int end = min(base + CHUNK, limit);
    if (rank0 < end && rank0 + cnt > base) {
      int rank = rank0;
      each_set(flags, r, [&](int j) {
        if (rank >= base) at[rank - base] = j;
        return ++rank < end;
      });
    }
    __syncthreads();
    out(base, end, at);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(CT)
    compact_kernel(const u8 *__restrict__ mask, int n, int k, u8 *__restrict__ valid,
                   int64_t *__restrict__ gi, int64_t *__restrict__ sidx) {
  const Run r = run_of(mask, n);
  const int cnt = count_set(mask, r);
  int total;
  const int rank0 = block_scan(cnt, total);
  by_rank(mask, r, rank0, cnt, min(total, k), [&](int base, int end, const int *at) {
    for (int q = base + (int)threadIdx.x; q < end; q += CT) {
      const int j = at[q - base];
      valid[q] = 1;
      gi[q] = j;
      sidx[q] = j;
    }
  });
  for (int q = total + (int)threadIdx.x; q < k; q += CT) {  // the pad
    valid[q] = 0;
    gi[q] = n - 1;
    sidx[q] = n;
  }
}

template <typename T>
__global__ void __launch_bounds__(CT)
    compact_rows_kernel(const u8 *__restrict__ make, const T *__restrict__ rows, int k,
                        T *__restrict__ ring, int64_t *count, int64_t cap, int64_t *n_drop) {
  using V = uint4;  // rows and ring 16-byte aligned; a row is ROW * sizeof(T) / 16 units
  constexpr int U = ROW * sizeof(T) / 16;
  const int64_t c0 = *count;  // read by every thread before the scan's barriers
  const int64_t room = cap > c0 ? cap - c0 : 0;
  const Run r = run_of(make, k);
  const int cnt = count_set(make, r);
  int total;
  const int rank0 = block_scan(cnt, total);
  const int kept = total < room ? total : (int)room;
  const V *src = reinterpret_cast<const V *>(rows);
  V *dst = reinterpret_cast<V *>(ring + (size_t)c0 * ROW);
  // unit u of the row of rank q in thread q U + u of the pass: whole rows in
  // consecutive threads
  by_rank(make, r, rank0, cnt, kept, [&](int base, int end, const int *at) {
    for (int e = (int)threadIdx.x; e < (end - base) * U; e += CT) {
      const int q = e / U, u = e - q * U;
      dst[(size_t)(base + q) * U + u] = __ldg(src + (size_t)at[q] * U + u);
    }
  });
  if (threadIdx.x == 0) {
    *count = c0 + kept;
    *n_drop += total - kept;
  }
}

template <typename T>
int launch_rows(void **ptrs, const double *scal, int k, void *stream) {
  if (k > 0)
    compact_rows_kernel<T><<<1, CT, 0, (cudaStream_t)stream>>>(
        (const u8 *)ptrs[0], (const T *)ptrs[1], k, (T *)ptrs[2], (int64_t *)ptrs[3],
        (int64_t)scal[0], (int64_t *)ptrs[4]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int compact_nptrs() { return 4; }
int compact_nscal() { return 1; }
int compact_rows_nptrs() { return 5; }
int compact_rows_nscal() { return 1; }
int compact_rows_f64_nptrs() { return 5; }
int compact_rows_f64_nscal() { return 1; }

int compact_launch(void **ptrs, const double *scal, int n, void *stream) {
  const int k = (int)scal[0];
  if (n > 0 && k > 0)
    compact_kernel<<<1, CT, 0, (cudaStream_t)stream>>>(
        (const u8 *)ptrs[0], n, k, (u8 *)ptrs[1], (int64_t *)ptrs[2], (int64_t *)ptrs[3]);
  return (int)cudaGetLastError();
}

int compact_rows_launch(void **ptrs, const double *scal, int k, void *stream) {
  return launch_rows<float>(ptrs, scal, k, stream);
}

int compact_rows_f64_launch(void **ptrs, const double *scal, int k, void *stream) {
  return launch_rows<double>(ptrs, scal, k, stream);
}

}  // extern "C"
