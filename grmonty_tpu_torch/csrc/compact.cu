// The pool's order-preserving compaction, hand-written for Hopper (sm_90a):
// a bool mask's first k set lanes in ascending order, its tiles spread over
// the card's SMs (compact_tiles_kernel), or one block of 1,024 threads that
// packs the flagged rows of the event phase's staging buffer into the
// secondary ring in slot order (compact_rows_kernel<T>, float or double).
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
// Mask mode, design: redundant counting.  Block b of ceil(N / TILE) blocks
// owns the mask's bytes [b TILE, (b + 1) TILE), TILE = 4 KB, one unit a
// thread: 256 threads of 16 bytes above one tile (65,536 lanes: 16 blocks),
// one block of 1,024 threads of 4 bytes up to one tile (the cascade's 4,096
// and 512 lanes, where one block is already at the launch's floor: 256
// threads of 16 bytes took 4.6 us at 4,096 lanes against 1,024 threads'
// 3.9, sixteen writes a thread where those had four).  Every
// block reads the whole mask (64 KB at 65,536 lanes, from L2; sixteen
// 16-byte loads in flight a thread) and counts the set bytes before its
// tile and in all, keeping its own unit's set bytes as a bit mask; a block
// scan of those (each warp's by shuffles, the warps' sums by warp 0) gives
// each thread the rank of its unit's first set lane; the tile's set lanes
// whose rank is below k go to shared memory at their rank, and the block
// writes them out with consecutive ranks in consecutive threads; every
// block then writes its share of the pad [total, k) by a grid stride.  No
// workspace, no second launch, no state: the launch reads nothing on the
// host and a CUDA graph replays it as often as it likes.  Weighed against a
// single-pass scan with decoupled look-back (Merrill & Garland, 2016): that
// reads each tile once, but only the last tile learns the total that the
// pad starts at, so it needs either that one block to write the whole pad
// or every block to wait for the last, and a status word a tile in a
// workspace with a ticket counter for the epoch; the redundant count costs
// a block one more L2 pass over 64 KB and nothing else.  Measured (PERF.md,
// H100 80GB HBM3): 5.2-7.3 us at 65,536 lanes for every k of the path and
// every density, against torch.nonzero_static's 11.7-12.4 and the one-block
// scan's 6.4-31 (its passes of 8,192 ranks); eight loads in flight a thread
// took 7.6-9.6.  What bounds it on an H100 80GB HBM3: it reads the mask and
// writes 17 B a slot (0.19 us at k = 32,768 at 3.35 TB/s); the launch, the
// dependent L2 pass of the count and the block's barriers set its time.
//
// Rows mode, design: every width on the path (K <= 16,384 slots) is one
// block.  Thread t owns a contiguous run of the flags of C bytes (C the
// bytes a thread rounded up to whole 16-byte units) and counts its set bytes
// by 16-byte loads (byte loads where the run is short or unaligned); a
// block-wide exclusive scan by warp shuffles (each warp's inclusive scan,
// the warps' totals scanned by warp 0 through shared memory) gives each
// thread the rank of its first set flag; it then walks its run again and
// puts each flagged row whose rank is below the ring's room into shared
// memory at its rank, 8,192 ranks a pass, and the block copies the pass
// out with a row's 16-byte units in consecutive threads.
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

// ---- mask mode: the tiles over blocks ----

constexpr int TILE = 4096;  // a block's tile of the mask, in bytes

// A unit of UB mask bytes (16: uint4, 4: unsigned) and its set bytes as a
// UB-bit mask.
template <int UB> struct Unit;
template <> struct Unit<4> {
  using type = unsigned;
  static __device__ __forceinline__ type zero() { return 0u; }
  static __device__ __forceinline__ unsigned bits(unsigned w) {
    unsigned b = w | (w >> 4);  // bit 0 of each byte: the byte's OR
    b |= b >> 2;
    b |= b >> 1;
    b &= 0x01010101u;
    return (b | (b >> 7) | (b >> 14) | (b >> 21)) & 0xfu;
  }
};
template <> struct Unit<16> {
  using type = uint4;
  static __device__ __forceinline__ type zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ unsigned bits(type v) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
    unsigned out = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) out |= Unit<4>::bits(w[q]) << (4 * q);
    return out;
  }
};

// The set bytes of unit u (bytes [UB u, UB u + UB) of the n) by byte loads.
template <int UB>
__device__ __forceinline__ unsigned byte_bits(const u8 *mask, int n, int u) {
  unsigned bits = 0u;
  for (int j = 0; j < UB && UB * u + j < n; ++j) bits |= (unsigned)(mask[UB * u + j] != 0) << j;
  return bits;
}

// Thread t's units t, t + NT, ... of the mask: the set lanes before unit
// `first` and in all, and unit `mine`'s set bytes.  kVec: the mask is
// aligned to UB bytes, its whole units read by UB-byte loads AH at a time
// (the last, partial unit by bytes); else every unit by bytes.
template <int NT, int UB, int AH, bool kVec>
__device__ __forceinline__ void count_units(const u8 *mask, int n, int first, int mine,
                                            int &before, int &all, unsigned &own) {
  using U = Unit<UB>;
  const int units = (n + UB - 1) / UB, whole = n / UB;
  for (int u0 = (int)threadIdx.x; u0 < units; u0 += AH * NT) {
    unsigned bits[AH];
    if constexpr (kVec) {
      typename U::type v[AH];
#pragma unroll
      for (int q = 0; q < AH; ++q) {
        const int u = u0 + q * NT;
        v[q] = u < whole ? __ldg(reinterpret_cast<const typename U::type *>(mask) + u)
                         : U::zero();
      }
#pragma unroll
      for (int q = 0; q < AH; ++q) {
        const int u = u0 + q * NT;
        bits[q] = u < whole ? U::bits(v[q]) : (u < units ? byte_bits<UB>(mask, n, u) : 0u);
      }
    } else {
#pragma unroll
      for (int q = 0; q < AH; ++q) {
        const int u = u0 + q * NT;
        bits[q] = u < units ? byte_bits<UB>(mask, n, u) : 0u;
      }
    }
#pragma unroll
    for (int q = 0; q < AH; ++q) {
      const int u = u0 + q * NT, c = __popc(bits[q]);
      all += c;
      before += u < first ? c : 0;
      own = u == mine ? bits[q] : own;
    }
  }
}

// Block b of NT threads owns the mask's bytes [b TILE, (b + 1) TILE), a unit
// of UB bytes a thread (NT UB = TILE), and counts the whole mask AH units a
// thread at a time.
template <int NT, int UB, int AH>
__global__ void __launch_bounds__(NT)
    compact_tiles_kernel(const u8 *__restrict__ mask, int n, int k, u8 *__restrict__ valid,
                         int64_t *__restrict__ gi, int64_t *__restrict__ sidx) {
  static_assert(NT * UB == TILE, "a thread's unit of the block's tile");
  constexpr int W = NT / 32;
  __shared__ int at[TILE];  // the tile's set lanes by rank within it
  __shared__ int w_before[W], w_all[W], w_tile[W], w_tile_n;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int first = (int)blockIdx.x * NT;
  // every unit, thread t taking t, t + NT, ...: the set lanes before this
  // tile and in all; the tile's unit first + t comes by in pass blockIdx.x
  int before = 0, all = 0;
  unsigned own = 0u;
  if (((uintptr_t)mask & (UB - 1)) == 0)
    count_units<NT, UB, AH, true>(mask, n, first, first + t, before, all, own);
  else
    count_units<NT, UB, AH, false>(mask, n, first, first + t, before, all, own);
  // the tile's ranks: each warp's inclusive scan, the sums through shared memory
  const int c = __popc(own);
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  before = __reduce_add_sync(FULL, before);
  all = __reduce_add_sync(FULL, all);
  if (lane == 31) {
    w_before[warp] = before;
    w_all[warp] = all;
    w_tile[warp] = x;
  }
  __syncthreads();
  if (warp == 0) {  // the warps' sums: their exclusive scan, the totals
    const int b = lane < W ? w_before[lane] : 0, a = lane < W ? w_all[lane] : 0;
    const int v = lane < W ? w_tile[lane] : 0;
    int y = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(FULL, y, d);
      if (lane >= d) y += z;
    }
    const int sb = __reduce_add_sync(FULL, b), sa = __reduce_add_sync(FULL, a);
    __syncwarp();  // every lane's loads before the stores
    if (lane < W) w_tile[lane] = y - v;
    if (lane == 31) {
      w_before[0] = sb;
      w_all[0] = sa;
      w_tile_n = y;
    }
  }
  __syncthreads();
  const int base = w_before[0], total = w_all[0], tile = w_tile_n;
  int rank = x - c + w_tile[warp];
  // the tile's set lanes of rank below k, staged by rank, written out by
  // consecutive ranks in consecutive threads
  const int keep = min(tile, k - base);
  if (keep > 0) {
    for (unsigned b = own; b && rank < keep; b &= b - 1)
      at[rank++] = UB * (first + t) + __ffs((int)b) - 1;
    __syncthreads();
    for (int q = t; q < keep; q += NT) {
      const int j = at[q];
      valid[base + q] = 1;
      gi[base + q] = j;
      sidx[base + q] = j;
    }
  }
  // the pad, a grid stride
  for (int q = total + first + t; q < k; q += (int)gridDim.x * NT) {
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
  if (n > 0 && k > 0) {
    const u8 *mask = (const u8 *)ptrs[0];
    u8 *valid = (u8 *)ptrs[1];
    int64_t *gi = (int64_t *)ptrs[2], *sidx = (int64_t *)ptrs[3];
    const cudaStream_t s = (cudaStream_t)stream;
    if (n <= TILE)  // one block: 1,024 threads of 4 bytes, one load each
      compact_tiles_kernel<1024, 4, 1><<<1, 1024, 0, s>>>(mask, n, k, valid, gi, sidx);
    else  // 256 threads of 16 bytes a block, 16 loads in flight a thread
      compact_tiles_kernel<256, 16, 16><<<(n + TILE - 1) / TILE, 256, 0, s>>>(mask, n, k, valid,
                                                                           gi, sidx);
  }
  return (int)cudaGetLastError();
}

int compact_rows_launch(void **ptrs, const double *scal, int k, void *stream) {
  return launch_rows<float>(ptrs, scal, k, stream);
}

int compact_rows_f64_launch(void **ptrs, const double *scal, int k, void *stream) {
  return launch_rows<double>(ptrs, scal, k, stream);
}

}  // extern "C"
