// The pool's order-preserving compaction, hand-written for Hopper (sm_90a):
// a bool mask's first k set lanes in ascending order, its tiles spread over
// the card's SMs (compact_tiles_kernel), and the pack of the event phase's
// flagged staged rows into the secondary ring in slot order, its tiles of
// slots spread the same way (compact_rows_kernel<T, NT>, float or double).
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
//     sidx = N), bit for bit what the sort gives; inverted, the same of the
//     clear lanes (refill's free lanes from the occupied mask);
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
// Rows mode, design: the mask mode's redundant counting over tiles of NT
// slots, one flag a thread (rows_threads: 128-slot tiles above 512 slots,
// 128 blocks at the wave's 16,384; one block up to 512, the cascade's 512
// and the gate's 256, which needs no ticket).  Every block counts
// the flags before its tile and in all from L2 (16 KB at K = 16,384, eight
// 16-byte loads in flight a thread), ranks its tile's flags by ballots and
// the warps' counts, stages the slots of its flagged rows whose rank is
// below the ring's room in shared memory by rank, and copies them with a
// row's 16-byte units in consecutive threads to ring[count + rank].  The
// hazard is the count, which every block reads and which only the kept
// rows' total may update: each block's thread 0 reads it first, and after
// its copies takes a ticket (one atomic add on a word that the ring's
// owner allocates beside its count, zero between launches); the block
// that takes the last ticket knows every block has read the count, writes
// the count and n_drop and resets the ticket to 0, so a replayed CUDA graph
// finds it at zero.  The launch reads nothing on the host.  What bounds it
// on an H100 80GB HBM3: the flags once and the kept rows read and written
// once (64 B a row in float: 0.25 us at 13,000 rows at 3.35 TB/s); the
// launch, the count's dependent L2 pass and the ticket set its time.  The
// one block of 1,024 threads before it took 14.1 us at 6,489 rows
// of 16,384 slots and 30 us on the path's 13,000.
//
// Interface: plain C entry points for ctypes, as the other kernels: compact
// (pointers mask, valid, gi, sidx; scalars k and whether inverted; the lane
// count N),
// compact_rows and compact_rows_f64 (pointers make, rows, ring, count,
// n_drop, ticket; scalar the ring's capacity; the slot count K), each with its
// <entry>_nptrs and _nscal; each returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned char u8;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROW = 16;  // a staged or ring row (engine.ROW_WIDTH)

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

// The set bytes of unit u (bytes [UB u, UB u + UB) of the n) by byte loads
// (under inv, the clear bytes).
template <int UB>
__device__ __forceinline__ unsigned byte_bits(const u8 *mask, int n, int u, bool inv) {
  unsigned bits = 0u;
  for (int j = 0; j < UB && UB * u + j < n; ++j)
    bits |= (unsigned)((mask[UB * u + j] != 0) != inv) << j;
  return bits;
}

// Thread t's units t, t + NT, ... of the mask: the set lanes before unit
// `first` and in all, and unit `mine`'s set bytes (under inv, the clear
// lanes).  kVec: the mask is aligned to UB bytes, its whole units read by
// UB-byte loads AH at a time (the last, partial unit by bytes); else every
// unit by bytes.
template <int NT, int UB, int AH, bool kVec>
__device__ __forceinline__ void count_units(const u8 *mask, int n, int first, int mine,
                                            int &before, int &all, unsigned &own,
                                            bool inv = false) {
  using U = Unit<UB>;
  const int units = (n + UB - 1) / UB, whole = n / UB;
  const unsigned flip = inv ? (UB == 32 ? FULL : (1u << UB) - 1u) : 0u;
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
        bits[q] = u < whole ? U::bits(v[q]) ^ flip
                            : (u < units ? byte_bits<UB>(mask, n, u, inv) : 0u);
      }
    } else {
#pragma unroll
      for (int q = 0; q < AH; ++q) {
        const int u = u0 + q * NT;
        bits[q] = u < units ? byte_bits<UB>(mask, n, u, inv) : 0u;
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
// thread at a time; under inv it compacts the mask's clear lanes.
template <int NT, int UB, int AH>
__global__ void __launch_bounds__(NT)
    compact_tiles_kernel(const u8 *__restrict__ mask, int n, int k, bool inv,
                         u8 *__restrict__ valid, int64_t *__restrict__ gi,
                         int64_t *__restrict__ sidx) {
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
    count_units<NT, UB, AH, true>(mask, n, first, first + t, before, all, own, inv);
  else
    count_units<NT, UB, AH, false>(mask, n, first, first + t, before, all, own, inv);
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

// ---- rows mode: the slots' tiles over blocks ----

// Block b of NT threads owns the flags [b NT, (b + 1) NT), one a thread,
// and (with more than one block) counts the whole flags, eight 16-byte
// units a thread at a time.
template <typename T, int NT>
__global__ void __launch_bounds__(NT)
    compact_rows_kernel(const u8 *__restrict__ make, const T *__restrict__ rows, int k,
                        T *__restrict__ ring, int64_t *count, int64_t cap, int64_t *n_drop,
                        unsigned *ticket) {
  static_assert(NT % 32 == 0 && NT % 16 == 0, "whole warps and 16-byte units a tile");
  using V = uint4;  // rows and ring 16-byte aligned; a row is U units
  constexpr int U = ROW * sizeof(T) / 16, W = NT / 32;
  __shared__ int at[NT];  // the tile's kept rows' slots by rank within it
  __shared__ int w_before[W], w_all[W], w_tile[W];
  __shared__ int64_t c0_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int j = (int)blockIdx.x * NT + t;
  if (t == 0) c0_s = *count;  // read before this block's ticket
  const bool f = j < k && make[j] != 0;
  int before = 0, all = 0;  // one block: its tile is every flag, nothing before it
  unsigned own = 0u;
  if (gridDim.x > 1 && ((uintptr_t)make & 15) == 0)
    count_units<NT, 16, 8, true>(make, k, (int)blockIdx.x * (NT / 16), -1, before, all, own);
  else if (gridDim.x > 1)
    count_units<NT, 16, 8, false>(make, k, (int)blockIdx.x * (NT / 16), -1, before, all, own);
  const unsigned bal = __ballot_sync(FULL, f);
  before = __reduce_add_sync(FULL, before);
  all = __reduce_add_sync(FULL, all);
  if (lane == 0) {
    w_before[warp] = before;
    w_all[warp] = all;
    w_tile[warp] = __popc(bal);
  }
  __syncthreads();
  int base = 0, total = 0, rank = __popc(bal & ((1u << lane) - 1u)), tile = 0;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    base += w_before[q];
    total += w_all[q];
    rank += q < warp ? w_tile[q] : 0;
    tile += w_tile[q];
  }
  if (gridDim.x == 1) total = tile;
  const int64_t c0 = c0_s;
  const int64_t room = cap > c0 ? cap - c0 : 0;
  const int kept = total < room ? total : (int)room;
  const int keep = min(tile, max(kept - base, 0));  // the tile's kept rows
  if (keep > 0) {
    if (f && rank < keep) at[rank] = j;
    __syncthreads();
    // unit u of the row of rank q in thread q U + u of a pass: whole rows in
    // consecutive threads
    const V *src = reinterpret_cast<const V *>(rows);
    V *dst = reinterpret_cast<V *>(ring) + (size_t)(c0 + base) * U;
    for (int e = t; e < keep * U; e += NT) {
      const int q = e / U, u = e - q * U;
      dst[(size_t)q * U + u] = __ldg(src + (size_t)at[q] * U + u);
    }
  }
  if (t == 0) {  // one block: it read the count; else the last to take a ticket
    bool last = gridDim.x == 1;
    if (!last) {
      __threadfence();
      last = atomicAdd(ticket, 1u) == gridDim.x - 1;
      if (last) *ticket = 0u;
    }
    if (last) {  // every block has read the count
      *count = c0 + kept;
      *n_drop += total - kept;
    }
  }
}

// The threads a block (and slots a tile) of the pack at K slots: one block
// up to 512 slots (no ticket), 128-slot tiles beyond.
inline int rows_threads(int k) { return k > 512 ? 128 : (k > 256 ? 512 : (k > 128 ? 256 : 128)); }

template <typename T, int NT>
void launch_rows_at(void **ptrs, int64_t cap, int k, cudaStream_t s) {
  compact_rows_kernel<T, NT><<<(k + NT - 1) / NT, NT, 0, s>>>(
      (const u8 *)ptrs[0], (const T *)ptrs[1], k, (T *)ptrs[2], (int64_t *)ptrs[3], cap,
      (int64_t *)ptrs[4], (unsigned *)ptrs[5]);
}

template <typename T>
int launch_rows(void **ptrs, const double *scal, int k, void *stream) {
  if (k > 0) {
    const int64_t cap = (int64_t)scal[0];
    const cudaStream_t s = (cudaStream_t)stream;
    switch (rows_threads(k)) {
      case 128: launch_rows_at<T, 128>(ptrs, cap, k, s); break;
      case 256: launch_rows_at<T, 256>(ptrs, cap, k, s); break;
      case 512: launch_rows_at<T, 512>(ptrs, cap, k, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int compact_nptrs() { return 4; }
int compact_nscal() { return 2; }
int compact_rows_nptrs() { return 6; }
int compact_rows_nscal() { return 1; }
int compact_rows_f64_nptrs() { return 6; }
int compact_rows_f64_nscal() { return 1; }
int compact_rows_threads(int k) { return rows_threads(k); }
int compact_rows_f64_threads(int k) { return rows_threads(k); }

int compact_launch(void **ptrs, const double *scal, int n, void *stream) {
  const int k = (int)scal[0];
  const bool inv = scal[1] != 0.0;
  if (n > 0 && k > 0) {
    const u8 *mask = (const u8 *)ptrs[0];
    u8 *valid = (u8 *)ptrs[1];
    int64_t *gi = (int64_t *)ptrs[2], *sidx = (int64_t *)ptrs[3];
    const cudaStream_t s = (cudaStream_t)stream;
    if (n <= TILE)  // one block: 1,024 threads of 4 bytes, one load each
      compact_tiles_kernel<1024, 4, 1><<<1, 1024, 0, s>>>(mask, n, k, inv, valid, gi, sidx);
    else  // 256 threads of 16 bytes a block, 16 loads in flight a thread
      compact_tiles_kernel<256, 16, 16><<<(n + TILE - 1) / TILE, 256, 0, s>>>(mask, n, k, inv,
                                                                           valid, gi, sidx);
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
