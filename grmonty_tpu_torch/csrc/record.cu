// The phases' upkeep of the pool, hand-written for Hopper (sm_90a): the
// poison sweep, the record of the escaped lanes into the spectrum and the
// frees with their census, in place on the pool's flags, the spectrum and
// the counters (record_count_kernel<T>, record_phase_kernel<T>, float or
// double; engine.record_phase_plain is the plain version).
//
// No TPU kernel does this: the JAX engine's record, sweep and frees are XLA
// (grmonty_tpu/transport/engine.py:1819 `spectrum_add`, :2395
// `_poison_sweep`, :2410 `_record_free_refill`).  The port ran them as some
// 150 torch operations a phase, each a node of the block's CUDA graph.
// A call takes any of three stages, in this order (the mode's bits):
//   - SWEEP (engine.poison_sweep_plain): an occupied lane with a NaN in x,
//     k or w loses alive, occupied, record_pending, at_event, ev_pending;
//   - RECORD (engine.spectrum_add_plain): bad = record_pending and a NaN
//     in w or e; rec = record_pending, not bad, no unconsumed event; the
//     first K rec lanes in lane order (valid) record: the bins (ix2 from
//     x2, i_e from ln e) and the 16 channels added into the spectrum where
//     in bins, n_recorded and n_scatt_rec over those, the max_tau_scatt
//     ratchet over every valid lane (padded slots read 0, as the plain
//     version's K slots do), and under the birth trace the birth state of
//     the first lane of the largest tau_scatt (padded slots read -1) where
//     it passes the ratchet before this call raises it; the valid lanes
//     lose occupied and record_pending, the bad ones those and ev_pending;
//   - FREE (engine.free_plain): occupied &= alive | record_pending |
//     ev_pending; freed = occupied before the record and not now; stalled
//     = freed, past the step cap, not cleared of its record_pending by the
//     record; n_retired, n_steps_retired, n_stall, w_stall added to.
//
// Design.  A block owns a tile of TILE = 1,024 lanes, four consecutive
// lanes a thread.  The first K rec lanes need each lane's rank across the
// pool, so above one tile a call is two launches: record_count_kernel runs
// the sweep and writes each tile's rec count into the scratch;
// record_phase_kernel sums the counts of the tiles before its own (warp 0,
// from L2), ranks its tile's rec lanes by a block scan, records, frees and
// counts, reduces its counters in the block, writes them into the scratch
// and takes a ticket; the last block to take it adds every block's
// counters (warp 0, from L2) into the engine's, decides the ratchet and the
// trace's capture, and resets the ticket to 0 for the next call or graph
// replay.  Up to one tile, one block does all of it in one launch, with no
// ticket.  The full phase's sweep comes before its event set, so there the
// sweep is a launch of its own (record_count_kernel, SWEEP only).  The
// spectrum's adds are atomics (at most K lanes a call), so the spectrum's
// sums, like w_stall's, are those of another order; every flag, count, the
// chosen lanes, the ratchet and the capture are the plain version's bits.
// Each lane's bins and channels round as the plain version's torch
// operations round them on the card (-fmad=false; a division by a Python
// scalar is a multiply by PyTorch's reciprocal, hot_kernels._recip).  The
// launches read nothing on the host.  A thread's loads come in rounds, not
// in a chain: every lane's flags, weight, energy and steps (and x and k
// where it sweeps) at once, by vector loads where the fields are aligned,
// then the valid lanes' record fields, then (the last block) every counter
// before any store.  The first version walked its four lanes one by one,
// each lane's loads behind its flags, and read the counters one by one:
// 31.7 us a call at 65,536 lanes and 14.2 at 512 on chip_smoke.py's pools,
// against 19.2 and 7.3 with the loads in rounds (PERF.md, H100 80GB HBM3,
// 700 W).
//
// What bounds it on an H100 80GB HBM3: the bytes.  At 65,536 lanes it
// reads each lane's flags, and the occupied lanes' x, k and w for the
// sweep, a pending lane's w and e, a recorded lane's 12 other fields and
// writes its spectrum row, 1-4 MB in float: 0.3-1.1 us at 3.35 TB/s; the
// launches, the rounds of dependent loads, the spectrum's atomics on the
// synthetic pools' 13,600 records a call (the path's wave about 4,000
// shipped, 11,000 reference) and the ticket's L2 pass set its time.
//
// Interface: plain C entry points for ctypes, record_phase (float) and
// record_phase_f64 (double).  Each takes an array of device pointers in the
// order of RecordPtrs (the wrapper hot_kernels.record_phase lists the same
// order and checks the count; the birth state's nine are null when the
// trace is off), an array of double scalars (RecordScal), the pool's lane
// count n and the CUDA stream, and returns cudaGetLastError();
// record_phase_scratch(n) gives the scratch's bytes for n lanes and
// record_phase_launches(n, mode) the kernels a call launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

typedef unsigned char u8;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;             // threads a block
constexpr int LPT = 4;              // consecutive lanes a thread
constexpr int TILE = NT * LPT;      // lanes a block
constexpr int W = NT / 32;          // warps a block
constexpr int N_SPEC_CHAN = 16;     // engine.N_SPEC_CHAN
constexpr int SWEEP = 1, RECORD = 2, FREE = 4;  // the mode's bits
constexpr int PARTIAL_BYTES = 128;  // a block's counters in the scratch

template <typename T>
struct RecordPtrs {  // order = hot_kernels._RECORD_PTRS
  // the pool's fields it reads
  const T *x0, *x1, *x2, *x3, *k0, *k1, *k2, *k3, *w, *e, *x1i, *x2i, *tau_abs, *tau_scatt;
  const T *n_e_0, *theta_e_0, *b_0, *e_0;
  const int32_t *n_scatt, *nsc0, *n_step;
  // the flags it updates in place
  u8 *alive, *occupied, *record_pending, *at_event, *ev_pending;
  // the birth state (EngineConfig.trace_birth; all null when off)
  const T *bx0, *bx1, *bx2, *bx3, *bk0, *bk1, *bk2, *bk3, *bw;
  // the spectrum (N_BINS + 1, 16) and the counters, updated in place
  T *spec;
  int64_t *n_recorded, *n_scatt_rec;
  T *max_tau_scatt;
  int64_t *n_retired, *n_steps_retired, *n_stall;
  T *w_stall, *mt_bx, *mt_bk, *mt_bw;
  int64_t *mt_nsc0;
  // the ticket (one word at zero between calls) and the scratch
  // (record_phase_scratch bytes: the tiles' counts, the blocks' counters)
  unsigned *ticket;
  u8 *scratch;
};
constexpr int RECORD_NPTRS = sizeof(RecordPtrs<float>) / sizeof(void *);
static_assert(sizeof(RecordPtrs<double>) == sizeof(RecordPtrs<float>), "one pointer layout");

struct RecordScal {  // order = hot_kernels._RECORD_SCAL
  double k, mode, stall_steps, n_th, n_e, mid, x_stop2, inv_dx2, l_e_0, inv_d_l_e;
};
constexpr int RECORD_NSCAL = sizeof(RecordScal) / sizeof(double);

template <typename T>
struct RecordConst {
  int k, mode, n_th, n_e;
  long long stall_steps;
  T mid, x_stop2, inv_dx2, l_e_0, inv_d_l_e;
};

// A block's counters: the recorded lanes' count and scatters, the frees'
// counts, steps and stalls, the valid lanes' count, the stalled weight, the
// largest valid tau_scatt with its first lane, and whether a valid
// tau_scatt is NaN.
template <typename T>
struct Partial {
  long long n_ok, n_nsc, n_freed, n_steps, n_stall, n_valid;
  T wsum, tmax;
  int tlane, tnan;
};
static_assert(sizeof(Partial<double>) <= PARTIAL_BYTES, "a block's counters");

__host__ __device__ inline int tiles(int n) { return (n + TILE - 1) / TILE; }
__host__ __device__ inline size_t counts_bytes(int n) {
  return ((size_t)tiles(n) * sizeof(int) + PARTIAL_BYTES - 1) / PARTIAL_BYTES * PARTIAL_BYTES;
}

template <typename T>
__device__ __forceinline__ bool isnan_(T v) { return v != v; }
// the math of the type, as torch calls it on the card
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return ::floor(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return ::log(x); }

// A thread's LPT consecutive lanes of a field, loaded at once: under kVec
// (the lanes' first a multiple of LPT, n too, every field aligned to 16
// bytes) by vector loads, else lane by lane (0 past n).  The pool's fields
// that the kernels only read go through the read-only cache.
template <bool kVec>
__device__ __forceinline__ void load4(const float *p, int i, int n, float (&v)[LPT]) {
  if constexpr (kVec) {
    const float4 q = __ldg(reinterpret_cast<const float4 *>(p + i));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < LPT; ++j) v[j] = i + j < n ? __ldg(p + i + j) : 0.0f;
  }
}
template <bool kVec>
__device__ __forceinline__ void load4(const double *p, int i, int n, double (&v)[LPT]) {
  if constexpr (kVec) {
    const double2 a = __ldg(reinterpret_cast<const double2 *>(p + i));
    const double2 b = __ldg(reinterpret_cast<const double2 *>(p + i + 2));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < LPT; ++j) v[j] = i + j < n ? __ldg(p + i + j) : 0.0;
  }
}
template <bool kVec>
__device__ __forceinline__ void load4(const int32_t *p, int i, int n, int32_t (&v)[LPT]) {
  if constexpr (kVec) {
    const int4 q = __ldg(reinterpret_cast<const int4 *>(p + i));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < LPT; ++j) v[j] = i + j < n ? __ldg(p + i + j) : 0;
  }
}
// The flags, which the kernels update: plain loads, one word under kVec.
template <bool kVec>
__device__ __forceinline__ void load4(const u8 *p, int i, int n, u8 (&v)[LPT]) {
  if constexpr (kVec) {
    const unsigned q = *reinterpret_cast<const unsigned *>(p + i);
#pragma unroll
    for (int j = 0; j < LPT; ++j) v[j] = (u8)(q >> (8 * j));
  } else {
#pragma unroll
    for (int j = 0; j < LPT; ++j) v[j] = i + j < n ? p[i + j] : (u8)0;
  }
}

// The sweep of a thread's lanes: each occupied lane with a NaN in x, k or
// w loses its five flags (written where it does); clears occ, rp and ev.
template <typename T, bool kVec>
__device__ __forceinline__ void sweep4(const RecordPtrs<T> &P, int i, int n, const T (&w)[LPT],
                                       u8 (&occ)[LPT], u8 (&rp)[LPT], u8 (&ev)[LPT]) {
  T f[8][LPT];
  const T *src[8] = {P.x0, P.x1, P.x2, P.x3, P.k0, P.k1, P.k2, P.k3};
#pragma unroll
  for (int q = 0; q < 8; ++q) load4<kVec>(src[q], i, n, f[q]);
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    bool bad = isnan_(w[j]);
#pragma unroll
    for (int q = 0; q < 8; ++q) bad = bad || isnan_(f[q][j]);
    if (occ[j] && bad) {
      P.alive[i + j] = 0;
      P.occupied[i + j] = 0;
      P.record_pending[i + j] = 0;
      P.at_event[i + j] = 0;
      P.ev_pending[i + j] = 0;
      occ[j] = rp[j] = ev[j] = 0;
    }
  }
}

// (a, la) takes (b, lb) where b is larger, or equal at a lower lane: the
// first lane of the largest value.
template <typename T>
__device__ __forceinline__ void take_max(T &a, int &la, T b, int lb) {
  if (b > a || (b == a && lb < la)) {
    a = b;
    la = lb;
  }
}

template <typename T>
__device__ __forceinline__ void warp_partial(Partial<T> &p) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    p.n_ok += __shfl_down_sync(FULL, p.n_ok, d);
    p.n_nsc += __shfl_down_sync(FULL, p.n_nsc, d);
    p.n_freed += __shfl_down_sync(FULL, p.n_freed, d);
    p.n_steps += __shfl_down_sync(FULL, p.n_steps, d);
    p.n_stall += __shfl_down_sync(FULL, p.n_stall, d);
    p.n_valid += __shfl_down_sync(FULL, p.n_valid, d);
    p.wsum += __shfl_down_sync(FULL, p.wsum, d);
    const T m = __shfl_down_sync(FULL, p.tmax, d);
    const int l = __shfl_down_sync(FULL, p.tlane, d);
    take_max(p.tmax, p.tlane, m, l);
    p.tnan |= __shfl_down_sync(FULL, p.tnan, d);
  }
}

template <typename T>
__device__ __forceinline__ Partial<T> no_partial() {
  Partial<T> p;
  p.n_ok = p.n_nsc = p.n_freed = p.n_steps = p.n_stall = p.n_valid = 0;
  p.wsum = T(0.0);
  p.tmax = -INFINITY;
  p.tlane = 0x7fffffff;
  p.tnan = 0;
  return p;
}

// The engine's counters from the call's (one thread): the record's and the
// ratchet (torch.maximum of the old value and the K slots' amax, NaN
// first), the trace's capture against the old ratchet (the argmax of the K
// slots: the valid lanes in order, then the pad, -1 at lane n - 1), the
// frees'.  Every old value is read before the first store, so the reads
// are one round trip.
template <typename T>
__device__ void finish(const RecordPtrs<T> &P, const RecordConst<T> &C, const Partial<T> &p,
                       int n) {
  const long long rec0 = *P.n_recorded, nsc0 = *P.n_scatt_rec, ret0 = *P.n_retired;
  const long long steps0 = *P.n_steps_retired, stall0 = *P.n_stall;
  const T old = *P.max_tau_scatt, ws0 = *P.w_stall;
  if (C.mode & RECORD) {
    const bool pad = p.n_valid < C.k;
    T amax = p.tmax, at = p.tmax;
    int lane = p.tlane;
    if (pad && (p.n_valid == 0 || T(-1.0) > p.tmax)) {
      at = T(-1.0);
      lane = n - 1;
    }
    if (pad && !(amax > T(0.0))) amax = T(0.0);
    if (p.tnan) amax = (T)NAN;
    if (P.bw != nullptr && !p.tnan && at > old) {
      const T b[9] = {P.bx0[lane], P.bx1[lane], P.bx2[lane], P.bx3[lane], P.bk0[lane],
                      P.bk1[lane], P.bk2[lane], P.bk3[lane], P.bw[lane]};
      const int32_t b_nsc0 = P.nsc0[lane];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        P.mt_bx[q] = b[q];
        P.mt_bk[q] = b[4 + q];
      }
      *P.mt_bw = b[8];
      *P.mt_nsc0 = (int64_t)b_nsc0;
    }
    *P.n_recorded = rec0 + p.n_ok;
    *P.n_scatt_rec = nsc0 + p.n_nsc;
    *P.max_tau_scatt = isnan_(old) ? old : (isnan_(amax) ? amax : (amax > old ? amax : old));
  }
  if (C.mode & FREE) {
    *P.n_retired = ret0 + p.n_freed;
    *P.n_steps_retired = steps0 + p.n_steps;
    *P.n_stall = stall0 + p.n_stall;
    *P.w_stall = ws0 + p.wsum;
  }
}

// Launch 1 above one tile (and the full phase's sweep alone): the sweep of
// the block's tile and, under RECORD, its rec count into the scratch.
template <typename T, bool kVec>
__global__ void __launch_bounds__(NT) record_count_kernel(const RecordPtrs<T> P, int n, int mode) {
  const int i = (int)blockIdx.x * TILE + (int)threadIdx.x * LPT;
  int c = 0;
  if (i < n) {  // every load of the thread's lanes at once
    u8 occ[LPT], rp[LPT], ev[LPT];
    T w[LPT], e[LPT];
    load4<kVec>(P.occupied, i, n, occ);
    load4<kVec>(P.record_pending, i, n, rp);
    load4<kVec>(P.ev_pending, i, n, ev);
    load4<kVec>(P.w, i, n, w);
    load4<kVec>(P.e, i, n, e);
    if (mode & SWEEP) sweep4<T, kVec>(P, i, n, w, occ, rp, ev);
#pragma unroll
    for (int j = 0; j < LPT; ++j)
      c += rp[j] && !ev[j] && !isnan_(w[j]) && !isnan_(e[j]);
  }
  if (!(mode & RECORD)) return;
  c = __reduce_add_sync(FULL, c);
  __shared__ int w_count[W];
  if ((threadIdx.x & 31) == 0) w_count[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int q = 0; q < W; ++q) s += w_count[q];
    reinterpret_cast<int *>(P.scratch)[blockIdx.x] = s;
  }
}

// Launch 2 (or the one launch up to one tile): the rank, the record, the
// frees and the counters.  A thread's loads come in two rounds: every
// lane's flags, weight, energy and steps (and, sweeping, x and k), then the
// valid lanes' record fields.
template <typename T, bool kVec>
__global__ void __launch_bounds__(NT)
    record_phase_kernel(const RecordPtrs<T> P, const RecordConst<T> C, int n) {
  __shared__ int w_scan[W];
  __shared__ int base_s;
  __shared__ Partial<T> w_part[W];
  __shared__ bool last_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int i = (int)blockIdx.x * TILE + t * LPT;
  const bool one = gridDim.x == 1;
  if (warp == 0) {  // the rec lanes of the tiles before this one
    int s = 0;
    if (!one && (C.mode & RECORD)) {
      const int *counts = reinterpret_cast<const int *>(P.scratch);
      for (int q = lane; q < (int)blockIdx.x; q += 32) s += __ldcg(counts + q);
    }
    s = __reduce_add_sync(FULL, s);
    if (lane == 0) base_s = s;
  }

  // each lane's flags, after the sweep (up to one tile: this block's own)
  u8 occ0[LPT] = {}, rp0[LPT] = {}, evp[LPT] = {}, al[LPT] = {};
  T w[LPT] = {}, e[LPT] = {};
  int32_t steps[LPT] = {};
  bool bad[LPT], rec[LPT];
  int c = 0;
  if (i < n) {
    load4<kVec>(P.occupied, i, n, occ0);
    load4<kVec>(P.record_pending, i, n, rp0);
    load4<kVec>(P.ev_pending, i, n, evp);
    load4<kVec>(P.alive, i, n, al);
    load4<kVec>(P.w, i, n, w);
    load4<kVec>(P.e, i, n, e);
    load4<kVec>(P.n_step, i, n, steps);
    if (one && (C.mode & SWEEP)) sweep4<T, kVec>(P, i, n, w, occ0, rp0, evp);
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    bad[j] = (C.mode & RECORD) && rp0[j] && (isnan_(w[j]) || isnan_(e[j]));
    rec[j] = (C.mode & RECORD) && rp0[j] && !bad[j] && !evp[j];
    c += rec[j];
  }
  // the block's exclusive scan of the rec counts
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) w_scan[warp] = x;
  __syncthreads();
  int rank = base_s + x - c;
#pragma unroll
  for (int q = 0; q < W; ++q) rank += q < warp ? w_scan[q] : 0;
  bool valid[LPT], any = false;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    valid[j] = rec[j] && rank < C.k;
    rank += rec[j];
    any = any || valid[j];
  }

  Partial<T> p = no_partial<T>();
  if (__any_sync(FULL, any)) {
    // the valid lanes' record fields, loaded together
    T x2[LPT], x3[LPT], x1i[LPT], x2i[LPT], tab[LPT], tsc[LPT], ne0[LPT], te0[LPT], b0[LPT];
    T e0[LPT];
    int32_t nsc[LPT], nsc0[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int l = valid[j] ? i + j : 0;  // lane 0 where invalid: in range
      x2[j] = __ldg(P.x2 + l), x3[j] = __ldg(P.x3 + l), x1i[j] = __ldg(P.x1i + l);
      x2i[j] = __ldg(P.x2i + l), tab[j] = __ldg(P.tau_abs + l), tsc[j] = __ldg(P.tau_scatt + l);
      ne0[j] = __ldg(P.n_e_0 + l), te0[j] = __ldg(P.theta_e_0 + l), b0[j] = __ldg(P.b_0 + l);
      e0[j] = __ldg(P.e_0 + l), nsc[j] = __ldg(P.n_scatt + l), nsc0[j] = __ldg(P.nsc0 + l);
    }
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (!valid[j]) continue;
      ++p.n_valid;
      if (isnan_(tsc[j]))
        p.tnan = 1;
      else
        take_max(p.tmax, p.tlane, tsc[j], i + j);
      // the bins, rounded as the plain version's torch operations
      const T fa = floor_(x2[j] * C.inv_dx2), fb = floor_((C.x_stop2 - x2[j]) * C.inv_dx2);
      const long long ix2 = (long long)(x2[j] < C.mid ? fa : fb);
      const T le = log_(e[j] > T(1e-30) ? e[j] : T(1e-30));
      const long long i_e = (long long)floor_((le - C.l_e_0) * C.inv_d_l_e + T(2.5)) - 2;
      if (ix2 >= 0 && ix2 < C.n_th && i_e >= 0 && i_e < C.n_e) {
        ++p.n_ok;
        p.n_nsc += nsc[j];
        const T wj = w[j], we = wj * e[j];
        const T v[N_SPEC_CHAN] = {
            wj, we, T(1.0), (T)nsc[j], wj * x1i[j], wj * x2i[j] * x2i[j], wj * x3[j] * x3[j],
            wj * tab[j], wj * tsc[j], wj * ne0[j], wj * te0[j], wj * b0[j], wj * e0[j], we * we,
            nsc0[j] > 0 ? T(1.0) : T(0.0), (T)nsc0[j]};
        T *row = P.spec + (ix2 * C.n_e + i_e) * N_SPEC_CHAN;
#pragma unroll
        for (int q = 0; q < N_SPEC_CHAN; ++q) atomicAdd(row + q, v[q]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    if (i + j >= n) break;
    bool occ = occ0[j] != 0, rp = rp0[j] != 0, ev = evp[j] != 0;
    if (valid[j]) occ = rp = false;
    if (bad[j]) occ = rp = ev = false;
    if (C.mode & FREE) {
      occ = occ && (al[j] || rp || ev);
      if (occ0[j] && !occ) {
        ++p.n_freed;
        p.n_steps += steps[j];
        if ((long long)steps[j] > C.stall_steps && !(rp0[j] && !rp)) {
          ++p.n_stall;
          p.wsum += w[j];
        }
      }
    }
    if (occ != (occ0[j] != 0)) P.occupied[i + j] = occ;
    if (rp != (rp0[j] != 0)) P.record_pending[i + j] = rp;
    if (ev != (evp[j] != 0)) P.ev_pending[i + j] = ev;
  }

  // the block's counters, then (above one block) the last block's sum
  warp_partial(p);
  if (lane == 0) w_part[warp] = p;
  __syncthreads();
  if (warp != 0) return;
  p = lane < W ? w_part[lane] : no_partial<T>();
  warp_partial(p);  // lane 0: the block's
  if (one) {
    if (lane == 0) finish(P, C, p, n);
    return;
  }
  Partial<T> *parts = reinterpret_cast<Partial<T> *>(P.scratch + counts_bytes(n));
  if (lane == 0) {
    parts[blockIdx.x] = p;
    __threadfence();
    last_s = atomicAdd(P.ticket, 1u) == gridDim.x - 1;
  }
  __syncwarp();
  if (!last_s) return;
  __threadfence();
  Partial<T> s = no_partial<T>();
  for (int b = lane; b < (int)gridDim.x; b += 32) {
    const Partial<T> *q = parts + b;
    s.n_ok += __ldcg(&q->n_ok);
    s.n_nsc += __ldcg(&q->n_nsc);
    s.n_freed += __ldcg(&q->n_freed);
    s.n_steps += __ldcg(&q->n_steps);
    s.n_stall += __ldcg(&q->n_stall);
    s.n_valid += __ldcg(&q->n_valid);
    s.wsum += __ldcg(&q->wsum);
    take_max(s.tmax, s.tlane, __ldcg(&q->tmax), __ldcg(&q->tlane));
    s.tnan |= __ldcg(&q->tnan);
  }
  warp_partial(s);
  if (lane == 0) {
    finish(P, C, s, n);
    *P.ticket = 0u;
  }
}

// Whether every field the kernels load by vectors is aligned for them, and
// the lanes come in whole groups of LPT.
template <typename T>
bool vec_ok(const RecordPtrs<T> &P, int n) {
  const void *t16[] = {P.x0, P.x1, P.x2, P.x3, P.k0, P.k1, P.k2, P.k3, P.w, P.e, P.n_step};
  const void *t4[] = {P.alive, P.occupied, P.record_pending, P.ev_pending};
  bool ok = n % LPT == 0;
  for (const void *p : t16) ok = ok && ((uintptr_t)p & 15) == 0;
  for (const void *p : t4) ok = ok && ((uintptr_t)p & 3) == 0;
  return ok;
}

// Whether a call on n lanes in this mode launches record_count_kernel before
// record_phase_kernel: above one tile, where it ranks or sweeps first.
inline bool count_first(int n, int mode) {
  return tiles(n) > 1 && (mode & (RECORD | FREE)) && (mode & (SWEEP | RECORD));
}

template <typename T, bool kVec>
void launch_record_at(const RecordPtrs<T> &P, RecordConst<T> C, int n, cudaStream_t s) {
  const int nb = tiles(n);
  if (C.mode & (RECORD | FREE)) {
    if (count_first(n, C.mode))
      record_count_kernel<T, kVec><<<nb, NT, 0, s>>>(P, n, C.mode & (SWEEP | RECORD));
    if (nb > 1) C.mode &= ~SWEEP;
    record_phase_kernel<T, kVec><<<nb, NT, 0, s>>>(P, C, n);
  } else if (C.mode & SWEEP) {
    record_count_kernel<T, kVec><<<nb, NT, 0, s>>>(P, n, SWEEP);
  }
}

template <typename T>
int launch_record(void **ptrs, const double *scal, int n, void *stream) {
  RecordPtrs<T> P;
  memcpy(&P, ptrs, sizeof(RecordPtrs<T>));
  RecordScal S;
  memcpy(&S, scal, sizeof(RecordScal));
  RecordConst<T> C;
  C.k = (int)S.k;
  C.mode = (int)S.mode;
  C.stall_steps = (long long)S.stall_steps;
  C.n_th = (int)S.n_th;
  C.n_e = (int)S.n_e;
  C.mid = (T)S.mid;
  C.x_stop2 = (T)S.x_stop2;
  C.inv_dx2 = (T)S.inv_dx2;
  C.l_e_0 = (T)S.l_e_0;
  C.inv_d_l_e = (T)S.inv_d_l_e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (vec_ok(P, n))
      launch_record_at<T, true>(P, C, n, s);
    else
      launch_record_at<T, false>(P, C, n, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int record_phase_nptrs() { return RECORD_NPTRS; }
int record_phase_nscal() { return RECORD_NSCAL; }
int record_phase_f64_nptrs() { return RECORD_NPTRS; }
int record_phase_f64_nscal() { return RECORD_NSCAL; }
int record_phase_scratch(int n) { return (int)(counts_bytes(n) + (size_t)tiles(n) * PARTIAL_BYTES); }
// the kernels a call on n lanes in this mode launches (0 for no stage)
int record_phase_launches(int n, int mode) {
  return (mode & (SWEEP | RECORD | FREE)) ? 1 + count_first(n, mode) : 0;
}

int record_phase_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_record<float>(ptrs, scal, n, stream);
}

int record_phase_f64_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_record<double>(ptrs, scal, n, stream);
}

}  // extern "C"
