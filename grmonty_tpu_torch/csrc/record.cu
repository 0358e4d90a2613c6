// The phases' upkeep of the pool, hand-written for Hopper (sm_90a): the
// poison sweep, the record of the escaped lanes into the spectrum, the frees
// with their census and the bias's terms, in place on the pool's flags, the
// spectrum, the counters and the engine's bias buffers
// (record_phase_kernel<T, kVec, NT>, float or double;
// engine.record_phase_plain then engine.bias_terms_plain is the plain
// version).
//
// No TPU kernel does this: the JAX engine's record, sweep and frees are XLA
// (grmonty_tpu/transport/engine.py:1819 `spectrum_add`, :2395
// `_poison_sweep`, :2410 `_record_free_refill`), and so are its bias's
// denominator and scale (:1226-1250, :1443-1445) and the EMA fold
// (:2462-2475).  The port ran them as some 150 torch operations a phase.
// A call takes any of these stages, in this order (the mode's bits):
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
//     record; n_retired, n_steps_retired, n_stall, w_stall added to;
//   - FOLD (the full phase's EMA fold, engine.bias_terms_plain): avg_ema =
//     (1 - a) * avg_ema + a * d_s / max(d_r, 1), a = BIAS_EMA where d_r > 0,
//     d_s and d_r the scatters and records since the marks, which take
//     n_scatt_rec and n_recorded;
//   - TERMS (the live bias): refill_den = bias_norm * max_tau * (avg + 2)
//     from the counters after the record, before the fold; event_den the
//     same after the fold; scale = 100 / event_den (a reciprocal, then a
//     multiply, as Tensor.__rtruediv__); avg the EMA, or under CUMUL the
//     reference's n_scatt_rec / (n_recorded + 1).  The sweep alone writes
//     them from the counters as it finds them.
// The sweep alone is every block's first launch, and in a graph replay it
// guards the block (the XLA while_loop running its body where cond holds,
// grmonty_tpu/transport/engine.py:2547): given the exit word's go, every
// thread returns at entry where go is clear, before any load, store or
// term, and given a conditional handle, block 0's first thread sets the
// condition of the IF node that holds the rest of the block from go.
//
// Design.  A block owns a tile of NT threads, four consecutive lanes a
// thread: one block of 1,024 lanes up to 1,024 (no look-back, no ticket),
// else tiles of 512 lanes (TILE), so that 65,536 lanes are 128 blocks over
// the 132 SMs.  Every call is one launch.  The first
// K rec lanes need each lane's rank across the pool: a block takes its
// tile from a counter (every earlier tile has then started), scans its rec
// counts, publishes its count and then its inclusive prefix in its tile's
// status word (flag and value in one 64-bit word) and reads its
// predecessors' words, 128 at a time by warp 0 (one round trip for every
// tile of 65,536 lanes), until it meets an inclusive prefix (the decoupled
// look-back of Merrill and Garland, 2016).  It records, frees and counts,
// reduces its counters, writes them beside the status words and takes the
// ticket (an acquire-release add); the last block to take it adds every
// block's counters (warp 0, from L2) into the engine's as its first thread
// read them when it started, decides the ratchet and the trace's
// capture, folds the EMA and writes the bias's terms, and leaves the
// ticket, the tile counter and every status word at zero for the next call
// or graph replay.  The scratch is the engine's, made once outside any
// capture (record_phase_scratch), so a call sets no memory of its own.
// The spectrum's adds are merged in the warp: the lanes that add into one
// spectrum row (__match_any_sync on the row) pass their 16 channels to the
// row's lowest lane by shuffles, which adds the row once (four 16-byte
// vector reductions in float); a lane alone in its warp's round adds its
// own.  It was chosen for the path's record counts (4,000 a call at the
// shipped wave, 11,100 on the reference path, one or two at 512 lanes):
// a block's shared spectrum would zero and flush 201 rows for the one or
// two records of a 512-lane call.  So the spectrum's sums,
// like w_stall's, are those of another order; every flag, count, the
// chosen lanes, the ratchet, the capture and the bias's terms are the
// plain version's bits.
// Each lane's bins and channels and the terms round as the plain version's
// torch operations round them on the card (-fmad=false; a division by a
// Python scalar is a multiply by PyTorch's reciprocal, hot_kernels._recip).
// The launches read nothing on the host.  A thread's loads come in
// rounds, not in a chain: every lane's flags, weight, energy and steps
// (and x and k where it sweeps) at once, by vector loads where the fields
// are aligned, then the record fields of a warp's lanes where one of
// them records, and each block's first thread reads the counters as the
// call finds them before any of its work.
//
// What bounds it on an H100 80GB HBM3: the bytes.  At 65,536 lanes it
// reads each lane's flags, and the occupied lanes' x, k and w for the
// sweep, a pending lane's w and e, a recorded lane's 12 other fields and
// writes its spectrum row, 1-4 MB in float: 0.3-1.1 us at 3.35 TB/s; the
// launch, the rounds of dependent loads, the look-back's L2 round trips
// and the ticket's pass set its time.
//
// Interface: plain C entry points for ctypes, record_phase (float) and
// record_phase_f64 (double).  Each takes an array of device pointers in the
// order of RecordPtrs (the wrapper hot_kernels.record_phase lists the same
// order and checks the count; the birth state's nine are null when the
// trace is off, the bias's three without TERMS), an array of double
// scalars (RecordScal), the pool's lane count n and the CUDA stream, and
// returns cudaGetLastError(); record_phase_scratch(n) gives the scratch's
// bytes for n lanes and record_phase_launches(mode) the kernels a call
// launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

typedef unsigned char u8;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LPT = 4;              // consecutive lanes a thread
constexpr int ONE_NT = 256;         // threads of the one block up to ONE_TILE
constexpr int ONE_TILE = ONE_NT * LPT;
constexpr int TILE_NT = 128;        // threads a block above ONE_TILE
constexpr int TILE = TILE_NT * LPT;
constexpr int N_SPEC_CHAN = 16;     // engine.N_SPEC_CHAN
// the mode's bits (hot_kernels.RECORD_*)
constexpr int SWEEP = 1, RECORD = 2, FREE = 4, FOLD = 8, TERMS = 16, CUMUL = 32;
constexpr int PARTIAL_BYTES = 128;  // a block's counters in the scratch
// a tile's status word: the flag in the high half, the count in the low
constexpr unsigned long long AGGREGATE = 1ull << 32, INCLUSIVE = 2ull << 32;

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
  T *avg_ema;
  int64_t *ema_scatt_mark, *ema_rec_mark;
  // the bias's terms (TERMS; null without): refill's denominator, the
  // event phase's, the hot steps' scale
  T *refill_den, *event_den, *scale;
  // the engine's scratch (record_phase_scratch bytes, at rest zero between
  // calls): the ticket and the tile counter, the tiles' status words, the
  // blocks' counters
  u8 *scratch;
  // the sweep alone, gated (null without): the exit word's go, which it
  // reads before anything else, and the bits of the conditional handle of
  // the block it opens (a cudaGraphConditionalHandle; 0 for none)
  const bool *go;
  unsigned long long handle;
};
constexpr int RECORD_NPTRS = sizeof(RecordPtrs<float>) / sizeof(void *);
static_assert(sizeof(RecordPtrs<double>) == sizeof(RecordPtrs<float>), "one pointer layout");

struct RecordScal {  // order = hot_kernels._RECORD_SCAL
  double k, mode, stall_steps, n_th, n_e, mid, x_stop2, inv_dx2, l_e_0, inv_d_l_e, bias_norm,
      ema;
};
constexpr int RECORD_NSCAL = sizeof(RecordScal) / sizeof(double);

template <typename T>
struct RecordConst {
  int k, mode, n_th, n_e;
  long long stall_steps;
  T mid, x_stop2, inv_dx2, l_e_0, inv_d_l_e, bias_norm, ema;
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

// The scratch: two words (the ticket, the tile counter), a status word a
// tile, then a block's counters a tile.
__host__ __device__ inline int max_tiles(int n) { return (n + TILE - 1) / TILE; }
__host__ __device__ inline size_t parts_offset(int n_tiles) {
  return (8 + 8 * (size_t)n_tiles + PARTIAL_BYTES - 1) / PARTIAL_BYTES * PARTIAL_BYTES;
}

template <typename T>
__device__ __forceinline__ bool isnan_(T v) { return v != v; }
// the math of the type, as torch calls it on the card
__device__ __forceinline__ float floor_(float x) { return floorf(x); }
__device__ __forceinline__ double floor_(double x) { return ::floor(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return ::log(x); }

// The status words, read and written through L2 with no order of their own:
// a word carries its flag and its value at once.
__device__ __forceinline__ unsigned long long ld_status(const unsigned long long *p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_status(unsigned long long *p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
// The ticket: an add that releases the thread's stores before it and
// acquires those of the threads that took the ticket before.
__device__ __forceinline__ unsigned take_ticket(unsigned *p) {
  unsigned v;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A thread's LPT consecutive lanes of a field, loaded at once: under kVec
// (the lanes' first a multiple of LPT, n too, every field aligned to 16
// bytes) by vector loads, else lane by lane (0 past n).  The pool's fields
// that the kernel only reads go through the read-only cache.
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
// The flags, which the kernel updates: plain loads, one word under kVec.
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

// The warp's counters into its lane 0: the lane counts (at most a call's
// lanes) by one reduction each, the rest by a tree of shuffles.
template <typename T>
__device__ __forceinline__ void warp_partial(Partial<T> &p) {
  p.n_ok = __reduce_add_sync(FULL, (unsigned)p.n_ok);
  p.n_freed = __reduce_add_sync(FULL, (unsigned)p.n_freed);
  p.n_stall = __reduce_add_sync(FULL, (unsigned)p.n_stall);
  p.n_valid = __reduce_add_sync(FULL, (unsigned)p.n_valid);
  p.tnan = (int)__reduce_or_sync(FULL, (unsigned)p.tnan);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    p.n_nsc += __shfl_down_sync(FULL, p.n_nsc, d);
    p.n_steps += __shfl_down_sync(FULL, p.n_steps, d);
    p.wsum += __shfl_down_sync(FULL, p.wsum, d);
    const T m = __shfl_down_sync(FULL, p.tmax, d);
    const int l = __shfl_down_sync(FULL, p.tlane, d);
    take_max(p.tmax, p.tlane, m, l);
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

// bias_norm * max_tau * (avg + 2): avg the EMA, or (CUMUL) n_scatt_rec /
// (n_recorded + 1), each operation rounded as its torch operation.
template <typename T>
__device__ __forceinline__ T bias_den(const RecordConst<T> &C, long long rec, long long nsc,
                                      T max_tau, T avg_ema) {
  const T avg = (C.mode & CUMUL) ? (T)nsc / ((T)rec + T(1.0)) : avg_ema;
  return C.bias_norm * (max_tau * (avg + T(2.0)));
}

// The EMA fold (FOLD) and the bias's terms (TERMS) from the counters the
// call leaves (one thread): the marks and avg_ema as the plain fold, the
// denominators before and after it, the scale 100 / den as a reciprocal
// and a multiply.
template <typename T>
__device__ void bias_finish(const RecordPtrs<T> &P, const RecordConst<T> &C, long long rec,
                            long long nsc, T max_tau, T avg0, long long mark_s,
                            long long mark_r) {
  T avg1 = avg0;
  if (C.mode & FOLD) {
    const T d_s = (T)(nsc - mark_s), d_r = (T)(rec - mark_r);
    const T a = d_r > T(0.0) ? C.ema : T(0.0);
    const T t1 = (T(1.0) - a) * avg0, t2 = a * d_s;
    avg1 = t1 + t2 / (d_r > T(1.0) ? d_r : T(1.0));
    *P.avg_ema = avg1;
    *P.ema_scatt_mark = nsc;
    *P.ema_rec_mark = rec;
  }
  if (C.mode & TERMS) {
    const T den = bias_den(C, rec, nsc, max_tau, avg1);
    *P.refill_den = bias_den(C, rec, nsc, max_tau, avg0);
    *P.event_den = den;
    *P.scale = (T(1.0) / den) * T(100.0);
  }
}

// The engine's counters as a call finds them, read by a block's first
// thread as it starts (no block writes them before the last one finishes),
// so that the last block does not wait for them.
template <typename T>
struct Olds {
  long long rec0, nsc0, ret0, steps0, stall0, mark_s, mark_r;
  T old, ws0, avg0;
};

template <typename T>
__device__ __forceinline__ Olds<T> read_olds(const RecordPtrs<T> &P) {
  Olds<T> o;
  o.rec0 = *P.n_recorded, o.nsc0 = *P.n_scatt_rec, o.ret0 = *P.n_retired;
  o.steps0 = *P.n_steps_retired, o.stall0 = *P.n_stall;
  o.mark_s = *P.ema_scatt_mark, o.mark_r = *P.ema_rec_mark;
  o.old = *P.max_tau_scatt, o.ws0 = *P.w_stall, o.avg0 = *P.avg_ema;
  return o;
}

// The engine's counters from the call's (one thread): the record's and the
// ratchet (torch.maximum of the old value and the K slots' amax, NaN
// first), the trace's capture against the old ratchet (the argmax of the K
// slots: the valid lanes in order, then the pad, -1 at lane n - 1), the
// frees', the fold and the terms, from the counters as the call found
// them (`o`).
template <typename T>
__device__ void finish(const RecordPtrs<T> &P, const RecordConst<T> &C, const Partial<T> &p,
                       int n, const Olds<T> &o) {
  const long long rec0 = o.rec0, nsc0 = o.nsc0, ret0 = o.ret0;
  const long long steps0 = o.steps0, stall0 = o.stall0;
  const long long mark_s = o.mark_s, mark_r = o.mark_r;
  const T old = o.old, ws0 = o.ws0, avg0 = o.avg0;
  long long rec1 = rec0, nsc1 = nsc0;
  T max_tau = old;
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
    rec1 = rec0 + p.n_ok;
    nsc1 = nsc0 + p.n_nsc;
    max_tau = isnan_(old) ? old : (isnan_(amax) ? amax : (amax > old ? amax : old));
    *P.n_recorded = rec1;
    *P.n_scatt_rec = nsc1;
    *P.max_tau_scatt = max_tau;
  }
  if (C.mode & FREE) {
    *P.n_retired = ret0 + p.n_freed;
    *P.n_steps_retired = steps0 + p.n_steps;
    *P.n_stall = stall0 + p.n_stall;
    *P.w_stall = ws0 + p.wsum;
  }
  bias_finish(P, C, rec1, nsc1, max_tau, avg0, mark_s, mark_r);
}

// The decoupled look-back of tile `tile` with `total` rec lanes (warp 0):
// publishes the tile's count, reads its predecessors' status words LB a
// lane, 32 LB at a time, nearest first, waiting on any not yet published,
// until one holds an inclusive prefix, then publishes its own.  Returns
// the rec lanes of the tiles before it.
__device__ int look_back(unsigned long long *status, int tile, int total, int lane) {
  constexpr int LB = 4;  // status words a lane a round: 128 tiles a round trip
  if (tile == 0) {
    if (lane == 0) st_status(status, INCLUSIVE | (unsigned)total);
    return 0;
  }
  if (lane == 0) st_status(status + tile, AGGREGATE | (unsigned)total);
  int before = 0;
  for (int top = tile - 1;; top -= 32 * LB) {
    unsigned long long s[LB];  // s[j]: tile top - 32 j - lane (below 0: a prefix of 0)
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      const int q = top - 32 * j - lane;
      s[j] = q >= 0 ? ld_status(status + q) : INCLUSIVE;
    }
    for (;;) {
      bool ready = true;
#pragma unroll
      for (int j = 0; j < LB; ++j) ready = ready && (s[j] >> 32) != 0;
      if (__all_sync(FULL, ready)) break;
#pragma unroll
      for (int j = 0; j < LB; ++j)
        if ((s[j] >> 32) == 0) s[j] = ld_status(status + (top - 32 * j - lane));
    }
    unsigned sum = 0;
    bool found = false;  // the same in every lane
#pragma unroll
    for (int j = 0; j < LB && !found; ++j) {
      const unsigned incl = __ballot_sync(FULL, (s[j] & INCLUSIVE) != 0);
      const int last = incl ? __ffs(incl) - 1 : 31;  // the nearest inclusive prefix
      sum += lane <= last ? (unsigned)s[j] : 0u;
      found = incl != 0;
    }
    before += (int)__reduce_add_sync(FULL, sum);
    if (found) break;
  }
  if (lane == 0) st_status(status + tile, INCLUSIVE | (unsigned)(before + total));
  return before;
}

// A row's 16 channels added into the spectrum: four 16-byte vector
// reductions in float (a row is 64 bytes, aligned; no value returned, so
// nothing waits for them), sixteen atomics in double.
__device__ __forceinline__ void add_row(float *dst, const float (&acc)[N_SPEC_CHAN]) {
#pragma unroll
  for (int q = 0; q < N_SPEC_CHAN / 4; ++q)
    asm volatile("red.relaxed.gpu.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(dst + 4 * q),
                 "f"(acc[4 * q]), "f"(acc[4 * q + 1]), "f"(acc[4 * q + 2]), "f"(acc[4 * q + 3])
                 : "memory");
}
__device__ __forceinline__ void add_row(double *dst, const double (&acc)[N_SPEC_CHAN]) {
#pragma unroll
  for (int q = 0; q < N_SPEC_CHAN; ++q) atomicAdd(dst + q, acc[q]);
}

// The warp's adds of one lane a thread into the spectrum (every lane of
// the warp takes part; `row` < 0 adds nothing): the lanes of one row hand
// their channels to the row's lowest lane, which adds the row once.  The
// lanes that add nothing pass nothing; a lone lane adds its own.
template <typename T>
__device__ __forceinline__ void add_rows(T *spec, int row, const T (&v)[N_SPEC_CHAN], int lane) {
  const unsigned adding = __ballot_sync(FULL, row >= 0);
  if (adding == 0u) return;
  if ((adding & (adding - 1u)) == 0u) {
    if (row >= 0) add_row(spec + (size_t)row * N_SPEC_CHAN, v);
    return;
  }
  const unsigned grp = __match_any_sync(FULL, row);
  const bool lead = row >= 0 && (grp & ((1u << lane) - 1u)) == 0u;
  unsigned rest = lead ? grp & (grp - 1u) : 0u;
  T acc[N_SPEC_CHAN];
#pragma unroll
  for (int q = 0; q < N_SPEC_CHAN; ++q) acc[q] = v[q];
  while (__any_sync(FULL, rest != 0u)) {
    const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
    for (int q = 0; q < N_SPEC_CHAN; ++q) {
      const T u = __shfl_sync(FULL, v[q], src);
      if (rest) acc[q] += u;
    }
    rest &= rest - 1u;
  }
  if (lead) add_row(spec + (size_t)row * N_SPEC_CHAN, acc);
}

// One call: the sweep alone, or the ranks, the record, the frees, the
// counters, the fold and the terms.  A thread's loads come in two rounds:
// every lane's flags, weight, energy and steps (and, sweeping, x and k),
// then the record fields of the lanes of a warp where one records.
template <typename T, bool kVec, int NT>
__global__ void __launch_bounds__(NT)
    record_phase_kernel(const RecordPtrs<T> P, const RecordConst<T> C, int n) {
  constexpr int BLOCK_LANES = NT * LPT, W = NT / 32;
  __shared__ int w_scan[W];
  __shared__ int tile_s, base_s;
  __shared__ Partial<T> w_part[W];
  __shared__ bool last_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool one = gridDim.x == 1;
  unsigned *ticket = reinterpret_cast<unsigned *>(P.scratch);  // the ticket, the tile counter
  unsigned long long *status = reinterpret_cast<unsigned long long *>(P.scratch + 8);

  if (!(C.mode & (RECORD | FREE))) {  // the sweep alone, and the terms as found
    if (P.go != nullptr) {  // gated: a block's first launch in a replay
      const bool g = *P.go;
      if (P.handle != 0ull && blockIdx.x == 0 && t == 0)
        cudaGraphSetConditional((cudaGraphConditionalHandle)P.handle, g ? 1u : 0u);
      if (!g) return;
    }
    if ((C.mode & TERMS) && blockIdx.x == 0 && t == 0) {
      const Olds<T> o = read_olds(P);
      bias_finish(P, C, o.rec0, o.nsc0, o.old, o.avg0, 0, 0);
    }
    const int i = (int)blockIdx.x * BLOCK_LANES + t * LPT;
    if (i < n) {
      u8 occ[LPT], rp[LPT] = {}, ev[LPT] = {};
      T w[LPT];
      load4<kVec>(P.occupied, i, n, occ);
      load4<kVec>(P.w, i, n, w);
      sweep4<T, kVec>(P, i, n, w, occ, rp, ev);
    }
    return;
  }
  // above one tile the record's tiles come from the counter, in the order
  // the blocks start
  const bool ranks = !one && (C.mode & RECORD);
  if (ranks) {
    if (t == 0) tile_s = (int)atomicAdd(ticket + 1, 1u);
    __syncthreads();
  }
  Olds<T> olds;
  if (t == 0) olds = read_olds(P);
  const int tile = ranks ? tile_s : (int)blockIdx.x;
  const int i = tile * BLOCK_LANES + t * LPT;

  // each lane's flags, after the sweep
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
    if (C.mode & SWEEP) sweep4<T, kVec>(P, i, n, w, occ0, rp0, evp);
  }
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    bad[j] = (C.mode & RECORD) && rp0[j] && (isnan_(w[j]) || isnan_(e[j]));
    rec[j] = (C.mode & RECORD) && rp0[j] && !bad[j] && !evp[j];
    c += rec[j];
  }
  // the block's scan of the rec counts, then the tiles' before it
  int x = c;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) w_scan[warp] = x;
  __syncthreads();
  int rank = x - c, total = 0;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    rank += q < warp ? w_scan[q] : 0;
    total += w_scan[q];
  }
  if (ranks) {
    if (warp == 0) {
      const int before = look_back(status, tile, total, lane);
      if (lane == 0) base_s = before;
    }
    __syncthreads();
    rank += base_s;
  }
  bool valid[LPT], any = false;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    valid[j] = rec[j] && rank < C.k;
    rank += rec[j];
    any = any || valid[j];
  }

  Partial<T> p = no_partial<T>();
  if (__any_sync(FULL, any)) {
    // the record fields of the thread's lanes, loaded together (vectors
    // where aligned)
    T x2[LPT], x3[LPT], x1i[LPT], x2i[LPT], tab[LPT], tsc[LPT], ne0[LPT], te0[LPT], b0[LPT];
    T e0[LPT];
    int32_t nsc[LPT], nsc0[LPT];
    const int li = i < n ? i : 0;  // a thread past n loads lane 0's, in range
    load4<kVec>(P.x2, li, n, x2), load4<kVec>(P.x3, li, n, x3), load4<kVec>(P.x1i, li, n, x1i);
    load4<kVec>(P.x2i, li, n, x2i), load4<kVec>(P.tau_abs, li, n, tab);
    load4<kVec>(P.tau_scatt, li, n, tsc), load4<kVec>(P.n_e_0, li, n, ne0);
    load4<kVec>(P.theta_e_0, li, n, te0), load4<kVec>(P.b_0, li, n, b0);
    load4<kVec>(P.e_0, li, n, e0), load4<kVec>(P.n_scatt, li, n, nsc);
    load4<kVec>(P.nsc0, li, n, nsc0);
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (valid[j]) {
        ++p.n_valid;
        if (isnan_(tsc[j]))
          p.tnan = 1;
        else
          take_max(p.tmax, p.tlane, tsc[j], i + j);
      }
      // the bins, rounded as the plain version's torch operations (a lane
      // that does not record bins at x2 = 0, e = 1)
      const T xj = valid[j] ? x2[j] : T(0.0), ej = valid[j] ? e[j] : T(1.0);
      const T fa = floor_(xj * C.inv_dx2), fb = floor_((C.x_stop2 - xj) * C.inv_dx2);
      const long long ix2 = (long long)(xj < C.mid ? fa : fb);
      const T le = log_(ej > T(1e-30) ? ej : T(1e-30));
      const long long i_e = (long long)floor_((le - C.l_e_0) * C.inv_d_l_e + T(2.5)) - 2;
      const bool ok = valid[j] && ix2 >= 0 && ix2 < C.n_th && i_e >= 0 && i_e < C.n_e;
      if (ok) {
        ++p.n_ok;
        p.n_nsc += nsc[j];
      }
      const T wj = w[j], we = wj * e[j];
      const T v[N_SPEC_CHAN] = {
          wj, we, T(1.0), (T)nsc[j], wj * x1i[j], wj * x2i[j] * x2i[j], wj * x3[j] * x3[j],
          wj * tab[j], wj * tsc[j], wj * ne0[j], wj * te0[j], wj * b0[j], wj * e0[j], we * we,
          nsc0[j] > 0 ? T(1.0) : T(0.0), (T)nsc0[j]};
      add_rows(P.spec, ok ? (int)(ix2 * C.n_e + i_e) : -1, v, lane);
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
  if (warp == 0) {
    p = lane < W ? w_part[lane] : no_partial<T>();
    warp_partial(p);  // lane 0: the block's
  }
  if (one) {
    if (t == 0) finish(P, C, p, n, olds);
    return;
  }
  Partial<T> *parts = reinterpret_cast<Partial<T> *>(P.scratch + parts_offset(max_tiles(n)));
  if (t == 0) {
    parts[tile] = p;
    last_s = take_ticket(ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // every block is past its look-back: the status words at rest again
  if (ranks)
    for (int b = t; b < (int)gridDim.x; b += NT) status[b] = 0ull;
  if (warp != 0) return;
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
    finish(P, C, s, n, olds);
    ticket[0] = 0u;
    ticket[1] = 0u;
  }
}

// Whether every field the kernel loads by vectors is aligned for them, and
// the lanes come in whole groups of LPT.
template <typename T>
bool vec_ok(const RecordPtrs<T> &P, int n) {
  const void *t16[] = {P.x0,      P.x1,      P.x2,      P.x3,  P.k0,     P.k1,
                       P.k2,      P.k3,      P.w,       P.e,   P.n_step, P.x1i,
                       P.x2i,     P.tau_abs, P.tau_scatt, P.n_e_0, P.theta_e_0, P.b_0,
                       P.e_0,     P.n_scatt, P.nsc0};
  const void *t4[] = {P.alive, P.occupied, P.record_pending, P.ev_pending};
  bool ok = n % LPT == 0;
  for (const void *p : t16) ok = ok && ((uintptr_t)p & 15) == 0;
  for (const void *p : t4) ok = ok && ((uintptr_t)p & 3) == 0;
  return ok;
}

// One block of ONE_TILE lanes up to ONE_TILE, else tiles of TILE.
template <typename T, bool kVec>
void launch_record_at(const RecordPtrs<T> &P, const RecordConst<T> &C, int n, cudaStream_t s) {
  if (n <= ONE_TILE)
    record_phase_kernel<T, kVec, ONE_NT><<<1, ONE_NT, 0, s>>>(P, C, n);
  else
    record_phase_kernel<T, kVec, TILE_NT><<<(n + TILE - 1) / TILE, TILE_NT, 0, s>>>(P, C, n);
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
  C.bias_norm = (T)S.bias_norm;
  C.ema = (T)S.ema;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && (C.mode & (SWEEP | RECORD | FREE))) {
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
int record_phase_scratch(int n) {
  return (int)(parts_offset(max_tiles(n)) + (size_t)max_tiles(n) * PARTIAL_BYTES);
}
// the kernels a call in this mode launches (0 for no stage)
int record_phase_launches(int mode) { return (mode & (SWEEP | RECORD | FREE)) ? 1 : 0; }

int record_phase_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_record<float>(ptrs, scal, n, stream);
}

int record_phase_f64_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_record<double>(ptrs, scal, n, stream);
}

}  // extern "C"
