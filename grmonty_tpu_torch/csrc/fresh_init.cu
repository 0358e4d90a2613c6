// The load and track start of refill's fresh lanes, one hand-written kernel
// for Hopper (sm_90a): fresh_init_kernel<kRef, T, G>, computing each slot's
// source, refill's row moves and all of engine.init_fresh_plain in float
// (T = float) or double (T = double), in place on the pool.
//
// No TPU kernel does this: the JAX engine's refill and fresh-lane init are
// XLA (grmonty_tpu/transport/engine.py:2204 `refill`, :2320 `init_fresh`,
// harm_model.cpp:895-915).  The engine's phases keep only the compaction of
// the free lanes (hot_kernels.compact, inverted on the occupied mask); each
// slot works out its source here from the compaction's (valid, sidx), the
// ring's count, the backlog position and its valid rows
// (engine.refill_sources_plain; slot_source), and the last block updates
// the count, the position and n_created in place through a ticket the
// engine owns.  For each slot s that loads, lane sidx[s] takes the 16-wide
// row of the ring or of the backlog that slot_source names here:
//   - the load (Engine.refill's row moves): x, k, w, e, l, n_e_0,
//     theta_e_0, b_0, e_0 from the row, e_0_s = e, x1i, x2i = x1, x2, the
//     optical depths, pend_dl and sec_w zeroed, n_scatt = nsc0 = the row's
//     count as int32, n_step and ev_tries 0, dl_shrink 1, occupied and
//     alive set where the row is valid (no NaN in x or k, nonzero weight),
//     pend_push, at_event and record_pending cleared;
//   - where the row is valid, the start: dk/dlambda from the 40-term
//     connection at the lane's (x1, x2) (geometry.connection_c,
//     geodesic_rhs_c); the fluid at (x1, x2): the shipped profile (kRef =
//     false) blends the derived 44-wide row of hot_tab (fluid.blend_derived),
//     reference semantics (kRef = true) the raw 32-wide row of corner_rows
//     through the metric pair (fluid.blend_raw); the opacities alpha_scatti
//     (the Chebyshev hotcross, scalar form) and alpha_absi (Kirchhoff, K2,
//     synch, B_nu), the bias bi (engine.bias_func), each zeroed outside the
//     plasma, interacting = n_e > 0; under EngineConfig.trace_birth the
//     birth state bx, bk, bw = x, k, w.
// Every lane outside the loaded slots keeps its values: the kernel writes
// nothing there.
//
// Design: the launch runs over the K slots, not the N pool lanes (the
// version before it searched sidx from every pool lane and copied every
// kept lane into new outputs: 4.2 MB at 65,536 lanes).  G threads take a
// slot (fresh_group: 8 at the narrow sets of the cascade and the gate, 1
// at the wide ones); they compute the same bits but for the hotcross sum,
// whose 31 columns they split (physics.cuh's hotcross_cols: each forms its
// columns' u_j over ix in the fused order, then the sum of u_j T_j runs in
// j order over a gather by shuffles, so the opacities are those of one
// thread a slot, bit for bit), and the first of them stores.  A block with
// no loaded slot exits at once; the others stage the (41, 31) hotcross
// surface in shared memory (rows padded to 32) by cp.async at entry,
// behind the row's loads, the connection and the blend, and wait on it
// only before the sum.  A loaded lane reads its row and its corner row by 16-byte
// loads.  Measured (PERF.md, on an H100, against the kernel before it with
// refill's row moves as torch ops, in turns): 14.0 / 268.5 us at 32,768
// slots, 7.7 / 184.8 at 512 in float (that kernel alone: 20.3 and 13.1).
//
// Working out the sources costs a block one shared read of the three
// values, two block counts and a ticket: 14.9 us at 32,768 slots in float,
// against 13.7 for the kernel before it, which took the sources as tensors
// worked out by torch ops (chip_smoke.py, PERF.md).
//
// What bounds it on an H100 80GB HBM3 at 700 W: at the shipped full phase
// (32,768 slots) each loaded slot reads its row and its corner row and
// writes its 35 fields once, about 240 B in float; a valid slot does about
// 3,500 float operations (the hotcross sum 2,542 of them).
//
// Numerics (physics.cuh): dk/dlambda and the blend round exactly as the
// plain versions (-fmad=false, the inv_* reciprocals); the bias follows the
// plain order, 100 theta_e^2 / (bias_norm max_tau (avg + 2)), the
// denominator a 0-d tensor of the pool's type; the hotcross sum is the
// reference variant's fused multiply-add order (u_j = sum_ix T_ix c[ix, j],
// then sum_j u_j T_j), not the plain version's matrix product, so the
// opacities agree to the hot step's tolerance.  The loaded fields are the
// row's bits (the count cast as torch casts it on the card).
//
// Interface: plain C entry points for ctypes, fresh_init and
// fresh_init_ref (float), fresh_init_f64 and fresh_init_ref_f64 (double).
// Each takes an array of device pointers in the order of FreshPtrs (the
// wrapper hot_kernels.refill_fresh lists the same order and checks the
// count; the birth state's nine are null when the trace is off, n_valid
// null where the backlog's valid rows come as a scalar), an array of
// double scalars (HotScal, then the slots K, the backlog's valid rows, the
// ring's and the backlog's rows), the pool's lane count n and the CUDA
// stream, and returns cudaGetLastError(); <entry>_group(k) gives the
// threads a slot at K = k.

#include "physics.cuh"

typedef unsigned char u8;

namespace {

constexpr int FRESH_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
// The packed photon rows of the backlog and the ring (engine.ROW_*): x, k,
// then the weight, e, l, n_e_0, theta_e_0, b_0, e_0 and the scatter count
constexpr int PK_WIDTH = 16, PK_W = 8, PK_E = 9, PK_L = 10, PK_NE0 = 11, PK_THETAE0 = 12,
              PK_B0 = 13, PK_E0 = 14, PK_NSCATT = 15;

template <typename T>
struct FreshPtrs {  // order = hot_kernels._FRESH_PTRS
  // the pool, updated in place: the fields the load writes
  T *x0, *x1, *x2, *x3, *k0, *k1, *k2, *k3, *w, *e, *l, *n_e_0, *theta_e_0, *b_0, *e_0;
  T *e_0_s, *x1i, *x2i, *tau_abs, *tau_scatt, *pend_dl, *dl_shrink, *sec_w;
  int32_t *n_scatt, *nsc0, *n_step, *ev_tries;
  u8 *occupied, *alive, *pend_push, *at_event, *record_pending;
  // those the start writes
  T *d0, *d1, *d2, *d3, *alpha_scatti, *alpha_absi, *bi;
  u8 *interacting;
  // the birth state (EngineConfig.trace_birth; all null when off)
  T *bx0, *bx1, *bx2, *bx3, *bk0, *bk1, *bk2, *bk3, *bw;
  // the slots (K): the compaction of the free lanes, its valid flags and
  // lanes (ascending, padded with n)
  const u8 *valid;
  const int64_t *sidx;
  // the ring's and the backlog's rows, the bias's denominator (one value),
  // the corner table (derived or raw) and the (41, 31) hotcross surface
  const T *sec_rows, *backlog_rows, *bias_den, *table, *hc;
  // the ring's count, the backlog position, its valid rows (null: the
  // scalar), the created count, and the ticket (three words at zero
  // between launches: the ticket, the slots taken from the ring and from
  // the backlog)
  int64_t *sec_count, *backlog_pos;
  const int64_t *n_valid;
  int64_t *n_created;
  unsigned *ticket;
};
constexpr int FRESH_NPTRS = sizeof(FreshPtrs<float>) / sizeof(void *);
static_assert(sizeof(FreshPtrs<double>) == sizeof(FreshPtrs<float>), "one pointer layout");
// HotScal, then the slots K, the backlog's valid rows where n_valid is
// null, the ring's and the backlog's rows
constexpr int FRESH_NSCAL = HOT_NSCAL + 4;

struct SlotScal {
  long long n_valid, sec_rows, backlog_rows;
};

// The threads a slot at K slots: the sets of the cascade's narrow pools and
// the gate's spread over more threads.
inline int fresh_group(int k) { return k <= 1024 ? 8 : (k <= 4096 ? 4 : 1); }

// Slot s's source (engine.refill_sources_plain): the r-th
// valid slot takes the ring's row count - 1 - r while r is below the ring's
// count, else the backlog's row pos + r - count while
// that is below its valid rows.  Every thread of the block reads the three
// values before thread 0 takes the block's ticket; the last block to take
// it adds the block's counts into the ring's count, the backlog position
// and the created count, so every block reads the values from before the
// launch.
template <typename T>
__device__ __forceinline__ void slot_source(const FreshPtrs<T> &P, const SlotScal &SS, int s0,
                                            int k, bool lead, bool &load, bool &from_sec,
                                            int64_t &sec_idx, int64_t &bl_idx) {
  __shared__ long long held[3];
  if (threadIdx.x == 0) {
    held[0] = *P.sec_count;
    held[1] = *P.backlog_pos;
    held[2] = P.n_valid != nullptr ? *P.n_valid : SS.n_valid;
  }
  __syncthreads();
  const long long n_sec = held[0], pos = held[1], nv = held[2], r = s0;
  const bool v = s0 < k && P.valid[s0];
  from_sec = v && r < n_sec;
  const long long si = n_sec - 1 - r, bl = pos + (r > n_sec ? r - n_sec : 0);
  const bool from_bl = v && r >= n_sec && bl < nv;
  sec_idx = si < 0 ? 0 : (si > SS.sec_rows - 1 ? SS.sec_rows - 1 : si);
  bl_idx = bl < 0 ? 0 : (bl > SS.backlog_rows - 1 ? SS.backlog_rows - 1 : bl);
  load = from_sec || from_bl;
  const int c_sec = __syncthreads_count(lead && from_sec);
  const int c_bl = __syncthreads_count(lead && from_bl);
  if (threadIdx.x == 0) {
    unsigned *tk = P.ticket;
    if (c_sec) atomicAdd(tk + 1, (unsigned)c_sec);
    if (c_bl) atomicAdd(tk + 2, (unsigned)c_bl);
    __threadfence();
    if (atomicAdd(tk, 1u) == gridDim.x - 1) {  // every block has read the values
      __threadfence();
      const unsigned a = atomicExch(tk + 1, 0u), b = atomicExch(tk + 2, 0u);
      *P.sec_count -= a;
      *P.backlog_pos += b;
      *P.n_created += b;
      *tk = 0u;
    }
  }
}

template <bool kRef, typename T, int G>
__global__ void __launch_bounds__(FRESH_THREADS)
    fresh_init_kernel(const FreshPtrs<T> P, const AConst<T> CA, const BConst<T> CB,
                      const SlotScal SS, int n, int k) {
  using V = typename Vec16<T>::type;
  constexpr int E = Vec16<T>::n;
  constexpr int W = kRef ? RAW_W : ROW_W, M = kRef ? RAW_NC : NC;
  __shared__ V hs[HC_NX * HC_PITCH / E];  // the hotcross surface, rows of HC_PITCH
  __shared__ unsigned long long hc_bar;  // its copies' barrier
  const int s0 = blockIdx.x * (FRESH_THREADS / G) + threadIdx.x / G;
  const int sub = threadIdx.x % G;  // this thread's place in its slot's group
  const int64_t lane = s0 < k ? __ldg(P.sidx + s0) : n;
  bool load, from_sec;
  int64_t sec_idx, bl_idx;
  slot_source(P, SS, s0, k, sub == 0, load, from_sec, sec_idx, bl_idx);
  if (!__syncthreads_or(load)) return;
  // the surface's copies run behind the row's loads, the connection and the
  // blend; each thread arrives on the barrier once its own have landed
  if (threadIdx.x == 0) barrier_init(&hc_bar, FRESH_THREADS);
  __syncthreads();
  for (int t = threadIdx.x; t < HC_NX * HC_PITCH; t += FRESH_THREADS) {
    const int ix = t / HC_PITCH, j = t - ix * HC_PITCH;
    const bool pad = j >= HC_NY;
    T *dst = reinterpret_cast<T *>(hs) + t;
    const T *src = P.hc + (pad ? 0 : ix * HC_NY + j);
    if constexpr (sizeof(T) == 8)
      cp_async8(dst, src, pad);
    else
      cp_async4(dst, src, pad);
  }
  cp_async_arrive(&hc_bar);
  if (!load) {  // no thread leaves with its copies in flight
    barrier_wait(&hc_bar);
    return;
  }

  // the slot's row: the load
  const int i = (int)lane;
  const T *rp = from_sec ? P.sec_rows + sec_idx * PK_WIDTH : P.backlog_rows + bl_idx * PK_WIDTH;
  T row[PK_WIDTH];
#pragma unroll
  for (int q = 0; q < PK_WIDTH / E; ++q)
    Vec16<T>::unpack(__ldg(reinterpret_cast<const V *>(rp) + q), row + E * q);
  // invalid photons are dropped on load (harm_model.cpp:895-900)
  bool bad = row[PK_W] == T(0.0);
#pragma unroll
  for (int j = 0; j < 8; ++j) bad = bad || ::isnan(row[j]);
  const bool lead = sub == 0;
  if (lead) {
    P.x0[i] = row[0]; P.x1[i] = row[1]; P.x2[i] = row[2]; P.x3[i] = row[3];
    P.k0[i] = row[4]; P.k1[i] = row[5]; P.k2[i] = row[6]; P.k3[i] = row[7];
    P.w[i] = row[PK_W];
    P.e[i] = row[PK_E];
    P.l[i] = row[PK_L];
    P.n_e_0[i] = row[PK_NE0];
    P.theta_e_0[i] = row[PK_THETAE0];
    P.b_0[i] = row[PK_B0];
    P.e_0[i] = row[PK_E0];
    P.e_0_s[i] = row[PK_E];
    P.x1i[i] = row[1];
    P.x2i[i] = row[2];
    P.tau_abs[i] = T(0.0);
    P.tau_scatt[i] = T(0.0);
    P.pend_dl[i] = T(0.0);
    P.dl_shrink[i] = T(1.0);
    P.sec_w[i] = T(0.0);
    const int32_t nsc = (int32_t)row[PK_NSCATT];
    P.n_scatt[i] = nsc;
    P.nsc0[i] = nsc;
    P.n_step[i] = 0;
    P.ev_tries[i] = 0;
    if (!bad) {
      P.occupied[i] = 1;
      P.alive[i] = 1;
    }
    P.pend_push[i] = 0;
    P.at_event[i] = 0;
    P.record_pending[i] = 0;
  }
  if (bad) {
    barrier_wait(&hc_bar);
    return;
  }

  // the start
  const T x1 = row[1], x2 = row[2], w = row[PK_W];
  const T kk[4] = {row[4], row[5], row[6], row[7]};
  // dk/dlambda (geometry.connection_c, geodesic_rhs_c)
  T dk[4];
  {
    T conn[40];
    connection(x1, x2, CA, conn);
    geodesic_rhs(conn, kk, dk);
  }

  // the lane's corner row at its cell (geometry.x_to_ij_c), then the blend
  const V *src = reinterpret_cast<const V *>(P.table) + (size_t)cell_of(x1, x2, CB) * (W / E);
  T crow[W];
#pragma unroll
  for (int q = 0; q < W / E; ++q) Vec16<T>::unpack(__ldg(src + q), crow + E * q);
  const bool inside = in_grid(x1, x2, CB);
  T pr[M];
  blend_row<M>(x1, x2, crow, CB, pr);
  T n_e, te, b_mag, u_cov[4], b_cov[4];
  if constexpr (kRef) {
    raw_scalars(pr, inside, CB, n_e, te);
    T g[7], gc[6];
    metric_pair(x1, x2, CB, g, gc);
    four_vectors(pr, g, gc, CB, u_cov, b_cov, &b_mag);
  } else {
    derived_fluid(pr, inside, n_e, te, b_mag, u_cov, b_cov);
  }

  // the opacities (Engine.eval_alphas) and the bias (engine.bias_func)
  T sin_th, nu;
  kinematics(kk, u_cov, b_cov, b_mag, CB, sin_th, nu);
  const T nu_safe = fm::fabs(nu) + T(EPS_D);
  const T e_g = T(HPL_D) * nu_safe * CB.inv_mecc;
  barrier_wait(&hc_bar);
  const int first = (threadIdx.x & 31) & ~(G - 1);
  const unsigned group = G == 32 ? FULL : ((1u << G) - 1u) << first;
  const T a_sc = nu_safe * hotcross_cols<G>(e_g, te, CB, hs, sub, group, first, 1) * n_e;
  const T a_ab = alpha_abs(nu_safe, n_e, te, b_mag, sin_th, CB);
  const T b0 = bias_clamp(w, CB, [&] { return T(100.0) * te * te / P.bias_den[0]; });
  const bool plasma = n_e > T(0.0);
  if (!lead) return;

  P.d0[i] = dk[0];
  P.d1[i] = dk[1];
  P.d2[i] = dk[2];
  P.d3[i] = dk[3];
  P.alpha_scatti[i] = plasma ? a_sc : T(0.0);
  P.alpha_absi[i] = plasma ? a_ab : T(0.0);
  P.bi[i] = plasma ? b0 : T(0.0);
  P.interacting[i] = plasma;
  if (P.bw != nullptr) {  // the freshly loaded lane's (x, k, w) is its birth state
    P.bx0[i] = row[0]; P.bx1[i] = x1; P.bx2[i] = x2; P.bx3[i] = row[3];
    P.bk0[i] = kk[0]; P.bk1[i] = kk[1]; P.bk2[i] = kk[2]; P.bk3[i] = kk[3];
    P.bw[i] = w;
  }
}

template <bool kRef, typename T, int G>
void launch_fresh_at(const FreshPtrs<T> &P, const AConst<T> &CA, const BConst<T> &CB,
                     const SlotScal &SS, int n, int k, cudaStream_t stream) {
  constexpr int SLOTS = FRESH_THREADS / G;
  fresh_init_kernel<kRef, T, G><<<(k + SLOTS - 1) / SLOTS, FRESH_THREADS, 0, stream>>>(
      P, CA, CB, SS, n, k);
}

template <bool kRef, typename T>
int launch_fresh(void **ptrs, const double *scal, int n, void *stream) {
  FreshPtrs<T> P;
  memcpy(&P, ptrs, sizeof(FreshPtrs<T>));
  AConst<T> CA;
  BConst<T> CB;
  make_consts<T>(scal, CA, CB);
  const int k = (int)scal[HOT_NSCAL];
  SlotScal SS;
  SS.n_valid = (long long)scal[HOT_NSCAL + 1];
  SS.sec_rows = (long long)scal[HOT_NSCAL + 2];
  SS.backlog_rows = (long long)scal[HOT_NSCAL + 3];
  const cudaStream_t s = (cudaStream_t)stream;
  if (n > 0 && k > 0) {
    switch (fresh_group(k)) {
      case 1: launch_fresh_at<kRef, T, 1>(P, CA, CB, SS, n, k, s); break;
      case 4: launch_fresh_at<kRef, T, 4>(P, CA, CB, SS, n, k, s); break;
      case 8: launch_fresh_at<kRef, T, 8>(P, CA, CB, SS, n, k, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define FRESH_ENTRY(name, kRef, T)                                                        \
  int name##_nptrs() { return FRESH_NPTRS; }                                              \
  int name##_nscal() { return FRESH_NSCAL; }                                              \
  int name##_group(int k) { return fresh_group(k); }                                      \
  int name##_launch(void **ptrs, const double *scal, int n, void *stream) {               \
    return launch_fresh<kRef, T>(ptrs, scal, n, stream);                                  \
  }

FRESH_ENTRY(fresh_init, false, float)
FRESH_ENTRY(fresh_init_ref, true, float)
FRESH_ENTRY(fresh_init_f64, false, double)
FRESH_ENTRY(fresh_init_ref_f64, true, double)

}  // extern "C"
