// The track start of freshly loaded lanes, one hand-written kernel for
// Hopper (sm_90a): fresh_init_kernel<kRef, T>, computing all of
// engine.init_fresh_plain in float (T = float) or double (T = double).
//
// No TPU kernel does this: the JAX engine's fresh-lane init is XLA
// (grmonty_tpu/transport/engine.py:2320 `init_fresh`, harm_model.cpp:902-915).
// Before this kernel it was about a thousand small torch launches a call.
// For each lane of refill's compacted fresh set (valid, sidx) it computes:
//   - dk/dlambda from the 40-term connection at the lane's (x1, x2)
//     (geometry.connection_c, geodesic_rhs_c);
//   - the fluid at (x1, x2): the shipped profile (kRef = false) blends the
//     derived 44-wide row of hot_tab (fluid.blend_derived); reference
//     semantics (kRef = true) fetch the raw 32-wide row of corner_rows and
//     blend it through the metric pair (fluid.blend_raw);
//   - the opacities alpha_scatti (the Chebyshev hotcross, scalar form) and
//     alpha_absi (Kirchhoff, K2, synch, B_nu), the bias bi
//     (engine.bias_func), each zeroed outside the plasma, and interacting
//     = n_e > 0;
//   - under EngineConfig.trace_birth, the birth state bx, bk, bw = x, k, w.
// Every other lane, and a loaded lane that is not valid (NaN or zero
// weight: sidx < n, valid false), keeps its values bit for bit.
//
// Design: one thread a pool lane, 128-thread blocks.  The pool stays
// functional (the wrapper allocates the eight outputs, and the birth
// state's nine, anew): each thread finds its lane in sidx by a binary search
// (sidx ascends, padded with n) and either copies its current values or
// computes the start.  A block with no fresh lane only copies; one with any
// stages the (41, 31) hotcross surface in shared memory (rows padded to 32)
// first.  A fresh lane reads its corner row by 16-byte loads.
//
// What bounds it on an H100 80GB HBM3 at 700 W: at the shipped full phase
// (a 65,536-lane pool, 32,768 fresh slots) the copies move about 4.2 MB
// (1.3 us at 3.35 TB/s) and the fresh lanes each do about 3,500 float
// operations (the hotcross sum 2,542 of them), 1.7 us at 67 TFLOP/s; the
// lanes of a warp that hold no fresh lane wait for those that do.
//
// Numerics (physics.cuh): dk/dlambda and the blend round exactly as the
// plain versions (-fmad=false, the inv_* reciprocals); the bias follows the
// plain order, 100 theta_e^2 / (bias_norm max_tau (avg + 2)), the
// denominator a 0-d tensor of the pool's type; the hotcross sum is the
// reference variant's fused multiply-add order (u_j = sum_ix T_ix c[ix, j],
// then sum_j u_j T_j), not the plain version's matrix product, so the
// opacities agree to the hot step's tolerance.
//
// Interface: plain C entry points for ctypes, fresh_init and
// fresh_init_ref (float), fresh_init_f64 and fresh_init_ref_f64 (double).
// Each takes an array of device pointers in the order of FreshPtrs (the
// wrapper hot_kernels.fresh_init lists the same order and checks the
// count; the birth state's eighteen are null when the trace is off), an
// array of double scalars (HotScal, then the fresh set's width k), the pool's
// lane count n and the CUDA stream, and returns cudaGetLastError().

#include "physics.cuh"

typedef unsigned char u8;

namespace {

constexpr int FRESH_THREADS = 128;

template <typename T>
struct FreshPtrs {  // order = hot_kernels._FRESH_PTRS
  // the pool's fields that the start reads or passes on
  const T *x0, *x1, *x2, *x3, *k0, *k1, *k2, *k3, *w;
  const T *d0, *d1, *d2, *d3, *alpha_scatti, *alpha_absi, *bi;
  const u8 *interacting;
  // the compacted fresh set: valid (k,) and sidx (k,) ascending, padded with n
  const u8 *valid;
  const int64_t *sidx;
  // the bias's denominator (one value), the corner table (derived or raw) and
  // the (41, 31) hotcross surface
  const T *bias_den, *table, *hc;
  // the new fields
  T *od0, *od1, *od2, *od3, *oalpha_scatti, *oalpha_absi, *obi;
  u8 *ointeracting;
  // the birth state in and out (EngineConfig.trace_birth; all null when off)
  const T *bx0, *bx1, *bx2, *bx3, *bk0, *bk1, *bk2, *bk3, *bw;
  T *obx0, *obx1, *obx2, *obx3, *obk0, *obk1, *obk2, *obk3, *obw;
};
constexpr int FRESH_NPTRS = sizeof(FreshPtrs<float>) / sizeof(void *);
static_assert(sizeof(FreshPtrs<double>) == sizeof(FreshPtrs<float>), "one pointer layout");
constexpr int FRESH_NSCAL = HOT_NSCAL + 1;

// The slot of pool lane i in the fresh set's sidx[0, k) (ascending, the
// padding n past the last lane), or -1.
__device__ __forceinline__ int fresh_slot(const int64_t *sidx, int k, int i) {
  int lo = 0, hi = k;  // the first slot whose lane is at least i
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(sidx + mid) < i)
      lo = mid + 1;
    else
      hi = mid;
  }
  return (lo < k && __ldg(sidx + lo) == i) ? lo : -1;
}

template <bool kRef, typename T>
__global__ void __launch_bounds__(FRESH_THREADS)
    fresh_init_kernel(const FreshPtrs<T> P, const AConst<T> CA, const BConst<T> CB, int n,
                      int k) {
  using V = typename Vec16<T>::type;
  constexpr int E = Vec16<T>::n;
  constexpr int W = kRef ? RAW_W : ROW_W, M = kRef ? RAW_NC : NC;
  __shared__ V hs[HC_NX * HC_PITCH / E];  // the hotcross surface, rows of HC_PITCH
  const int i = blockIdx.x * FRESH_THREADS + threadIdx.x;
  const int slot = i < n ? fresh_slot(P.sidx, k, i) : -1;
  const bool fresh = slot >= 0 && P.valid[slot];
  const bool trace = P.obw != nullptr;
  if (__syncthreads_or(fresh)) {
    for (int t = threadIdx.x; t < HC_NX * HC_PITCH; t += FRESH_THREADS) {
      const int ix = t / HC_PITCH, j = t - ix * HC_PITCH;
      reinterpret_cast<T *>(hs)[t] = j < HC_NY ? __ldg(P.hc + ix * HC_NY + j) : T(0.0);
    }
    __syncthreads();
  }
  if (i >= n) return;
  if (!fresh) {  // the lane keeps its values
    P.od0[i] = P.d0[i];
    P.od1[i] = P.d1[i];
    P.od2[i] = P.d2[i];
    P.od3[i] = P.d3[i];
    P.oalpha_scatti[i] = P.alpha_scatti[i];
    P.oalpha_absi[i] = P.alpha_absi[i];
    P.obi[i] = P.bi[i];
    P.ointeracting[i] = P.interacting[i];
    if (trace) {
      P.obx0[i] = P.bx0[i]; P.obx1[i] = P.bx1[i]; P.obx2[i] = P.bx2[i]; P.obx3[i] = P.bx3[i];
      P.obk0[i] = P.bk0[i]; P.obk1[i] = P.bk1[i]; P.obk2[i] = P.bk2[i]; P.obk3[i] = P.bk3[i];
      P.obw[i] = P.bw[i];
    }
    return;
  }

  const T x1 = P.x1[i], x2 = P.x2[i], w = P.w[i];
  const T kk[4] = {P.k0[i], P.k1[i], P.k2[i], P.k3[i]};
  // dk/dlambda (geometry.connection_c, geodesic_rhs_c)
  T dk[4];
  {
    T conn[40];
    connection(x1, x2, CA, conn);
    geodesic_rhs(conn, kk, dk);
  }

  // the lane's corner row at its cell (geometry.x_to_ij_c), then the blend
  const V *src = reinterpret_cast<const V *>(P.table) + (size_t)cell_of(x1, x2, CB) * (W / E);
  T row[W];
#pragma unroll
  for (int q = 0; q < W / E; ++q) Vec16<T>::unpack(__ldg(src + q), row + E * q);
  const bool inside = in_grid(x1, x2, CB);
  T pr[M];
  blend_row<M>(x1, x2, row, CB, pr);
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
  const T a_sc = nu_safe * hotcross<true>(e_g, te, CB, hs) * n_e;
  const T a_ab = alpha_abs(nu_safe, n_e, te, b_mag, sin_th, CB);
  const T b0 = bias_clamp(w, CB, [&] { return T(100.0) * te * te / P.bias_den[0]; });
  const bool plasma = n_e > T(0.0);

  P.od0[i] = dk[0];
  P.od1[i] = dk[1];
  P.od2[i] = dk[2];
  P.od3[i] = dk[3];
  P.oalpha_scatti[i] = plasma ? a_sc : T(0.0);
  P.oalpha_absi[i] = plasma ? a_ab : T(0.0);
  P.obi[i] = plasma ? b0 : T(0.0);
  P.ointeracting[i] = plasma;
  if (trace) {  // the freshly loaded lane's (x, k, w) is its birth state
    P.obx0[i] = P.x0[i]; P.obx1[i] = x1; P.obx2[i] = x2; P.obx3[i] = P.x3[i];
    P.obk0[i] = kk[0]; P.obk1[i] = kk[1]; P.obk2[i] = kk[2]; P.obk3[i] = kk[3];
    P.obw[i] = w;
  }
}

template <bool kRef, typename T>
int launch_fresh(void **ptrs, const double *scal, int n, void *stream) {
  FreshPtrs<T> P;
  memcpy(&P, ptrs, sizeof(FreshPtrs<T>));
  AConst<T> CA;
  BConst<T> CB;
  make_consts<T>(scal, CA, CB);
  const int k = (int)scal[HOT_NSCAL];
  if (n > 0)
    fresh_init_kernel<kRef, T><<<(n + FRESH_THREADS - 1) / FRESH_THREADS, FRESH_THREADS, 0,
                                 (cudaStream_t)stream>>>(P, CA, CB, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int fresh_init_nptrs() { return FRESH_NPTRS; }
int fresh_init_nscal() { return FRESH_NSCAL; }
int fresh_init_ref_nptrs() { return FRESH_NPTRS; }
int fresh_init_ref_nscal() { return FRESH_NSCAL; }
int fresh_init_f64_nptrs() { return FRESH_NPTRS; }
int fresh_init_f64_nscal() { return FRESH_NSCAL; }
int fresh_init_ref_f64_nptrs() { return FRESH_NPTRS; }
int fresh_init_ref_f64_nscal() { return FRESH_NSCAL; }

int fresh_init_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_fresh<false, float>(ptrs, scal, n, stream);
}

int fresh_init_ref_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_fresh<true, float>(ptrs, scal, n, stream);
}

int fresh_init_f64_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_fresh<false, double>(ptrs, scal, n, stream);
}

int fresh_init_ref_f64_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_fresh<true, double>(ptrs, scal, n, stream);
}

}  // extern "C"
