// The event phase's fluid, opacities and bias, one hand-written kernel for
// Hopper (sm_90a): event_fluid_kernel<T>, computing engine.event_fluid_plain
// in float (T = float) or double (T = double).
//
// No TPU kernel does this: the JAX engine's event phase is XLA
// (grmonty_tpu/transport/engine.py:2036 `process_scatters`).  Before this
// kernel it was about 800 small torch launches a full phase.  For each lane
// of the event phase's compacted set it reads the raw 32-wide corner row
// that the phase's row gather fetched (hot_kernels.row_gather), the event's
// position (x1, x2), wave vector k, the lane's weight w and its defer count
// and writes:
//   - the covariant metric g7 at (x1, x2) (geometry.gcov_c);
//   - the fluid state the event kernel reads (fluid.blend_raw): n_e,
//     theta_e, |B|, u^mu, u_mu, b^mu, b_mu;
//   - the samplers' theta_e, halved every EV_HALVE defers
//     (theta_e 2^-(tries // EV_HALVE));
//   - the post-event refresh at the parent's k and the un-halved fluid
//     (harm_model.cpp:1026-1039): alpha_scatt and alpha_abs, each 0 where
//     the fluid-frame frequency is negative, and the bias
//     (engine.bias_func).
// scatter_event.cu's event kernel consumes these.  On the engine's path
// scatter_event.cu's event_phase kernel does this work itself (this kernel
// and the event alone stay as checks of its parts).
//
// Design: one thread a lane, 128-thread blocks; each block stages the
// (41, 31) hotcross surface in shared memory (rows padded to 32), and each
// lane reads its row by 16-byte loads.  What bounds it on an H100 80GB HBM3
// at 700 W: at 16,384 lanes it moves 3.0 MB in float (0.9 us at 3.35 TB/s)
// and each lane does about 3,200 float operations (the hotcross sum 2,542
// of them), 0.8 us at 67 TFLOP/s; a lane's chain of dependent operations,
// not the card's rates, sets its time.
//
// Numerics (physics.cuh): the blend, the metric pair, the four-vectors and
// the bias round as the plain versions (-fmad=false, the inv_*
// reciprocals); the bias in the plain order, 100 theta_e^2 / (bias_norm
// max_tau (avg + 2)); the hotcross sum in the reference variant's fused
// multiply-add order, so the scattering opacity agrees to the hot step's
// tolerance.
//
// Interface: plain C entry points for ctypes, event_fluid (float) and
// event_fluid_f64 (double): an array of device pointers in the order of
// FluidPtrs (hot_kernels.event_fluid lists the same order and checks the
// count), an array of double scalars (HotScal, then EV_HALVE), the lane
// count and the CUDA stream; returns cudaGetLastError().

#include "physics.cuh"

namespace {

constexpr int FLUID_THREADS = 128;
constexpr int FLUID_OUT = 30;  // the output fields, in the order of FluidPtrs' o[]

template <typename T>
struct FluidPtrs {  // order = hot_kernels._FLUID_PTRS
  const T *rows;  // (n, 32) raw corner rows
  const T *x1, *x2, *k0, *k1, *k2, *k3, *w;
  const int32_t *tries;
  const T *bias_den, *hc;  // the bias's denominator (one value), the (41, 31) surface
  // g7 (7), n_e, theta_e, b, u_con (4), u_cov (4), b_con (4), b_cov (4),
  // the samplers' theta_e, alpha_scatt, alpha_abs, the bias
  T *o[FLUID_OUT];
};
constexpr int FLUID_NPTRS = sizeof(FluidPtrs<float>) / sizeof(void *);
static_assert(sizeof(FluidPtrs<double>) == sizeof(FluidPtrs<float>), "one pointer layout");
constexpr int FLUID_NSCAL = HOT_NSCAL + 1;

template <typename T>
__global__ void __launch_bounds__(FLUID_THREADS)
    event_fluid_kernel(const FluidPtrs<T> P, const BConst<T> CB, int ev_halve, int n) {
  using V = typename Vec16<T>::type;
  constexpr int E = Vec16<T>::n;
  __shared__ V hs[HC_NX * HC_PITCH / E];  // the hotcross surface, rows of HC_PITCH
  for (int t = threadIdx.x; t < HC_NX * HC_PITCH; t += FLUID_THREADS) {
    const int ix = t / HC_PITCH, j = t - ix * HC_PITCH;
    reinterpret_cast<T *>(hs)[t] = j < HC_NY ? __ldg(P.hc + ix * HC_NY + j) : T(0.0);
  }
  __syncthreads();
  const int i = blockIdx.x * FLUID_THREADS + threadIdx.x;
  if (i >= n) return;

  const T x1 = P.x1[i], x2 = P.x2[i];
  const V *src = reinterpret_cast<const V *>(P.rows) + (size_t)i * (RAW_W / E);
  T row[RAW_W];
#pragma unroll
  for (int q = 0; q < RAW_W / E; ++q) Vec16<T>::unpack(__ldg(src + q), row + E * q);
  const bool inside = in_grid(x1, x2, CB);
  T pr[RAW_NC];
  blend_row<RAW_NC>(x1, x2, row, CB, pr);
  T n_e, te, b_mag, g[7], gc[6], u_con[4], u_cov[4], b_con[4], b_cov[4];
  raw_scalars(pr, inside, CB, n_e, te);
  metric_pair(x1, x2, CB, g, gc);
  four_vectors(pr, g, gc, CB, u_cov, b_cov, &b_mag, u_con, b_con);

  // the post-event refresh (Engine.eval_alphas at the parent's k) and the bias
  const T kk[4] = {P.k0[i], P.k1[i], P.k2[i], P.k3[i]};
  T sin_th, nu;
  kinematics(kk, u_cov, b_cov, b_mag, CB, sin_th, nu);
  const T nu_safe = fm::fabs(nu) + T(EPS_D);
  const T e_g = T(HPL_D) * nu_safe * CB.inv_mecc;
  const T a_sc = nu_safe * hotcross<true>(e_g, te, CB, hs) * n_e;
  const T a_ab = alpha_abs(nu_safe, n_e, te, b_mag, sin_th, CB);
  const T bias = bias_clamp(P.w[i], CB, [&] { return T(100.0) * te * te / P.bias_den[0]; });
  const bool neg = nu < T(0.0);

  T *const *o = P.o;
#pragma unroll
  for (int m = 0; m < 7; ++m) o[m][i] = g[m];
  o[7][i] = n_e;
  o[8][i] = te;
  o[9][i] = b_mag;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    o[10 + m][i] = u_con[m];
    o[14 + m][i] = u_cov[m];
    o[18 + m][i] = b_con[m];
    o[22 + m][i] = b_cov[m];
  }
  o[26][i] = te * fm::exp2(-T(P.tries[i] / ev_halve));
  o[27][i] = neg ? T(0.0) : a_sc;
  o[28][i] = neg ? T(0.0) : a_ab;
  o[29][i] = bias;
}

template <typename T>
int launch_fluid(void **ptrs, const double *scal, int n, void *stream) {
  FluidPtrs<T> P;
  memcpy(&P, ptrs, sizeof(FluidPtrs<T>));
  AConst<T> CA;
  BConst<T> CB;
  make_consts<T>(scal, CA, CB);
  const int ev_halve = (int)scal[HOT_NSCAL];
  if (n > 0)
    event_fluid_kernel<T><<<(n + FLUID_THREADS - 1) / FLUID_THREADS, FLUID_THREADS, 0,
                            (cudaStream_t)stream>>>(P, CB, ev_halve, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int event_fluid_nptrs() { return FLUID_NPTRS; }
int event_fluid_nscal() { return FLUID_NSCAL; }
int event_fluid_f64_nptrs() { return FLUID_NPTRS; }
int event_fluid_f64_nscal() { return FLUID_NSCAL; }

int event_fluid_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_fluid<float>(ptrs, scal, n, stream);
}

int event_fluid_f64_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_fluid<double>(ptrs, scal, n, stream);
}

}  // extern "C"
