// The transport's device physics, shared by the hand-written kernels of
// this directory: hot_step.cu (the fused hot step), fresh_init.cu (the
// track start of freshly loaded lanes), event_fluid.cu (the event phase's
// fluid, opacities and bias) and scatter_event.cu (the event itself, and
// the whole event phase in one kernel).
//
// Each function is the plain torch version's arithmetic operation by
// operation in the kernel's type T (float or double), as hot_step.cu's
// header sets out: every literal T(x), every math call the T overload of
// namespace fm, a division by a Python scalar a multiply by its reciprocal
// in T (the inv_* constants, read from PyTorch per type), so that with
// -fmad=false each result rounds as its plain version's does.  It holds:
//   - the math of the type (fm), the 16-byte unit (Vec16) and torch's
//     NaN-propagating maximum, minimum and clip;
//   - the scalars and constants (AScal/AConst, BScal/BConst, HotScal and
//     their makers);
//   - the 40-term connection and the geodesic right-hand side
//     (geometry.connection_c, geodesic_rhs_c);
//   - the bilinear blend of a corner row (fluid.blend_derived, blend_raw):
//     in_grid, cell_of, blend_row, derived_fluid, raw_scalars, and the raw rows'
//     metric pair and four-vectors (metric_pair, four_vectors);
//   - the kinematics (radiation.kinematics_sin_c), the Chebyshev hotcross
//     (cheb.hotcross_eval, scalar form in two orders; hotcross_cols and
//     hotcross_rows: each order split over a lane's threads, by columns or
//     by rows, the same bits), K2, synch and B_nu
//     (alpha_abs: radiation.alpha_inv_abs_sin_c) and the bias clamp
//     (engine.bias_func);
//   - the staging of a table in shared memory by cp.async, its copies'
//     arrival on a shared-memory barrier and the wait for it;
//   - the lanes' random numbers: Philox4x64-10 (philox), a word as a
//     uniform (unif) and the samplers of the counter's second word
//     (ops/draws.py, whose PhiloxDraws and hot_uniforms are their plain
//     versions).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr double PI_D = 3.14159265358979323846;
constexpr double EPS_D = 1.0e-30;
constexpr double ME_D = 9.1093826e-28;
constexpr double CL_D = 2.99792458e10;
constexpr double HPL_D = 6.6260693e-27;
constexpr double EE_D = 4.80320680e-10;
constexpr double SIGMA_T_D = 0.665245873e-24;

// The math of the kernel's type: each function the float or the double
// operation, chosen by overload, never by promotion.
namespace fm {
__device__ __forceinline__ float exp(float x) { return expf(x); }
__device__ __forceinline__ double exp(double x) { return ::exp(x); }
__device__ __forceinline__ float exp2(float x) { return exp2f(x); }
__device__ __forceinline__ double exp2(double x) { return ::exp2(x); }
__device__ __forceinline__ float log(float x) { return logf(x); }
__device__ __forceinline__ double log(double x) { return ::log(x); }
__device__ __forceinline__ float log10(float x) { return log10f(x); }
__device__ __forceinline__ double log10(double x) { return ::log10(x); }
__device__ __forceinline__ float log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p(double x) { return ::log1p(x); }
__device__ __forceinline__ float sin(float x) { return sinf(x); }
__device__ __forceinline__ double sin(double x) { return ::sin(x); }
__device__ __forceinline__ float cos(float x) { return cosf(x); }
__device__ __forceinline__ double cos(double x) { return ::cos(x); }
__device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
__device__ __forceinline__ float rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt(double x) { return ::rsqrt(x); }
__device__ __forceinline__ float fabs(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs(double x) { return ::fabs(x); }
__device__ __forceinline__ float floor(float x) { return floorf(x); }
__device__ __forceinline__ double floor(double x) { return ::floor(x); }
__device__ __forceinline__ float fmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax(double a, double b) { return ::fmax(a, b); }
__device__ __forceinline__ float fmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double fmin(double a, double b) { return ::fmin(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float qnan(float) { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ double qnan(double) {
  return __longlong_as_double(0x7ff8000000000000ll);
}
}  // namespace fm

// A 16-byte unit of T (one LDS.128 / LDG.128) and the values it holds.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(const float4 &v, float *c) {
    c[0] = v.x;
    c[1] = v.y;
    c[2] = v.z;
    c[3] = v.w;
  }
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ void unpack(const double2 &v, double *c) {
    c[0] = v.x;
    c[1] = v.y;
  }
};

// torch.maximum / torch.minimum: NaN if either operand is NaN.
template <typename T>
__device__ __forceinline__ T jmax(T a, T b) {
  return (a != a || b != b) ? fm::qnan(a) : fm::fmax(a, b);
}
template <typename T>
__device__ __forceinline__ T jmin(T a, T b) {
  return (a != a || b != b) ? fm::qnan(a) : fm::fmin(a, b);
}
template <typename T>
__device__ __forceinline__ T jclip(T x, T lo, T hi) {
  return jmin(jmax(x, lo), hi);
}

// ---------------------------------------------------------------------------
// the scalars of a launch
// ---------------------------------------------------------------------------

struct AScal {  // order = hot_kernels._A_SCAL
  double a, h_slope, r_0, x_start1, x_start2, x_stop2, dx1, dx2, n1, n2,
      x1_min, d_tau_k, fp_iters, weight_min, shrink_floor, grow_cap,
      grow_tau_cap, step_ctrl, inv_dx1, inv_dx2, inv_e_tol, inv_e_drift_tol;
};
constexpr int A_NSCAL = sizeof(AScal) / sizeof(double);

// Per-launch constants of type T, folded in double on the host side of the
// launch exactly as the Python expressions fold their float literals.
template <typename T>
struct AConst {
  T a, a2, a3, a4, neg_a, neg_a2, neg_2a, r_0, two_pi, pi, half_1mh,
      one_mh, neg2pipi_1mh, x_start1, x_start2, x_stop2, dx1, dx2, x1_min,
      half_dtk, weight_min, shrink_floor, grow_cap, grow_tau_cap, step_ctrl,
      inv_dx1, inv_dx2, inv_e_tol, inv_e_drift_tol;
  int n1, n2, fp_iters;
};

constexpr int HC_NX = 41, HC_NY = 31, K2_N = 25, ROW_W = 44, NC = 11;
constexpr int RAW_W = 32, RAW_NC = 8;
constexpr int HC_PITCH = 32;  // a staged coefficient row: 31 values and a pad

struct BScal {  // order = hot_kernels._B_SCAL
  double x_start1, x_start2, x_stop1, x_stop2, dx1, dx2, n1, n2, b_unit,
      d_tau_k, weight_min, stall_steps, tau_cap, hc_xlo, hc_xhi,
      hc_ylo, hc_yhi, k2_lo, k2_hi, inv_dx1, inv_dx2, inv_b_unit, inv_hpl,
      inv_mecc, inv_hc_xdiff, inv_hc_ydiff, inv_k2_diff, inv_cl, inv_24,
      inv_2pimecl, inv_weight_min, inv_tp_over_te;
  double k2c[K2_N];
};
constexpr int B_NSCAL = sizeof(BScal) / sizeof(double);

template <typename T>
struct BConst {
  T x_start1, x_start2, x_stop1, x_stop2, dx1, dx2, b_unit, half_dtk,
      weight_min, tau_cap, hc_xlo, hc_xhi, hc_xsum, hc_xdiff, hc_ylo, hc_yhi,
      hc_ysum, hc_ydiff, k2_lo, k2_hi, k2_sum, k2_diff, inv_dx1, inv_dx2,
      inv_b_unit, inv_hpl, inv_mecc, inv_hc_xdiff, inv_hc_ydiff, inv_k2_diff,
      inv_cl, inv_24, inv_2pimecl, inv_weight_min, inv_tp_over_te;
  T k2c[K2_N];
  int n1, n2, stall_steps;
  // raw rows only: the metric pair and the primitives' units
  T a, a2, neg_a, r_0, two_pi, pi, half_1mh, one_mh, n_e_unit, theta_e_unit;
};

struct HotScal {  // order = hot_kernels._HOT_SCAL
  AScal a;
  BScal b;
  double n_e_unit, theta_e_unit;
};
constexpr int HOT_NSCAL = sizeof(HotScal) / sizeof(double);

template <typename T>
AConst<T> make_aconst(const AScal &S) {
  AConst<T> C;
  C.a = (T)S.a;
  C.a2 = (T)(S.a * S.a);
  C.a3 = (T)(S.a * S.a * S.a);
  C.a4 = (T)(S.a * S.a * S.a * S.a);
  C.neg_a = (T)(-S.a);
  C.neg_a2 = (T)(-(S.a * S.a));
  C.neg_2a = (T)(-2.0 * S.a);
  C.r_0 = (T)S.r_0;
  C.two_pi = (T)(2.0 * PI_D);
  C.pi = (T)PI_D;
  C.half_1mh = (T)(0.5 * (1.0 - S.h_slope));
  C.one_mh = (T)(1.0 - S.h_slope);
  C.neg2pipi_1mh = (T)(-2.0 * PI_D * PI_D * (1.0 - S.h_slope));
  C.x_start1 = (T)S.x_start1;
  C.x_start2 = (T)S.x_start2;
  C.x_stop2 = (T)S.x_stop2;
  C.dx1 = (T)S.dx1;
  C.dx2 = (T)S.dx2;
  C.inv_dx1 = (T)S.inv_dx1;
  C.inv_dx2 = (T)S.inv_dx2;
  C.inv_e_tol = (T)S.inv_e_tol;
  C.inv_e_drift_tol = (T)S.inv_e_drift_tol;
  C.x1_min = (T)S.x1_min;
  C.half_dtk = (T)(0.5 * S.d_tau_k);
  C.weight_min = (T)S.weight_min;
  C.shrink_floor = (T)S.shrink_floor;
  C.grow_cap = (T)S.grow_cap;
  C.grow_tau_cap = (T)S.grow_tau_cap;
  C.step_ctrl = (T)S.step_ctrl;
  C.n1 = (int)S.n1;
  C.n2 = (int)S.n2;
  C.fp_iters = (int)S.fp_iters;
  return C;
}

template <typename T>
BConst<T> make_bconst(const BScal &S) {
  BConst<T> C;
  C.x_start1 = (T)S.x_start1;
  C.x_start2 = (T)S.x_start2;
  C.x_stop1 = (T)S.x_stop1;
  C.x_stop2 = (T)S.x_stop2;
  C.dx1 = (T)S.dx1;
  C.dx2 = (T)S.dx2;
  C.b_unit = (T)S.b_unit;
  C.half_dtk = (T)(0.5 * S.d_tau_k);
  C.weight_min = (T)S.weight_min;
  C.tau_cap = (T)S.tau_cap;
  C.hc_xlo = (T)S.hc_xlo;
  C.hc_xhi = (T)S.hc_xhi;
  C.hc_xsum = (T)(S.hc_xhi + S.hc_xlo);
  C.hc_xdiff = (T)(S.hc_xhi - S.hc_xlo);
  C.hc_ylo = (T)S.hc_ylo;
  C.hc_yhi = (T)S.hc_yhi;
  C.hc_ysum = (T)(S.hc_yhi + S.hc_ylo);
  C.hc_ydiff = (T)(S.hc_yhi - S.hc_ylo);
  C.k2_lo = (T)S.k2_lo;
  C.k2_hi = (T)S.k2_hi;
  C.k2_sum = (T)(S.k2_hi + S.k2_lo);
  C.k2_diff = (T)(S.k2_hi - S.k2_lo);
  C.inv_dx1 = (T)S.inv_dx1;
  C.inv_dx2 = (T)S.inv_dx2;
  C.inv_b_unit = (T)S.inv_b_unit;
  C.inv_hpl = (T)S.inv_hpl;
  C.inv_mecc = (T)S.inv_mecc;
  C.inv_hc_xdiff = (T)S.inv_hc_xdiff;
  C.inv_hc_ydiff = (T)S.inv_hc_ydiff;
  C.inv_k2_diff = (T)S.inv_k2_diff;
  C.inv_cl = (T)S.inv_cl;
  C.inv_24 = (T)S.inv_24;
  C.inv_2pimecl = (T)S.inv_2pimecl;
  C.inv_weight_min = (T)S.inv_weight_min;
  C.inv_tp_over_te = (T)S.inv_tp_over_te;
  for (int q = 0; q < K2_N; ++q) C.k2c[q] = (T)S.k2c[q];
  C.n1 = (int)S.n1;
  C.n2 = (int)S.n2;
  C.stall_steps = (int)S.stall_steps;
  return C;
}

// The hot step's scalars (HotScal) as per-launch constants of type T: phase
// A's, phase B's, and the raw rows' metric pair and primitives' units.
template <typename T>
void make_consts(const double *scal, AConst<T> &CA, BConst<T> &CB) {
  HotScal S;
  memcpy(&S, scal, sizeof(HotScal));
  CA = make_aconst<T>(S.a);
  CB = make_bconst<T>(S.b);
  CB.a = CA.a;
  CB.a2 = CA.a2;
  CB.neg_a = CA.neg_a;
  CB.r_0 = CA.r_0;
  CB.two_pi = CA.two_pi;
  CB.pi = CA.pi;
  CB.half_1mh = CA.half_1mh;
  CB.one_mh = CA.one_mh;
  CB.n_e_unit = (T)S.n_e_unit;
  CB.theta_e_unit = (T)S.theta_e_unit;
}

// ---------------------------------------------------------------------------
// the geodesic
// ---------------------------------------------------------------------------

// The 40 Christoffel terms at (x1, x2) into c; with `keep`, also its
// transcendentals exp(x1), sin(2 pi x2), cos(2 pi x2), sin(th) and cos(th),
// from which metric row 0 and the metric pair at (x1, x2) follow.
template <typename T, typename Out>
__device__ __forceinline__ void connection(T x1, T x2, const AConst<T> &C, Out c,
                                           T *keep = nullptr) {
  const T r1 = fm::exp(x1);
  const T r2 = r1 * r1, r3 = r2 * r1, r4 = r3 * r1;
  const T sx = fm::sin(C.two_pi * x2);
  const T cx = fm::cos(C.two_pi * x2);
  const T th = C.pi * x2 + C.half_1mh * sx;
  const T dth = C.pi * (T(1.0) + C.one_mh * cx);
  const T d2th = C.neg2pipi_1mh * sx;
  const T dth2 = dth * dth;
  const T sth = fm::sin(th), cth = fm::cos(th);
  const T sth2 = sth * sth, sth4 = sth2 * sth2;
  const T cth2 = cth * cth, cth4 = cth2 * cth2;
  const T s2th = T(2.0) * sth * cth;
  const T c2th = T(2.0) * cth2 - T(1.0);
  const T r1sth2 = r1 * sth2;
  const T a = C.a, a2 = C.a2, a3 = C.a3, a4 = C.a4;
  const T a2sth2 = a2 * sth2, a2cth2 = a2 * cth2, a4cth4 = a4 * cth4;
  const T rho2 = r2 + a2cth2;
  const T rho22 = rho2 * rho2, rho23 = rho22 * rho2;
  const T ir2 = T(1.0) / rho2;
  const T ir22 = ir2 * ir2, ir23 = ir22 * ir2;
  const T ir23_dth = ir23 / dth;
  const T fac1 = r2 - a2cth2;
  const T f1r3 = fac1 * ir23;
  const T fac2 = a2 + T(2.0) * r2 + a2 * c2th;
  const T fac3 = a2 + r1 * (r1 - T(2.0));

  c[0] = T(2.0) * r1 * f1r3;
  c[1] = r1 * (T(2.0) * r1 + rho2) * f1r3;
  c[2] = C.neg_a2 * r1 * s2th * dth * ir22;
  c[3] = C.neg_2a * r1sth2 * f1r3;
  c[4] = T(2.0) * r2 * (r4 + r1 * fac1 - a4cth4) * ir23;
  c[5] = C.neg_a2 * r2 * s2th * dth * ir22;
  c[6] = a * r1 * (-r1 * (r3 + T(2.0) * fac1) + a4cth4) * sth2 * ir23;
  c[7] = T(-2.0) * r2 * dth2 * ir2;
  c[8] = a3 * r1sth2 * s2th * dth * ir22;
  c[9] = T(2.0) * r1sth2 * (-r1 * rho22 + a2sth2 * fac1) * ir23;

  c[10] = fac3 * fac1 / (r1 * rho23);
  c[11] = fac1 * (T(-2.0) * r1 + a2sth2) * ir23;
  c[12] = T(0.0);
  c[13] = C.neg_a * sth2 * fac3 * fac1 / (r1 * rho23);
  c[14] = (r4 * (r1 - T(2.0)) * (T(1.0) + r1) +
           a2 * (a2 * r1 * (T(1.0) + T(3.0) * r1) * cth4 + a4cth4 * cth2 +
                 r3 * sth2 + r1 * cth2 * (T(2.0) * r1 + T(3.0) * r3 - a2sth2))) *
          ir23;
  c[15] = C.neg_a2 * dth * s2th / fac2;
  c[16] = a * sth2 *
          (a4 * r1 * cth4 + r2 * (T(2.0) * r1 + r3 - a2sth2) +
           a2cth2 * (T(2.0) * r1 * (r2 - T(1.0)) + a2sth2)) *
          ir23;
  c[17] = -fac3 * dth2 * ir2;
  c[18] = T(0.0);
  c[19] = -fac3 * sth2 * (r1 * rho22 - a2 * fac1 * sth2) / (r1 * rho23);

  const T c200 = C.neg_a2 * r1 * s2th * ir23_dth;
  c[20] = c200;
  c[21] = r1 * c200;
  c[22] = T(0.0);
  c[23] = a * r1 * (a2 + r2) * s2th * ir23_dth;
  c[24] = r2 * c200;
  c[25] = r2 * ir2;
  c[26] = (a * r1 * cth * sth *
           (r3 * (T(2.0) + r1) +
            a2 * (T(2.0) * r1 * (T(1.0) + r1) * cth2 + a2 * cth4 + T(2.0) * r1sth2))) *
          ir23_dth;
  c[27] = C.neg_a2 * cth * sth * dth * ir2 + d2th / dth;
  c[28] = T(0.0);
  c[29] = (-cth * sth *
           (rho23 + a2sth2 * rho2 * (r1 * (T(4.0) + r1) + a2cth2) +
            T(2.0) * r1 * a4 * sth4) *
           ir23_dth);

  const T c300 = a * f1r3;
  c[30] = c300;
  c[31] = r1 * c300;
  c[32] = C.neg_2a * r1 * cth * dth / (sth * rho22);
  c[33] = -a2sth2 * f1r3;
  c[34] = a * r2 * f1r3;
  c[35] = C.neg_2a * r1 * (a2 + T(2.0) * r1 * (T(2.0) + r1) + a2 * c2th) * cth *
          dth / (sth * fac2 * fac2);
  c[36] = r1 * (r1 * rho22 - a2sth2 * fac1) * ir23;
  c[37] = C.neg_a * r1 * dth2 * ir2;
  c[38] = dth * (T(0.25) * fac2 * fac2 * cth / sth + a2 * r1 * s2th) * ir22;
  c[39] = (C.neg_a * r1sth2 * rho22 + a3 * sth4 * fac1) * ir23;
  if (keep) {
    keep[0] = r1;
    keep[1] = sx;
    keep[2] = cx;
    keep[3] = sth;
    keep[4] = cth;
  }
}

template <typename T, typename In>
__device__ __forceinline__ void geodesic_rhs(const In &c, const T *k, T *dk) {
  const T q[10] = {k[0] * k[0],          T(2.0) * k[0] * k[1],
                   T(2.0) * k[0] * k[2], T(2.0) * k[0] * k[3],
                   k[1] * k[1],          T(2.0) * k[1] * k[2],
                   T(2.0) * k[1] * k[3], k[2] * k[2],
                   T(2.0) * k[2] * k[3], k[3] * k[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T s = c[10 * i] * q[0];
#pragma unroll
    for (int j = 1; j < 10; ++j) s = s + c[10 * i + j] * q[j];
    dk[i] = -s;
  }
}

// ---------------------------------------------------------------------------
// the fluid and the opacities
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T hc_klein_nishina(T w) {
  const T series = T(1.0) - T(2.0) * w;
  const T ws = jmax(w, T(1.0e-6));
  const T full =
      T(0.75) * ((T(1.0) / (ws * ws)) * T(2.0) +
                 (T(1.0) / (T(2.0) * ws) - (T(1.0) + ws) / (ws * ws * ws)) *
                     fm::log1p(T(2.0) * ws) +
                 (T(1.0) + ws) / ((T(1.0) + T(2.0) * ws) * (T(1.0) + T(2.0) * ws)));
  return (w < T(1.0e-3)) ? series : full;
}

template <typename T>
__device__ __forceinline__ T k2_eval(T te, const BConst<T> &C) {
  const T l_t = jclip(fm::log(jmax(te, T(0.3))), C.k2_lo, C.k2_hi);
  const T t = (T(2.0) * l_t - C.k2_sum) * C.inv_k2_diff;
  const T t2 = T(2.0) * t;
  T b1 = T(0.0), b2 = T(0.0);
#pragma unroll
  for (int k = K2_N - 1; k > 0; --k) {
    const T nb = C.k2c[k] + t2 * b1 - b2;
    b2 = b1;
    b1 = nb;
  }
  const T interp = fm::exp(C.k2c[0] + t * b1 - b2);
  const T out = (te > T(100.0)) ? T(2.0) * te * te : interp;
  return (te < T(0.3)) ? T(0.0) : out;
}

template <typename T>
__device__ __forceinline__ T b_nu(T nu, T te, const BConst<T> &C) {
  const T x = T(HPL_D) * nu / (T(ME_D * CL_D * CL_D) * te + T(EPS_D));
  const T pref = (T(2.0 * HPL_D) * nu) * (nu * C.inv_cl) * (nu * C.inv_cl);
  const T series =
      pref / (x * C.inv_24 * (T(24.0) + x * (T(12.0) + x * (T(4.0) + x))) + T(EPS_D));
  const T full = pref / (fm::exp(jmin(x, T(80.0))) - T(1.0) + T(EPS_D));
  return (x < T(1.0e-3)) ? series : full;
}

template <typename T>
__device__ __forceinline__ T synch(T nu, T n_e, T te, T b, T sin_th, T k2,
                                   const BConst<T> &C) {
  const T nu_c = T(EE_D) * b * C.inv_2pimecl;
  const T nu_s = T(2.0 / 9.0) * nu_c * te * te * sin_th;
  const T x = nu / (nu_s + T(EPS_D));
  const T xp = fm::exp(fm::log(jmax(x, T(1e-37))) * T(1.0 / 3.0));
  const T xx = fm::sqrt(x) + T(1.88774862536) * fm::sqrt(xp);
  const T f = xx * xx;
  const T val = T(1.4142135623730951 * PI_D * EE_D * EE_D / (3.0 * CL_D)) * n_e * nu_s /
                (k2 + T(EPS_D)) * f * fm::exp(-xp);
  const bool bad = (te < T(0.3)) || (nu > T(1.0e12) * nu_s) || (k2 <= T(0.0));
  return bad ? T(0.0) : val;
}

// The covariant and contravariant MKS metric at (x1, x2) (geometry.gcov_c,
// gcon_c): g = (g00, g01, g03, g11, g13, g22, g33), gc = (gc00, gc01, gc11,
// gc13, gc22, gc33); with `keep`, from the transcendentals that connection()
// kept at (x1, x2).
template <typename T>
__device__ __forceinline__ void metric_pair(T x1, T x2, const BConst<T> &C, T *g, T *gc,
                                            const T *keep = nullptr) {
  const T eps = T(EPS_D);
  const T r = (keep ? keep[0] : fm::exp(x1)) + C.r_0;
  const T th = C.pi * x2 + C.half_1mh * (keep ? keep[1] : fm::sin(C.two_pi * x2));
  const T sth = fm::fabs(keep ? keep[3] : fm::sin(th)) + eps;
  const T cth = keep ? keep[4] : fm::cos(th);
  const T s2 = sth * sth;
  const T rho2 = r * r + C.a2 * cth * cth;
  const T tworr = T(2.0) * r / rho2;
  const T rfac = r - C.r_0;
  const T hfac = C.pi * (T(1.0) + C.one_mh * (keep ? keep[2] : fm::cos(C.two_pi * x2)));
  g[0] = T(-1.0) + tworr;
  g[1] = tworr * rfac;
  g[2] = C.neg_a * s2 * tworr;
  g[3] = (T(1.0) + tworr) * rfac * rfac;
  g[4] = C.neg_a * s2 * (T(1.0) + tworr) * rfac;
  g[5] = rho2 * hfac * hfac;
  g[6] = s2 * (rho2 + C.a2 * s2 * (T(1.0) + tworr));
  const T irho2 = T(1.0) / (r * r + C.a2 * cth * cth);
  gc[0] = T(-1.0) - T(2.0) * r * irho2;
  gc[1] = T(2.0) * irho2;
  gc[2] = irho2 * (r * (r - T(2.0)) + C.a2) / (r * r);
  gc[3] = C.a * irho2 / r;
  gc[4] = irho2 / (hfac * hfac);
  gc[5] = irho2 / (sth * sth);
}

// v_mu = g_{mu nu} v^nu (geometry.lower_c)
template <typename T>
__device__ __forceinline__ void lower(const T *g, const T *v, T *out) {
  out[0] = g[0] * v[0] + g[1] * v[1] + g[2] * v[3];
  out[1] = g[1] * v[0] + g[3] * v[1] + g[4] * v[3];
  out[2] = g[5] * v[2];
  out[3] = g[2] * v[0] + g[4] * v[1] + g[6] * v[3];
}

// u_mu, b_mu and |B| from the blended primitives (fluid._four_vectors_c);
// with u_con_out and b_con_out also u^mu and b^mu
template <typename T>
__device__ __forceinline__ void four_vectors(const T *pr, const T *g, const T *gc,
                                             const BConst<T> &C, T *u_cov, T *b_cov,
                                             T *b_mag, T *u_con_out = nullptr,
                                             T *b_con_out = nullptr) {
  const T v1 = pr[2], v2 = pr[3], v3 = pr[4];
  const T b1 = pr[5], b2 = pr[6], b3 = pr[7];
  const T v_dot_v = g[3] * v1 * v1 + g[5] * v2 * v2 + g[6] * v3 * v3 +
                    T(2.0) * g[4] * v1 * v3;
  const T v_fac = fm::sqrt(T(-1.0) / gc[0] * (T(1.0) + fm::fabs(v_dot_v)));
  const T u0 = -v_fac * gc[0];
  const T u1 = v1 - v_fac * gc[1];
  const T u_con[4] = {u0, u1, v2, v3};
  lower(g, u_con, u_cov);
  const T u_dot_bp = u_cov[1] * b1 + u_cov[2] * b2 + u_cov[3] * b3;
  const T b_con[4] = {u_dot_bp, (b1 + u1 * u_dot_bp) / u0, (b2 + v2 * u_dot_bp) / u0,
                      (b3 + v3 * u_dot_bp) / u0};
  lower(g, b_con, b_cov);
  const T bsq = b_con[0] * b_cov[0] + b_con[1] * b_cov[1] + b_con[2] * b_cov[2] +
                b_con[3] * b_cov[3];
  *b_mag = fm::sqrt(fm::fabs(bsq)) * C.b_unit;
  if (u_con_out) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      u_con_out[m] = u_con[m];
      b_con_out[m] = b_con[m];
    }
  }
}

// Whether (x1, x2) lies inside the grid (fluid._inside): outside it n_e is 0.
template <typename T>
__device__ __forceinline__ bool in_grid(T x1, T x2, const BConst<T> &CB) {
  return (x1 >= CB.x_start1) && (x1 <= CB.x_stop1) && (x2 >= CB.x_start2) &&
         (x2 <= CB.x_stop2);
}

// The lane's cell (geometry.x_to_ij_c): the index i * n2 + j of its corner
// row, the cell clamped into the grid as blend_row clamps it.
template <typename T>
__device__ __forceinline__ int cell_of(T x1, T x2, const BConst<T> &CB) {
  const T fi = fm::floor((x1 - CB.x_start1) * CB.inv_dx1 - T(0.5));
  const T fj = fm::floor((x2 - CB.x_start2) * CB.inv_dx2 - T(0.5));
  const int ii = (int)fm::fmin(fm::fmax(fi, T(0.0)), T(CB.n1 - 2));
  const int jj = (int)fm::fmin(fm::fmax(fj, T(0.0)), T(CB.n2 - 2));
  return ii * CB.n2 + jj;
}

// The bilinear blend of a lane's corner row (fluid.blend_derived,
// fluid.blend_raw): the M components pr[] blended from the row's 4 corners
// of M (the cell and the offsets of geometry.x_to_ij_c).
template <int M, typename T>
__device__ __forceinline__ void blend_row(T x1, T x2, const T *row, const BConst<T> &CB,
                                          T *pr) {
  const T fi = fm::floor((x1 - CB.x_start1) * CB.inv_dx1 - T(0.5));
  const T fj = fm::floor((x2 - CB.x_start2) * CB.inv_dx2 - T(0.5));
  const T ci = fm::fmin(fm::fmax(fi, T(0.0)), T(CB.n1 - 2));
  const T cj = fm::fmin(fm::fmax(fj, T(0.0)), T(CB.n2 - 2));
  T del_i = (x1 - ((ci + T(0.5)) * CB.dx1 + CB.x_start1)) * CB.inv_dx1;
  T del_j = (x2 - ((cj + T(0.5)) * CB.dx2 + CB.x_start2)) * CB.inv_dx2;
  del_i = (fi < T(0.0)) ? T(0.0) : ((fi > T(CB.n1 - 2)) ? T(1.0) : del_i);
  del_j = (fj < T(0.0)) ? T(0.0) : ((fj > T(CB.n2 - 2)) ? T(1.0) : del_j);
  const T c00 = (T(1.0) - del_i) * (T(1.0) - del_j);
  const T c01 = (T(1.0) - del_i) * del_j;
  const T c10 = del_i * (T(1.0) - del_j);
  const T c11 = del_i * del_j;
#pragma unroll
  for (int m = 0; m < M; ++m)
    pr[m] = row[m] * c00 + row[M + m] * c01 + row[2 * M + m] * c10 + row[3 * M + m] * c11;
}

// The fluid state of a blended derived row (fluid.blend_derived): n_e (0
// outside the grid), theta_e as the ratio of blends, |B|, u_mu and b_mu.
template <typename T>
__device__ __forceinline__ void derived_fluid(const T *pr, bool inside, T &n_e, T &te,
                                              T &b_mag, T *u_cov, T *b_cov) {
  n_e = inside ? pr[0] : T(0.0);
  te = pr[1] / pr[0];
  b_mag = pr[2];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    u_cov[m] = pr[3 + m];
    b_cov[m] = pr[7 + m];
  }
}

// n_e (0 outside the grid) and theta_e of a blended raw row
// (fluid.blend_raw); its four-vectors follow from four_vectors.
template <typename T>
__device__ __forceinline__ void raw_scalars(const T *pr, bool inside, const BConst<T> &CB,
                                            T &n_e, T &te) {
  n_e = inside ? pr[0] * CB.n_e_unit : T(0.0);
  te = pr[1] / pr[0] * CB.theta_e_unit;
}

// (sin theta, nu) of the photon k in the fluid (radiation.kinematics_sin_c).
template <typename T>
__device__ __forceinline__ void kinematics(const T *k, const T *u_cov, const T *b_cov, T b_mag,
                                           const BConst<T> &CB, T &sin_th, T &nu) {
  const T eps = T(EPS_D);
  const T k_u = k[0] * u_cov[0] + k[1] * u_cov[1] + k[2] * u_cov[2] + k[3] * u_cov[3];
  const T k_b = k[0] * b_cov[0] + k[1] * b_cov[1] + k[2] * b_cov[2] + k[3] * b_cov[3];
  const T mu = jclip(k_b / (fm::fabs(k_u) * b_mag * CB.inv_b_unit + eps), T(-1.0), T(1.0));
  sin_th = (b_mag == T(0.0)) ? T(1.0) : fm::sqrt(T(1.0) - mu * mu);
  nu = -k_u * T(ME_D) * T(CL_D) * T(CL_D) * CB.inv_hpl;
}

// The invariant absorption opacity by Kirchhoff's law at nu_safe
// (radiation.alpha_inv_abs_sin_c, the K2 of cheb.k2_eval).
template <typename T>
__device__ __forceinline__ T alpha_abs(T nu_safe, T n_e, T te, T b_mag, T sin_th,
                                       const BConst<T> &CB) {
  const T j = synch(nu_safe, n_e, te, b_mag, sin_th, k2_eval(te, CB), CB);
  return nu_safe * j / (b_nu(nu_safe, te, CB) + T(EPS_D));
}

// The scattering bias's clamp (engine.bias_func): at least TP_OVER_TE, at
// most half the weight w over WEIGHT_MIN, over TP_OVER_TE; `bias()` gives
// the value before the clamp, evaluated after the cap.
template <typename T, typename F>
__device__ __forceinline__ T bias_clamp(T w, const BConst<T> &CB, F bias) {
  const T cap = T(0.5) * w * CB.inv_weight_min;
  return jmin(jmax(bias(), T(3.0)), cap) * CB.inv_tp_over_te;
}

// T_ix(tx) by the recurrence, ix = 0, 1, 2, ... in turn.
template <typename T>
__device__ __forceinline__ T cheb_next(int ix, T tx, T &tm1, T &tm2) {
  if (ix == 0) return T(1.0);
  if (ix == 1) return tx;
  const T t = T(2.0) * tx * tm1 - tm2;
  tm2 = tm1;
  tm1 = t;
  return t;
}

// sigma_hot(w, theta_e) [cm^2] from the Chebyshev surface
// (cheb.hotcross_eval), its rows staged in shared memory at hs (HC_PITCH
// values a row), each read as 16-byte broadcast loads.  kPlainOrder =
// false (the derived variant, as the shipped profile was measured): s_ix =
// sum_j c[ix, j] T_j(ty), then sum_ix T_ix(tx) s_ix.  kPlainOrder = true
// (the raw variant): the order of the plain version, u_j = sum_ix T_ix(tx)
// c[ix, j] as one fused multiply-add chain in ix order (each row's dot
// product of the matrix product), then sum_j u_j T_j(ty), T_j built after
// the sum so that it holds no registers across it.
template <bool kPlainOrder, typename T>
__device__ __forceinline__ T hotcross(T w, T te, const BConst<T> &C,
                                      const typename Vec16<T>::type *hs) {
  constexpr int E = Vec16<T>::n;
  const T l_w = jclip(fm::log10(jmax(w, T(1e-30))), C.hc_xlo, C.hc_xhi);
  const T l_t = jclip(fm::log10(jmax(te, T(1e-30))), C.hc_ylo, C.hc_yhi);
  const T tx = (T(2.0) * l_w - C.hc_xsum) * C.inv_hc_xdiff;
  const T ty = (T(2.0) * l_t - C.hc_ysum) * C.inv_hc_ydiff;
  T acc = T(0.0), tm2 = T(1.0), tm1 = tx;
  T u[HC_NY], by[HC_NY];
  if constexpr (kPlainOrder) {
#pragma unroll
    for (int j = 0; j < HC_NY; ++j) u[j] = T(0.0);
  } else {
    by[0] = T(1.0);
    by[1] = ty;
#pragma unroll
    for (int j = 2; j < HC_NY; ++j) by[j] = T(2.0) * ty * by[j - 1] - by[j - 2];
  }
#pragma unroll 1
  for (int ix = 0; ix < HC_NX; ++ix) {
    const T t = cheb_next(ix, tx, tm1, tm2);
    T c[HC_PITCH];
#pragma unroll
    for (int q = 0; q < HC_PITCH / E; ++q)
      Vec16<T>::unpack(hs[ix * (HC_PITCH / E) + q], c + E * q);
    if constexpr (kPlainOrder) {
#pragma unroll
      for (int j = 0; j < HC_NY; ++j) u[j] = fm::fma_rn(t, c[j], u[j]);
    } else {
      T s = T(0.0);
#pragma unroll
      for (int j = 0; j < HC_NY; ++j) s += c[j] * by[j];
      acc += t * s;
    }
  }
  if constexpr (kPlainOrder) {
    T bm2 = T(1.0), bm1 = ty;
#pragma unroll
    for (int j = 0; j < HC_NY; ++j) acc += u[j] * cheb_next(j, ty, bm1, bm2);
  }
  const T interp = fm::exp(acc * T(2.302585092994046));
  const T cold = hc_klein_nishina(w) * T(SIGMA_T_D);
  const T out = (te < T(1.0e-4)) ? cold : interp;
  return (w * te < T(1.0e-6)) ? T(SIGMA_T_D) : out;
}

// sigma_hot as hotcross<true> computes it, bit for bit, with the 32 staged
// columns (31 and the pad) split over a lane's G threads (fresh_init.cu,
// the event phase of scatter_event.cu): thread `sub` forms u_j = sum_ix
// T_ix(tx) c[ix, j] for its 32 / G columns in ix order, then each thread
// gathers u_0 ... u_30 in order from their threads and sums u_j T_j(ty) in j
// order.  The group's threads are first, first + stride, ... (`group` their
// mask), thread first + q stride holding sub = q.
template <int G, typename T>
__device__ __forceinline__ T hotcross_cols(T w, T te, const BConst<T> &C,
                                           const typename Vec16<T>::type *hs, int sub,
                                           unsigned group, int first, int stride) {
  if constexpr (G == 1) {
    return hotcross<true>(w, te, C, hs);
  } else {
    constexpr int E = Vec16<T>::n, COLS = HC_PITCH / G;
    static_assert(COLS % E == 0, "whole 16-byte units of columns a thread");
    const T l_w = jclip(fm::log10(jmax(w, T(1e-30))), C.hc_xlo, C.hc_xhi);
    const T l_t = jclip(fm::log10(jmax(te, T(1e-30))), C.hc_ylo, C.hc_yhi);
    const T tx = (T(2.0) * l_w - C.hc_xsum) * C.inv_hc_xdiff;
    const T ty = (T(2.0) * l_t - C.hc_ysum) * C.inv_hc_ydiff;
    T u[COLS];
#pragma unroll
    for (int q = 0; q < COLS; ++q) u[q] = T(0.0);
    T tm2 = T(1.0), tm1 = tx;
#pragma unroll
    for (int ix = 0; ix < HC_NX; ++ix) {  // unrolled: a few columns hold few registers
      const T t = cheb_next(ix, tx, tm1, tm2);
      T c[COLS];
#pragma unroll
      for (int q = 0; q < COLS / E; ++q)
        Vec16<T>::unpack(hs[ix * (HC_PITCH / E) + sub * (COLS / E) + q], c + E * q);
#pragma unroll
      for (int q = 0; q < COLS; ++q) u[q] = fm::fma_rn(t, c[q], u[q]);
    }
    T acc = T(0.0), bm2 = T(1.0), bm1 = ty;
#pragma unroll
    for (int j = 0; j < HC_NY; ++j)
      acc += __shfl_sync(group, u[j % COLS], first + (j / COLS) * stride) *
             cheb_next(j, ty, bm1, bm2);
    const T interp = fm::exp(acc * T(2.302585092994046));
    const T cold = hc_klein_nishina(w) * T(SIGMA_T_D);
    const T out = (te < T(1.0e-4)) ? cold : interp;
    return (w * te < T(1.0e-6)) ? T(SIGMA_T_D) : out;
  }
}

// sigma_hot as hotcross<false> computes it, bit for bit, with the 41 rows
// dealt over a lane's G threads (the float hot step's shipped variant):
// thread `sub` takes the rows sub, sub + G, ... (the first 41 % G threads one
// more), forms each row's T_ix(tx) s_ix, s_ix = sum_j c[ix, j] T_j(ty) in j
// order, and every thread then adds the 41 products in ix order, each
// gathered from its thread by a shuffle.  The staged rows are PITCH values
// apart (36 keeps the group's loads of one column unit, on G rows at once,
// off each other's banks).  The group's threads are as hotcross_cols's.
template <int G, int PITCH, typename T>
__device__ __forceinline__ T hotcross_rows(T w, T te, const BConst<T> &C,
                                           const typename Vec16<T>::type *hs, int sub,
                                           unsigned group, int first, int stride) {
  if constexpr (G == 1) {
    static_assert(PITCH == HC_PITCH, "one thread a lane reads the rows at HC_PITCH");
    return hotcross<false>(w, te, C, hs);
  } else {
    constexpr int E = Vec16<T>::n, R = (HC_NX + G - 1) / G;
    static_assert(PITCH % E == 0 && PITCH >= HC_PITCH, "whole 16-byte units a row");
    const T l_w = jclip(fm::log10(jmax(w, T(1e-30))), C.hc_xlo, C.hc_xhi);
    const T l_t = jclip(fm::log10(jmax(te, T(1e-30))), C.hc_ylo, C.hc_yhi);
    const T tx = (T(2.0) * l_w - C.hc_xsum) * C.inv_hc_xdiff;
    const T ty = (T(2.0) * l_t - C.hc_ysum) * C.inv_hc_ydiff;
    T by[HC_NY];
    by[0] = T(1.0);
    by[1] = ty;
#pragma unroll
    for (int j = 2; j < HC_NY; ++j) by[j] = T(2.0) * ty * by[j - 1] - by[j - 2];
    T t_own[R];  // T_ix(tx) of this thread's rows, by the recurrence over all 41
#pragma unroll
    for (int r = 0; r < R; ++r) t_own[r] = T(0.0);
    {
      T tm2 = T(1.0), tm1 = tx;
#pragma unroll
      for (int ix = 0; ix < HC_NX; ++ix) {
        const T t = cheb_next(ix, tx, tm1, tm2);
        if (ix % G == sub) t_own[ix / G] = t;
      }
    }
    T p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ix = sub + r * G < HC_NX ? sub + r * G : HC_NX - 1;  // past the last: unused
      T c[HC_PITCH];
#pragma unroll
      for (int q = 0; q < HC_PITCH / E; ++q) Vec16<T>::unpack(hs[ix * (PITCH / E) + q], c + E * q);
      T s = T(0.0);
#pragma unroll
      for (int j = 0; j < HC_NY; ++j) s += c[j] * by[j];
      p[r] = t_own[r] * s;
    }
    T acc = T(0.0);
#pragma unroll
    for (int ix = 0; ix < HC_NX; ++ix)
      acc += __shfl_sync(group, p[ix / G], first + (ix % G) * stride);
    const T interp = fm::exp(acc * T(2.302585092994046));
    const T cold = hc_klein_nishina(w) * T(SIGMA_T_D);
    const T out = (te < T(1.0e-4)) ? cold : interp;
    return (w * te < T(1.0e-6)) ? T(SIGMA_T_D) : out;
  }
}

// ---------------------------------------------------------------------------
// staging in shared memory behind the thread (hot_step.cu, fresh_init.cu)
// ---------------------------------------------------------------------------

// A copy of 8 (or 4) bytes from global into shared memory that runs behind
// the thread (cp.async; `zero`: zero bytes, nothing read), the thread's
// arrival on a shared-memory barrier once its copies have landed, and the
// wait for the barrier's first phase: a warp that reaches the wait after
// every copy landed passes at once, whatever the other warps are doing.
__device__ __forceinline__ void cp_async8(void *dst, const void *src, bool zero) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(zero ? 0 : 8)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void *dst, const void *src, bool zero) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(zero ? 0 : 4)
               : "memory");
}
__device__ __forceinline__ void barrier_init(unsigned long long *bar, int count) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(b), "r"(count) : "memory");
}
__device__ __forceinline__ void cp_async_arrive(unsigned long long *bar) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(b) : "memory");
}
__device__ __forceinline__ void barrier_wait(unsigned long long *bar) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// the lanes' random numbers
// ---------------------------------------------------------------------------

// The samplers of the counter's second word (ops/draws.py): the event's
// (scatter_event.cu) and the hot step's two uniforms (hot_step.cu).
constexpr uint64_t S_ELECTRON = 0, S_ELECTRON_DIR = 1, S_KLEIN_NISHINA = 2, S_THOMSON = 3,
                   S_SCATTER_DIR = 4, S_HOT = 5;

constexpr uint64_t PHILOX_M0 = 0xD2E7470EE14C6C93ull, PHILOX_M1 = 0xCA5A826395121157ull;
constexpr uint64_t PHILOX_W0 = 0x9E3779B97F4A7C15ull, PHILOX_W1 = 0xBB67AE8584CAA73Bull;

struct Words {
  uint64_t v[4];
};

// Philox4x64-10 of the counter (c0, c1, c2, c3) under the key (k0, k1).
__device__ __forceinline__ Words philox(uint64_t c0, uint64_t c1, uint64_t c2, uint64_t c3,
                                        uint64_t k0, uint64_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint64_t hi0 = __umul64hi(PHILOX_M0, c0), lo0 = PHILOX_M0 * c0;
    const uint64_t hi1 = __umul64hi(PHILOX_M1, c2), lo1 = PHILOX_M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

// a word as torch.rand makes a uniform: the top 24 or 53 bits
template <typename T>
__device__ __forceinline__ T unif(uint64_t w);
template <>
__device__ __forceinline__ float unif<float>(uint64_t w) {
  return (float)(uint32_t)(w >> 40) * 0x1p-24f;
}
template <>
__device__ __forceinline__ double unif<double>(uint64_t w) {
  return (double)(w >> 11) * 0x1p-53;
}

}  // namespace
