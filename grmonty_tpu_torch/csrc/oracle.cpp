// Native scalar reference tracker (the fast CPU validation oracle).
//
// Mirrors grmonty_tpu/transport/cpu_reference.py function-for-function:
// the same math, the same control flow, the same RNG consumption points —
// the Python oracle is itself the documented transcription of the
// reference semantics (cuda_grmonty/harm_model.cpp:362-404,894-1069).
// The Python oracle pays ~1 ms of JAX dispatch per photon step (several
// jitted scalar calls each step), making a 2,000-photon validation run a
// 20-hour job; this C++ mirror runs the identical physics at ~10^4-10^5
// photons/minute, so accuracy validation (M_unit sweeps, large-N oracle
// spectra) becomes interactive.
//
// Parity with the Python oracle is enforced two ways (tests/test_oracle_native.py):
//  * oracle_probe(): every deterministic sub-function (metric, connection,
//    fluid interpolation, opacities, step size, implicit-midpoint segment,
//    tetrad) evaluated at arbitrary states and compared ~1e-10 relative.
//  * end-to-end statistical comparison on a shared emission sample.
//
// Distribution samplers use an independent mt19937_64 (chi^2 drawn as the
// sum of dof squared normals — the exact definition); bitwise RNG parity
// with numpy's PCG64 is neither possible nor required (the oracle-vs-engine
// acceptance criterion is statistical; SURVEY.md "Design stance").

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <random>

namespace {

// ----- constants (grmonty_tpu/consts.py; reference consts.hpp:12-173) -----
constexpr double EPS = 1.0e-30;
constexpr double STEP_EPS = 0.04;
constexpr double E_TOL = 1.0e-3;
constexpr int MAX_ITER = 2;
constexpr long MAX_N_STEP = 1280000;
constexpr double E_DRIFT_TOL = 1.0e-4;
constexpr int MAX_HALVING_DEPTH = 7;
constexpr double THETA_E_MIN = 0.3;
constexpr double TP_OVER_TE = 3.0;
constexpr double WEIGHT_MIN = 1.0e31;
constexpr double ROULETTE = 1.0e4;
const double X1_MAX = std::log(100.0);

constexpr int N_TH_BINS = 6;
constexpr int N_E_BINS = 200;
constexpr int N_SPEC_CHAN = 16;  // 13 reference channels + sum((w*e)^2)
                                 // + secondary count + summed birth generation
                                 // + recorded-secondary count (ch 14)
constexpr double SPEC_D_L_E = 0.25;
const double SPEC_L_E_0 = std::log(1.0e-12);

constexpr double EE = 4.80320680e-10;
constexpr double CL = 2.99792458e10;
constexpr double ME = 9.1093826e-28;
constexpr double HPL = 6.6260693e-27;
constexpr double SIGMA_THOMSON = 0.665245873e-24;
const double PI = std::acos(-1.0);

// hotcross table geometry (consts.py class hotcross)
constexpr int HC_N_W = 220;  // grid intervals; table rows = N_W + 1
constexpr int HC_N_T = 80;
constexpr double HC_MIN_T = 1.0e-4;
const double HC_L_MIN_W = std::log10(1.0e-12);
const double HC_L_MIN_T = std::log10(1.0e-4);
const double HC_D_L_W = std::log10(1.0e18) / HC_N_W;
const double HC_D_L_T = std::log10(1.0e8) / HC_N_T;

// jnu K2 table geometry (consts.py class jnu)
constexpr int JNU_N = 201;  // N_E_SAMP + 1 entries
constexpr double JNU_MIN_T = 0.3;
constexpr double JNU_MAX_T = 100.0;
const double JNU_L_MIN_T = std::log(0.3);
const double JNU_D_L_T = std::log(100.0 / 0.3) / 200.0;
constexpr double JNU_CST = 1.88774862536;  // 2^(11/12)

struct Consts {
  double a, h_slope, r_0;
  double x_start[4], x_stop[4], dx[4];
  int64_t n1, n2;
  double n_e_unit, theta_e_unit, b_unit;
  double x1_min, bias_norm, d_tau_k, max_tau_scatt0;
  // Frozen-bias comparison mode (validate_accuracy --freeze-bias): when
  // bias_fixed_tau > 0 the bias normalization reads these constants
  // instead of the live feedback counters, pinning the variance-reduction
  // parameter so engine/oracle secondary POPULATIONS are directly
  // comparable (the live ratchet is an unstable extreme-value statistic
  // whose trajectory diverges between any two trackers).
  double bias_fixed_tau, bias_fixed_avg;
};

struct FluidState {
  double n_e, theta_e, b;  // b in gauss
  double u_con[4], u_cov[4], b_con[4], b_cov[4];
};

struct Photon {
  double x[4], k[4], dkdlam[4];
  double w, e, l, x1i, x2i, tau_abs, tau_scatt;
  double n_e_0, theta_e_0, b_0, e_0, e_0_s;
  int n_scatt;
  int nsc0 = 0;  // birth generation (0 = primary; spectrum channel 15)
  bool is_sec = false;  // born at a scatter event (spectrum channel 14)
};

// ----- geometry (ops/geometry.py; harm_model.cpp:473-530,1436-1644) -------

inline void bl_coord(double x1, double x2, double a, double hs, double r0,
                     double* r, double* th) {
  *r = std::exp(x1) + r0;
  *th = PI * x2 + 0.5 * (1.0 - hs) * std::sin(2.0 * PI * x2);
}

inline double theta_deriv(double x2, double hs) {
  return PI * (1.0 + (1.0 - hs) * std::cos(2.0 * PI * x2));
}

// 7 independent covariant components (g00, g01, g03, g11, g13, g22, g33)
inline void gcov7(double x1, double x2, const Consts& C, double g[7]) {
  double r, th;
  bl_coord(x1, x2, C.a, C.h_slope, C.r_0, &r, &th);
  double sth = std::fabs(std::sin(th)) + EPS;
  double cth = std::cos(th);
  double s2 = sth * sth;
  double a = C.a;
  double rho2 = r * r + a * a * cth * cth;
  double tworr = 2.0 * r / rho2;
  double rfac = r - C.r_0;
  double hfac = theta_deriv(x2, C.h_slope);
  g[0] = -1.0 + tworr;
  g[1] = tworr * rfac;
  g[2] = -a * s2 * tworr;
  g[3] = (1.0 + tworr) * rfac * rfac;
  g[4] = -a * s2 * (1.0 + tworr) * rfac;
  g[5] = rho2 * hfac * hfac;
  g[6] = s2 * (rho2 + a * a * s2 * (1.0 + tworr));
}

// 6 independent contravariant components (g00, g01, g11, g13, g22, g33)
inline void gcon6(double x1, double x2, const Consts& C, double g[6]) {
  double r, th;
  bl_coord(x1, x2, C.a, C.h_slope, C.r_0, &r, &th);
  double sth = std::fabs(std::sin(th)) + EPS;
  double cth = std::cos(th);
  double a = C.a;
  double irho2 = 1.0 / (r * r + a * a * cth * cth);
  double hfac = theta_deriv(x2, C.h_slope);
  g[0] = -1.0 - 2.0 * r * irho2;
  g[1] = 2.0 * irho2;
  g[2] = irho2 * (r * (r - 2.0) + a * a) / (r * r);
  g[3] = a * irho2 / r;
  g[4] = irho2 / (hfac * hfac);
  g[5] = irho2 / (sth * sth);
}

inline void gcov_row0(double x1, double x2, const Consts& C,
                      double* g00, double* g01, double* g03) {
  double r, th;
  bl_coord(x1, x2, C.a, C.h_slope, C.r_0, &r, &th);
  double sth = std::fabs(std::sin(th)) + EPS;
  double cth = std::cos(th);
  double a = C.a;
  double rho2 = r * r + a * a * cth * cth;
  double tworr = 2.0 * r / rho2;
  *g00 = -1.0 + tworr;
  *g01 = tworr * (r - C.r_0);
  *g03 = -a * sth * sth * tworr;
}

inline double dot7(const double g[7], const double u[4], const double v[4]) {
  return g[0] * u[0] * v[0] + g[1] * (u[0] * v[1] + u[1] * v[0])
       + g[2] * (u[0] * v[3] + u[3] * v[0]) + g[3] * u[1] * v[1]
       + g[4] * (u[1] * v[3] + u[3] * v[1]) + g[5] * u[2] * v[2]
       + g[6] * u[3] * v[3];
}

inline void lower7(const double g[7], const double v[4], double out[4]) {
  out[0] = g[0] * v[0] + g[1] * v[1] + g[2] * v[3];
  out[1] = g[1] * v[0] + g[3] * v[1] + g[4] * v[3];
  out[2] = g[5] * v[2];
  out[3] = g[2] * v[0] + g[4] * v[1] + g[6] * v[3];
}

// 40-component affine connection (ops/geometry.py connection_c; the
// standard closed-form MKS Christoffels, harm_model.cpp:1436-1569).
// Row i holds the 10 lower components (00 01 02 03 11 12 13 22 23 33).
void connection40(double x1, double x2, double a, double hs, double c[40]) {
  double r1 = std::exp(x1);
  double r2 = r1 * r1, r3 = r2 * r1, r4 = r3 * r1;

  double sx = std::sin(2.0 * PI * x2);
  double cx = std::cos(2.0 * PI * x2);
  double th = PI * x2 + 0.5 * (1.0 - hs) * sx;
  double dth = PI * (1.0 + (1.0 - hs) * cx);
  double d2th = -2.0 * PI * PI * (1.0 - hs) * sx;
  double dth2 = dth * dth;

  double sth = std::sin(th), cth = std::cos(th);
  double sth2 = sth * sth, sth4 = sth2 * sth2;
  double cth2 = cth * cth, cth4 = cth2 * cth2;
  double s2th = 2.0 * sth * cth;
  double c2th = 2.0 * cth2 - 1.0;
  double r1sth2 = r1 * sth2;

  double a2 = a * a, a3 = a2 * a, a4 = a3 * a;
  double a2sth2 = a2 * sth2, a2cth2 = a2 * cth2, a4cth4 = a4 * cth4;

  double rho2 = r2 + a2cth2;
  double rho22 = rho2 * rho2, rho23 = rho22 * rho2;
  double ir2 = 1.0 / rho2, ir22 = ir2 * ir2, ir23 = ir22 * ir2;
  double ir23_dth = ir23 / dth;

  double fac1 = r2 - a2cth2;
  double f1r3 = fac1 * ir23;
  double fac2 = a2 + 2.0 * r2 + a2 * c2th;
  double fac3 = a2 + r1 * (r1 - 2.0);

  // upper index 0
  c[0] = 2.0 * r1 * f1r3;
  c[1] = r1 * (2.0 * r1 + rho2) * f1r3;
  c[2] = -a2 * r1 * s2th * dth * ir22;
  c[3] = -2.0 * a * r1sth2 * f1r3;
  c[4] = 2.0 * r2 * (r4 + r1 * fac1 - a4cth4) * ir23;
  c[5] = -a2 * r2 * s2th * dth * ir22;
  c[6] = a * r1 * (-r1 * (r3 + 2.0 * fac1) + a4cth4) * sth2 * ir23;
  c[7] = -2.0 * r2 * dth2 * ir2;
  c[8] = a3 * r1sth2 * s2th * dth * ir22;
  c[9] = 2.0 * r1sth2 * (-r1 * rho22 + a2sth2 * fac1) * ir23;

  // upper index 1
  c[10] = fac3 * fac1 / (r1 * rho23);
  c[11] = fac1 * (-2.0 * r1 + a2sth2) * ir23;
  c[12] = 0.0;
  c[13] = -a * sth2 * fac3 * fac1 / (r1 * rho23);
  c[14] = (r4 * (r1 - 2.0) * (1.0 + r1)
           + a2 * (a2 * r1 * (1.0 + 3.0 * r1) * cth4 + a4cth4 * cth2
                   + r3 * sth2
                   + r1 * cth2 * (2.0 * r1 + 3.0 * r3 - a2sth2))) * ir23;
  c[15] = -a2 * dth * s2th / fac2;
  c[16] = a * sth2
          * (a4 * r1 * cth4 + r2 * (2.0 * r1 + r3 - a2sth2)
             + a2cth2 * (2.0 * r1 * (r2 - 1.0) + a2sth2)) * ir23;
  c[17] = -fac3 * dth2 * ir2;
  c[18] = 0.0;
  c[19] = -fac3 * sth2 * (r1 * rho22 - a2 * fac1 * sth2) / (r1 * rho23);

  // upper index 2
  c[20] = -a2 * r1 * s2th * ir23_dth;
  c[21] = r1 * c[20];
  c[22] = 0.0;
  c[23] = a * r1 * (a2 + r2) * s2th * ir23_dth;
  c[24] = r2 * c[20];
  c[25] = r2 * ir2;
  c[26] = (a * r1 * cth * sth
           * (r3 * (2.0 + r1)
              + a2 * (2.0 * r1 * (1.0 + r1) * cth2 + a2 * cth4
                      + 2.0 * r1sth2))) * ir23_dth;
  c[27] = -a2 * cth * sth * dth * ir2 + d2th / dth;
  c[28] = 0.0;
  c[29] = (-cth * sth
           * (rho23 + a2sth2 * rho2 * (r1 * (4.0 + r1) + a2cth2)
              + 2.0 * r1 * a4 * sth4)) * ir23_dth;

  // upper index 3
  c[30] = a * f1r3;
  c[31] = r1 * c[30];
  c[32] = -2.0 * a * r1 * cth * dth / (sth * rho22);
  c[33] = -a2sth2 * f1r3;
  c[34] = a * r2 * f1r3;
  c[35] = -2.0 * a * r1 * (a2 + 2.0 * r1 * (2.0 + r1) + a2 * c2th) * cth * dth
          / (sth * fac2 * fac2);
  c[36] = r1 * (r1 * rho22 - a2sth2 * fac1) * ir23;
  c[37] = -a * r1 * dth2 * ir2;
  c[38] = dth * (0.25 * fac2 * fac2 * cth / sth + a2 * r1 * s2th) * ir22;
  c[39] = (-a * r1sth2 * rho22 + a3 * sth4 * fac1) * ir23;
}

// dk^i/dlambda = -Gamma^i_{lm} k^l k^m (geodesic_rhs_c)
inline void geodesic_rhs(const double c[40], const double k[4], double out[4]) {
  double q[10] = {
      k[0] * k[0], 2.0 * k[0] * k[1], 2.0 * k[0] * k[2], 2.0 * k[0] * k[3],
      k[1] * k[1], 2.0 * k[1] * k[2], 2.0 * k[1] * k[3],
      k[2] * k[2], 2.0 * k[2] * k[3], k[3] * k[3]};
  for (int i = 0; i < 4; ++i) {
    double s = 0.0;
    for (int j = 0; j < 10; ++j) s += c[10 * i + j] * q[j];
    out[i] = -s;
  }
}

inline double step_size(const double x[4], const double k[4], double x2_stop) {
  double dl1 = STEP_EPS * x[1] / (std::fabs(k[1]) + EPS);
  double dl2 = STEP_EPS * std::fmin(x[2], x2_stop - x[2]) / (std::fabs(k[2]) + EPS);
  double dl3 = STEP_EPS / (std::fabs(k[3]) + EPS);
  return 1.0 / (1.0 / (std::fabs(dl1) + EPS) + 1.0 / (std::fabs(dl2) + EPS)
                + 1.0 / (std::fabs(dl3) + EPS));
}

// Grid cell + bilinear offsets (ops/geometry.py x_to_ij_c)
inline void x_to_ij(const double x[4], const Consts& C,
                    int64_t* i_out, int64_t* j_out, double* di, double* dj) {
  int64_t fi = (int64_t)std::floor((x[1] - C.x_start[1]) / C.dx[1] - 0.5);
  int64_t fj = (int64_t)std::floor((x[2] - C.x_start[2]) / C.dx[2] - 0.5);
  int64_t i = fi < 0 ? 0 : (fi > C.n1 - 2 ? C.n1 - 2 : fi);
  int64_t j = fj < 0 ? 0 : (fj > C.n2 - 2 ? C.n2 - 2 : fj);
  double del_i = (x[1] - (((double)i + 0.5) * C.dx[1] + C.x_start[1])) / C.dx[1];
  double del_j = (x[2] - (((double)j + 0.5) * C.dx[2] + C.x_start[2])) / C.dx[2];
  if (fi < 0) del_i = 0.0; else if (fi > C.n1 - 2) del_i = 1.0;
  if (fj < 0) del_j = 0.0; else if (fj > C.n2 - 2) del_j = 1.0;
  *i_out = i; *j_out = j; *di = del_i; *dj = del_j;
}

// ----- fluid interpolation (ops/fluid.py get_fluid_params) ----------------

void fluid_params(const double x[4], const double g7[7], const double* prims,
                  const Consts& C, FluidState* fs) {
  bool inside = x[1] >= C.x_start[1] && x[1] <= C.x_stop[1]
             && x[2] >= C.x_start[2] && x[2] <= C.x_stop[2];

  int64_t i, j;
  double di, dj;
  x_to_ij(x, C, &i, &j, &di, &dj);

  double c00 = (1.0 - di) * (1.0 - dj), c01 = (1.0 - di) * dj;
  double c10 = di * (1.0 - dj), c11 = di * dj;
  int64_t n2 = C.n2, z = i * n2 + j, zn = C.n1 * n2;
  double p[8];
  for (int c = 0; c < 8; ++c) {
    const double* pc = prims + c * zn;
    p[c] = pc[z] * c00 + pc[z + 1] * c01 + pc[z + n2] * c10 + pc[z + n2 + 1] * c11;
  }

  double rho = p[0], uu = p[1];
  fs->n_e = inside ? rho * C.n_e_unit : 0.0;
  fs->theta_e = uu / rho * C.theta_e_unit;

  double gc[6];
  gcon6(x[1], x[2], C, gc);

  // u^0 from v.v and g^00 (harm_model.cpp:567-571); g_con row 0 = (g00, g01, 0, 0)
  double v[4] = {0.0, p[2], p[3], p[4]};
  double bp[4] = {0.0, p[5], p[6], p[7]};
  double vdv = g7[3] * v[1] * v[1] + 2.0 * g7[4] * v[1] * v[3]
             + g7[5] * v[2] * v[2] + g7[6] * v[3] * v[3];
  double v_fac = std::sqrt(-1.0 / gc[0] * (1.0 + std::fabs(vdv)));

  fs->u_con[0] = -v_fac * gc[0];
  fs->u_con[1] = v[1] - v_fac * gc[1];
  fs->u_con[2] = v[2];
  fs->u_con[3] = v[3];
  lower7(g7, fs->u_con, fs->u_cov);

  double udb = fs->u_cov[1] * bp[1] + fs->u_cov[2] * bp[2] + fs->u_cov[3] * bp[3];
  for (int c = 1; c < 4; ++c)
    fs->b_con[c] = (bp[c] + fs->u_con[c] * udb) / fs->u_con[0];
  fs->b_con[0] = udb;
  lower7(g7, fs->b_con, fs->b_cov);

  double bb = fs->b_con[0] * fs->b_cov[0] + fs->b_con[1] * fs->b_cov[1]
            + fs->b_con[2] * fs->b_cov[2] + fs->b_con[3] * fs->b_cov[3];
  fs->b = std::sqrt(std::fabs(bb)) * C.b_unit;
}

// ----- opacities (ops/radiation.py, ops/hotcross.py, ops/jnu.py) ----------

inline double hc_klein_nishina(double w) {
  if (w < 1.0e-3) return 1.0 - 2.0 * w;
  return 0.75 * (2.0 / (w * w)
                 + (1.0 / (2.0 * w) - (1.0 + w) / (w * w * w)) * std::log1p(2.0 * w)
                 + (1.0 + w) / ((1.0 + 2.0 * w) * (1.0 + 2.0 * w)));
}

// sigma(w, theta_e) [cm^2], bilinear log-log (ops/hotcross.py lookup)
double hotcross_lookup(double w, double theta_e, const double* table) {
  double l_w = (std::log10(std::fmax(w, 1e-30)) - HC_L_MIN_W) / HC_D_L_W;
  double l_t = (std::log10(std::fmax(theta_e, 1e-30)) - HC_L_MIN_T) / HC_D_L_T;
  l_w = std::fmin(std::fmax(l_w, 0.0), HC_N_W - 1.0e-9);
  l_t = std::fmin(std::fmax(l_t, 0.0), HC_N_T - 1.0e-9);
  int i = (int)std::floor(l_w), j = (int)std::floor(l_t);
  double di = l_w - i, dj = l_t - j;
  const int NT = HC_N_T + 1;  // table shape (221, 81) row-major
  double l_cross = (1.0 - di) * (1.0 - dj) * table[i * NT + j]
                 + di * (1.0 - dj) * table[(i + 1) * NT + j]
                 + (1.0 - di) * dj * table[i * NT + j + 1]
                 + di * dj * table[(i + 1) * NT + j + 1];
  double out = std::pow(10.0, l_cross);
  if (theta_e < HC_MIN_T) out = hc_klein_nishina(w) * SIGMA_THOMSON;
  if (w * theta_e < 1.0e-6) out = SIGMA_THOMSON;
  return out;
}

inline double alpha_inv_scatt(double nu, double theta_e, double n_e,
                              const double* hc_table) {
  double e_g = HPL * nu / (ME * CL * CL);
  return nu * hotcross_lookup(e_g, theta_e, hc_table) * n_e;
}

// K_2(1/theta_e) via the log table with asymptote (ops/jnu.py k2_eval)
double k2_eval(double theta_e, const double* k2_table) {
  double l_v = std::log(std::fmax(theta_e, JNU_MIN_T));
  double d_i = (l_v - JNU_L_MIN_T) / JNU_D_L_T;
  int i = (int)std::floor(d_i);
  if (i < 0) i = 0;
  if (i > JNU_N - 2) i = JNU_N - 2;
  double frac = d_i - i;
  double interp = std::exp((1.0 - frac) * k2_table[i] + frac * k2_table[i + 1]);
  double out = theta_e > JNU_MAX_T ? 2.0 * theta_e * theta_e : interp;
  return theta_e < THETA_E_MIN ? 0.0 : out;
}

// thermal synchrotron emissivity j_nu (ops/jnu.py _synch_from_sin)
double synch(double nu, double n_e, double theta_e, double b, double theta,
             const double* k2_table) {
  double k2 = k2_eval(theta_e, k2_table);
  double sin_th = std::sin(theta);
  double nu_c = EE * b / (2.0 * PI * ME * CL);
  double nu_s = (2.0 / 9.0) * nu_c * theta_e * theta_e * sin_th;
  double xr = nu / (nu_s + EPS);
  double xp = std::exp(std::log(std::fmax(xr, 1e-37)) * (1.0 / 3.0));
  double xx = std::sqrt(xr) + JNU_CST * std::sqrt(xp);
  double f = xx * xx;
  double val = (std::sqrt(2.0) * PI * EE * EE / (3.0 * CL))
             * n_e * nu_s / (k2 + EPS) * f * std::exp(-xp);
  bool bad = theta_e < THETA_E_MIN || nu > 1.0e12 * nu_s || k2 <= 0.0;
  return bad ? 0.0 : val;
}

// Planck B_nu with small-x series (ops/radiation.py b_nu)
double planck_b_nu(double nu, double theta_e) {
  double x = HPL * nu / (ME * CL * CL * theta_e + EPS);
  double pref = (2.0 * HPL * nu) * (nu / CL) * (nu / CL);
  if (x < 1.0e-3)
    return pref / (x / 24.0 * (24.0 + x * (12.0 + x * (4.0 + x))) + EPS);
  return pref / (std::exp(std::fmin(x, 80.0)) - 1.0 + EPS);
}

inline double alpha_inv_abs(double nu, double theta_e, double n_e, double b,
                            double theta, const double* k2_table) {
  double j = synch(nu, n_e, theta_e, b, theta, k2_table);
  return nu * j / (planck_b_nu(nu, theta_e) + EPS);
}

// (theta, nu, a_sc, a_ab) exactly as CPUTracker._alphas
void alphas_at(const double k[4], const FluidState& fs, const Consts& C,
               const double* hc_table, const double* k2_table,
               double* theta, double* nu, double* a_sc, double* a_ab) {
  double k_u = k[0] * fs.u_cov[0] + k[1] * fs.u_cov[1] + k[2] * fs.u_cov[2]
             + k[3] * fs.u_cov[3];
  double k_b = k[0] * fs.b_cov[0] + k[1] * fs.b_cov[1] + k[2] * fs.b_cov[2]
             + k[3] * fs.b_cov[3];
  double mu = k_b / (std::fabs(k_u) * fs.b / C.b_unit + EPS);
  mu = std::fmin(1.0, std::fmax(-1.0, mu));
  *theta = fs.b == 0.0 ? PI / 2.0 : std::acos(mu);
  *nu = -k_u * ME * CL * CL / HPL;
  double nu_s = std::fabs(*nu) + EPS;
  *a_sc = alpha_inv_scatt(nu_s, fs.theta_e, fs.n_e, hc_table);
  *a_ab = alpha_inv_abs(nu_s, fs.theta_e, fs.n_e, fs.b, *theta, k2_table);
}

// ----- tetrads (ops/tetrads.py make_tetrad / frame transforms) ------------

inline void normalize7(const double g7[7], double v[4]) {
  double n = std::sqrt(std::fabs(dot7(g7, v, v)));
  for (int i = 0; i < 4; ++i) v[i] /= n;
}

inline void project_out7(const double g7[7], double va[4], const double vb[4]) {
  double fac = dot7(g7, va, vb) / dot7(g7, vb, vb);
  for (int i = 0; i < 4; ++i) va[i] -= vb[i] * fac;
}

// e_con[mu][i], e_cov[mu][i] (time row of e_cov sign-flipped)
void make_tetrad(const double u_con[4], const double trial[4],
                 const double g7[7], double e_con[4][4], double e_cov[4][4]) {
  double e0[4] = {u_con[0], u_con[1], u_con[2], u_con[3]};
  normalize7(g7, e0);

  double t1[4];
  if (dot7(g7, trial, trial) < 1.0e-30) {
    t1[0] = 0.0; t1[1] = 1.0; t1[2] = 0.0; t1[3] = 0.0;
  } else {
    for (int i = 0; i < 4; ++i) t1[i] = trial[i];
  }
  project_out7(g7, t1, e0);
  normalize7(g7, t1);

  double e2[4] = {0.0, 0.0, 1.0, 0.0};
  project_out7(g7, e2, e0);
  project_out7(g7, e2, t1);
  normalize7(g7, e2);

  double e3[4] = {0.0, 0.0, 0.0, 1.0};
  project_out7(g7, e3, e0);
  project_out7(g7, e3, t1);
  project_out7(g7, e3, e2);
  normalize7(g7, e3);

  for (int i = 0; i < 4; ++i) {
    e_con[0][i] = e0[i]; e_con[1][i] = t1[i];
    e_con[2][i] = e2[i]; e_con[3][i] = e3[i];
  }
  for (int mu = 0; mu < 4; ++mu) lower7(g7, e_con[mu], e_cov[mu]);
  for (int i = 0; i < 4; ++i) e_cov[0][i] = -e_cov[0][i];
}

// ----- RNG -----------------------------------------------------------------

struct Rng {
  std::mt19937_64 gen;
  std::normal_distribution<double> normal{0.0, 1.0};
  explicit Rng(uint64_t seed) : gen(seed) {}
  double uniform() { return (gen() >> 11) * 0x1.0p-53; }
  double chisquare(int dof) {
    // chi^2_k IS the sum of k squared standard normals (exact definition;
    // also how the reference GPU draws it, proba.cuh:197-245)
    double s = 0.0;
    for (int i = 0; i < dof; ++i) {
      double z = normal(gen);
      s += z * z;
    }
    return s;
  }
};

// ----- tracker --------------------------------------------------------------

struct Tracker {
  const Consts& C;
  const double* hc_table;
  const double* k2_table;
  const double* prims;
  Rng rng;
  double* spec;  // (6, 200, 13)
  int64_t n_recorded = 0;
  int64_t n_scatt_rec = 0;
  double max_tau_scatt;

  Tracker(const Consts& c, const double* hc, const double* k2,
          const double* pr, uint64_t seed, double* sp)
      : C(c), hc_table(hc), k2_table(k2), prims(pr), rng(seed), spec(sp),
        max_tau_scatt(c.max_tau_scatt0) {}

  double bias(double theta_e, double w) const {
    double cap = 0.5 * w / WEIGHT_MIN;
    double avg = (double)n_scatt_rec / ((double)n_recorded + 1.0);
    double denom = (C.bias_fixed_tau > 0.0)
        ? C.bias_fixed_tau * (C.bias_fixed_avg + 2.0)
        : max_tau_scatt * (avg + 2.0);
    double b = 100.0 * theta_e * theta_e / (C.bias_norm * denom);
    b = std::fmax(b, TP_OVER_TE);
    b = std::fmin(b, cap);
    return b / TP_OVER_TE;
  }

  void fluid_at(const double x[4], double g7[7], FluidState* fs) const {
    gcov7(x[1], x[2], C, g7);
    fluid_params(x, g7, prims, C, fs);
  }

  // One implicit-midpoint trial segment (CPUTracker seg_step;
  // harm_model.cpp:1217-1277)
  void seg_step(const double x[4], const double k[4], const double dk[4],
                double e0s, double dl, double x_new[4], double k_new[4],
                double dk_new[4], double* e1, double* err, double* err_e) const {
    double dl_2 = 0.5 * dl;
    double k_half[4], k_pred[4];
    for (int i = 0; i < 4; ++i) {
      double dkh = dk[i] * dl_2;
      k_half[i] = k[i] + dkh;
      k_pred[i] = k_half[i] + dkh;
      x_new[i] = x[i] + k_half[i] * dl;
    }
    double conn[40];
    connection40(x_new[1], x_new[2], C.a, C.h_slope, conn);
    double e = 0.0;
    double dkn[4] = {0, 0, 0, 0};
    for (int it = 0; it < MAX_ITER; ++it) {
      geodesic_rhs(conn, k_pred, dkn);
      e = 0.0;
      for (int i = 0; i < 4; ++i) {
        double k_next = k_half[i] + dl_2 * dkn[i];
        e += std::fabs((k_pred[i] - k_next) / (k_next + EPS));
        k_pred[i] = k_next;
      }
    }
    double g00, g01, g03;
    gcov_row0(x_new[1], x_new[2], C, &g00, &g01, &g03);
    *e1 = -(k_pred[0] * g00 + k_pred[1] * g01 + k_pred[3] * g03);
    *err = e;
    *err_e = std::fabs((*e1 - e0s) / (e0s + EPS));
    for (int i = 0; i < 4; ++i) {
      k_new[i] = k_pred[i];
      dk_new[i] = dkn[i];
    }
  }

  // Adaptive-halving geodesic push (CPUTracker.push; harm_model.cpp:1217-1289)
  void push(Photon& ph, double dl, int n = 0) {
    if (ph.x[1] < C.x_start[1]) return;
    double x_new[4], k_new[4], dk_new[4], e1, err, err_e;
    seg_step(ph.x, ph.k, ph.dkdlam, ph.e_0_s, dl, x_new, k_new, dk_new,
             &e1, &err, &err_e);
    if (n < MAX_HALVING_DEPTH
        && (err_e > E_DRIFT_TOL || err > E_TOL || !std::isfinite(err))) {
      push(ph, 0.5 * dl, n + 1);
      push(ph, 0.5 * dl, n + 1);
    } else {
      for (int i = 0; i < 4; ++i) {
        ph.x[i] = x_new[i];
        ph.k[i] = k_new[i];
        ph.dkdlam[i] = dk_new[i];
      }
      ph.e_0_s = e1;
    }
  }

  // --- scalar samplers (CPUTracker._sample_*; proba.cpp) -------------------

  double sample_y(double theta_e) {
    double p3 = std::sqrt(PI) / 4.0;
    double p4 = std::sqrt(0.5 * theta_e) / 2.0;
    double p5 = 3.0 * std::sqrt(PI) * theta_e / 8.0;
    double p6 = theta_e * std::sqrt(0.5 * theta_e);
    double s = p3 + p4 + p5 + p6;
    for (;;) {
      double x1 = rng.uniform();
      int dof;
      if (x1 < p3 / s) dof = 3;
      else if (x1 < (p3 + p4) / s) dof = 4;
      else if (x1 < (p3 + p4 + p5) / s) dof = 5;
      else dof = 6;
      double y = std::sqrt(rng.chisquare(dof) / 2.0);
      double num = std::sqrt(1.0 + 0.5 * theta_e * y * y);
      double den = 1.0 + y * std::sqrt(0.5 * theta_e);
      if (rng.uniform() < num / den) return y;
    }
  }

  void sample_electron(const double k_tet[4], double theta_e, double p[4]) {
    long cnt = 0;
    double gamma_e = 1.0, beta_e = 0.0, mu = 0.0;
    for (;;) {
      double y = sample_y(theta_e);
      gamma_e = y * y * theta_e + 1.0;
      beta_e = std::sqrt(1.0 - 1.0 / (gamma_e * gamma_e));
      double x1 = rng.uniform();
      double det = 1.0 + 2.0 * beta_e + beta_e * beta_e - 4.0 * beta_e * x1;
      mu = (1.0 - std::sqrt(det)) / (beta_e + 1e-300);
      mu = std::fmin(1.0, std::fmax(-1.0, mu));
      double k_ = gamma_e * (1.0 - beta_e * mu) * k_tet[0];
      double sigma;
      if (k_ < 1e-3) {
        sigma = 1.0 - 2.0 * k_;
      } else {
        sigma = (3.0 / (4.0 * k_ * k_))
              * (2.0 + k_ * k_ * (1.0 + k_) / ((1.0 + 2.0 * k_) * (1.0 + 2.0 * k_))
                 + (k_ * k_ - 2.0 * k_ - 2.0) / (2.0 * k_) * std::log(1.0 + 2.0 * k_));
      }
      ++cnt;
      if (rng.uniform() < sigma) break;
      if (cnt > 10000000L) {  // anti-stall theta_e halving (proba.cpp:59-64)
        theta_e *= 0.5;
        cnt = 0;
      }
    }
    double nrm = std::sqrt(k_tet[1] * k_tet[1] + k_tet[2] * k_tet[2]
                           + k_tet[3] * k_tet[3]);
    double v0[3] = {k_tet[1] / nrm, k_tet[2] / nrm, k_tet[3] / nrm};
    double z = rng.uniform() * 2.0 - 1.0;
    double phi0 = rng.uniform() * 2.0 * PI;
    double sz = std::sqrt(1.0 - z * z);
    double n0[3] = {sz * std::cos(phi0), sz * std::sin(phi0), z};
    double n0v0 = n0[0] * v0[0] + n0[1] * v0[1] + n0[2] * v0[2];
    double v1[3] = {n0[0] - n0v0 * v0[0], n0[1] - n0v0 * v0[1], n0[2] - n0v0 * v0[2]};
    double v1n = std::sqrt(v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2]);
    v1[0] /= v1n; v1[1] /= v1n; v1[2] /= v1n;
    double v2[3] = {v0[1] * v1[2] - v0[2] * v1[1],
                    v0[2] * v1[0] - v0[0] * v1[2],
                    v0[0] * v1[1] - v0[1] * v1[0]};
    double phi = rng.uniform() * 2.0 * PI;
    double s_th = std::sqrt(1.0 - mu * mu);
    double cp = std::cos(phi), sp = std::sin(phi);
    p[0] = gamma_e;
    double gb = gamma_e * beta_e;
    for (int i = 0; i < 3; ++i)
      p[1 + i] = gb * (mu * v0[i] + s_th * (cp * v1[i] + sp * v2[i]));
  }

  static void lorentz_boost(const double v[4], const double u[4], double vp[4]) {
    double g = u[0];
    double vel = std::sqrt(std::fabs(1.0 - 1.0 / (g * g)));
    double denom = g * vel + EPS;
    double n[3] = {u[1] / denom, u[2] / denom, u[3] / denom};
    double gm1 = g - 1.0;
    vp[0] = u[0] * v[0] - (u[1] * v[1] + u[2] * v[2] + u[3] * v[3]);
    double ndv = n[0] * v[1] + n[1] * v[2] + n[2] * v[3];
    for (int i = 0; i < 3; ++i)
      vp[1 + i] = -u[1 + i] * v[0] + v[1 + i] + n[i] * gm1 * ndv;
  }

  void sample_scattered(const double k_tet[4], const double p[4], double out[4]) {
    double ke[4];
    lorentz_boost(k_tet, p, ke);
    double k0p, c_th;
    if (ke[0] > 1e-4) {
      double k0 = ke[0];
      double k0pmin = k0 / (1.0 + 2.0 * k0);
      double env = 2.0 * (1.0 + 2.0 * k0 + 2.0 * k0 * k0)
                 / (k0 * k0 * (1.0 + 2.0 * k0));
      double tent;
      for (;;) {
        tent = k0pmin + (k0 - k0pmin) * rng.uniform();
        double ch = 1.0 + 1.0 / k0 - 1.0 / tent;
        double kn = (k0 / tent + tent / k0 - 1.0 + ch * ch) / (k0 * k0);
        if (env * rng.uniform() < kn) break;
      }
      k0p = tent;
      c_th = 1.0 - 1.0 / k0p + 1.0 / k0;
    } else {
      k0p = ke[0];
      double x1;
      for (;;) {
        x1 = 2.0 * rng.uniform() - 1.0;
        if ((3.0 / 4.0) * rng.uniform() < (3.0 / 8.0) * (1.0 + x1 * x1)) break;
      }
      c_th = x1;
    }
    double s_th = std::sqrt(std::fabs(1.0 - c_th * c_th));
    double v0[3] = {ke[1] / ke[0], ke[2] / ke[0], ke[3] / ke[0]};
    double z = rng.uniform() * 2.0 - 1.0;
    double phi0 = rng.uniform() * 2.0 * PI;
    double sz = std::sqrt(1.0 - z * z);
    double n0[3] = {sz * std::cos(phi0), sz * std::sin(phi0), z};
    double n0v0 = n0[0] * v0[0] + n0[1] * v0[1] + n0[2] * v0[2];
    double v1[3] = {n0[0] - n0v0 * v0[0], n0[1] - n0v0 * v0[1], n0[2] - n0v0 * v0[2]};
    double v1n = std::sqrt(v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2]);
    v1[0] /= v1n; v1[1] /= v1n; v1[2] /= v1n;
    double v2[3] = {v0[1] * v1[2] - v0[2] * v1[1],
                    v0[2] * v1[0] - v0[0] * v1[2],
                    v0[0] * v1[1] - v0[1] * v1[0]};
    double phi = 2.0 * PI * rng.uniform();
    double cp = std::cos(phi), sp = std::sin(phi);
    double kpe[4];
    kpe[0] = k0p;
    for (int i = 0; i < 3; ++i)
      kpe[1 + i] = k0p * (c_th * v0[i] + s_th * (cp * v1[i] + sp * v2[i]));
    double p2[4] = {p[0], -p[1], -p[2], -p[3]};
    lorentz_boost(kpe, p2, out);
  }

  // scatter_super_photon (CPUTracker._scatter; harm_model.cpp:1071-1145).
  // Returns true with *sec filled, or false (no secondary).  May zero the
  // parent's weight (light-cone failure guards).
  bool scatter(Photon& ph, const FluidState& fs, const double g7[7],
               Photon* sec) {
    const double* k = ph.k;
    if (k[0] > 1e5 || k[0] < 0.0 || std::isnan(k[0]) || std::isnan(k[1])
        || std::isnan(k[3])) {
      ph.k[0] = std::fabs(k[0]);
      ph.w = 0.0;
      return false;
    }
    double b_code = fs.b / C.b_unit;
    double trial[4];
    if (fs.b > 0.0) {
      for (int i = 0; i < 4; ++i) trial[i] = fs.b_con[i] / b_code;
    } else {
      trial[0] = 0.0; trial[1] = 1.0; trial[2] = 0.0; trial[3] = 0.0;
    }
    double e_con[4][4], e_cov[4][4];
    make_tetrad(fs.u_con, trial, g7, e_con, e_cov);

    double k_tet[4];
    for (int mu = 0; mu < 4; ++mu)
      k_tet[mu] = e_cov[mu][0] * k[0] + e_cov[mu][1] * k[1]
                + e_cov[mu][2] * k[2] + e_cov[mu][3] * k[3];
    if (k_tet[0] > 1e5 || k_tet[0] < 0.0 || std::isnan(k_tet[1])) return false;

    double p[4];
    sample_electron(k_tet, fs.theta_e, p);
    double k_tet_p[4];
    sample_scattered(k_tet, p, k_tet_p);

    double k_sec[4];
    for (int i = 0; i < 4; ++i)
      k_sec[i] = e_con[0][i] * k_tet_p[0] + e_con[1][i] * k_tet_p[1]
               + e_con[2][i] * k_tet_p[2] + e_con[3][i] * k_tet_p[3];
    if (std::isnan(k_sec[1])) return false;

    double k_tet_p2[4] = {-k_tet_p[0], k_tet_p[1], k_tet_p[2], k_tet_p[3]};
    double tmp[4];
    for (int i = 0; i < 4; ++i)
      tmp[i] = e_cov[0][i] * k_tet_p2[0] + e_cov[1][i] * k_tet_p2[1]
             + e_cov[2][i] * k_tet_p2[2] + e_cov[3][i] * k_tet_p2[3];

    *sec = ph;  // copy, then overwrite the secondary's own fields
    for (int i = 0; i < 4; ++i) {
      sec->k[i] = k_sec[i];
      sec->x[i] = ph.x[i];
      sec->dkdlam[i] = 0.0;
    }
    sec->e = -tmp[0];
    sec->e_0_s = -tmp[0];
    sec->l = tmp[3];
    sec->tau_abs = 0.0;
    sec->tau_scatt = 0.0;
    sec->b_0 = fs.b;
    sec->x1i = ph.x[1];
    sec->x2i = ph.x[2];
    sec->n_scatt = ph.n_scatt + 1;
    return true;
  }

  // stop_criterion (CPUTracker.stop; harm_model.cpp:1589-1616)
  bool stop(Photon& ph) {
    if (ph.x[1] < C.x1_min) return true;
    if (ph.x[1] > X1_MAX) {
      if (ph.w < WEIGHT_MIN) {
        if (rng.uniform() <= 1.0 / ROULETTE) ph.w *= ROULETTE;
        else ph.w = 0.0;
      }
      return true;
    }
    if (ph.w < WEIGHT_MIN) {
      if (rng.uniform() <= 1.0 / ROULETTE) ph.w *= ROULETTE;
      else { ph.w = 0.0; return true; }
    }
    return false;
  }

  // record_super_photon (CPUTracker.record; harm_model.cpp:1291-1335)
  void record(const Photon& ph) {
    if (std::isnan(ph.w) || std::isnan(ph.e)) return;
    if (ph.tau_scatt > max_tau_scatt) max_tau_scatt = ph.tau_scatt;
    double dx2 = (C.x_stop[2] - C.x_start[2]) / (2.0 * N_TH_BINS);
    long ix2;
    if (ph.x[2] < 0.5 * (C.x_start[2] + C.x_stop[2]))
      ix2 = (long)(ph.x[2] / dx2);  // truncation toward zero, as Python int()
    else
      ix2 = (long)((C.x_stop[2] - ph.x[2]) / dx2);
    if (ix2 < 0 || ix2 >= N_TH_BINS) return;
    double l_e = std::log(std::fmax(ph.e, 1e-300));
    long i_e = (long)((l_e - SPEC_L_E_0) / SPEC_D_L_E + 2.5) - 2;
    if (i_e < 0 || i_e >= N_E_BINS) return;
    ++n_recorded;
    n_scatt_rec += ph.n_scatt;
    double w = ph.w;
    double* row = spec + (ix2 * N_E_BINS + i_e) * N_SPEC_CHAN;
    row[0] += w;
    row[1] += w * ph.e;
    row[2] += 1.0;
    row[3] += ph.n_scatt;
    row[4] += w * ph.x1i;
    row[5] += w * ph.x2i * ph.x2i;
    row[6] += w * ph.x[3] * ph.x[3];
    row[7] += w * ph.tau_abs;
    row[8] += w * ph.tau_scatt;
    row[9] += w * ph.n_e_0;
    row[10] += w * ph.theta_e_0;
    row[11] += w * ph.b_0;
    row[12] += w * ph.e_0;
    row[13] += w * ph.e * w * ph.e;  // MC variance of the energy channel
    row[14] += ph.is_sec ? 1.0 : 0.0;  // secondary-origin count
    row[15] += ph.nsc0;  // summed birth generation (kappa^g model)
  }

  // track_super_photon (CPUTracker.track; harm_model.cpp:894-1069).
  // Secondaries recurse depth-first exactly as the Python oracle does —
  // ordering matters for the shared bias-feedback counters.
  void track(Photon& ph, int depth = 0) {
    for (int i = 0; i < 4; ++i)
      if (std::isnan(ph.x[i]) || std::isnan(ph.k[i])) return;
    if (ph.w == 0.0) return;

    double g7[7];
    FluidState fs;
    fluid_at(ph.x, g7, &fs);
    double theta, nu, a_sc, a_ab;
    alphas_at(ph.k, fs, C, hc_table, k2_table, &theta, &nu, &a_sc, &a_ab);
    double alpha_scatti = a_sc, alpha_absi = a_ab;
    double bi = bias(fs.theta_e, ph.w);
    {
      double conn[40];
      connection40(ph.x[1], ph.x[2], C.a, C.h_slope, conn);
      geodesic_rhs(conn, ph.k, ph.dkdlam);
    }

    long n_step = 0;
    while (!stop(ph)) {
      Photon saved = ph;  // pre-step state (x, k, dkdlam, e_0_s used)
      double dl = step_size(ph.x, ph.k, C.x_stop[2]);
      push(ph, dl);
      if (stop(ph)) break;

      if (alpha_absi > 0.0 || alpha_scatti > 0.0 || fs.n_e > 0.0) {
        fluid_at(ph.x, g7, &fs);
        bool bound = fs.n_e == 0.0;
        double d_tau_scatt, d_tau_abs, bias_;
        double a_scf = 0.0, a_abf = 0.0;
        if (!bound) {
          alphas_at(ph.k, fs, C, hc_table, k2_table, &theta, &nu, &a_scf, &a_abf);
        }
        if (bound || nu < 0.0) {
          d_tau_scatt = 0.5 * alpha_scatti * C.d_tau_k * dl;
          d_tau_abs = 0.5 * alpha_absi * C.d_tau_k * dl;
          alpha_scatti = alpha_absi = 0.0;
          bias_ = 0.0;
          bi = 0.0;
        } else {
          d_tau_scatt = 0.5 * (alpha_scatti + a_scf) * C.d_tau_k * dl;
          alpha_scatti = a_scf;
          d_tau_abs = 0.5 * (alpha_absi + a_abf) * C.d_tau_k * dl;
          alpha_absi = a_abf;
          double bf = bias(fs.theta_e, ph.w);
          bias_ = 0.5 * (bi + bf);
          bi = bf;
        }
        double x1r = -std::log(rng.uniform() + 1e-300);
        double sec_w = bias_ > 0.0 ? ph.w / bias_ : HUGE_VAL;
        if (bias_ * d_tau_scatt > x1r && sec_w > WEIGHT_MIN) {
          // SCATTER (harm_model.cpp:980-1039)
          double frac = x1r / (bias_ * d_tau_scatt);
          d_tau_abs *= frac;
          if (d_tau_abs > 100.0) return;
          d_tau_scatt *= frac;
          double d_tau = d_tau_abs + d_tau_scatt;
          if (d_tau_abs < 1e-3)
            ph.w *= 1.0 - d_tau / 24.0 * (24.0 - d_tau * (12.0 - d_tau * (4.0 - d_tau)));
          else
            ph.w *= std::exp(-d_tau);
          // partial re-push of the pre-step state to the event point
          // (only x/k/dkdlam/e_0_s restore; the decayed weight stays)
          for (int i = 0; i < 4; ++i) {
            ph.x[i] = saved.x[i];
            ph.k[i] = saved.k[i];
            ph.dkdlam[i] = saved.dkdlam[i];
          }
          ph.e_0_s = saved.e_0_s;
          push(ph, dl * frac);
          fluid_at(ph.x, g7, &fs);
          if (fs.n_e > 0.0) {
            Photon sec;
            bool made = scatter(ph, fs, g7, &sec);
            if (ph.w < 1e-100) return;
            if (made) {
              sec.w = sec_w;
              sec.e_0 = ph.e_0;
              sec.n_e_0 = ph.n_e_0;
              sec.theta_e_0 = ph.theta_e_0;
              sec.is_sec = true;
              sec.nsc0 = sec.n_scatt;
              track(sec, depth + 1);
            }
          }
          alphas_at(ph.k, fs, C, hc_table, k2_table, &theta, &nu, &a_scf, &a_abf);
          if (nu < 0.0) {
            alpha_scatti = alpha_absi = 0.0;
          } else {
            alpha_scatti = a_scf;
            alpha_absi = a_abf;
          }
          bi = bias(fs.theta_e, ph.w);
        } else {
          if (d_tau_abs > 100.0) return;
          double d_tau = d_tau_abs + d_tau_scatt;
          if (d_tau < 1e-3)
            ph.w *= 1.0 - d_tau / 24.0 * (24.0 - d_tau * (12.0 - d_tau * (4.0 - d_tau)));
          else
            ph.w *= std::exp(-d_tau);
        }
        ph.tau_abs += d_tau_abs;
        ph.tau_scatt += d_tau_scatt;
      }
      ++n_step;
      if (n_step > MAX_N_STEP) break;
    }
    if (ph.x[1] > X1_MAX && n_step <= MAX_N_STEP) record(ph);
  }
};

}  // namespace

// ----- C API ----------------------------------------------------------------

extern "C" {

struct OracleOut {
  double max_tau_scatt;
  int64_t n_recorded;
  int64_t n_scatt_rec;
};

// Track n photons; accumulates into spec (6*200*N_SPEC_CHAN doubles, caller-zeroed).
// `out` is IN/OUT: its counters seed the tracker's bias-feedback state, so
// chunked calls behave exactly like one long sequential run (the Python
// CPUTracker keeps this state across run() calls too).  Pass
// max_tau_scatt = consts.max_tau_scatt0 and zero counters on the first call.
int oracle_run(const Consts* C, const double* hc_table, const double* k2_table,
               const double* prims, const double* x, const double* k,
               const double* w, const double* e, const double* l,
               const double* n_e_0, const double* theta_e_0, const double* b_0,
               const double* e_0, const int32_t* n_scatt, int64_t n,
               uint64_t seed, double* spec, OracleOut* out,
               int64_t progress_every) {
  Tracker tr(*C, hc_table, k2_table, prims, seed, spec);
  if (out->max_tau_scatt > 0.0) tr.max_tau_scatt = out->max_tau_scatt;
  tr.n_recorded = out->n_recorded;
  tr.n_scatt_rec = out->n_scatt_rec;
  std::time_t t0 = std::time(nullptr);
  for (int64_t i = 0; i < n; ++i) {
    if (progress_every > 0 && i > 0 && i % progress_every == 0)
      std::fprintf(stderr, "oracle_native: photon %lld/%lld (%lld s, %lld recorded)\n",
                   (long long)i, (long long)n,
                   (long long)(std::time(nullptr) - t0),
                   (long long)tr.n_recorded);
    Photon ph;
    for (int c = 0; c < 4; ++c) {
      ph.x[c] = x[i * 4 + c];
      ph.k[c] = k[i * 4 + c];
      ph.dkdlam[c] = 0.0;
    }
    ph.w = w[i];
    ph.e = e[i];
    ph.l = l[i];
    ph.x1i = x[i * 4 + 1];
    ph.x2i = x[i * 4 + 2];
    ph.tau_abs = 0.0;
    ph.tau_scatt = 0.0;
    ph.n_e_0 = n_e_0[i];
    ph.theta_e_0 = theta_e_0[i];
    ph.b_0 = b_0[i];
    ph.e_0 = e_0[i];
    ph.e_0_s = e[i];
    ph.n_scatt = (int)n_scatt[i];
    tr.track(ph);
  }
  out->max_tau_scatt = tr.max_tau_scatt;
  out->n_recorded = tr.n_recorded;
  out->n_scatt_rec = tr.n_scatt_rec;
  return 0;
}

// Deterministic sub-function probe for exact parity tests.  Layout:
//   [0:7]    gcov7 at x
//   [7:13]   gcon6 at x
//   [13:53]  connection40 at x
//   [53:56]  n_e, theta_e, b
//   [56:72]  u_con, u_cov, b_con, b_cov
//   [72:76]  theta, nu, a_sc, a_ab
//   [76]     step_size(x, k)
//   [77:92]  seg_step(x, k, dk, e0s, dl): x_new, k_new, dk_new, e1, err, err_e
//   [92:124] tetrad at the fluid state (b-field trial rule): e_con, e_cov
//   [124:128] init dkdlam at (x, k)
int oracle_probe(const Consts* C, const double* hc_table, const double* k2_table,
                 const double* prims, const double* x, const double* k,
                 const double* dk, double e0s, double dl, double* out) {
  Tracker tr(*C, hc_table, k2_table, prims, 1, nullptr);
  double g7[7];
  gcov7(x[1], x[2], *C, g7);
  for (int i = 0; i < 7; ++i) out[i] = g7[i];
  double gc[6];
  gcon6(x[1], x[2], *C, gc);
  for (int i = 0; i < 6; ++i) out[7 + i] = gc[i];
  connection40(x[1], x[2], C->a, C->h_slope, out + 13);

  FluidState fs;
  fluid_params(x, g7, prims, *C, &fs);
  out[53] = fs.n_e;
  out[54] = fs.theta_e;
  out[55] = fs.b;
  for (int i = 0; i < 4; ++i) {
    out[56 + i] = fs.u_con[i];
    out[60 + i] = fs.u_cov[i];
    out[64 + i] = fs.b_con[i];
    out[68 + i] = fs.b_cov[i];
  }
  double theta, nu, a_sc, a_ab;
  alphas_at(k, fs, *C, hc_table, k2_table, &theta, &nu, &a_sc, &a_ab);
  out[72] = theta; out[73] = nu; out[74] = a_sc; out[75] = a_ab;
  out[76] = step_size(x, k, C->x_stop[2]);

  double x_new[4], k_new[4], dk_new[4], e1, err, err_e;
  tr.seg_step(x, k, dk, e0s, dl, x_new, k_new, dk_new, &e1, &err, &err_e);
  for (int i = 0; i < 4; ++i) {
    out[77 + i] = x_new[i];
    out[81 + i] = k_new[i];
    out[85 + i] = dk_new[i];
  }
  out[89] = e1; out[90] = err; out[91] = err_e;

  double b_code = fs.b / C->b_unit;
  double trial[4];
  if (fs.b > 0.0) {
    for (int i = 0; i < 4; ++i) trial[i] = fs.b_con[i] / b_code;
  } else {
    trial[0] = 0.0; trial[1] = 1.0; trial[2] = 0.0; trial[3] = 0.0;
  }
  double e_con[4][4], e_cov[4][4];
  make_tetrad(fs.u_con, trial, g7, e_con, e_cov);
  for (int mu = 0; mu < 4; ++mu)
    for (int i = 0; i < 4; ++i) {
      out[92 + mu * 4 + i] = e_con[mu][i];
      out[108 + mu * 4 + i] = e_cov[mu][i];
    }

  double conn[40];
  connection40(x[1], x[2], C->a, C->h_slope, conn);
  geodesic_rhs(conn, k, out + 124);
  return 0;
}

// Distribution-sampler hooks (statistical tests)
int oracle_sample_electron(const Consts* C, const double* k_tet, double theta_e,
                           uint64_t seed, int64_t n, double* out) {
  Tracker tr(*C, nullptr, nullptr, nullptr, seed, nullptr);
  for (int64_t i = 0; i < n; ++i) tr.sample_electron(k_tet, theta_e, out + 4 * i);
  return 0;
}

int oracle_sample_scattered(const Consts* C, const double* k_tet,
                            const double* p, uint64_t seed, int64_t n,
                            double* out) {
  Tracker tr(*C, nullptr, nullptr, nullptr, seed, nullptr);
  for (int64_t i = 0; i < n; ++i) tr.sample_scattered(k_tet, p, out + 4 * i);
  return 0;
}

}  // extern "C"
