// The scatter event of the transport engine's event phase, hand-written for
// Hopper (sm_90a): one thread a lane, each lane's whole Compton event with
// its own random numbers, in float (T = float) or double (T = double).
//
// No TPU kernel does this: in the JAX package the event is XLA, the
// rejection samplers lax.while_loops inside the compiled full phase
// (grmonty_tpu/transport/engine.py:2036 `process_scatters`, the event
// grmonty_tpu/ops/scattering.py:125 `scatter_event_c`).  Its plain PyTorch
// version, grmonty_tpu_torch/ops/scattering.py `scatter_event_c`, issues
// every sampler round as 10-25 batched torch ops from the host, which reads
// the all-accepted flag every few rounds.  Here each lane runs:
//   1. the field trial vector (the x1 axis when unmagnetised), the
//      Gram-Schmidt tetrad, k in the tetrad frame, the doomed-parent and
//      invalid-frame guards (tetrads.py, scattering.py);
//   2. unless guarded or inactive: the electron loop (16 rounds at most: the
//      chi^2 mixture, Maxwell-Juettner and Klein-Nishina tests; `force`
//      takes the last draw), the electron's direction about the photon axis,
//      the boost into its frame, the Klein-Nishina loop (128 rounds) where
//      the boosted photon is hot (k > 1e-4), else the Thomson loop (16
//      rounds; a lane that never accepts keeps cos 0), the scattered
//      direction and the boost back (proba.py, scattering.py);
//   3. k_sec through e_con, e_sec and l_sec through e_cov with the time sign
//      flipped, the masks, and the rounds each loop ran.
// scatter_chain runs step 2 alone from a tetrad-frame k and theta_e (the
// scatter-chain probe's chain); philox_words writes the generator's raw
// words for given counters (the known-answer check against numpy).
//
// Random numbers: Philox4x64-10 (Salmon et al. 2011; numpy.random.Philox is
// the same generator) under a 128-bit key that the wrapper draws from the
// run's torch.Generator into device memory on each call; the counter is
// (lane, sampler, round, block), so a lane's numbers do not depend on how
// far other lanes ran.  Slots and samplers as grmonty_tpu_torch/ops/
// draws.py documents them; uniforms in [0, 1) from the top 24 (float) or
// 53 (double) bits, normals by Box-Muller with log(1 - u).
//
// Rounding: every operation of the plain version in its order, each
// multiply and add rounded on its own (-fmad=false), the same libm calls
// (log, log1p, sqrt, sin, cos), a Python scalar over a tensor as the
// tensor's reciprocal times the scalar, as PyTorch computes it on the card
// (the wrapper passes 1 / b_unit rounded as PyTorch rounds it); the six
// squared normals are added in order, as draws.PhiloxDraws adds them.  The
// literal 1e-300 of the direction's normalisation rounds to 0 in float, as
// PyTorch rounds the scalar.
//
// What bounds it on an H100 80GB HBM3: a lane reads 24 values and writes 11
// (about 140 B in float, 250 B in double: 0.7 and 1.2 us at 16,384 lanes at
// 3.35 TB/s); its work is the rounds it runs, about 60 operations and three
// Philox blocks an electron round, 30 and one block a Klein-Nishina round
// (chip_smoke.py counts them from the round counts).  A lane's rounds vary
// from 1 to 144, so a warp runs at the pace of its slowest lane; this first
// version does nothing about that (the rounds are returned for the bound).
//
// Interface: plain C entry points for ctypes, as hot_step.cu: an array of
// device pointers in the order the wrapper (transport/hot_kernels.py) lists,
// an array of double scalars, the lane count and the CUDA stream; each
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

// the device physics shared with the other kernels: the math of the type
// (fm), EPS_D and PI_D, the covariant lowering, and the lanes' random
// numbers (philox, unif, the samplers' ids)
#include "physics.cuh"

namespace {

// math.sqrt(math.pi) / 4.0 and 3.0 * math.sqrt(math.pi), as Python rounds
// them (the plain version's scalars)
constexpr double SQRT_PI_OVER_4_D = 0x1.c5bf891b4ef6ap-2;
constexpr double THREE_SQRT_PI_D = 0x1.544fa6d47b390p+2;
constexpr int THREADS = 128;

constexpr int CAP_ELECTRON = 16;
constexpr int CAP_KN = 128;
constexpr int CAP_THOMSON = 16;

namespace fm {
__device__ __forceinline__ bool isnan(float x) { return ::isnan(x); }
__device__ __forceinline__ bool isnan(double x) { return ::isnan(x); }
}  // namespace fm

// The plain version's 1e-300 (the direction's normalisation) as PyTorch
// rounds the scalar: 0 in float.
template <typename T>
__device__ __forceinline__ T tiny300();
template <>
__device__ __forceinline__ float tiny300<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ double tiny300<double>() {
  return 1e-300;
}

// torch.clamp(x, min=lo) and (x, lo, hi): NaN stays NaN
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}
template <typename T>
__device__ __forceinline__ T clamp(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A lane's generator: its key and its lane index.
struct Lane {
  uint64_t k0, k1, lane;
  __device__ __forceinline__ Words block(uint64_t sampler, uint64_t rnd, uint64_t blk) const {
    return philox(lane, sampler, rnd, blk, k0, k1);
  }
};

template <typename T>
__device__ __forceinline__ void box_muller(T u1, T u2, T &a, T &b) {
  const T r = fm::sqrt(T(-2.0) * fm::log(T(1) - u1));
  const T t = u2 * T(2.0 * PI_D);
  a = r * fm::cos(t);
  b = r * fm::sin(t);
}

// ---- tetrads (ops/tetrads.py, ops/geometry.py) ----------------------------

template <typename T>
__device__ __forceinline__ T dot_cov(const T g[7], const T u[4], const T v[4]) {
  return g[0] * u[0] * v[0] + g[1] * (u[0] * v[1] + u[1] * v[0]) +
         g[2] * (u[0] * v[3] + u[3] * v[0]) + g[3] * u[1] * v[1] +
         g[4] * (u[1] * v[3] + u[3] * v[1]) + g[5] * u[2] * v[2] + g[6] * u[3] * v[3];
}

template <typename T>
__device__ __forceinline__ void normalize(const T g[7], T v[4]) {
  const T norm = fm::sqrt(fm::fabs(dot_cov(g, v, v)));
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = v[i] / norm;
}

// va -= vb (va . vb) / (vb . vb)
template <typename T>
__device__ __forceinline__ void project_out(const T g[7], T va[4], const T vb[4]) {
  const T vb_sq = dot_cov(g, vb, vb);
  const T fac = dot_cov(g, va, vb) / vb_sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) va[i] = va[i] - vb[i] * fac;
}

// make_tetrad_c: e_con[mu][i], e_cov[mu][i]
template <typename T>
__device__ void make_tetrad(const T u_con[4], const T trial[4], const T g[7], T e_con[4][4],
                            T e_cov[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) e_con[0][i] = u_con[i];
  normalize(g, e_con[0]);
  const bool degen = dot_cov(g, trial, trial) < T(1.0e-30);
#pragma unroll
  for (int i = 0; i < 4; ++i) e_con[1][i] = degen ? T(i == 1 ? 1 : 0) : trial[i];
  project_out(g, e_con[1], e_con[0]);
  normalize(g, e_con[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) e_con[2][i] = T(i == 2 ? 1 : 0);
  project_out(g, e_con[2], e_con[0]);
  project_out(g, e_con[2], e_con[1]);
  normalize(g, e_con[2]);
#pragma unroll
  for (int i = 0; i < 4; ++i) e_con[3][i] = T(i == 3 ? 1 : 0);
  project_out(g, e_con[3], e_con[0]);
  project_out(g, e_con[3], e_con[1]);
  project_out(g, e_con[3], e_con[2]);
  normalize(g, e_con[3]);
#pragma unroll
  for (int m = 0; m < 4; ++m) lower(g, e_con[m], e_cov[m]);
#pragma unroll
  for (int i = 0; i < 4; ++i) e_cov[0][i] = -e_cov[0][i];
}

// k^i = e[0][i] kt^0 + ... as tetrad_to_coordinate_c (kt^mu e[mu][i])
template <typename T>
__device__ __forceinline__ void tetrad_to_coordinate(const T e[4][4], const T kt[4], T out[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = kt[0] * e[0][i] + kt[1] * e[1][i] + kt[2] * e[2][i] + kt[3] * e[3][i];
}

// Lorentz boost of v into the frame of 4-velocity u (tetrads.boost_c)
template <typename T>
__device__ __forceinline__ void boost(const T v[4], const T u[4], T out[4]) {
  const T g = u[0];
  const T vel = fm::sqrt(fm::fabs(T(1) - T(1) / (g * g)));
  const T denom = g * vel + T(EPS_D);
  const T n1 = u[1] / denom, n2 = u[2] / denom, n3 = u[3] / denom;
  const T gm1 = g - T(1);
  out[0] = u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3];
  out[1] = -u[1] * v[0] + (T(1) + n1 * n1 * gm1) * v[1] + n1 * n2 * gm1 * v[2] +
           n1 * n3 * gm1 * v[3];
  out[2] = -u[2] * v[0] + n2 * n1 * gm1 * v[1] + (T(1) + n2 * n2 * gm1) * v[2] +
           n2 * n3 * gm1 * v[3];
  out[3] = -u[3] * v[0] + n3 * n1 * gm1 * v[1] + n3 * n2 * gm1 * v[2] +
           (T(1) + n3 * n3 * gm1) * v[3];
}

// ---- samplers (ops/proba.py, ops/scattering.py) ---------------------------

template <typename T>
__device__ __forceinline__ T sigma_kn_total(T k_eff) {
  const T k = clamp_min(k_eff, T(1e-30));
  const T one_2k = T(1) + T(2) * k;
  const T inner = T(2) + k * k * (T(1) + k) / (one_2k * one_2k) +
                  (k * k - T(2) * k - T(2)) / (T(2) * k) * fm::log1p(T(2) * k);
  const T full = (T(1) / (T(4) * k * k)) * T(3) * inner;
  return k_eff < T(1.0e-3) ? T(1) - T(2) * k_eff : full;
}

template <typename T>
__device__ __forceinline__ T klein_nishina(T a, T ap) {
  const T ch = T(1) + T(1) / a - T(1) / ap;
  return (a / ap + ap / a - T(1) + ch * ch) / (a * a);
}

// unit vector at polar angle (c_th, s_th, phi) about `axis`, the azimuthal
// frame from the random direction of the uniforms (uz, uphi)
template <typename T>
__device__ __forceinline__ void dir_about_axis(T ax, T ay, T az, T c_th, T s_th, T phi, T uz,
                                               T uphi, T d[3]) {
  const T inv = T(1) / fm::sqrt(ax * ax + ay * ay + az * az + tiny300<T>());
  const T v0x = ax * inv, v0y = ay * inv, v0z = az * inv;
  const T z = uz * T(2) - T(1);
  const T ph = uphi * T(2) * T(PI_D);
  const T s = fm::sqrt(T(1) - z * z);
  const T n0x = s * fm::cos(ph), n0y = s * fm::sin(ph), n0z = z;
  const T ndv = n0x * v0x + n0y * v0y + n0z * v0z;
  T v1x = n0x - ndv * v0x, v1y = n0y - ndv * v0y, v1z = n0z - ndv * v0z;
  const T inv1 = T(1) / fm::sqrt(v1x * v1x + v1y * v1y + v1z * v1z + tiny300<T>());
  v1x = v1x * inv1;
  v1y = v1y * inv1;
  v1z = v1z * inv1;
  const T v2x = v0y * v1z - v0z * v1y;
  const T v2y = v0z * v1x - v0x * v1z;
  const T v2z = v0x * v1y - v0y * v1x;
  const T cp = fm::cos(phi), sp = fm::sin(phi);
  d[0] = c_th * v0x + s_th * (cp * v1x + sp * v2x);
  d[1] = c_th * v0y + s_th * (cp * v1y + sp * v2y);
  d[2] = c_th * v0z + s_th * (cp * v1z + sp * v2z);
}

// sample_electron_distr_p_c for one lane: p, ok and the rounds it ran
template <typename T>
__device__ void electron(const Lane &rng, const T k[4], T th, bool force, T p[4], bool &ok,
                         int &rounds) {
  const T pi_3 = T(SQRT_PI_OVER_4_D);
  const T sq = fm::sqrt(T(0.5) * th);
  const T pi_4 = sq * T(0.5);
  const T pi_5 = T(THREE_SQRT_PI_D) * th * T(0.125);
  const T pi_6 = th * sq;
  const T s3 = pi_3 + pi_4 + pi_5 + pi_6;
  const T c1 = pi_3 / s3, c2 = (pi_3 + pi_4) / s3, c3 = (pi_3 + pi_4 + pi_5) / s3;
  T gamma = T(1), beta = T(0), mu = T(0);
  bool acc = false;
  int r = 0;
  while (r < CAP_ELECTRON) {
    const Words a = rng.block(S_ELECTRON, r, 0), b = rng.block(S_ELECTRON, r, 1),
                c = rng.block(S_ELECTRON, r, 2);
    const T x1 = unif<T>(a.v[0]);
    const int dof = x1 < c1 ? 3 : (x1 < c2 ? 4 : (x1 < c3 ? 5 : 6));
    T n[6];
    box_muller(unif<T>(a.v[1]), unif<T>(a.v[2]), n[0], n[1]);
    box_muller(unif<T>(a.v[3]), unif<T>(b.v[0]), n[2], n[3]);
    box_muller(unif<T>(b.v[1]), unif<T>(b.v[2]), n[4], n[5]);
    T y2 = n[0] * n[0];
#pragma unroll
    for (int i = 1; i < 6; ++i) y2 = y2 + (i < dof ? n[i] * n[i] : T(0));
    const T y = fm::sqrt(y2 * T(0.5));
    const T num = fm::sqrt(T(1) + T(0.5) * th * y * y);
    const T den = T(1) + y * sq;
    const bool accept_y = unif<T>(b.v[3]) < num / den;
    const T g = y * y * th + T(1);
    const T bn = fm::sqrt(T(1) - T(1) / (g * g));
    const T det = T(1) + T(2) * bn + bn * bn - T(4) * bn * unif<T>(c.v[0]);
    const T m = clamp((T(1) - fm::sqrt(det)) / (bn + T(1e-30)), T(-1), T(1));
    const T k_eff = g * (T(1) - bn * m) * k[0];
    const bool accept_kn = unif<T>(c.v[1]) < sigma_kn_total(k_eff);
    ++r;
    if ((accept_y && accept_kn) || (r >= CAP_ELECTRON && force)) {
      gamma = g;
      beta = bn;
      mu = m;
      acc = true;
      break;
    }
  }
  rounds = r;
  ok = acc;
  const Words d = rng.block(S_ELECTRON_DIR, 0, 0);
  const T s_th = fm::sqrt(T(1) - mu * mu);
  const T phi = unif<T>(d.v[0]) * T(2) * T(PI_D);
  T dir[3];
  dir_about_axis(k[1], k[2], k[3], mu, s_th, phi, unif<T>(d.v[1]), unif<T>(d.v[2]), dir);
  const T gb = gamma * beta;
  p[0] = gamma;
  p[1] = gb * dir[0];
  p[2] = gb * dir[1];
  p[3] = gb * dir[2];
}

// sample_scattered_photon_c for one lane: k_tet_p, ok and the rounds of the
// loop it ran (Klein-Nishina where hot, else Thomson)
template <typename T>
__device__ void scattered(const Lane &rng, const T k_tet[4], const T p[4], bool force,
                          T k_out[4], bool &ok, int &rounds) {
  T ke[4];
  boost(k_tet, p, ke);
  const T ke0 = ke[0];
  const bool hot = ke0 > T(1.0e-4);
  T k0p, c_th;
  ok = true;
  int r = 0;
  if (hot) {
    const T k0 = clamp_min(ke0, T(1.0e-4));
    const T k0pmin = k0 / (T(1) + T(2) * k0);
    const T envelope =
        T(2) * (T(1) + T(2) * k0 + T(2) * k0 * k0) / (k0 * k0 * (T(1) + T(2) * k0));
    k0p = k0;
    bool acc = false;
    while (r < CAP_KN) {
      const Words w = rng.block(S_KLEIN_NISHINA, r, 0);
      const T tent = k0pmin + (k0 - k0pmin) * unif<T>(w.v[0]);
      const T x1 = envelope * unif<T>(w.v[1]);
      ++r;
      if (x1 < klein_nishina(k0, tent) || (r >= CAP_KN && force)) {
        k0p = tent;
        acc = true;
        break;
      }
    }
    ok = acc;
    c_th = T(1) - T(1) / k0p + T(1) / k0;
  } else {
    k0p = ke0;
    c_th = T(0);
    while (r < CAP_THOMSON) {
      const Words w = rng.block(S_THOMSON, r, 0);
      const T x1 = T(2) * unif<T>(w.v[0]) - T(1);
      const T x2 = T(0.75) * unif<T>(w.v[1]);
      ++r;
      if (x2 < T(0.375) * (T(1) + x1 * x1)) {
        c_th = x1;
        break;
      }
    }
  }
  rounds = r;
  const T s_th = fm::sqrt(fm::fabs(T(1) - c_th * c_th));
  const Words d = rng.block(S_SCATTER_DIR, 0, 0);
  const T phi = T(2.0 * PI_D) * unif<T>(d.v[0]);
  T dir[3];
  dir_about_axis(ke[1], ke[2], ke[3], c_th, s_th, phi, unif<T>(d.v[1]), unif<T>(d.v[2]), dir);
  const T kpe[4] = {k0p, k0p * dir[0], k0p * dir[1], k0p * dir[2]};
  const T p_rev[4] = {p[0], -p[1], -p[2], -p[3]};
  boost(kpe, p_rev, k_out);
}

// ---- the kernels ------------------------------------------------------------

// The device pointers of a launch, passed by value as the kernel's parameter.
template <int NPTRS>
struct Ptrs {
  void *p[NPTRS];
};

// scatter_event: pointers k0..3, u_con0..3, b_con0..3, b, theta_e, g7[7],
// active, force, key[2]; then parent_die, made, sampled (u8), k_sec0..3,
// e_sec, l_sec (T), rounds_el, rounds_sc (int32).  Scalar: 1 / b_unit.
constexpr int EVENT_NPTRS = 24 + 11;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    scatter_event_kernel(const Ptrs<EVENT_NPTRS> ptrs, T inv_b_unit, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto in = [&](int j) { return ((const T *)ptrs.p[j])[i]; };
  const T k[4] = {in(0), in(1), in(2), in(3)};
  const T u_con[4] = {in(4), in(5), in(6), in(7)};
  const T b_con[4] = {in(8), in(9), in(10), in(11)};
  const T b = in(12), theta_e = in(13);
  T g[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) g[j] = in(14 + j);
  const bool active = ((const uint8_t *)ptrs.p[21])[i] != 0;
  const bool force = ((const uint8_t *)ptrs.p[22])[i] != 0;
  const int64_t *key = (const int64_t *)ptrs.p[23];

  const bool parent_die = k[0] > T(1.0e5) || k[0] < T(0) || fm::isnan(k[0]) ||
                          fm::isnan(k[1]) || fm::isnan(k[3]);
  const T b_code = b * inv_b_unit;
  const bool mag = b > T(0);
  const T inv_b = T(1) / clamp_min(b_code, T(1e-30));
  T trial[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) trial[j] = mag ? b_con[j] * inv_b : T(j == 1 ? 1 : 0);
  T e_con[4][4], e_cov[4][4];
  make_tetrad(u_con, trial, g, e_con, e_cov);
  T k_tet[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    k_tet[m] = e_cov[m][0] * k[0] + e_cov[m][1] * k[1] + e_cov[m][2] * k[2] + e_cov[m][3] * k[3];
  const bool invalid_frame = k_tet[0] > T(1.0e5) || k_tet[0] < T(0) || fm::isnan(k_tet[1]);
  const bool guard = invalid_frame || parent_die || !active;

  T k_tet_p[4] = {T(0), T(0), T(0), T(0)};
  bool ok_el = true, ok_kn = true;
  int rounds_el = 0, rounds_sc = 0;
  if (!guard) {
    const Lane rng{(uint64_t)key[0], (uint64_t)key[1], (uint64_t)i};
    T p[4];
    electron(rng, k_tet, clamp_min(theta_e, T(1e-4)), force, p, ok_el, rounds_el);
    scattered(rng, k_tet, p, force, k_tet_p, ok_kn, rounds_sc);
  }
  T k_sec[4], tmp[4];
  tetrad_to_coordinate(e_con, k_tet_p, k_sec);
  const T flip[4] = {-k_tet_p[0], k_tet_p[1], k_tet_p[2], k_tet_p[3]};
  tetrad_to_coordinate(e_cov, flip, tmp);

  ((uint8_t *)ptrs.p[24])[i] = parent_die;
  ((uint8_t *)ptrs.p[25])[i] = !(parent_die || invalid_frame || fm::isnan(k_sec[1]));
  ((uint8_t *)ptrs.p[26])[i] = (ok_el && ok_kn) || guard;
#pragma unroll
  for (int j = 0; j < 4; ++j) ((T *)ptrs.p[27 + j])[i] = k_sec[j];
  ((T *)ptrs.p[31])[i] = -tmp[0];
  ((T *)ptrs.p[32])[i] = tmp[3];
  ((int32_t *)ptrs.p[33])[i] = rounds_el;
  ((int32_t *)ptrs.p[34])[i] = rounds_sc;
}

// scatter_chain: pointers k_tet0..3, theta_e, force, key[2]; then p_el0..3,
// k_tet_p0..3 (T), ok_el, ok_kn (u8), rounds_el, rounds_sc (int32).
constexpr int CHAIN_NPTRS = 7 + 12;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    scatter_chain_kernel(const Ptrs<CHAIN_NPTRS> ptrs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto in = [&](int j) { return ((const T *)ptrs.p[j])[i]; };
  const T k_tet[4] = {in(0), in(1), in(2), in(3)};
  const T theta_e = in(4);
  const bool force = ((const uint8_t *)ptrs.p[5])[i] != 0;
  const int64_t *key = (const int64_t *)ptrs.p[6];
  const Lane rng{(uint64_t)key[0], (uint64_t)key[1], (uint64_t)i};
  T p[4], k_out[4];
  bool ok_el, ok_kn;
  int rounds_el, rounds_sc;
  electron(rng, k_tet, theta_e, force, p, ok_el, rounds_el);
  scattered(rng, k_tet, p, force, k_out, ok_kn, rounds_sc);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    ((T *)ptrs.p[7 + j])[i] = p[j];
    ((T *)ptrs.p[11 + j])[i] = k_out[j];
  }
  ((uint8_t *)ptrs.p[15])[i] = ok_el;
  ((uint8_t *)ptrs.p[16])[i] = ok_kn;
  ((int32_t *)ptrs.p[17])[i] = rounds_el;
  ((int32_t *)ptrs.p[18])[i] = rounds_sc;
}

// philox_words: pointers ctr (n, 4) int64, key[2] int64, out (n, 4) int64
__global__ void __launch_bounds__(THREADS)
    philox_words_kernel(const int64_t *__restrict__ ctr, const int64_t *__restrict__ key,
                        int64_t *__restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t *c = (const uint64_t *)ctr + 4 * (int64_t)i;
  const Words w = philox(c[0], c[1], c[2], c[3], (uint64_t)key[0], (uint64_t)key[1]);
#pragma unroll
  for (int j = 0; j < 4; ++j) out[4 * (int64_t)i + j] = (int64_t)w.v[j];
}

inline unsigned blocks_for(int n) { return (unsigned)((n + THREADS - 1) / THREADS); }

template <int NPTRS>
Ptrs<NPTRS> gather_ptrs(void **ptrs) {
  Ptrs<NPTRS> out;
  for (int j = 0; j < NPTRS; ++j) out.p[j] = ptrs[j];
  return out;
}

template <typename T>
int launch_event(void **ptrs, const double *scal, int n, void *stream) {
  if (n > 0)
    scatter_event_kernel<T><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        gather_ptrs<EVENT_NPTRS>(ptrs), (T)scal[0], n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chain(void **ptrs, int n, void *stream) {
  if (n > 0)
    scatter_chain_kernel<T><<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        gather_ptrs<CHAIN_NPTRS>(ptrs), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int scatter_event_nptrs() { return EVENT_NPTRS; }
int scatter_event_nscal() { return 1; }
int scatter_event_f64_nptrs() { return EVENT_NPTRS; }
int scatter_event_f64_nscal() { return 1; }
int scatter_chain_nptrs() { return CHAIN_NPTRS; }
int scatter_chain_nscal() { return 0; }
int scatter_chain_f64_nptrs() { return CHAIN_NPTRS; }
int scatter_chain_f64_nscal() { return 0; }
int philox_words_nptrs() { return 3; }
int philox_words_nscal() { return 0; }

int scatter_event_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_event<float>(ptrs, scal, n, stream);
}

int scatter_event_f64_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_event<double>(ptrs, scal, n, stream);
}

int scatter_chain_launch(void **ptrs, const double *, int n, void *stream) {
  return launch_chain<float>(ptrs, n, stream);
}

int scatter_chain_f64_launch(void **ptrs, const double *, int n, void *stream) {
  return launch_chain<double>(ptrs, n, stream);
}

int philox_words_launch(void **ptrs, const double *, int n, void *stream) {
  if (n > 0)
    philox_words_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)ptrs[0], (const int64_t *)ptrs[1], (int64_t *)ptrs[2], n);
  return (int)cudaGetLastError();
}

}  // extern "C"
