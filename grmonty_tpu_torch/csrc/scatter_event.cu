// The scatter event of the transport engine's event phase, hand-written for
// Hopper (sm_90a): each lane's whole Compton event with its own random
// numbers, a warp's threads sharing its lanes' rejection rounds, in float
// (T = float) or double (T = double).
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
// event_phase runs the whole event phase between its compaction and the
// ring in one launch, in place on the pool (event_fluid.cu's work, this
// event, the outcome; the section before its kernel says how): on the
// engine's path it replaces the row gather, event_fluid and this kernel
// alone, which stay as checks of its parts.
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
// (chip_smoke.py counts them from the round counts).  A lane runs 1 to 144
// rounds, and one thread a lane ran each warp at the pace of its slowest
// lane (37 us at 512 lanes against a 0.02 us bound, PERF.md).
//
// Design: the rounds are independent and addressed by the counter, so any
// thread can run any round of any lane, and a round's acceptance depends on
// its own draws and the lane's inputs alone.  A warp holds L lanes (32, 8
// or 1 by the launch's width, event_lanes); thread t computes lane t % L's
// tetrad and the work between the loops (the same bits as the lane's
// owner, thread t % L).  Each loop runs in passes (warp_rounds): the
// threads are dealt over the lanes still sampling, each runs one round and
// fetches what it needs from the owner by shuffles, a ballot finds each
// lane's lowest accepted round and a shuffle hands its values to the lane.
// That is the round the sequential loop stops at, so the outputs and the
// round counts are those of one thread a lane, bit for bit; `force` (round
// CAP - 1 accepts) and Thomson's "no accept keeps cos 0" are rules of the
// round and of the lane, as there.  A lane that accepted gives its threads
// to the others; the warp's passes follow its lanes' total rounds over 32,
// not its slowest lane's.  Measured (PERF.md, in turns with one thread a
// lane on an H100): 20.2 / 43.8 us at 16,384 lanes, 15.6 / 40.3 at 4,096,
// 12.5 / 37.5 at 1,024, 11.2 / 37.5 at 512 in float; the narrow widths'
// floor is one lane's chain, its tetrad alone about 5,500 cycles.

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

// ---- the rounds of a warp's lanes ------------------------------------------
//
// A warp holds L lanes (L = 32: one a thread; L < 32: thread t computes lane
// t % L, the same bits as its owner, thread t % L < L).  A rejection loop's
// rounds are independent and addressed by the counter (lane, sampler, round,
// block), so a pass deals the warp's 32 threads over the lanes still
// sampling: with m of them live, thread t runs round base + t / m of the
// (t % m)-th live lane, and each lane takes its lowest accepted round, which
// is the round the sequential loop stops at.  A lane that accepted, hit its
// cap or samples nothing gives its threads to the others.

constexpr unsigned FULL = 0xffffffffu;

// The place of the j-th set bit (from 0) of a mask with more than j of them.
__device__ __forceinline__ int nth_set_bit(unsigned mask, int j) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) {
    const unsigned lo = mask & ((1u << w) - 1u);
    const int c = __popc(lo);
    if (j >= c) {
      j -= c;
      mask >>= w;
      pos += w;
    } else {
      mask = lo;
    }
  }
  return pos;
}

// The threads of a pass that run rounds of owner o's lane, `live` the
// owners still sampling: t = j, j + m, j + 2m, ... for its rank j among m.
__device__ __forceinline__ unsigned lane_workers(unsigned live, int o) {
  const int m = __popc(live);
  const int j = __popc(live & ((1u << o) - 1u));
  unsigned p = 1u;
  for (int s = m; s < 32; s <<= 1) p |= p << s;
  return p << j;
}

// One rejection loop over the warp's lanes.  `sampling`: whether this
// thread's lane runs the loop (the same in all threads of a lane); `cap` its
// rounds at most.  eval(src, r, work, v) runs round r of the lane of owner
// thread src when `work` (fetching what the round needs from src by
// shuffles, which every thread reaches) and returns whether it accepts,
// with the round's NV values in v.  On return, for a sampling lane: whether
// a round accepted, `val` that round's values (else left as given) and
// `rounds` the rounds the sequential loop would have run.
template <int L, int NV, typename T, typename Eval>
__device__ __forceinline__ bool warp_rounds(bool sampling, int cap, int &rounds, T (&val)[NV],
                                            Eval eval) {
  constexpr unsigned OWNERS = L == 32 ? FULL : (1u << L) - 1u;
  const int t = threadIdx.x & 31, own = t % L;
  int base = 0;
  bool acc = false;
  unsigned live = __ballot_sync(FULL, sampling) & OWNERS;
  while (live) {
    const int m = __popc(live);
    const int src = nth_set_bit(live, t % m);
    const int r = __shfl_sync(FULL, base, src) + t / m;
    const int src_cap = __shfl_sync(FULL, cap, src);
    T v[NV] = {};
    const bool a = eval(src, r, r < src_cap, v);
    const unsigned wk = lane_workers(live, own);
    const int win = __ffs(__ballot_sync(FULL, a) & wk) - 1;
    const int from = win >= 0 ? win : t;
    T got[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) got[q] = __shfl_sync(FULL, v[q], from);
    const int r_win = __shfl_sync(FULL, r, from);
    if (sampling) {
      if (win >= 0) {
        acc = true;
        sampling = false;
        rounds = r_win + 1;
#pragma unroll
        for (int q = 0; q < NV; ++q) val[q] = got[q];
      } else {
        base = min(base + __popc(wk), cap);
        if (base >= cap) {
          sampling = false;
          rounds = cap;
        }
      }
    }
    live = __ballot_sync(FULL, sampling) & OWNERS;
  }
  return acc;
}

// ---- the lanes' rounds and samplers (ops/proba.py, ops/scattering.py) -------

// What a lane's electron rounds read (sample_electron_distr_p_c): theta_e,
// the mixture's weights and k_tet^0, computed once by the lane's thread.
template <typename T>
struct ElConst {
  T th, sq, c1, c2, c3, k0;
};

template <typename T>
__device__ __forceinline__ ElConst<T> electron_consts(T k0, T th) {
  const T pi_3 = T(SQRT_PI_OVER_4_D);
  const T sq = fm::sqrt(T(0.5) * th);
  const T pi_4 = sq * T(0.5);
  const T pi_5 = T(THREE_SQRT_PI_D) * th * T(0.125);
  const T pi_6 = th * sq;
  const T s3 = pi_3 + pi_4 + pi_5 + pi_6;
  return {th, sq, pi_3 / s3, (pi_3 + pi_4) / s3, (pi_3 + pi_4 + pi_5) / s3, k0};
}

// Round r of a lane's electron loop: whether it accepts (round CAP - 1
// under `force` always does) and its gamma, beta, mu.
template <typename T>
__device__ __forceinline__ bool electron_round(const Lane &rng, const ElConst<T> &C, int r,
                                               bool force, T (&v)[3]) {
  const Words a = rng.block(S_ELECTRON, r, 0), b = rng.block(S_ELECTRON, r, 1),
              c = rng.block(S_ELECTRON, r, 2);
  const T x1 = unif<T>(a.v[0]);
  const int dof = x1 < C.c1 ? 3 : (x1 < C.c2 ? 4 : (x1 < C.c3 ? 5 : 6));
  T n[6];
  box_muller(unif<T>(a.v[1]), unif<T>(a.v[2]), n[0], n[1]);
  box_muller(unif<T>(a.v[3]), unif<T>(b.v[0]), n[2], n[3]);
  box_muller(unif<T>(b.v[1]), unif<T>(b.v[2]), n[4], n[5]);
  T y2 = n[0] * n[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) y2 = y2 + (i < dof ? n[i] * n[i] : T(0));
  const T y = fm::sqrt(y2 * T(0.5));
  const T num = fm::sqrt(T(1) + T(0.5) * C.th * y * y);
  const T den = T(1) + y * C.sq;
  const bool accept_y = unif<T>(b.v[3]) < num / den;
  const T g = y * y * C.th + T(1);
  const T bn = fm::sqrt(T(1) - T(1) / (g * g));
  const T det = T(1) + T(2) * bn + bn * bn - T(4) * bn * unif<T>(c.v[0]);
  const T m = clamp((T(1) - fm::sqrt(det)) / (bn + T(1e-30)), T(-1), T(1));
  const T k_eff = g * (T(1) - bn * m) * C.k0;
  const bool accept_kn = unif<T>(c.v[1]) < sigma_kn_total(k_eff);
  v[0] = g;
  v[1] = bn;
  v[2] = m;
  return (accept_y && accept_kn) || (r == CAP_ELECTRON - 1 && force);
}

// What a hot lane's Klein-Nishina rounds read (sample_scattered_photon_c).
template <typename T>
struct KnConst {
  T k0, k0pmin, envelope;
};

// Round r of a lane's second loop: Klein-Nishina where hot (the tentative
// k0'; round CAP_KN - 1 under `force` always accepts), else Thomson (the
// cosine); whether it accepts.
template <typename T>
__device__ __forceinline__ bool second_round(const Lane &rng, bool hot, const KnConst<T> &C, int r,
                                             bool force, T (&v)[1]) {
  const Words w = rng.block(hot ? S_KLEIN_NISHINA : S_THOMSON, r, 0);
  if (hot) {
    const T tent = C.k0pmin + (C.k0 - C.k0pmin) * unif<T>(w.v[0]);
    const T x1 = C.envelope * unif<T>(w.v[1]);
    v[0] = tent;
    return x1 < klein_nishina(C.k0, tent) || (r == CAP_KN - 1 && force);
  }
  const T x1 = T(2) * unif<T>(w.v[0]) - T(1);
  const T x2 = T(0.75) * unif<T>(w.v[1]);
  v[0] = x1;
  return x2 < T(0.375) * (T(1) + x1 * x1);
}

// The samplers of the warp's lanes (sample_electron_distr_p_c, then
// sample_scattered_photon_c), every thread of the warp taking part: on a
// lane that samples (`go`) the electron p, the scattered k_out, whether
// each loop accepted and the rounds each ran; elsewhere ok_el = ok_sc =
// true, k_out = 0 and no rounds.  `lane` is the lane's counter index.
template <int L, typename T>
__device__ __forceinline__ void sample_lanes(uint64_t key0, uint64_t key1, int lane,
                                             const T k_tet[4], T th, bool force, bool go, T p[4],
                                             bool &ok_el, int &rounds_el, T k_out[4],
                                             bool &ok_sc, int &rounds_sc) {
  // the electron loop: 16 rounds at most
  const ElConst<T> ec = electron_consts(k_tet[0], th);
  T el[3] = {T(1), T(0), T(0)};  // gamma, beta, mu where no round accepts
  rounds_el = 0;
  const bool acc_el = warp_rounds<L>(go, CAP_ELECTRON, rounds_el, el,
                                     [&](int src, int r, bool work, T (&v)[3]) {
    const ElConst<T> c{__shfl_sync(FULL, ec.th, src), __shfl_sync(FULL, ec.sq, src),
                       __shfl_sync(FULL, ec.c1, src), __shfl_sync(FULL, ec.c2, src),
                       __shfl_sync(FULL, ec.c3, src), __shfl_sync(FULL, ec.k0, src)};
    const int ln = __shfl_sync(FULL, lane, src);
    const bool f = __shfl_sync(FULL, (int)force, src) != 0;
    return work && electron_round(Lane{key0, key1, (uint64_t)ln}, c, r, f, v);
  });
  ok_el = acc_el || !go;

  // the electron's direction about the photon, the photon in its frame
  const Lane rng{key0, key1, (uint64_t)lane};
  T ke[4] = {T(0), T(0), T(0), T(0)};
  KnConst<T> kc{T(0), T(0), T(0)};
  bool hot = false;
  if (go) {
    const T gamma = el[0], beta = el[1], mu = el[2];
    const Words d = rng.block(S_ELECTRON_DIR, 0, 0);
    const T s_th = fm::sqrt(T(1) - mu * mu);
    const T phi = unif<T>(d.v[0]) * T(2) * T(PI_D);
    T dir[3];
    dir_about_axis(k_tet[1], k_tet[2], k_tet[3], mu, s_th, phi, unif<T>(d.v[1]),
                   unif<T>(d.v[2]), dir);
    const T gb = gamma * beta;
    p[0] = gamma;
    p[1] = gb * dir[0];
    p[2] = gb * dir[1];
    p[3] = gb * dir[2];
    boost(k_tet, p, ke);
    hot = ke[0] > T(1.0e-4);
    if (hot) {
      const T k0 = clamp_min(ke[0], T(1.0e-4));
      kc = {k0, k0 / (T(1) + T(2) * k0),
            T(2) * (T(1) + T(2) * k0 + T(2) * k0 * k0) / (k0 * k0 * (T(1) + T(2) * k0))};
    }
  }

  // the second loop: Klein-Nishina (128 rounds) where hot, else Thomson (16)
  T sc[1] = {T(0)};
  rounds_sc = 0;
  const bool acc_sc = warp_rounds<L>(go, hot ? CAP_KN : CAP_THOMSON, rounds_sc, sc,
                                     [&](int src, int r, bool work, T (&v)[1]) {
    const KnConst<T> c{__shfl_sync(FULL, kc.k0, src), __shfl_sync(FULL, kc.k0pmin, src),
                       __shfl_sync(FULL, kc.envelope, src)};
    const int ln = __shfl_sync(FULL, lane, src);
    const bool h = __shfl_sync(FULL, (int)hot, src) != 0;
    const bool f = __shfl_sync(FULL, (int)force, src) != 0;
    return work && second_round(Lane{key0, key1, (uint64_t)ln}, h, c, r, f, v);
  });

  // the scattered direction and the boost back
  ok_sc = true;
#pragma unroll
  for (int j = 0; j < 4; ++j) k_out[j] = T(0);
  if (go) {
    T k0p, c_th;
    if (hot) {  // a lane that never accepts keeps k0' = k0
      k0p = acc_sc ? sc[0] : kc.k0;
      ok_sc = acc_sc;
      c_th = T(1) - T(1) / k0p + T(1) / kc.k0;
    } else {  // a lane that never accepts keeps cos 0
      k0p = ke[0];
      c_th = acc_sc ? sc[0] : T(0);
    }
    const T s_th = fm::sqrt(fm::fabs(T(1) - c_th * c_th));
    const Words d = rng.block(S_SCATTER_DIR, 0, 0);
    const T phi = T(2.0 * PI_D) * unif<T>(d.v[0]);
    T dir[3];
    dir_about_axis(ke[1], ke[2], ke[3], c_th, s_th, phi, unif<T>(d.v[1]), unif<T>(d.v[2]),
                   dir);
    const T kpe[4] = {k0p, k0p * dir[0], k0p * dir[1], k0p * dir[2]};
    const T p_rev[4] = {p[0], -p[1], -p[2], -p[3]};
    boost(kpe, p_rev, k_out);
  }
}

// ---- the kernels ------------------------------------------------------------

// The device pointers of a launch, passed by value as the kernel's parameter.
template <int NPTRS>
struct Ptrs {
  void *p[NPTRS];
};

// The lanes a warp and a block of an instance of L lanes a warp, and a
// thread's lane: blocks of THREADS, warp w's lanes (block's first + w) L +
// [0, L), thread t computing lane t % L of its warp's, storing if t < L.
template <int L>
__device__ __forceinline__ int warp_lane(int &t) {
  t = threadIdx.x & 31;
  return (blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * L + t % L;
}

// scatter_event: pointers k0..3, u_con0..3, b_con0..3, b, theta_e, g7[7],
// active, force, key[2]; then parent_die, made, sampled (u8), k_sec0..3,
// e_sec, l_sec (T), rounds_el, rounds_sc (int32).  Scalars: 1 / b_unit,
// then the lanes a warp (below 1: by the width, event_lanes).
constexpr int EVENT_NPTRS = 24 + 11;

template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
    scatter_event_kernel(const Ptrs<EVENT_NPTRS> ptrs, T inv_b_unit, int n) {
  int t;
  const int i0 = warp_lane<L>(t);
  const int i = i0 < n ? i0 : n - 1;  // past n: lane n - 1's work, no store
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

  T p[4], k_tet_p[4];
  bool ok_el, ok_kn;
  int rounds_el, rounds_sc;
  sample_lanes<L>((uint64_t)key[0], (uint64_t)key[1], i, k_tet, clamp_min(theta_e, T(1e-4)),
                  force, !guard && i0 < n, p, ok_el, rounds_el, k_tet_p, ok_kn, rounds_sc);
  if (i0 >= n || t >= L) return;
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
// k_tet_p0..3 (T), ok_el, ok_kn (u8), rounds_el, rounds_sc (int32).  Its
// lanes run as the event kernel's at 32 lanes a warp.
constexpr int CHAIN_NPTRS = 7 + 12;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    scatter_chain_kernel(const Ptrs<CHAIN_NPTRS> ptrs, int n) {
  int t;
  const int i0 = warp_lane<32>(t);
  const int i = i0 < n ? i0 : n - 1;
  auto in = [&](int j) { return ((const T *)ptrs.p[j])[i]; };
  const T k_tet[4] = {in(0), in(1), in(2), in(3)};
  const T theta_e = in(4);
  const bool force = ((const uint8_t *)ptrs.p[5])[i] != 0;
  const int64_t *key = (const int64_t *)ptrs.p[6];
  T p[4], k_out[4];
  bool ok_el, ok_kn;
  int rounds_el, rounds_sc;
  sample_lanes<32>((uint64_t)key[0], (uint64_t)key[1], i, k_tet, theta_e, force, i0 < n, p,
                   ok_el, rounds_el, k_out, ok_kn, rounds_sc);
  if (i0 >= n) return;
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

// ---- the whole event phase in one kernel ------------------------------------
//
// event_phase_kernel<T, L>: all of Engine.process_scatters between the
// compaction and the ring (engine.event_phase_plain), in place on the pool.
// Slot s of the compacted set (valid, sidx; K wide) runs where it is valid
// and within the ring's room (s < room) or the ring is wedged, on lane i =
// sidx[s]:
//   - the prologue (event_fluid.cu's work): the lane's position and wave
//     vector, its shadow registers' where they hold an event; its raw corner
//     row at its cell, fetched here by 16-byte loads; the metric pair, the
//     fluid and its four-vectors (fluid.blend_raw); the post-event opacities
//     at the parent's k and the bias; the samplers' theta_e, halved every
//     EV_HALVE defers;
//   - the event: scatter_event_kernel's, dealt over the warp's threads as
//     there (L lanes a warp), the lane's Philox counter its slot s;
//   - the epilogue: a deferred event (no accept within the caps) retries
//     next phase (ev_tries + 1); the others reset ev_tries and clear at_event
//     (or ev_pending for a shadow-register event); a doomed parent dies
//     (w, alive, occupied cleared); a surviving parent takes the refreshed
//     opacities and bias.  Each slot's 16-wide secondary row goes to the
//     staging buffer (K, 16) where it makes one (`make`, written for every
//     slot), and n_ev_soft and n_ev_forced take one atomic add a warp.
// The ring's pack is the next launch (compact.cu, rows mode).
//
// Shape: a pair of warps holds L lanes by type and width (phase_lanes:
// 16, 4 or 1 in float, 32, 8, 4 or 1 in double; the sweep of PERF.md, which
// also measured L = 32 and 8 in float, 16 in double and one warp a group of
// lanes, and kept the pair at every width).  At L < 32 the 32 / L
// threads of a lane split the
// hotcross sum's columns (hotcross_cols, G = min(32 / L, 8) of them: the same
// bits as one thread) and deal its rejection rounds.  A warp's divergent
// branches run one after the other, so the lane's two independent branches
// after its four-vectors go to two warps of a pair: the fluid warp computes
// kinematics, the hotcross sum, alpha_abs and the bias and reads the
// secondary's inputs from the pool, puts them in shared memory and arrives
// at the pair's named barrier; the owner warp computes the tetrad, k_tet and
// the samplers, waits at the barrier and stores.  Both compute the lane's
// loads, its row's blend, the metric pair and the four-vectors.  A lane's
// reads come in three dependent rounds: the slot's flag, lane and the
// ring's room; the lane's fields (the shadow registers' and the pool's
// both, picked after) and the secondary's; its corner row, with the metric
// pair computed while the row is on its way.  Only the lane's owner (thread
// t < L of the owner warp) stores, after the warp's shuffles, which every
// thread's loads precede.  Each valid slot's lane is its own (sidx
// ascending), so no two slots touch one lane; an invalid slot reads lane 0
// and stores nothing there.  What the epilogue reads (the refreshed
// opacities, the bias, |B| and the secondary's pool fields) waits in
// shared memory across the event, a slot an owner thread, so that the
// samplers run in the registers the event kernel alone had.

typedef unsigned char u8;

template <typename T>
struct PhasePtrs {  // order = hot_kernels._PHASE_PTRS
  // the pool, read at the events' lanes
  const T *x0, *x1, *x2, *x3, *k0, *k1, *k2, *k3;
  const T *ev_x0, *ev_x1, *ev_x2, *ev_x3, *ev_k0, *ev_k1, *ev_k2, *ev_k3, *ev_w;
  const T *sec_w, *n_e_0, *theta_e_0, *e_0;
  const int32_t *n_scatt;
  // and updated in place there
  T *w, *alpha_scatti, *alpha_absi, *bi;
  int32_t *ev_tries;
  u8 *alive, *occupied, *at_event, *ev_pending;
  // the compacted set (K), the ring's room (int64) and whether it is wedged
  const u8 *valid;
  const int64_t *sidx, *room;
  const u8 *wedged;
  // the key, the bias's denominator (one value), the raw corner table, the
  // (41, 31) hotcross surface
  const int64_t *key;
  const T *bias_den, *table, *hc;
  // the staged secondaries (K, 16) and their flags (K); the counters
  T *rows;
  u8 *make;
  int64_t *n_ev_soft, *n_ev_forced;
};
constexpr int PHASE_NPTRS = sizeof(PhasePtrs<float>) / sizeof(void *);
static_assert(sizeof(PhasePtrs<double>) == sizeof(PhasePtrs<float>), "one pointer layout");
// the hot step's scalars, then EV_HALVE, EV_FORCE and the lanes a warp (below
// 1: by the width, phase_lanes)
constexpr int PHASE_NSCAL = HOT_NSCAL + 3;
constexpr int STAGE_W = 16;  // a staged secondary's row (engine.ROW_WIDTH)
constexpr int STASH = 11;  // what the epilogue reads of the prologue and the pool

// A pair's named barrier (ids 1, 2, ...: 0 is __syncthreads'): the fluid
// warp arrives once its opacities are in shared memory, the owner warp
// waits there before it reads them.
__device__ __forceinline__ void pair_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// A thread's slot in an event-phase instance of L lanes a warp: blocks of
// THREADS, warps 2p and 2p + 1 holding pair p's lanes (block's first + p) L
// + [0, L), the first (the owner warp) running the event and the second (the
// fluid warp) the opacities.  Thread t of a warp computes lane t % L.
constexpr int PAIRS = THREADS / 64;  // a block's pairs of warps

template <int L>
__device__ __forceinline__ int phase_lane(int &t) {
  t = threadIdx.x & 31;
  return (blockIdx.x * PAIRS + (threadIdx.x >> 6)) * L + t % L;
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
    event_phase_kernel(const PhasePtrs<T> P, const BConst<T> CB, int ev_halve, int ev_force,
                       int k) {
  using V = typename Vec16<T>::type;
  constexpr int E = Vec16<T>::n;
  // the threads a lane that split the hotcross columns
  constexpr int G = 32 / L < 8 ? 32 / L : 8;
  __shared__ V hs[HC_NX * HC_PITCH / E];  // the hotcross surface, rows of HC_PITCH
  __shared__ unsigned long long hc_bar;   // its copies' barrier
  int t;
  const int s0 = phase_lane<L>(t);
  const int s = s0 < k ? s0 : k - 1;
  // the pair's second warp computes the opacities and the bias
  const bool fluid_warp = (threadIdx.x >> 5) & 1;
  const int pair = threadIdx.x >> 6;
  // the slot's flag, lane and the ring's room, loaded together
  const bool valid = P.valid[s];
  const int64_t lane = P.sidx[s], room = *P.room;
  const bool wedged = *P.wedged;
  const bool on = s0 < k && valid && ((int64_t)s < room || wedged);
  if (!__syncthreads_or(on)) {  // no event in the block: its slots make nothing
    if (!fluid_warp && t < L && s0 < k) P.make[s] = 0;
    return;
  }
  // the event: the shadow registers' where they hold one; both sides' loads
  // in flight with the flag's, then the corner row's, ahead of the
  // surface's staging
  const int i = on ? (int)lane : 0;
  const bool reg = on && P.ev_pending[i];
  auto at = [&](const T *r, const T *p) {
    const T a = r[i], b = p[i];
    return on ? (reg ? a : b) : T(0.0);
  };
  const T x1 = at(P.ev_x1, P.x1), x2 = at(P.ev_x2, P.x2);
  const T kk[4] = {at(P.ev_k0, P.k0), at(P.ev_k1, P.k1), at(P.ev_k2, P.k2), at(P.ev_k3, P.k3)};
  const T w = on ? P.w[i] : T(0.0);
  const int tries = on ? P.ev_tries[i] : 0;
  // the fluid at the event (fluid.blend_raw on the cell's raw corner row)
  T row[RAW_W];
  if (on) {
    const V *src =
        reinterpret_cast<const V *>(P.table) + (size_t)cell_of(x1, x2, CB) * (RAW_W / E);
#pragma unroll
    for (int q = 0; q < RAW_W / E; ++q) Vec16<T>::unpack(__ldg(src + q), row + E * q);
  } else {
#pragma unroll
    for (int q = 0; q < RAW_W; ++q) row[q] = T(0.0);
  }
  // the metric pair (x1 and x2 alone) while the row is on its way
  T g[7], gc[6];
  metric_pair(x1, x2, CB, g, gc);
  // what the epilogue reads waits in shared memory across the event, a slot
  // an owner thread (volatile: stored and loaded again), so that it holds no
  // registers through the samplers: the opacities, the bias and |B| of the
  // prologue, and the secondary's inputs from the pool, loaded here; a fluid
  // warp's thread fills its owner's (the thread 32 before it), the owner
  // warp only |B|
  __shared__ T stash[STASH][THREADS];
  volatile T *keep = &stash[0][threadIdx.x - (fluid_warp ? 32 : 0)];
  if (fluid_warp) {
    keep[4 * THREADS] = at(P.ev_x0, P.x0);
    keep[5 * THREADS] = at(P.ev_x3, P.x3);
    keep[6 * THREADS] = at(P.ev_w, P.sec_w);
    keep[7 * THREADS] = P.n_e_0[i];
    keep[8 * THREADS] = P.theta_e_0[i];
    keep[9 * THREADS] = P.e_0[i];
    keep[10 * THREADS] = (T)(P.n_scatt[i] + 1);
  }
  // the surface's copies run behind the row's loads, the blend and the metric
  if (threadIdx.x == 0) barrier_init(&hc_bar, THREADS);
  __syncthreads();
  for (int q = threadIdx.x; q < HC_NX * HC_PITCH; q += THREADS) {
    const int ix = q / HC_PITCH, j = q - ix * HC_PITCH;
    const bool pad = j >= HC_NY;
    T *dst = reinterpret_cast<T *>(hs) + q;
    const T *src = P.hc + (pad ? 0 : ix * HC_NY + j);
    if constexpr (sizeof(T) == 8)
      cp_async8(dst, src, pad);
    else
      cp_async4(dst, src, pad);
  }
  cp_async_arrive(&hc_bar);

  const bool inside = in_grid(x1, x2, CB);
  T n_e, te, b_mag, u_con[4], u_cov[4], b_con[4], b_cov[4];
  {
    T pr[RAW_NC];
    blend_row<RAW_NC>(x1, x2, row, CB, pr);
    raw_scalars(pr, inside, CB, n_e, te);
    four_vectors(pr, g, gc, CB, u_cov, b_cov, &b_mag, u_con, b_con);
  }
  if (fluid_warp) {
    // the post-event refresh (Engine.eval_alphas at the parent's k) and the bias
    T sin_th, nu;
    kinematics(kk, u_cov, b_cov, b_mag, CB, sin_th, nu);
    const T nu_safe = fm::fabs(nu) + T(EPS_D);
    const T e_g = T(HPL_D) * nu_safe * CB.inv_mecc;
    barrier_wait(&hc_bar);
    // this thread's place among its lane's G column threads: lane t % L's
    // threads are t % L + L q; group q / G's G of them split the columns
    const int sub = (t / L) % G, first = t - sub * L;
    unsigned group = 0u;
#pragma unroll
    for (int q = 0; q < G; ++q) group |= 1u << (first + q * L);
    const T a_sc = nu_safe * hotcross_cols<G>(e_g, te, CB, hs, sub, group, first, L) * n_e;
    const T a_ab = alpha_abs(nu_safe, n_e, te, b_mag, sin_th, CB);
    const T bias = bias_clamp(w, CB, [&] { return T(100.0) * te * te / P.bias_den[0]; });
    keep[0 * THREADS] = nu < T(0.0) ? T(0.0) : a_sc;
    keep[1 * THREADS] = nu < T(0.0) ? T(0.0) : a_ab;
    keep[2 * THREADS] = bias;
    pair_arrive(1 + pair);  // the fluid warp's part is done
    return;
  }
  keep[3 * THREADS] = b_mag;
  const T theta_s = te * fm::exp2(-T(tries / ev_halve));
  const bool plasma = n_e > T(0.0);

  // the event (scatter_event_kernel on these inputs)
  const bool force = on && tries >= ev_force;
  const bool parent_die = kk[0] > T(1.0e5) || kk[0] < T(0) || fm::isnan(kk[0]) ||
                          fm::isnan(kk[1]) || fm::isnan(kk[3]);
  const T b_code = b_mag * CB.inv_b_unit;
  const bool mag = b_mag > T(0);
  const T inv_b = T(1) / clamp_min(b_code, T(1e-30));
  T trial[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) trial[j] = mag ? b_con[j] * inv_b : T(j == 1 ? 1 : 0);
  T e_con[4][4], e_cov[4][4];
  make_tetrad(u_con, trial, g, e_con, e_cov);
  T k_tet[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    k_tet[m] = e_cov[m][0] * kk[0] + e_cov[m][1] * kk[1] + e_cov[m][2] * kk[2] +
               e_cov[m][3] * kk[3];
  const bool invalid_frame = k_tet[0] > T(1.0e5) || k_tet[0] < T(0) || fm::isnan(k_tet[1]);
  const bool guard = invalid_frame || parent_die || !on;
  T p[4], k_tet_p[4];
  bool ok_el, ok_kn;
  int rounds_el, rounds_sc;
  sample_lanes<L>((uint64_t)P.key[0], (uint64_t)P.key[1], s, k_tet,
                  clamp_min(theta_s, T(1e-4)), force, !guard && s0 < k, p, ok_el, rounds_el,
                  k_tet_p, ok_kn, rounds_sc);
  pair_sync(1 + pair);  // the fluid warp's opacities are in

  // the outcome: an event that no round accepted waits for the next phase
  const bool sampled = (ok_el && ok_kn) || guard;
  const bool ran = on && (sampled || parent_die);
  const bool own = t < L && s0 < k;
  const unsigned soft = __ballot_sync(FULL, own && ran && tries >= ev_halve);
  const unsigned forced = __ballot_sync(FULL, own && ran && force);
  if (t == 0 && soft)
    atomicAdd(reinterpret_cast<unsigned long long *>(P.n_ev_soft),
              (unsigned long long)__popc(soft));
  if (t == 0 && forced)
    atomicAdd(reinterpret_cast<unsigned long long *>(P.n_ev_forced),
              (unsigned long long)__popc(forced));
  if (!own) return;
  T k_sec[4], tmp[4];
  tetrad_to_coordinate(e_con, k_tet_p, k_sec);
  const T flip[4] = {-k_tet_p[0], k_tet_p[1], k_tet_p[2], k_tet_p[3]};
  tetrad_to_coordinate(e_cov, flip, tmp);
  const bool made = !(parent_die || invalid_frame || fm::isnan(k_sec[1]));
  const bool make = ran && made && plasma && !parent_die;
  P.make[s] = make;
  if (!on) return;
  if (ran && !parent_die && !reg) {  // a surviving parent (harm_model.cpp:1026-1039)
    P.alpha_scatti[i] = keep[0 * THREADS];
    P.alpha_absi[i] = keep[1 * THREADS];
    P.bi[i] = keep[2 * THREADS];
  }
  if (ran && parent_die && !reg) {
    P.w[i] = T(0.0);
    P.alive[i] = 0;
    P.occupied[i] = 0;
  }
  P.ev_tries[i] = ran ? 0 : tries + 1;
  if (ran && reg) P.ev_pending[i] = 0;
  if (ran && !reg) P.at_event[i] = 0;
  if (make) {  // the secondary's row (engine.ROW_*), born at the event
    T *r = P.rows + (size_t)s * STAGE_W;
    r[0] = keep[4 * THREADS];
    r[1] = x1;
    r[2] = x2;
    r[3] = keep[5 * THREADS];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[4 + j] = k_sec[j];
    r[8] = keep[6 * THREADS];
    r[9] = -tmp[0];
    r[10] = tmp[3];
    r[11] = keep[7 * THREADS];
    r[12] = keep[8 * THREADS];
    r[13] = keep[3 * THREADS];
    r[14] = keep[9 * THREADS];
    r[15] = keep[10 * THREADS];
  }
}

// The lanes a warp of the event kernel's instance at n lanes: one a thread
// where the launch fills the card; fewer where it does not, down to one
// lane a warp (its 16 electron rounds in one pass) at the cascade's and the
// gate's sets (measured, PERF.md).
inline int event_lanes(int n) { return n > 4096 ? 32 : (n > 1024 ? 8 : 1); }

inline unsigned blocks_for(int n, int lanes_a_block) {
  return (unsigned)((n + lanes_a_block - 1) / lanes_a_block);
}

template <int NPTRS>
Ptrs<NPTRS> gather_ptrs(void **ptrs) {
  Ptrs<NPTRS> out;
  for (int j = 0; j < NPTRS; ++j) out.p[j] = ptrs[j];
  return out;
}

template <typename T, int L>
void launch_event_at(void **ptrs, T inv_b_unit, int n, cudaStream_t stream) {
  scatter_event_kernel<T, L><<<blocks_for(n, THREADS / 32 * L), THREADS, 0, stream>>>(
      gather_ptrs<EVENT_NPTRS>(ptrs), inv_b_unit, n);
}

template <typename T>
int launch_event(void **ptrs, const double *scal, int n, void *stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int lanes = scal[1] >= 1.0 ? (int)scal[1] : event_lanes(n);
  const T inv = (T)scal[0];
  const cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 32: launch_event_at<T, 32>(ptrs, inv, n, s); break;
    case 8: launch_event_at<T, 8>(ptrs, inv, n, s); break;
    case 1: launch_event_at<T, 1>(ptrs, inv, n, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The event phase's lanes a warp at K slots, by type
// (hot_kernels.EVENT_PHASE_SHAPES; measured, PERF.md): one lane to 1,024
// slots, 4 beyond, 16 (float) and 8 then 32 (double) at the waves' widths.
template <typename T>
inline int phase_lanes(int k);
template <>
inline int phase_lanes<float>(int k) {
  return k > 8192 ? 16 : (k > 1024 ? 4 : 1);
}
template <>
inline int phase_lanes<double>(int k) {
  return k > 8192 ? 32 : (k > 4096 ? 8 : (k > 1024 ? 4 : 1));
}

// The instances built: those phase_lanes selects for T.
template <typename T, int L>
constexpr bool phase_instance =
    L == 1 || L == 4 || (sizeof(T) == sizeof(float) ? L == 16 : L == 8 || L == 32);

// False where L is no instance of T (nothing launched).
template <typename T, int L>
bool launch_phase_at(const PhasePtrs<T> &P, const BConst<T> &CB, int ev_halve, int ev_force,
                     int k, cudaStream_t stream) {
  if constexpr (phase_instance<T, L>) {
    event_phase_kernel<T, L><<<blocks_for(k, PAIRS * L), THREADS, 0, stream>>>(P, CB, ev_halve,
                                                                              ev_force, k);
    return true;
  } else {
    return false;
  }
}

// event_phase: pointers in the order of PhasePtrs, the scalars PHASE_NSCAL,
// k the compacted width K.
template <typename T>
int launch_phase(void **ptrs, const double *scal, int k, void *stream) {
  if (k <= 0) return (int)cudaGetLastError();
  PhasePtrs<T> P;
  memcpy(&P, ptrs, sizeof(PhasePtrs<T>));
  AConst<T> CA;
  BConst<T> CB;
  make_consts<T>(scal, CA, CB);
  const int ev_halve = (int)scal[HOT_NSCAL], ev_force = (int)scal[HOT_NSCAL + 1];
  const int lanes = scal[HOT_NSCAL + 2] >= 1.0 ? (int)scal[HOT_NSCAL + 2] : phase_lanes<T>(k);
  const cudaStream_t s = (cudaStream_t)stream;
  bool launched = false;
  switch (lanes) {
    case 32: launched = launch_phase_at<T, 32>(P, CB, ev_halve, ev_force, k, s); break;
    case 16: launched = launch_phase_at<T, 16>(P, CB, ev_halve, ev_force, k, s); break;
    case 8: launched = launch_phase_at<T, 8>(P, CB, ev_halve, ev_force, k, s); break;
    case 4: launched = launch_phase_at<T, 4>(P, CB, ev_halve, ev_force, k, s); break;
    case 1: launched = launch_phase_at<T, 1>(P, CB, ev_halve, ev_force, k, s); break;
  }
  return launched ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_chain(void **ptrs, int n, void *stream) {
  if (n > 0)
    scatter_chain_kernel<T><<<blocks_for(n, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        gather_ptrs<CHAIN_NPTRS>(ptrs), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int scatter_event_nptrs() { return EVENT_NPTRS; }
int scatter_event_nscal() { return 2; }
int scatter_event_f64_nptrs() { return EVENT_NPTRS; }
int scatter_event_f64_nscal() { return 2; }
int scatter_chain_nptrs() { return CHAIN_NPTRS; }
int scatter_chain_nscal() { return 0; }
int scatter_chain_f64_nptrs() { return CHAIN_NPTRS; }
int scatter_chain_f64_nscal() { return 0; }
int philox_words_nptrs() { return 3; }
int philox_words_nscal() { return 0; }
int scatter_event_lanes(int n) { return event_lanes(n); }
int scatter_event_f64_lanes(int n) { return event_lanes(n); }
int event_phase_nptrs() { return PHASE_NPTRS; }
int event_phase_nscal() { return PHASE_NSCAL; }
int event_phase_f64_nptrs() { return PHASE_NPTRS; }
int event_phase_f64_nscal() { return PHASE_NSCAL; }
int event_phase_lanes(int k) { return phase_lanes<float>(k); }
int event_phase_f64_lanes(int k) { return phase_lanes<double>(k); }

int scatter_event_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_event<float>(ptrs, scal, n, stream);
}

int scatter_event_f64_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_event<double>(ptrs, scal, n, stream);
}

int event_phase_launch(void **ptrs, const double *scal, int k, void *stream) {
  return launch_phase<float>(ptrs, scal, k, stream);
}

int event_phase_f64_launch(void **ptrs, const double *scal, int k, void *stream) {
  return launch_phase<double>(ptrs, scal, k, stream);
}

int scatter_chain_launch(void **ptrs, const double *, int n, void *stream) {
  return launch_chain<float>(ptrs, n, stream);
}

int scatter_chain_f64_launch(void **ptrs, const double *, int n, void *stream) {
  return launch_chain<double>(ptrs, n, stream);
}

int philox_words_launch(void **ptrs, const double *, int n, void *stream) {
  if (n > 0)
    philox_words_kernel<<<blocks_for(n, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t *)ptrs[0], (const int64_t *)ptrs[1], (int64_t *)ptrs[2], n);
  return (int)cudaGetLastError();
}

}  // extern "C"
