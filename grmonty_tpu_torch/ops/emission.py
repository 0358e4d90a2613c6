"""Superphoton emission: per-dump tables, zone budgets, photon sampling.

Port of ``grmonty_tpu/ops/emission.py``:

* ``init_weight_table``  (harm_model.cpp:268-306)  -> :func:`weight_table`
* ``init_nint_table``    (harm_model.cpp:308-338)  -> :func:`nint_table`
* ``init_zone``          (harm_model.cpp:1337-1389)-> :func:`zone_budgets`
* ``get_zone`` stochastic rounding (:693-697)      -> :func:`zone_counts`
* ``sample_zone_photon`` (harm_model.cpp:706-782)  -> :func:`sample_photons`
  (reference semantics) and :func:`sample_photons_cdf` (shipped profile)
* the direction quantile table's builder          -> :func:`build_theta_quantiles`
  (host numpy; ``utils/cache.theta_quantiles`` builds it on a cache miss)

The reference samples frequency and direction by rejection, and so does
:func:`sample_photons`, in log space.  The shipped profile samples both by
inverse transform of the same densities (the frequency CDF per emitting
zone, :func:`build_nu_cdf`; one global |cos theta| quantile table), exactly
as the JAX package's shipped profile does.  Every table is built in torch
on the run's device.
"""

import math
import typing

import numpy as np
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.ops import jnu, tetrads

PI = math.pi

_MAX_REJECT_ITERS = 1024  # rounds of each rejection loop
_CHECK_EVERY = 4  # rejection rounds between host reads of the all-accepted flag

NU_CDF_NODES = 512
TH_X_NODES = 384  # log10(x90) grid of the direction quantile table
TH_U_NODES = 513  # quantile nodes per x90 row
TH_LX_MIN, TH_LX_MAX = -14.0, 13.0


def build_theta_quantiles():
    """The global |cos theta| quantile table over log10(x90) (host numpy).

    Row X: the CDF of the direction density sin(th) [f(x_th)/f(x90)]^2
    exp(x90^(1/3) - x_th^(1/3)) with x_th = x90 / sin(th) (the density of
    :func:`jnu.ln_synch_ratio`) on an 8,192-point grid in |cos theta|,
    inverted at TH_U_NODES uniform quantiles; (TH_X_NODES, TH_U_NODES)
    float32."""
    lx = np.linspace(TH_LX_MIN, TH_LX_MAX, TH_X_NODES)
    x90 = 10.0**lx
    c = (np.arange(8192) + 0.5) / 8192.0  # |cos theta| midpoints
    s = np.sqrt(1.0 - c * c)

    def ln_f(x):
        xp6 = np.power(np.maximum(x, 1e-30), 1.0 / 6.0)
        return 2.0 * np.log(xp6**3 + consts.jnu.CST * xp6)

    x_th = x90[:, None] / s[None, :]
    lnr = (np.log(s)[None, :] + ln_f(x_th) - ln_f(x90)[:, None]
           + np.cbrt(x90)[:, None] - np.cbrt(x_th))
    lnr = np.maximum(lnr - lnr.max(axis=1, keepdims=True), -745.0)
    cum = np.cumsum(np.exp(lnr), axis=1)
    cdf = cum / np.maximum(cum[:, -1:], 1e-300)
    u = np.linspace(0.0, 1.0, TH_U_NODES)
    q = np.empty((TH_X_NODES, TH_U_NODES))
    grid = np.concatenate([[0.0], c + 0.5 / 8192.0])
    for ix in range(TH_X_NODES):
        q[ix] = np.interp(u, np.concatenate([[0.0], cdf[ix]]), grid)
    return q.astype(np.float32)


class SamplerTables(typing.NamedTuple):
    """Device tables of the inverse-CDF emission sampler."""

    zone_map: torch.Tensor  # (n1, n2) int64 -> cdf row, -1 for dead zones
    lnrho: torch.Tensor  # (Z_em, M) float32 ln density at the lnnu nodes
    cdf: torch.Tensor  # (Z_em, M) float32 cumulative mass in [0, 1]
    theta_q: torch.Tensor  # (TH_X_NODES, TH_U_NODES) float32 |cos theta| quantiles


def mc_l_unit(mc):
    """l_unit recovered from d_tau_k."""
    return mc.d_tau_k * (consts.ME * consts.CL * consts.CL / consts.HBAR) / (2.0 * PI)


def weight_table(fluid_zone, g_det, mc, photon_n, f_table, k2_table):
    """ln(photon weight) vs frequency, (N_E_SAMP + 1,) (harm_model.cpp:268-306)."""
    dt, dev = g_det.dtype, g_det.device
    nu = torch.exp(torch.arange(consts.N_E_SAMP + 1, dtype=dt, device=dev)
                   * consts.D_L_NU + consts.L_NU_MIN)
    s_fac = mc.dx[1] * mc.dx[2] * mc.dx[3]
    l_unit3 = mc_l_unit(mc) ** 3

    te, ne, b = fluid_zone.theta_e, fluid_zone.n_e, fluid_zone.b
    k2 = jnu.k2_eval(te, k2_table)
    live = (ne > 0.0) & (te >= consts.THETA_E_MIN) & (k2 > 0.0)
    fac = torch.where(
        live,
        (consts.JCST * ne * b * te * te / (k2 + consts.EPS)) * s_fac * l_unit3 * g_det,
        torch.zeros_like(te))
    f = jnu.f_eval(te[..., None], b[..., None], nu, f_table)
    f = torch.where(live[..., None], f, torch.zeros_like(f))
    sums = torch.einsum("ij,ijk->k", fac, f)
    return torch.log(sums / (consts.HPL * photon_n) + 1e-300)


def nint_table(weights, mc, f_table):
    """(ln nint, ln dndlnu_max) vs ln(B theta_e^2), each (NINT + 1,)
    (harm_model.cpp:308-338)."""
    dt, dev = weights.dtype, weights.device
    b_mag = torch.exp(torch.arange(consts.NINT + 1, dtype=dt, device=dev)
                      * consts.D_L_B + consts.L_B_MIN)
    nu = torch.exp(torch.arange(consts.N_E_SAMP, dtype=dt, device=dev)
                   * consts.D_L_NU + consts.L_NU_MIN)
    dn = jnu.f_eval(1.0, b_mag[:, None], nu[None, :], f_table) / (
        torch.exp(weights[: consts.N_E_SAMP])[None, :] + 1.0e-100)
    dndlnu_max = torch.amax(dn, dim=1)
    nint = torch.sum(consts.D_L_NU * dn, dim=1)
    nint = nint * (
        mc.dx[1] * mc.dx[2] * mc.dx[3] * mc_l_unit(mc) ** 3 * math.sqrt(2.0)
        * consts.EE**3 / (27.0 * consts.ME * consts.CL * consts.CL) / consts.HPL)
    return torch.log(nint + 1e-300), torch.log(dndlnu_max + 1e-300)


def zone_budgets(fluid_zone, g_det, nint_tab, dndlnu_max_tab, k2_table, photon_n):
    """Expected photon count nz and envelope dn_max per zone
    (harm_model.cpp:1337-1389), each (n1, n2)."""
    theta_e, b = fluid_zone.theta_e, fluid_zone.b
    l_bth = torch.log(torch.clamp(b * theta_e * theta_e, min=1e-300))
    d_l = (l_bth - consts.L_B_MIN) / consts.D_L_B
    l_idx = torch.trunc(d_l).to(torch.int64)  # C++ int cast
    frac = d_l - l_idx.to(d_l.dtype)
    li = torch.clamp(l_idx, 0, consts.NINT - 1)
    ninterp = torch.exp((1.0 - frac) * nint_tab[li] + frac * nint_tab[li + 1])
    dn_max = torch.exp((1.0 - frac) * dndlnu_max_tab[li] + frac * dndlnu_max_tab[li + 1])

    k2 = jnu.k2_eval(theta_e, k2_table)
    nz = g_det * fluid_zone.n_e * b * theta_e * theta_e * ninterp / (k2 + consts.EPS)
    bad = ((fluid_zone.n_e <= 0.0) | (theta_e < consts.THETA_E_MIN) | (l_idx < 0)
           | (k2 <= 0.0) | (nz > photon_n * math.log(consts.NU_MAX / consts.NU_MIN)))
    zero = torch.zeros_like(nz)
    return torch.where(bad, zero, nz), torch.where(bad, zero, dn_max)


def zone_tetrads(fluid_zone, g_cov, b_unit):
    """Per-zone emission tetrads from the field direction (harm_model.cpp:717-730);
    unmagnetised zones pass the time axis, which degenerates to the x1 axis."""
    b_code_mag = fluid_zone.b / b_unit
    t_axis = torch.zeros_like(fluid_zone.b_con)
    t_axis[..., 0] = 1.0
    b_hat = torch.where((fluid_zone.b > 0.0)[..., None],
                        fluid_zone.b_con / torch.clamp(b_code_mag, min=1e-30)[..., None],
                        t_axis)
    return tetrads.make_tetrad(fluid_zone.u_con, b_hat, g_cov)


def build_nu_cdf(theta_e, b, weights, f_table, nz):
    """Per-zone inverse-CDF tables of the frequency sampler.

    Zone rows carry the accepted density dN/dlnnu ~ F(k(nu))/W(nu) on a
    512-node lnnu grid, log-linear between nodes; bin masses integrate in
    closed form.  Zones with nz == 0 get no row.  Returns (zone_map (n1, n2)
    int64, lnrho (Z_em, M) float32, cdf (Z_em, M) float32).
    """
    dev = theta_e.device
    te = theta_e.reshape(-1).to(torch.float64)
    bb = b.reshape(-1).to(torch.float64)
    emit = (nz.reshape(-1) > 0) & (te >= consts.THETA_E_MIN)
    rows = torch.nonzero(emit).reshape(-1)
    zone_map = torch.full(te.shape, -1, dtype=torch.int64, device=dev)
    zone_map[rows] = torch.arange(rows.numel(), device=dev)
    zone_map = zone_map.reshape(theta_e.shape)

    m = NU_CDF_NODES
    lnnu = consts.L_NU_MIN + (consts.N_L_N / (m - 1)) * torch.arange(
        m, dtype=torch.float64, device=dev)
    ln_f = jnu.ln_f_eval(te[rows][:, None], bb[rows][:, None], torch.exp(lnnu),
                         f_table.to(torch.float64))

    w = weights.to(torch.float64)
    d_w = (lnnu - consts.L_NU_MIN) / (consts.N_L_N / consts.N_E_SAMP)
    iw = torch.clamp(d_w.to(torch.int64), 0, w.shape[0] - 2)
    fw = d_w - iw.to(torch.float64)
    ln_w = (1.0 - fw) * w[iw] + fw * w[iw + 1]

    lnr = ln_f - ln_w[None, :]
    # zero the density wherever the weight interpolation touches the
    # table's zero-emissivity sentinel (ln 1e-300): such photons carry no
    # weight and are dropped on load
    sentinel = (w[iw] < -600.0) | (w[iw + 1] < -600.0)
    lnr = torch.where(sentinel[None, :], -math.inf, lnr)
    lnr = torch.where(torch.isfinite(lnr), lnr, -745.0)
    lnr = torch.clamp(lnr - torch.amax(lnr, dim=1, keepdim=True), min=-745.0)

    r0 = torch.exp(lnr[:, :-1])
    r1 = torch.exp(lnr[:, 1:])
    bslope = lnr[:, 1:] - lnr[:, :-1]
    steep = torch.abs(bslope) > 1e-9
    mass = torch.where(steep, (r1 - r0) / torch.where(steep, bslope, 1.0), 0.5 * (r0 + r1))
    mass = torch.clamp(mass, min=0.0)
    cum = torch.cat([torch.zeros_like(mass[:, :1]), torch.cumsum(mass, dim=1)], dim=1)
    cdf = cum / torch.clamp(cum[:, -1:], min=1e-300)
    return zone_map, lnr.to(torch.float32), cdf.to(torch.float32)


def _interp_weight_ln(nu, weights):
    """ln(photon weight) at frequency nu (harm_model.cpp:784-792)."""
    d_i = (torch.log(nu) - consts.L_NU_MIN) / consts.D_L_NU
    i = torch.clamp(torch.floor(d_i).to(torch.int64), 0, consts.N_E_SAMP - 1)
    frac = d_i - i.to(d_i.dtype)
    return (1.0 - frac) * weights[i] + frac * weights[i + 1]


def _lower_bound(cdf_flat, base, m, u):
    """#{j < m : cdf[base + j] < u} per lane, by binary search (the rows
    are nondecreasing), without materialising the (N, m) rows."""
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, m)
    for _ in range(int(math.ceil(math.log2(m + 1)))):
        active = lo < hi
        mid = (lo + hi) // 2
        below = cdf_flat[base + torch.clamp(mid, max=m - 1)] < u
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


def sample_nu_cdf(gen, row, tabs: SamplerTables, weights, dtype):
    """(nu, lnw, alive): inverse-CDF frequency draw per lane."""
    alive = row >= 0
    m = NU_CDF_NODES
    base = torch.clamp(row, min=0) * m
    u = torch.rand(row.shape, generator=gen, dtype=dtype, device=row.device)
    cdf = tabs.cdf.reshape(-1)
    lnrho = tabs.lnrho.reshape(-1)
    idx = torch.clamp(_lower_bound(cdf, base, m, u) - 1, 0, m - 2)
    c0 = cdf[base + idx].to(dtype)
    c1 = cdf[base + idx + 1].to(dtype)
    v = torch.clamp((u - c0) / torch.clamp(c1 - c0, min=1e-12), 0.0, 1.0)
    r0 = lnrho[base + idx].to(dtype)
    r1 = lnrho[base + idx + 1].to(dtype)
    slope = torch.clamp(r1 - r0, -60.0, 60.0)
    steep = torch.abs(slope) > 1e-5
    t = torch.where(steep, torch.log1p(v * torch.expm1(slope))
                    / torch.where(steep, slope, 1.0), v)
    lnnu = consts.L_NU_MIN + (idx.to(dtype) + t) * (consts.N_L_N / (m - 1))
    nu = torch.exp(lnnu)
    lnw = _interp_weight_ln(nu, weights)
    return nu, torch.where(alive, lnw, -math.inf), alive


def sample_costh_cdf(gen, nu, theta_e, b, tabs: SamplerTables, dtype):
    """cos(theta) from the global (x90, u) quantile table, bilinear, with
    a fair-coin sign."""
    nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
    nu_s90 = (2.0 / 9.0) * nu_c * theta_e * theta_e
    lx = torch.log10(torch.clamp(nu / (nu_s90 + consts.EPS), min=1e-300))
    xg = torch.clamp((lx - TH_LX_MIN) / (TH_LX_MAX - TH_LX_MIN) * (TH_X_NODES - 1),
                     0.0, TH_X_NODES - 1.0001)
    xi = torch.floor(xg).to(torch.int64)
    xf = (xg - xi.to(xg.dtype)).to(dtype)
    u = torch.rand(nu.shape, generator=gen, dtype=dtype, device=nu.device)
    ug = u * (TH_U_NODES - 1)
    ui = torch.clamp(torch.floor(ug).to(torch.int64), 0, TH_U_NODES - 2)
    uf = (ug - ui.to(ug.dtype)).to(dtype)
    q = tabs.theta_q

    def at(i, j):
        return q[i, j].to(dtype)

    cabs = ((1 - xf) * ((1 - uf) * at(xi, ui) + uf * at(xi, ui + 1))
            + xf * ((1 - uf) * at(xi + 1, ui) + uf * at(xi + 1, ui + 1)))
    coin = torch.rand(nu.shape, generator=gen, dtype=dtype, device=nu.device)
    sign = torch.where(coin < 0.5, -1.0, 1.0).to(dtype)
    return torch.clamp(cabs, 0.0, 1.0) * sign


def _finish_photon(gen, nu, cos_th, e_con, e_cov):
    """Azimuth draw + tetrad->coordinate transform + conserved quantities
    (harm_model.cpp:753-781).  Returns (k (N, 4), e, l)."""
    sin_th = torch.sqrt(1.0 - cos_th * cos_th)
    phi = 2.0 * PI * torch.rand(nu.shape, generator=gen, dtype=nu.dtype, device=nu.device)
    e = nu * consts.HPL / (consts.ME * consts.CL * consts.CL)
    k_tetrad = torch.stack([e, e * cos_th, e * sin_th * torch.cos(phi),
                            e * sin_th * torch.sin(phi)], dim=-1)
    k = tetrads.tetrad_to_coordinate(e_con, k_tetrad)
    k_tetrad[..., 0] *= -1.0
    tmp = tetrads.tetrad_to_coordinate(e_cov, k_tetrad)
    return k, -tmp[..., 0], tmp[..., 3]


class ZoneTables(typing.NamedTuple):
    """Flat (n1*n2, ...) per-zone emission inputs in the engine dtype."""

    x: torch.Tensor  # (Z, 4) zone centres
    theta_e: torch.Tensor
    n_e: torch.Tensor
    b: torch.Tensor
    dead: torch.Tensor  # (Z,) bool: no emission budget or too cold
    ln_dn_max: torch.Tensor  # (Z,) ln of the rejection envelope (-inf where 0)
    e_con: torch.Tensor  # (Z, 4, 4)
    e_cov: torch.Tensor
    weights: torch.Tensor  # (N_E_SAMP + 1,) ln weight table


def sample_photons_cdf(gen, zflat, zt: ZoneTables, tabs: SamplerTables, dtype,
                       ln_w_offset=0.0):
    """One photon per flat zone index (harm_model.cpp:706-782), by inverse
    transform.  Returns packed (N, 16) backlog rows (engine.ROW_* layout);
    ``ln_w_offset`` = ln(weight_scale) puts the weight in engine units."""
    theta_e = zt.theta_e[zflat]
    b = zt.b[zflat]
    dead = zt.dead[zflat]
    row = torch.where(dead, -1, tabs.zone_map.reshape(-1)[zflat])
    nu, lnw, _ = sample_nu_cdf(gen, row, tabs, zt.weights, dtype)
    w = torch.exp(lnw + ln_w_offset)
    nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
    j90_zero = nu > 1.0e12 * (2.0 / 9.0) * nu_c * theta_e * theta_e
    cos_th = sample_costh_cdf(gen, nu, theta_e, b, tabs, dtype)
    cos_th = torch.where(dead | j90_zero, torch.zeros_like(cos_th), cos_th)
    k, e, l_ = _finish_photon(gen, nu, cos_th, zt.e_con[zflat], zt.e_cov[zflat])
    return _pack(zt, zflat, k, w, e, l_, theta_e, b, dtype)


def _pack(zt, zflat, k, w, e, l_, theta_e, b, dtype):
    """Packed (N, 16) backlog rows (engine.ROW_* layout)."""
    n = zflat.shape[0]
    return torch.cat([zt.x[zflat], k, torch.stack(
        [w, e, l_, zt.n_e[zflat], theta_e, b, e,
         torch.zeros(n, dtype=dtype, device=zflat.device)], dim=1)], dim=1)


def sample_photons(gen, zflat, zt: ZoneTables, f_table, dtype, ln_w_offset=0.0):
    """One photon per flat zone index (harm_model.cpp:706-782) by the
    reference's two rejection loops, with log-space accept tests: the
    frequency against the weight envelope ln F - ln w - ln dn_max, then the
    direction against ln[j(theta)/j(pi/2)] (:func:`jnu.ln_synch_ratio`).
    Lanes of dead zones start accepted (weight 0, dropped on load); each
    loop ends when every lane accepted, read on the host every
    ``_CHECK_EVERY`` rounds, or at ``_MAX_REJECT_ITERS`` rounds.  Returns
    packed (N, 16) backlog rows as :func:`sample_photons_cdf`."""
    theta_e, b, ln_dn_max = zt.theta_e[zflat], zt.b[zflat], zt.ln_dn_max[zflat]
    dead = zt.dead[zflat]
    dev = zflat.device

    def uniform():
        return torch.rand(zflat.shape, generator=gen, dtype=dtype, device=dev)

    nu = torch.full(zflat.shape, consts.NU_MIN, dtype=dtype, device=dev)
    lnw = torch.full(zflat.shape, -math.inf, dtype=dtype, device=dev)
    accepted = dead.clone()
    for it in range(_MAX_REJECT_ITERS):  # frequency (:736-740)
        if it % _CHECK_EVERY == 0 and bool(accepted.all()):
            break
        nu_new = torch.exp(uniform() * consts.N_L_N + consts.L_NU_MIN)
        lnw_new = _interp_weight_ln(nu_new, zt.weights)
        ln_ratio = jnu.ln_f_eval(theta_e, b, nu_new, f_table) - lnw_new - ln_dn_max
        take = (torch.log(uniform() + 1e-300) <= ln_ratio) & ~accepted
        nu = torch.where(take, nu_new, nu)
        lnw = torch.where(take, lnw_new, lnw)
        accepted = accepted | take
    w = torch.exp(lnw + ln_w_offset)

    # direction (:743-751); j(pi/2) = 0 where the nu > 1e12 nu_s cutoff
    # trips at sin = 1
    nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
    j90_zero = nu > 1.0e12 * (2.0 / 9.0) * nu_c * theta_e * theta_e
    cos_th = torch.zeros_like(nu)
    accepted = dead | j90_zero
    for it in range(_MAX_REJECT_ITERS):
        if it % _CHECK_EVERY == 0 and bool(accepted.all()):
            break
        cth_new = 2.0 * uniform() - 1.0
        s_th = torch.sqrt(torch.clamp(1.0 - cth_new * cth_new, min=1e-30))
        ln_ratio = jnu.ln_synch_ratio(nu, theta_e, b, s_th)
        take = (torch.log(uniform() + 1e-300) <= ln_ratio) & ~accepted
        cos_th = torch.where(take, cth_new, cos_th)
        accepted = accepted | take
    k, e, l_ = _finish_photon(gen, nu, cos_th, zt.e_con[zflat], zt.e_cov[zflat])
    return _pack(zt, zflat, k, w, e, l_, theta_e, b, dtype)


def zone_counts(gen, nz):
    """Stochastically round expected counts to integers (harm_model.cpp:693-697)."""
    u = torch.rand(nz.shape, generator=gen, dtype=nz.dtype, device=nz.device)
    frac = nz - torch.floor(nz)
    return (torch.floor(nz) + (frac > u).to(nz.dtype)).to(torch.int64)


class EmissionPlan(typing.NamedTuple):
    """Host-side plan: one entry per photon to create."""

    zone_i: np.ndarray  # (T,) int32
    zone_j: np.ndarray  # (T,) int32
    total: int


def plan_emission(counts: np.ndarray) -> EmissionPlan:
    """Expand per-zone counts into a flat photon -> zone map."""
    counts = np.asarray(counts)
    flat = counts.reshape(-1)
    zone_ids = np.repeat(np.arange(flat.size, dtype=np.int64), flat)
    n2 = counts.shape[1]
    return EmissionPlan(zone_i=(zone_ids // n2).astype(np.int32),
                        zone_j=(zone_ids % n2).astype(np.int32),
                        total=int(flat.sum()))
