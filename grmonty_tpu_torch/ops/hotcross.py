"""Angle-averaged hot-electron Compton cross-section ("hotcross").

Port of ``grmonty_tpu/ops/hotcross.py`` (reference ``hotcross.cpp:60-179``):

* the table builder :func:`build_table` (numpy/scipy, float64, on the
  host): log10 sigma(w, theta_e) on the (N_W+1, N_T+1) log10 grid, each
  entry a midpoint double integral over the electron pitch cosine and
  Lorentz factor of the Maxwell-Juettner distribution times the boosted
  Klein-Nishina cross-section (``utils/cache.hotcross_table`` builds it on a
  cache miss);
* :func:`lookup`, the bilinear log-log table lookup with the reference's
  analytic fallbacks (Thomson for w * theta_e < 1e-6, cold Klein-Nishina
  below the table), clamped to the table edge elsewhere, as the JAX device
  lookup; the scalar oracle (``transport/cpu_reference``) reads it;
* the cold Klein-Nishina branch and :func:`clamp_hit`, the census of
  lookups that fall where the reference re-runs its numeric integral
  (hotcross.cpp:81-106) but the Chebyshev surrogate of the hot step clamps.
"""

import numpy as np
import scipy.special
import torch

from grmonty_tpu_torch import consts

HC = consts.hotcross


# ---------------------------------------------------------------------------
# the table builder (host numpy)
# ---------------------------------------------------------------------------

def _hc_klein_nishina_np(w):
    """Total KN cross-section / sigma_T for photon energy w (hotcross.cpp:144-151)."""
    w = np.asarray(w, dtype=np.float64)
    series = 1.0 - 2.0 * w
    with np.errstate(divide="ignore", invalid="ignore"):
        full = 0.75 * (
            2.0 / (w * w)
            + (1.0 / (2.0 * w) - (1.0 + w) / (w**3)) * np.log1p(2.0 * w)
            + (1.0 + w) / ((1.0 + 2.0 * w) ** 2)
        )
    return np.where(w < 1.0e-3, series, full)


def _dnd_gamma_e_np(theta_e, gamma_e):
    """Maxwell-Juettner dN/dgamma_e (hotcross.cpp:153-163), with the scaled
    Bessel function kve(2, 1/theta) = K_2(1/theta) exp(1/theta)."""
    small = theta_e <= 1.0e-2
    k2f = np.where(
        small,
        np.sqrt(np.pi * np.maximum(theta_e, 1e-300) / 2.0),
        scipy.special.kve(2, 1.0 / np.maximum(theta_e, 1e-300)),
    )
    return (
        gamma_e
        * np.sqrt(np.maximum(gamma_e * gamma_e - 1.0, 0.0))
        / (theta_e * k2f)
        * np.exp(-(gamma_e - 1.0) / theta_e)
    )


def total_compton_cross_num(w, theta_e):
    """Numeric thermal average sigma [cm^2] (hotcross.cpp:108-142),
    vectorized over ``w`` (scalar or 1D) at the scalar ``theta_e``."""
    w = np.atleast_1d(np.asarray(w, dtype=np.float64))
    if theta_e < HC.MIN_T:
        if np.all(w < HC.MIN_W):
            return np.full_like(w, consts.SIGMA_THOMSON)
        return _hc_klein_nishina_np(w) * consts.SIGMA_THOMSON

    # Midpoint grids: mu_e over [-1, 1] step D_MU_E; gamma_e = 1 + theta_e*u
    # with u over (0, MAX_GAMMA) step D_GAMMA_E (the jacobian theta_e folded in).
    n_mu = int(round(2.0 / HC.D_MU_E))
    mu = -1.0 + (np.arange(n_mu) + 0.5) * HC.D_MU_E
    n_g = int(round(HC.MAX_GAMMA / HC.D_GAMMA_E))
    u = (np.arange(n_g) + 0.5) * HC.D_GAMMA_E
    gamma = 1.0 + theta_e * u

    f = 0.5 * _dnd_gamma_e_np(theta_e, gamma)  # (n_g,)
    v = np.sqrt(gamma * gamma - 1.0) / gamma  # (n_g,)

    # boostcross(w, mu, gamma) = KN(w') * (1 - mu v), w' = w gamma (1 - mu v)
    one_minus = 1.0 - mu[None, :, None] * v[None, None, :]  # (1, n_mu, n_g)
    we = w[:, None, None] * gamma[None, None, :] * one_minus
    boost = _hc_klein_nishina_np(we) * one_minus  # (n_w, n_mu, n_g)

    cross = theta_e * HC.D_MU_E * HC.D_GAMMA_E * np.einsum("wmg,g->w", boost, f)
    return cross * consts.SIGMA_THOMSON


def build_table():
    """The (N_W+1, N_T+1) log10 cross-section table (hotcross.cpp:60-79)."""
    l_w = HC.L_MIN_W + np.arange(HC.N_W + 1) * HC.D_L_W
    l_t = HC.L_MIN_T + np.arange(HC.N_T + 1) * HC.D_L_T
    w = 10.0**l_w
    table = np.empty((HC.N_W + 1, HC.N_T + 1))
    for j, lt in enumerate(l_t):
        table[:, j] = np.log10(total_compton_cross_num(w, 10.0**lt))
    return table


# ---------------------------------------------------------------------------
# torch lookups
# ---------------------------------------------------------------------------

def _hc_klein_nishina(w):
    """Total KN cross-section / sigma_T (hotcross.cpp:144-151)."""
    series = 1.0 - 2.0 * w
    ws = torch.clamp(w, min=1.0e-6)
    full = 0.75 * (
        2.0 / (ws * ws)
        + (1.0 / (2.0 * ws) - (1.0 + ws) / (ws * ws * ws)) * torch.log1p(2.0 * ws)
        + (1.0 + ws) / ((1.0 + 2.0 * ws) * (1.0 + 2.0 * ws))
    )
    return torch.where(w < 1.0e-3, series, full)


def clamp_hit(w, theta_e):
    """True where the device lookup clamps to the table edge: outside the
    table domain and served by neither the Thomson nor the cold branch."""
    thomson = w * theta_e < 1.0e-6
    cold = theta_e < HC.MIN_T
    return ~thomson & ~cold & (
        (w <= HC.MIN_W) | (w >= HC.MAX_W)
        | (theta_e <= HC.MIN_T) | (theta_e >= HC.MAX_T))


def lookup(w, theta_e, table):
    """sigma(w, theta_e) [cm^2] by bilinear log-log interpolation of the
    log10 ``table`` (a tensor), with the Thomson and cold fallbacks."""
    l_w = (torch.log10(torch.clamp(w, min=1e-30)) - HC.L_MIN_W) / HC.D_L_W
    l_t = (torch.log10(torch.clamp(theta_e, min=1e-30)) - HC.L_MIN_T) / HC.D_L_T
    l_w = torch.clamp(l_w, 0.0, HC.N_W - 1.0e-9)
    l_t = torch.clamp(l_t, 0.0, HC.N_T - 1.0e-9)
    i = torch.floor(l_w).to(torch.int64)
    j = torch.floor(l_t).to(torch.int64)
    di = l_w - i
    dj = l_t - j
    l_cross = (
        (1.0 - di) * (1.0 - dj) * table[i, j]
        + di * (1.0 - dj) * table[i + 1, j]
        + (1.0 - di) * dj * table[i, j + 1]
        + di * dj * table[i + 1, j + 1]
    )
    interp = torch.pow(10.0, l_cross)
    cold = _hc_klein_nishina(w) * consts.SIGMA_THOMSON
    out = torch.where(theta_e < HC.MIN_T, cold, interp)
    return torch.where(w * theta_e < 1.0e-6, torch.full_like(out, consts.SIGMA_THOMSON), out)
