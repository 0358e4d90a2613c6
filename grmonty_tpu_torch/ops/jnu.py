"""Thermal synchrotron emissivity: the tables' builder and the evaluators.

Port of ``grmonty_tpu/ops/jnu.py`` (reference ``jnu_mixed.cpp:57-168``):

* :func:`build_tables` (numpy/scipy, float64, on the host) builds the two
  tables, ``f_table[i] = ln(4 pi Int_0^{pi/2} sin^2(th) (sqrt(x) +
  2^{11/12} x^{1/6})^2 exp(-x^{1/3}) dth)`` with x = k / sin(th) over 201
  log-spaced k, and ``k2_table[i] = ln K_2(1/theta_e)`` over 201 log-spaced
  theta_e (``utils/cache.jnu_tables`` builds them on a cache miss);
* the torch evaluators, among them :func:`synch`, the angle-dependent
  emissivity with the K2 table (the scalar oracle's), and
  :func:`ln_synch_ratio`, the direction density of the rejection emission
  sampler.
"""

import math

import numpy as np
import scipy.special
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.ops.integration import adaptive_gauss_quad

PI = math.pi


def _jnu_integrand(th, k):
    """Pitch-angle integrand (jnu_mixed.cpp:127-137), numpy-vectorized."""
    sin_th = np.sin(th)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        x = k / sin_th
        val = (
            sin_th
            * sin_th
            * (np.sqrt(x) + consts.jnu.CST * x ** (1.0 / 6.0)) ** 2
            * np.exp(-(x ** (1.0 / 3.0)))
        )
    return np.where((sin_th < 1.0e-150) | (x > 2.0e8), 0.0, val)


def build_tables():
    """(f_table, k2_table), each (N_E_SAMP + 1,) float64."""
    n = consts.N_E_SAMP
    f_table = np.empty(n + 1)
    for i in range(n + 1):
        k = math.exp(i * consts.jnu.D_L_K + consts.jnu.L_MIN_K)
        integral = adaptive_gauss_quad(
            lambda th: _jnu_integrand(th, k), 0.0, PI / 2.0,
            eps_abs=consts.jnu.EPS_ABS, eps_rel=consts.jnu.EPS_REL, limit=1000)
        f_table[i] = math.log(4.0 * PI * integral)
    t = np.exp(np.arange(n + 1) * consts.jnu.D_L_T + consts.jnu.L_MIN_T)
    k2_table = np.log(scipy.special.kv(2, 1.0 / t))
    return f_table, k2_table


def _cbrt(x):
    """Real cube root of x > 0."""
    return torch.pow(x, 1.0 / 3.0)


def _interp_log(l_v, l_min, d_l, table):
    """Linear interpolation of ln-valued ``table`` on a log-spaced axis."""
    d_i = (l_v - l_min) / d_l
    i = torch.clamp(torch.floor(d_i).to(torch.int64), 0, table.shape[0] - 2)
    frac = d_i - i.to(d_i.dtype)
    return torch.exp((1.0 - frac) * table[i] + frac * table[i + 1])


def k2_eval(theta_e, k2_table):
    """K_2(1/theta_e) with the asymptote above the table (jnu_mixed.cpp:102-111)."""
    interp = _interp_log(torch.log(torch.clamp(theta_e, min=consts.jnu.MIN_T)),
                         consts.jnu.L_MIN_T, consts.jnu.D_L_T, k2_table)
    out = torch.where(theta_e > consts.jnu.MAX_T, 2.0 * theta_e * theta_e, interp)
    return torch.where(theta_e < consts.THETA_E_MIN, torch.zeros_like(out), out)


def f_eval(theta_e, b_mag, nu, f_table):
    """Angle-integrated emissivity shape F(k) (jnu_mixed.cpp:113-125)."""
    k = consts.jnu.K_FAC * nu / (b_mag * theta_e * theta_e + consts.EPS)
    small = _cbrt(torch.clamp(k, min=consts.EPS))
    small_val = small * (37.67503800178 + 2.240274341836 * small)
    interp = _interp_log(torch.log(torch.clamp(k, min=consts.jnu.MIN_K)),
                         consts.jnu.L_MIN_K, consts.jnu.D_L_K, f_table)
    out = torch.where(k < consts.jnu.MIN_K, small_val, interp)
    return torch.where(k > consts.jnu.MAX_K, torch.zeros_like(out), out)


def ln_f_eval(theta_e, b_mag, nu, f_table):
    """ln F(k); out-of-table k > MAX_K returns -inf (f_eval's 0)."""
    k = consts.jnu.K_FAC * nu / (b_mag * theta_e * theta_e + consts.EPS)
    small = _cbrt(torch.clamp(k, min=consts.EPS))
    ln_small = torch.log(small * (37.67503800178 + 2.240274341836 * small))
    d_i = (torch.log(torch.clamp(k, min=consts.jnu.MIN_K)) - consts.jnu.L_MIN_K) / consts.jnu.D_L_K
    i = torch.clamp(torch.floor(d_i).to(torch.int64), 0, f_table.shape[0] - 2)
    frac = d_i - i.to(d_i.dtype)
    interp = (1.0 - frac) * f_table[i] + frac * f_table[i + 1]
    out = torch.where(k < consts.jnu.MIN_K, ln_small, interp)
    return torch.where(k > consts.jnu.MAX_K, torch.full_like(out, -math.inf), out)


def ln_synch_ratio(nu, theta_e, b, sin_th):
    """ln[j(theta) / j(pi/2)] of the thermal synchrotron emissivity: the
    n_e, K2 and constant prefactors cancel, leaving sin(theta) f(x_th) /
    f(x_90) exp(x_90^(1/3) - x_th^(1/3)), every factor in float32 range.
    -inf where the emissivity is zero at theta (nu > 1e12 nu_s); the
    caller handles j(pi/2) = 0."""
    nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
    nu_s90 = (2.0 / 9.0) * nu_c * theta_e * theta_e
    x90 = nu / (nu_s90 + consts.EPS)
    x_th = nu / (nu_s90 * sin_th + consts.EPS)

    def ln_f(x):
        xp6 = torch.pow(torch.clamp(x, min=1e-30), 1.0 / 6.0)
        return 2.0 * torch.log(xp6 * xp6 * xp6 + consts.jnu.CST * xp6)

    out = (torch.log(torch.clamp(sin_th, min=1e-30)) + ln_f(x_th) - ln_f(x90)
           + _cbrt(x90) - _cbrt(x_th))
    return torch.where(nu > 1.0e12 * nu_s90 * sin_th, torch.full_like(out, -math.inf), out)


def synch_sin_c(nu, n_e, theta_e, b, sin_th, k2_coeffs):
    """Angle-dependent emissivity j_nu from sin(pitch angle), with the
    Chebyshev K2 surrogate (the transport hot path)."""
    from grmonty_tpu_torch.ops import cheb

    return _synch_from_sin(nu, n_e, theta_e, b, sin_th,
                           cheb.k2_eval(theta_e, k2_coeffs))


def synch(nu, n_e, theta_e, b, theta, k2_table):
    """Angle-dependent thermal synchrotron emissivity j_nu with the K2
    table (jnu_mixed.cpp:75-100); zero below THETA_E_MIN and beyond
    nu > 1e12 nu_s."""
    return _synch_from_sin(nu, n_e, theta_e, b, torch.sin(theta), k2_eval(theta_e, k2_table))


def _cbrt_pos(x):
    """cbrt for x >= 0 as exp(log(x)/3) (the form the kernels use)."""
    return torch.exp(torch.log(torch.clamp(x, min=1e-37)) * (1.0 / 3.0))


def _synch_from_sin(nu, n_e, theta_e, b, sin_th, k2):
    nu_c = consts.EE * b / (2.0 * PI * consts.ME * consts.CL)
    nu_s = (2.0 / 9.0) * nu_c * theta_e * theta_e * sin_th

    x = nu / (nu_s + consts.EPS)
    xp = _cbrt_pos(x)
    xx = torch.sqrt(x) + consts.jnu.CST * torch.sqrt(xp)
    f = xx * xx
    val = (
        (math.sqrt(2.0) * PI * consts.EE * consts.EE / (3.0 * consts.CL))
        * n_e
        * nu_s
        / (k2 + consts.EPS)
        * f
        * torch.exp(-xp)
    )
    bad = (theta_e < consts.THETA_E_MIN) | (nu > 1.0e12 * nu_s) | (k2 <= 0.0)
    return torch.where(bad, torch.zeros_like(val), val)
