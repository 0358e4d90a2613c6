"""Frequency-invariant opacities and photon-fluid kinematics.

Port of ``grmonty_tpu/ops/radiation.py`` (reference ``radiation.cpp:59-146``):
the component layer of the hot path (Chebyshev surrogates), and the array
forms with the hotcross and K2 tables that the scalar oracle evaluates
(:func:`bk_angle`, :func:`fluid_nu`, :func:`alpha_inv_scatt`,
:func:`alpha_inv_abs`).
"""

import math

import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.ops import cheb, hotcross, jnu

PI = math.pi


def b_nu(nu, theta_e):
    """Planck B_nu with the reference's small-x series (radiation.cpp:121-129),
    factored so every intermediate stays inside the float32 range."""
    x = consts.HPL * nu / (consts.ME * consts.CL * consts.CL * theta_e + consts.EPS)
    pref = (2.0 * consts.HPL * nu) * (nu / consts.CL) * (nu / consts.CL)
    series = pref / (x / 24.0 * (24.0 + x * (12.0 + x * (4.0 + x))) + consts.EPS)
    full = pref / (torch.exp(torch.clamp(x, max=80.0)) - 1.0 + consts.EPS)
    return torch.where(x < 1.0e-3, series, full)


def kinematics_sin_c(k, u_cov, b_cov, b, b_unit):
    """(sin(pitch angle), fluid-frame nu [Hz]) from component tuples
    (radiation.cpp:59-101, with sqrt(1 - mu^2) for sin(arccos mu))."""
    k_u = k[0] * u_cov[0] + k[1] * u_cov[1] + k[2] * u_cov[2] + k[3] * u_cov[3]
    k_b = k[0] * b_cov[0] + k[1] * b_cov[1] + k[2] * b_cov[2] + k[3] * b_cov[3]
    mu = torch.clamp(k_b / (torch.abs(k_u) * b / b_unit + consts.EPS), -1.0, 1.0)
    sin_th = torch.where(b == 0.0, torch.ones_like(mu), torch.sqrt(1.0 - mu * mu))
    nu = -k_u * consts.ME * consts.CL * consts.CL / consts.HPL
    return sin_th, nu


def alpha_inv_scatt_c(nu, theta_e, n_e, hc_coeffs):
    """Invariant scattering opacity nu * sigma_hot * n_e (radiation.cpp:103-107)."""
    e_g = consts.HPL * nu / (consts.ME * consts.CL * consts.CL)
    sigma = cheb.hotcross_eval(e_g, theta_e, hc_coeffs)
    return nu * sigma * n_e


def alpha_inv_abs_sin_c(nu, theta_e, n_e, b, sin_th, k2_coeffs):
    """Invariant absorption opacity by Kirchhoff's law (radiation.cpp:109-119)."""
    j = jnu.synch_sin_c(nu, n_e, theta_e, b, sin_th, k2_coeffs)
    return nu * j / (b_nu(nu, theta_e) + consts.EPS)


# ---------------------------------------------------------------------------
# array forms with the tables (the scalar oracle, transport/cpu_reference.py)
# ---------------------------------------------------------------------------

def bk_angle(k, u_cov, b_cov, b, b_unit):
    """Pitch angle between photon k and the field (radiation.cpp:59-87);
    pi/2 where b == 0."""
    k_u = torch.abs(torch.sum(k * u_cov, dim=-1))
    k_b = torch.sum(k * b_cov, dim=-1)
    mu = torch.clamp(k_b / (k_u * b / b_unit + consts.EPS), -1.0, 1.0)
    return torch.where(b == 0.0, torch.full_like(mu, PI / 2.0), torch.arccos(mu))


def fluid_nu(k, u_cov):
    """Fluid-frame photon frequency [Hz] (radiation.cpp:89-101)."""
    return -torch.sum(k * u_cov, dim=-1) * consts.ME * consts.CL * consts.CL / consts.HPL


def alpha_inv_scatt(nu, theta_e, n_e, hotcross_table):
    """Invariant scattering opacity nu * sigma_hot * n_e (radiation.cpp:103-107),
    sigma from the log10 hotcross table."""
    e_g = consts.HPL * nu / (consts.ME * consts.CL * consts.CL)
    return nu * hotcross.lookup(e_g, theta_e, hotcross_table) * n_e


def alpha_inv_abs(nu, theta_e, n_e, b, theta, k2_table):
    """Invariant absorption opacity by Kirchhoff's law (radiation.cpp:109-119),
    with the K2 table."""
    j = jnu.synch(nu, n_e, theta_e, b, theta, k2_table)
    return nu * j / (b_nu(nu, theta_e) + consts.EPS)
