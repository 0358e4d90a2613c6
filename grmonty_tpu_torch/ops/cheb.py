"""Chebyshev surrogates for the hotcross and K2 lookups.

Port of ``grmonty_tpu/ops/cheb.py``: evaluation only (the fits live in
``utils/tables.py``).  The fitted domains and the out-of-domain branches
mirror the reference lookups (``hotcross.cpp:81-106``,
``jnu_mixed.cpp:102-111``).
"""

import math

import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.utils.tables import HC_XHI, HC_XLO, HC_YHI, HC_YLO, K2_HI, K2_LO

HC = consts.hotcross


def eval1d(c, x, lo, hi):
    """Clenshaw evaluation; ``c`` is a host ndarray of coefficients."""
    t = (2.0 * x - (hi + lo)) / (hi - lo)
    t2 = 2.0 * t
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for k in range(len(c) - 1, 0, -1):
        b1, b2 = float(c[k]) + t2 * b1 - b2, b1
    return float(c[0]) + t * b1 - b2


def _t_matrix(t, n):
    """Chebyshev basis T_0..T_{n-1}(t) stacked to (..., n)."""
    ts = [torch.ones_like(t), t]
    for _ in range(n - 2):
        ts.append(2.0 * t * ts[-1] - ts[-2])
    return torch.stack(ts[:n], dim=-1)


def eval2d(c, x, y, xlo, xhi, ylo, yhi):
    """Tensor Chebyshev series at (x, y): ``c`` is an (nx, ny) tensor."""
    tx = (2.0 * x - (xhi + xlo)) / (xhi - xlo)
    ty = (2.0 * y - (yhi + ylo)) / (yhi - ylo)
    bx = _t_matrix(tx, c.shape[0])
    by = _t_matrix(ty, c.shape[1])
    u = bx @ c.to(bx.dtype)
    return torch.sum(u * by, dim=-1)


def hotcross_eval(w, theta_e, coeffs):
    """sigma(w, theta_e) [cm^2]: Thomson for w*theta_e < 1e-6, cold
    Klein-Nishina below the table temperature, the fitted surface (inputs
    clamped to the table domain) otherwise."""
    from grmonty_tpu_torch.ops import hotcross as hc_mod

    l_w = torch.clamp(torch.log10(torch.clamp(w, min=1e-30)), HC_XLO, HC_XHI)
    l_t = torch.clamp(torch.log10(torch.clamp(theta_e, min=1e-30)), HC_YLO, HC_YHI)
    l_sigma = eval2d(coeffs, l_w, l_t, HC_XLO, HC_XHI, HC_YLO, HC_YHI)
    interp = torch.exp(l_sigma * math.log(10.0))

    cold = hc_mod._hc_klein_nishina(w) * consts.SIGMA_THOMSON
    out = torch.where(theta_e < HC.MIN_T, cold, interp)
    return torch.where(w * theta_e < 1.0e-6, torch.full_like(out, consts.SIGMA_THOMSON), out)


def k2_eval(theta_e, coeffs):
    """K2(1/theta_e) from the Chebyshev series (jnu_mixed.cpp:102-111)."""
    l_t = torch.clamp(torch.log(torch.clamp(theta_e, min=consts.jnu.MIN_T)), K2_LO, K2_HI)
    interp = torch.exp(eval1d(coeffs, l_t, K2_LO, K2_HI))
    out = torch.where(theta_e > consts.jnu.MAX_T, 2.0 * theta_e * theta_e, interp)
    return torch.where(theta_e < consts.THETA_E_MIN, torch.zeros_like(out), out)
