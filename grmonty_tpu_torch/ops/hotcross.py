"""Hot Compton cross-section helpers used on the device path.

Port of the device half of ``grmonty_tpu/ops/hotcross.py``: the cold
Klein-Nishina branch and :func:`clamp_hit`, the census of lookups that fall
where the reference re-runs its numeric integral (hotcross.cpp:81-106) but
the Chebyshev surrogate clamps to the table edge.
"""

import torch

from grmonty_tpu_torch import consts

HC = consts.hotcross


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
