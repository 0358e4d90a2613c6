"""The physics tables and their Chebyshev fits (numpy/scipy).

The hotcross sigma table, the synchrotron F(k)/K2 tables and the emission
direction quantile table depend only on constants.  They are read through
``utils/cache.py``, which names each file by a hash of the constants that
shape it (the JAX package's ``utils/cache._key``), reads the tracked copy
under ``grmonty_tpu_torch/data/`` (byte-for-byte the JAX package's) and
builds the table on a miss.

The Chebyshev fits are ports of ``grmonty_tpu/ops/cheb.py``
``fit1d``/``fit2d``/``fit_hotcross``/``fit_k2``: the 41x31 log10-sigma
surface and the 25-term ln K2(1/theta_e) series the hot step evaluates.
"""

import math

import numpy as np

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.utils import cache
from grmonty_tpu_torch.utils.cache import (DATA_DIR, hotcross_table,  # noqa: F401
                                           jnu_tables, theta_quantiles)

# the tracked files' names, derived from the constants
HOTCROSS_FILE = cache.file_name("hotcross", cache.hotcross_key())
JNU_FILE = cache.file_name("jnu", cache.jnu_key())
THETA_Q_FILE = cache.file_name("theta_q", cache.theta_q_key())


# ---------------------------------------------------------------------------
# Chebyshev fits
# ---------------------------------------------------------------------------

HC = consts.hotcross
HC_XLO, HC_XHI = HC.L_MIN_W, HC.L_MIN_W + HC.N_W * HC.D_L_W
HC_YLO, HC_YHI = HC.L_MIN_T, HC.L_MIN_T + HC.N_T * HC.D_L_T
K2_LO, K2_HI = consts.jnu.L_MIN_T, consts.jnu.L_MIN_T + consts.N_E_SAMP * consts.jnu.D_L_T


def cheb_nodes(n, lo, hi):
    """Chebyshev points of the first kind mapped to [lo, hi]."""
    k = np.arange(n)
    t = np.cos(math.pi * (k + 0.5) / n)
    return 0.5 * (lo + hi) + 0.5 * (hi - lo) * t


def fit1d(f, lo, hi, deg):
    """Degree-``deg`` Chebyshev series of f on [lo, hi] by discrete
    orthogonality at the nodes; returns (deg + 1,) float64."""
    n = deg + 1
    xk = cheb_nodes(n, lo, hi)
    fk = np.asarray(f(xk), dtype=np.float64)
    theta = math.pi * (np.arange(n) + 0.5) / n
    c = (2.0 / n) * np.cos(np.outer(np.arange(n), theta)) @ fk
    c[0] *= 0.5
    return c


def fit2d(f, xlo, xhi, ylo, yhi, degx, degy):
    """Tensor Chebyshev series of f(x, y); returns (degx+1, degy+1)."""
    nx, ny = degx + 1, degy + 1
    xk = cheb_nodes(nx, xlo, xhi)
    yk = cheb_nodes(ny, ylo, yhi)
    fk = np.asarray(f(xk[:, None], yk[None, :]), dtype=np.float64)
    tx = math.pi * (np.arange(nx) + 0.5) / nx
    ty = math.pi * (np.arange(ny) + 0.5) / ny
    px = (2.0 / nx) * np.cos(np.outer(np.arange(nx), tx))
    py = (2.0 / ny) * np.cos(np.outer(np.arange(ny), ty))
    c = px @ fk @ py.T
    c[0, :] *= 0.5
    c[:, 0] *= 0.5
    return c


def fit_hotcross(table, degx=40, degy=30):
    """Chebyshev fit of the log10 hotcross surface, sampled through a cubic
    spline of the table at the Chebyshev nodes (hotcross.cpp:60-79)."""
    import scipy.interpolate

    l_w = HC.L_MIN_W + np.arange(HC.N_W + 1) * HC.D_L_W
    l_t = HC.L_MIN_T + np.arange(HC.N_T + 1) * HC.D_L_T
    sp = scipy.interpolate.RectBivariateSpline(l_w, l_t, np.asarray(table), kx=3, ky=3)

    def f(x, y):
        # nodes arrive descending; the spline wants them ascending
        xs, ys = x.ravel(), y.ravel()
        xo, yo = np.argsort(xs), np.argsort(ys)
        vals = sp(xs[xo], ys[yo], grid=True)
        return vals[np.argsort(xo)][:, np.argsort(yo)]

    return fit2d(f, HC_XLO, HC_XHI, HC_YLO, HC_YHI, degx, degy)


def fit_k2(deg=24):
    """Chebyshev fit of ln K2(1/theta_e) over the K2 table span."""
    import scipy.special

    def f(l_t):
        return np.log(scipy.special.kv(2, 1.0 / np.exp(l_t)))

    return fit1d(f, K2_LO, K2_HI, deg)
