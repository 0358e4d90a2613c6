"""Adaptive Gaussian quadrature for the host-side table builders.

Port of ``grmonty_tpu/ops/integration.py`` (numpy, float64): the
reference's adaptive 61-point Gauss-Kronrod integrator
(``cuda_grmonty/integration.cpp:144-236``), used only to build the
synchrotron F(k) table (``ops/jnu.build_tables``).  As in the JAX package,
the nodes are a Gauss-Legendre pair (30 and 61 points) whose difference
estimates the error, and the interval with the largest estimate is bisected
first until the summed estimate meets the tolerance.
"""

import heapq
import itertools

import numpy as np

_X30, _W30 = np.polynomial.legendre.leggauss(30)
_X61, _W61 = np.polynomial.legendre.leggauss(61)


def _panel(f, a, b):
    """(61-point value, |61-point - 30-point|) of f over [a, b]."""
    h = 0.5 * (b - a)
    c = 0.5 * (a + b)
    v61 = h * float(np.dot(_W61, f(c + h * _X61)))
    v30 = h * float(np.dot(_W30, f(c + h * _X30)))
    return v61, abs(v61 - v30)


def adaptive_gauss_quad(f, a, b, eps_abs=0.0, eps_rel=1.0e-6, limit=1000):
    """Adaptive quadrature of the vectorized ``f`` over [a, b]: bisect the
    worst interval until ``sum(err) <= max(eps_abs, eps_rel * |integral|)``
    or ``limit`` bisections were made."""
    if a == b:
        return 0.0
    v, e = _panel(f, a, b)
    counter = itertools.count()  # heap tie-breaker: tuples are never compared
    heap = [(-e, next(counter), a, b, v, e)]
    total_v, total_e = v, e
    for _ in range(limit):
        if total_e <= max(eps_abs, eps_rel * abs(total_v)):
            break
        _, _, pa, pb, pv, pe = heapq.heappop(heap)
        mid = 0.5 * (pa + pb)
        lv, le = _panel(f, pa, mid)
        rv, re = _panel(f, mid, pb)
        total_v += lv + rv - pv
        total_e += le + re - pe
        heapq.heappush(heap, (-le, next(counter), pa, mid, lv, le))
        heapq.heappush(heap, (-re, next(counter), mid, pb, rv, re))
    return total_v
