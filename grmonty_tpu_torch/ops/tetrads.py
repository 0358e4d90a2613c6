"""Orthonormal tetrads and frame transforms.

Port of ``grmonty_tpu/ops/tetrads.py`` (reference ``tetrads.cpp:46-194``,
``boost`` at ``harm_model.cpp:1658-1671``).  The ``_c`` functions work on
component tuples: ``e_con[mu][i]`` is coordinate component i of basis
vector mu (mu=0 along the fluid 4-velocity, mu=1 along the field).
:func:`make_tetrad` is the batched array form used for the per-zone
emission tetrads, with ``e_con[..., mu, i]``.
"""

import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.ops import geometry


def _normalize_c(v, g7):
    norm = torch.sqrt(torch.abs(geometry.dot_cov_c(g7, v, v)))
    return tuple(c / norm for c in v)


def _project_out_c(va, vb, g7):
    vb_sq = geometry.dot_cov_c(g7, vb, vb)
    fac = geometry.dot_cov_c(g7, va, vb) / vb_sq
    return tuple(a - b * fac for a, b in zip(va, vb))


def make_tetrad_c(u_con, trial, g7):
    """Gram-Schmidt tetrad (tetrads.cpp:68-124): e0 along u, e1 from the
    trial vector (the x1 axis when degenerate), e2/e3 from the axes.
    Returns (e_con, e_cov), each a 4-tuple of 4-tuples of (N,) tensors."""
    zero = torch.zeros_like(u_con[0])
    one = torch.ones_like(u_con[0])

    e0 = _normalize_c(u_con, g7)

    degen = geometry.dot_cov_c(g7, trial, trial) < 1.0e-30
    t1 = (torch.where(degen, zero, trial[0]), torch.where(degen, one, trial[1]),
          torch.where(degen, zero, trial[2]), torch.where(degen, zero, trial[3]))
    e1 = _normalize_c(_project_out_c(t1, e0, g7), g7)

    e2 = _normalize_c(_project_out_c(_project_out_c((zero, zero, one, zero), e0, g7),
                                     e1, g7), g7)

    e3 = _project_out_c((zero, zero, zero, one), e0, g7)
    e3 = _project_out_c(e3, e1, g7)
    e3 = _normalize_c(_project_out_c(e3, e2, g7), g7)

    low0 = geometry.lower_c(g7, e0)
    e_cov = (tuple(-c for c in low0), geometry.lower_c(g7, e1),
             geometry.lower_c(g7, e2), geometry.lower_c(g7, e3))
    return (e0, e1, e2, e3), e_cov


def coordinate_to_tetrad_c(e_cov, k):
    """k^(mu-hat) = e_cov[mu][j] k^j (tetrads.cpp:46-55)."""
    return tuple(e[0] * k[0] + e[1] * k[1] + e[2] * k[2] + e[3] * k[3] for e in e_cov)


def tetrad_to_coordinate_c(e_con, k_tet):
    """k^i = e_con[mu][i] k^(mu-hat) (tetrads.cpp:57-66)."""
    return tuple(
        k_tet[0] * e_con[0][i] + k_tet[1] * e_con[1][i]
        + k_tet[2] * e_con[2][i] + k_tet[3] * e_con[3][i]
        for i in range(4))


def boost_c(v, u):
    """Lorentz boost of v into the frame of 4-velocity u (harm_model.cpp:1658-1671)."""
    g = u[0]
    vel = torch.sqrt(torch.abs(1.0 - 1.0 / (g * g)))
    denom = g * vel + consts.EPS
    n1 = u[1] / denom
    n2 = u[2] / denom
    n3 = u[3] / denom
    gm1 = g - 1.0

    v0, v1, v2, v3 = v
    vp0 = u[0] * v0 - u[1] * v1 - u[2] * v2 - u[3] * v3
    vp1 = -u[1] * v0 + (1.0 + n1 * n1 * gm1) * v1 + n1 * n2 * gm1 * v2 + n1 * n3 * gm1 * v3
    vp2 = -u[2] * v0 + n2 * n1 * gm1 * v1 + (1.0 + n2 * n2 * gm1) * v2 + n2 * n3 * gm1 * v3
    vp3 = -u[3] * v0 + n3 * n1 * gm1 * v1 + n3 * n2 * gm1 * v2 + (1.0 + n3 * n3 * gm1) * v3
    return (vp0, vp1, vp2, vp3)


# ---------------------------------------------------------------------------
# batched array form (per-zone emission tetrads)
# ---------------------------------------------------------------------------

def _dot(u, v, g_cov):
    return torch.einsum("...i,...ij,...j->...", u, g_cov, v)


def _normalize(v, g_cov):
    return v / torch.sqrt(torch.abs(_dot(v, v, g_cov)))[..., None]


def _project_out(va, vb, g_cov):
    return va - vb * (_dot(va, vb, g_cov) / _dot(vb, vb, g_cov))[..., None]


def make_tetrad(u_con, trial, g_cov):
    """Array form of :func:`make_tetrad_c`: (e_con, e_cov), each (..., 4, 4)."""
    batch = u_con.shape[:-1]

    def axis(i):
        a = torch.zeros(batch + (4,), dtype=u_con.dtype, device=u_con.device)
        a[..., i] = 1.0
        return a

    e0 = _normalize(u_con, g_cov)
    degen = _dot(trial, trial, g_cov) < 1.0e-30
    t1 = torch.where(degen[..., None], axis(1), trial)
    e1 = _normalize(_project_out(t1, e0, g_cov), g_cov)
    e2 = _normalize(_project_out(_project_out(axis(2), e0, g_cov), e1, g_cov), g_cov)
    e3 = _project_out(axis(3), e0, g_cov)
    e3 = _project_out(e3, e1, g_cov)
    e3 = _normalize(_project_out(e3, e2, g_cov), g_cov)

    e_con = torch.stack([e0, e1, e2, e3], dim=-2)
    e_cov = torch.einsum("...mi,...ij->...mj", e_con, g_cov)
    e_cov[..., 0, :] *= -1.0
    return e_con, e_cov


def tetrad_to_coordinate(e_con, k_tetrad):
    """k^i = e_con[mu, i] k^(mu-hat), batched."""
    return torch.einsum("...mi,...m->...i", e_con, k_tetrad)
