"""Fluid state: zone-centred tables and bilinear interpolation.

Port of ``grmonty_tpu/ops/fluid.py`` (reference ``harm_model.cpp``:
``get_fluid_zone`` :538-593, ``get_fluid_params`` :595-671).  The 8
primitives are one (8, n1, n2) tensor in the order rho, u, u1, u2, u3, B1,
B2, B3.  Two bilinear corner tables serve the transport:

* the raw 32-wide table (:func:`make_corner_table`): the 8 primitives at
  the 4 corners of each cell, read by the event phase through
  :func:`get_fluid_params_c` and, under reference semantics, by the hot
  step (:func:`blend_raw`; the fused kernel fetches its rows itself);
* the derived 44-wide table (:func:`derived11` + :func:`pack_corner_rows`):
  n_e, theta_e*n_e, |B|, u_cov and b_cov at the 4 corners, read by the hot
  step of the shipped profile.
"""

import typing

import torch

from grmonty_tpu_torch.ops import geometry

DERIVED_COMPS = 11  # n_e, theta_e*n_e, |B|, u_cov(4), b_cov(4)


class ModelConsts(typing.NamedTuple):
    """Static per-dump scalars threaded through the physics."""

    a: float
    h_slope: float
    r_0: float
    x_start: tuple
    x_stop: tuple
    dx: tuple
    n1: int
    n2: int
    n_e_unit: float
    theta_e_unit: float
    b_unit: float
    x1_min: float  # ln(horizon radius)
    bias_norm: float
    d_tau_k: float
    max_tau_scatt0: float  # initial bias normalisation depth


def make_model_consts(model) -> ModelConsts:
    """ModelConsts from a parsed :class:`models.harm.HARMModel`."""
    h = model.header
    return ModelConsts(
        a=float(h.a), h_slope=float(h.h_slope), r_0=float(h.r_0),
        x_start=tuple(float(v) for v in h.x_start),
        x_stop=tuple(float(v) for v in h.x_stop),
        dx=tuple(float(v) for v in h.dx),
        n1=int(h.n[0]), n2=int(h.n[1]),
        n_e_unit=float(model.units.n_e_unit),
        theta_e_unit=float(model.units.theta_e_unit),
        b_unit=float(model.units.b_unit),
        x1_min=float(model.x1_min),
        bias_norm=float(model.bias_norm),
        d_tau_k=float(model.d_tau_k),
        max_tau_scatt0=float(model.max_tau_scatt_init),
    )


class FluidState(typing.NamedTuple):
    """Zone-centred fluid state; vectors carry a trailing axis of 4."""

    n_e: torch.Tensor
    theta_e: torch.Tensor
    b: torch.Tensor  # field magnitude [gauss]
    u_con: torch.Tensor
    u_cov: torch.Tensor
    b_con: torch.Tensor  # code units
    b_cov: torch.Tensor


class FluidC(typing.NamedTuple):
    """Component-form fluid state (4-tuples of (N,) tensors)."""

    n_e: torch.Tensor
    theta_e: torch.Tensor
    b: torch.Tensor
    u_con: tuple
    u_cov: tuple
    b_con: tuple
    b_cov: tuple


def _full_metric(comps, pattern):
    """(..., 4, 4) from the sparse component tuple; ``pattern`` maps each
    (row, col) to a component index or None (zero)."""
    zero = torch.zeros_like(comps[0])
    return torch.stack([
        torch.stack([comps[pattern[r][c]] if pattern[r][c] is not None else zero
                     for c in range(4)], dim=-1)
        for r in range(4)], dim=-2)


_GCOV_PATTERN = ((0, 1, None, 2), (1, 3, None, 4), (None, None, 5, None), (2, 4, None, 6))
_GCON_PATTERN = ((0, 1, None, None), (1, 2, None, 3), (None, None, 4, None), (None, 3, None, 5))


def det4(m):
    """4x4 determinant by cofactor expansion along row 0."""
    c01 = m[..., 2, 0] * m[..., 3, 1] - m[..., 2, 1] * m[..., 3, 0]
    c02 = m[..., 2, 0] * m[..., 3, 2] - m[..., 2, 2] * m[..., 3, 0]
    c03 = m[..., 2, 0] * m[..., 3, 3] - m[..., 2, 3] * m[..., 3, 0]
    c12 = m[..., 2, 1] * m[..., 3, 2] - m[..., 2, 2] * m[..., 3, 1]
    c13 = m[..., 2, 1] * m[..., 3, 3] - m[..., 2, 3] * m[..., 3, 1]
    c23 = m[..., 2, 2] * m[..., 3, 3] - m[..., 2, 3] * m[..., 3, 2]
    m00 = m[..., 1, 1] * c23 - m[..., 1, 2] * c13 + m[..., 1, 3] * c12
    m01 = m[..., 1, 0] * c23 - m[..., 1, 2] * c03 + m[..., 1, 3] * c02
    m02 = m[..., 1, 0] * c13 - m[..., 1, 1] * c03 + m[..., 1, 3] * c01
    m03 = m[..., 1, 0] * c12 - m[..., 1, 1] * c02 + m[..., 1, 2] * c01
    return (m[..., 0, 0] * m00 - m[..., 0, 1] * m01
            + m[..., 0, 2] * m02 - m[..., 0, 3] * m03)


def precompute_zone_geometry(mc, device, dtype=torch.float64):
    """Zone centres x (n1, n2, 4), g_cov/g_con (n1, n2, 4, 4) and
    sqrt|det g| (n1, n2) (harm_model.cpp:242-266)."""
    ii, jj = torch.meshgrid(
        torch.arange(mc.n1, dtype=dtype, device=device),
        torch.arange(mc.n2, dtype=dtype, device=device), indexing="ij")
    x1 = mc.x_start[1] + (ii + 0.5) * mc.dx[1]
    x2 = mc.x_start[2] + (jj + 0.5) * mc.dx[2]
    x = torch.stack([torch.full_like(x1, mc.x_start[0]), x1, x2,
                     torch.full_like(x1, mc.x_start[3])], dim=-1)
    g_cov = _full_metric(geometry.gcov_c(x1, x2, mc.a, mc.h_slope, mc.r_0), _GCOV_PATTERN)
    g_con = _full_metric(geometry.gcon_c(x1, x2, mc.a, mc.h_slope, mc.r_0), _GCON_PATTERN)
    g_det = torch.sqrt(torch.abs(det4(g_cov)))
    return x, g_cov, g_con, g_det


def lower(v_con, g_cov):
    """v_mu = g_{mu nu} v^nu for batched vectors."""
    return torch.einsum("...ij,...j->...i", g_cov, v_con)


def _four_vectors(v_con_sp, bp_sp, g_cov, g_con, mc):
    """u^mu and b^mu from the spatial primitives (harm_model.cpp:560-593)."""
    zeros = torch.zeros_like(v_con_sp[..., :1])
    v_con = torch.cat([zeros, v_con_sp], dim=-1)
    bp = torch.cat([zeros, bp_sp], dim=-1)

    v_dot_v = torch.einsum("...i,...ij,...j->...", v_con[..., 1:],
                           g_cov[..., 1:, 1:], v_con[..., 1:])
    v_fac = torch.sqrt(-1.0 / g_con[..., 0, 0] * (1.0 + torch.abs(v_dot_v)))

    u_con = v_con - v_fac[..., None] * g_con[..., 0, :]
    u_con[..., 0] = -v_fac * g_con[..., 0, 0]
    u_cov = lower(u_con, g_cov)

    u_dot_bp = torch.sum(u_cov[..., 1:] * bp[..., 1:], dim=-1)
    b_con = (bp + u_con * u_dot_bp[..., None]) / u_con[..., 0:1]
    b_con[..., 0] = u_dot_bp
    b_cov = lower(b_con, g_cov)

    b_mag = torch.sqrt(torch.abs(torch.sum(b_con * b_cov, dim=-1))) * mc.b_unit
    return u_con, u_cov, b_con, b_cov, b_mag


def get_fluid_zone(prims, g_cov, g_con, mc):
    """Zone-centred fluid state for every zone (harm_model.cpp:538-593)."""
    rho, uu = prims[0], prims[1]
    n_e = rho * mc.n_e_unit
    theta_e = uu / rho * mc.theta_e_unit
    v_con_sp = torch.movedim(prims[2:5], 0, -1)
    bp_sp = torch.movedim(prims[5:8], 0, -1)
    u_con, u_cov, b_con, b_cov, b_mag = _four_vectors(v_con_sp, bp_sp, g_cov, g_con, mc)
    return FluidState(n_e, theta_e, b_mag, u_con, u_cov, b_con, b_cov)


def pack_corner_rows(comp, n2):
    """(Z, C) per-zone components -> (Z, 4C) bilinear corner rows: zones
    z, z+1, z+n2, z+n2+1 (out-of-range corners edge-clamped; the cell index
    is clamped to n-2 so they are never selected)."""
    zmax = comp.shape[0] - 1
    z = torch.arange(comp.shape[0], device=comp.device)
    return torch.cat([comp[z], comp[torch.clamp(z + 1, max=zmax)],
                      comp[torch.clamp(z + n2, max=zmax)],
                      comp[torch.clamp(z + n2 + 1, max=zmax)]], dim=1)


def make_corner_table(prims, n1, n2):
    """The raw (n1*n2, 32) corner table of the 8 primitives."""
    return pack_corner_rows(prims.reshape(8, n1 * n2).T, n2)


def derived11(fz: FluidState):
    """(Z, 11) derived components per zone.  [1] = theta_e * n_e: the hot
    step recovers theta_e as a ratio of blends, the reference's uu/rho
    ratio of interpolated primitives."""
    z = fz.n_e.numel()
    return torch.cat([fz.n_e.reshape(z, 1), (fz.theta_e * fz.n_e).reshape(z, 1),
                      fz.b.reshape(z, 1), fz.u_cov.reshape(z, 4),
                      fz.b_cov.reshape(z, 4)], dim=1)


def _four_vectors_c(v1, v2, v3, b1, b2, b3, g7, gc6, mc):
    """Component-form u^mu / b^mu reconstruction (harm_model.cpp:560-593)."""
    g00, g01, g03, g11, g13, g22, g33 = g7
    gc00, gc01, gc11, gc13, gc22, gc33 = gc6

    v_dot_v = g11 * v1 * v1 + g22 * v2 * v2 + g33 * v3 * v3 + 2.0 * g13 * v1 * v3
    v_fac = torch.sqrt(-1.0 / gc00 * (1.0 + torch.abs(v_dot_v)))

    u0 = -v_fac * gc00
    u1 = v1 - v_fac * gc01
    u_con = (u0, u1, v2, v3)
    u_cov = geometry.lower_c(g7, u_con)

    u_dot_bp = u_cov[1] * b1 + u_cov[2] * b2 + u_cov[3] * b3
    b_con = (u_dot_bp, (b1 + u1 * u_dot_bp) / u0, (b2 + v2 * u_dot_bp) / u0,
             (b3 + v3 * u_dot_bp) / u0)
    b_cov = geometry.lower_c(g7, b_con)

    bsq = (b_con[0] * b_cov[0] + b_con[1] * b_cov[1] + b_con[2] * b_cov[2]
           + b_con[3] * b_cov[3])
    b_mag = torch.sqrt(torch.abs(bsq)) * mc.b_unit
    return u_con, u_cov, b_con, b_cov, b_mag


def _inside(x1, x2, mc):
    return ((x1 >= mc.x_start[1]) & (x1 <= mc.x_stop[1])
            & (x2 >= mc.x_start[2]) & (x2 <= mc.x_stop[2]))


def bilinear_weights(del_i, del_j):
    """(c00, c01, c10, c11) corner weights of the bilinear blend."""
    return ((1.0 - del_i) * (1.0 - del_j), (1.0 - del_i) * del_j,
            del_i * (1.0 - del_j), del_i * del_j)


def cell_index_c(x1, x2, mc):
    """The corner tables' row z = i * n2 + j (int64) of the cell at (x1, x2)."""
    i, j, _, _ = geometry.x_to_ij_c(x1, x2, mc.x_start, mc.dx, (mc.n1, mc.n2))
    return i * mc.n2 + j


def get_fluid_params_c(x1, x2, corner_rows, mc, g7=None, gather_fn=None):
    """Bilinear fluid state at (x1, x2) from one row gather of the raw
    corner table (harm_model.cpp:595-671).  ``gather_fn``: ``(table, idx)
    -> rows`` for the gather, taking int32 indices (the engine passes
    ``hot_kernels.row_gather``); plain indexing when None."""
    z = cell_index_c(x1, x2, mc)
    rows = corner_rows[z] if gather_fn is None else gather_fn(corner_rows, z.to(torch.int32))
    if g7 is None:
        g7 = geometry.gcov_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
    gc6 = geometry.gcon_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
    return blend_raw(x1, x2, rows, mc, g7, gc6)


def blend_raw(x1, x2, rows, mc, g7, gc6):
    """Fluid state at (x1, x2) from gathered raw 32-wide corner rows: the
    bilinear blend of the 8 primitives, n_e and theta_e from rho and u,
    and u^mu/b^mu through the metric pair ``g7``/``gc6`` at (x1, x2)."""
    inside = _inside(x1, x2, mc)
    _, _, del_i, del_j = geometry.x_to_ij_c(x1, x2, mc.x_start, mc.dx, (mc.n1, mc.n2))
    c00, c01, c10, c11 = bilinear_weights(del_i, del_j)
    p = [rows[:, m] * c00 + rows[:, 8 + m] * c01 + rows[:, 16 + m] * c10
         + rows[:, 24 + m] * c11 for m in range(8)]

    n_e = torch.where(inside, p[0] * mc.n_e_unit, torch.zeros_like(p[0]))
    theta_e = p[1] / p[0] * mc.theta_e_unit
    u_con, u_cov, b_con, b_cov, b_mag = _four_vectors_c(
        p[2], p[3], p[4], p[5], p[6], p[7], g7, gc6, mc)
    return FluidC(n_e, theta_e, b_mag, u_con, u_cov, b_con, b_cov)


def blend_derived(x1, x2, rows, mc):
    """Derived fluid state at (x1, x2) from gathered 44-wide corner rows
    (the hot step's blend; u_con/b_con are not carried)."""
    inside = _inside(x1, x2, mc)
    _, _, del_i, del_j = geometry.x_to_ij_c(x1, x2, mc.x_start, mc.dx, (mc.n1, mc.n2))
    c00, c01, c10, c11 = bilinear_weights(del_i, del_j)
    nc = DERIVED_COMPS
    pr = [rows[:, m] * c00 + rows[:, nc + m] * c01 + rows[:, 2 * nc + m] * c10
          + rows[:, 3 * nc + m] * c11 for m in range(nc)]
    return FluidC(
        n_e=torch.where(inside, pr[0], torch.zeros_like(pr[0])),
        theta_e=pr[1] / pr[0], b=pr[2], u_con=None,
        u_cov=(pr[3], pr[4], pr[5], pr[6]), b_con=None,
        b_cov=(pr[7], pr[8], pr[9], pr[10]))


def get_fluid_params(x, g_cov, prims, mc):
    """Bilinear fluid state at x (..., 4) from the (8, n1, n2) primitives,
    with ``g_cov`` (..., 4, 4) at x from the caller (harm_model.cpp:595-671;
    the scalar oracle's form).  Outside the grid n_e is 0."""
    inside = _inside(x[..., 1], x[..., 2], mc)
    i, j, del_i, del_j = geometry.x_to_ij_c(x[..., 1], x[..., 2], mc.x_start, mc.dx,
                                            (mc.n1, mc.n2))
    c00, c01, c10, c11 = bilinear_weights(del_i, del_j)
    p = (prims[:, i, j] * c00 + prims[:, i, j + 1] * c01 + prims[:, i + 1, j] * c10
         + prims[:, i + 1, j + 1] * c11)  # (8, ...)
    n_e = torch.where(inside, p[0] * mc.n_e_unit, torch.zeros_like(p[0]))
    theta_e = p[1] / p[0] * mc.theta_e_unit
    g_con = geometry.gcon(x, mc.a, mc.h_slope, mc.r_0)
    u_con, u_cov, b_con, b_cov, b_mag = _four_vectors(
        torch.movedim(p[2:5], 0, -1), torch.movedim(p[5:8], 0, -1), g_cov, g_con, mc)
    return FluidState(n_e, theta_e, b_mag, u_con, u_cov, b_con, b_cov)
