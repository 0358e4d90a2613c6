"""The PyTorch port's ops against the JAX package's, float64 on the CPU.

Inputs are drawn with numpy from a seed and go through both functions.
Tolerance: rtol 1e-10, with an absolute floor of 1e-12 of the largest
reference magnitude for quantities that pass through zero (the two
implementations evaluate libm functions that differ in the last ulp, and
a few closed-form terms cancel).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grmonty_tpu import consts as jconsts
from grmonty_tpu.models import harm as jharm
from grmonty_tpu.models import torus as jtorus
from grmonty_tpu.ops import cheb as jcheb
from grmonty_tpu.ops import fluid as jfluid
from grmonty_tpu.ops import geometry as jgeo
from grmonty_tpu.ops import hotcross as jhc
from grmonty_tpu.ops import jnu as jjnu
from grmonty_tpu.ops import radiation as jrad
from grmonty_tpu.ops import tetrads as jtet
from grmonty_tpu.utils import cache as jcache
from grmonty_tpu_torch import consts
from grmonty_tpu_torch.models import harm
from grmonty_tpu_torch.ops import cheb, fluid, geometry, hotcross, jnu, radiation, tetrads
from grmonty_tpu_torch.utils import tables

RTOL = 1e-10


def close(got, ref, rtol=RTOL, what="", scale=None):
    """``scale``: the magnitude the absolute floor is taken of (default the
    largest finite reference value; a tensor's components pass the whole
    tensor's)."""
    got = np.asarray(got.detach().cpu() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    if scale is None:
        scale = np.nanmax(np.abs(ref[np.isfinite(ref)])) if np.isfinite(ref).any() else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-12 * scale, err_msg=what)


def T(a):
    return torch.as_tensor(np.array(a, np.float64))


@pytest.fixture(scope="module")
def mc_pair(tmp_path_factory):
    """The 64x32 torus read by both packages: (jax mc, port mc, prims)."""
    path = str(tmp_path_factory.mktemp("dump") / "torus")
    jtorus.write_torus_dump(path, n1=64, n2=32)
    jm = jharm.read_dump(path, 4.0e19)
    pm = harm.read_dump(path, 4.0e19)
    return jfluid.make_model_consts(jm), fluid.make_model_consts(pm), pm.data.stacked()


def test_consts_match_jax():
    def public(mod):
        return {k: v for k, v in vars(mod).items()
                if not k.startswith("_") and isinstance(v, (int, float))}

    ref, got = public(jconsts), public(consts)
    assert set(ref) == set(got)
    for k, v in ref.items():
        assert got[k] == v, k
    for ns in ("hotcross", "jnu", "spectrum"):
        r, g = public(getattr(jconsts, ns)), public(getattr(consts, ns))
        assert r and r == g, ns


def test_model_consts_match_jax(mc_pair):
    jmc, pmc, _ = mc_pair
    assert tuple(jmc) == tuple(pmc)


def _points(rng, mc, n=2048):
    """x1 across and beyond the grid (seams at the grid edges and the
    horizon), x2 across the poles' neighbourhood."""
    x1 = rng.uniform(mc.x_start[1] - 0.1, mc.x_stop[1] + 1.0, n)
    x1[:8] = [mc.x_start[1], mc.x_stop[1], mc.x1_min, jconsts.X1_MAX,
              mc.x_start[1] + 0.5 * mc.dx[1], mc.x_start[1] + 1.5 * mc.dx[1],
              mc.x_stop[1] - 0.5 * mc.dx[1], mc.x_stop[1] - 1.5 * mc.dx[1]]
    x2 = rng.uniform(1e-3, 1.0 - 1e-3, n)
    x2[8:14] = [0.5 * mc.dx[2], 1.5 * mc.dx[2], 1.0 - 0.5 * mc.dx[2],
                1.0 - 1.5 * mc.dx[2], 0.5, 0.25]
    return x1, x2


def test_geometry_matches_jax(mc_pair):
    jmc, mc, _ = mc_pair
    rng = np.random.default_rng(1)
    x1, x2 = _points(rng, mc)
    a, hs, r0 = mc.a, mc.h_slope, mc.r_0
    for name in ("gcov_c", "gcon_c", "gcov_row0_c", "bl_coord_c"):
        ref = getattr(jgeo, name)(jnp.asarray(x1), jnp.asarray(x2), a, hs, r0)
        got = getattr(geometry, name)(T(x1), T(x2), a, hs, r0)
        for i, (g, r) in enumerate(zip(got, ref)):
            close(g, r, what=f"{name}[{i}]")
    close(geometry.theta_deriv(T(x2), hs), jgeo.theta_deriv(jnp.asarray(x2), hs))
    close(geometry.d_omega(T(x2), T(x2 + 0.01), hs),
          jgeo.d_omega(jnp.asarray(x2), jnp.asarray(x2 + 0.01), hs))

    conn_r = jgeo.connection_c(jnp.asarray(x1), jnp.asarray(x2), a, hs)
    conn_g = geometry.connection_c(T(x1), T(x2), a, hs)
    for i in range(40):
        close(conn_g[i], conn_r[i], what=f"connection[{i}]")
    k = rng.normal(size=(4, x1.size)) * 10.0 ** rng.uniform(-8, -2, x1.size)
    rhs_r = jgeo.geodesic_rhs_c(conn_r, *map(jnp.asarray, k))
    rhs_g = geometry.geodesic_rhs_c(conn_g, *map(T, k))
    for i in range(4):
        close(rhs_g[i], rhs_r[i], what=f"geodesic_rhs[{i}]")
    close(geometry.step_size_c(T(x1), T(x2), T(k[1]), T(k[2]), T(k[3]), mc.x_stop[2]),
          jgeo.step_size_c(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(k[1]),
                           jnp.asarray(k[2]), jnp.asarray(k[3]), mc.x_stop[2]))
    n = (mc.n1, mc.n2)
    ij_r = jgeo.x_to_ij_c(jnp.asarray(x1), jnp.asarray(x2), mc.x_start, mc.dx, n)
    ij_g = geometry.x_to_ij_c(T(x1), T(x2), mc.x_start, mc.dx, n)
    np.testing.assert_array_equal(ij_g[0].numpy(), np.asarray(ij_r[0]))
    np.testing.assert_array_equal(ij_g[1].numpy(), np.asarray(ij_r[1]))
    close(ij_g[2], ij_r[2])
    close(ij_g[3], ij_r[3])


@pytest.fixture(scope="module")
def coeffs():
    return (jcheb.fit_hotcross(jcache.hotcross_table()), jcheb.fit_k2())


def test_cheb_matches_jax(coeffs):
    hc, k2 = coeffs
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.0, 4.0, 1024)
    close(cheb.eval1d(k2, T(x), -1.0, 4.0), jcheb.eval1d(k2, jnp.asarray(x), -1.0, 4.0))
    y = rng.uniform(-2.0, 3.0, 1024)
    close(cheb.eval2d(T(hc), T(x), T(y), -1.0, 4.0, -2.0, 3.0),
          jcheb.eval2d(jnp.asarray(hc), jnp.asarray(x), jnp.asarray(y),
                       -1.0, 4.0, -2.0, 3.0))

    # hotcross across its table edges and the Thomson / cold seams
    HC = jconsts.hotcross
    w = 10.0 ** rng.uniform(-13.0, 7.0, 4096)
    th = 10.0 ** rng.uniform(-5.0, 5.0, 4096)
    w[:6] = [HC.MIN_W, HC.MAX_W, 1e-3, 1e-3 * (1 + 1e-12), 1e-6 / 0.5, 2e-6]
    th[:6] = [HC.MIN_T, HC.MAX_T, 1e-4, 0.5, 0.5, 0.5]
    close(cheb.hotcross_eval(T(w), T(th), T(hc)),
          jcheb.hotcross_eval(jnp.asarray(w), jnp.asarray(th), jnp.asarray(hc)))
    np.testing.assert_array_equal(
        hotcross.clamp_hit(T(w), T(th)).numpy(),
        np.asarray(jhc.clamp_hit(jnp.asarray(w), jnp.asarray(th))))
    assert hotcross.clamp_hit(T(w), T(th)).any()

    # K2 across 0.3 (THETA_E_MIN), the table ends and the asymptote
    t = 10.0 ** rng.uniform(-2.0, 3.0, 2048)
    t[:6] = [0.3, 0.3 * (1 - 1e-12), jconsts.jnu.MIN_T, jconsts.jnu.MAX_T,
             jconsts.jnu.MAX_T * (1 + 1e-12), 100.0]
    close(cheb.k2_eval(T(t), k2), jcheb.k2_eval(jnp.asarray(t), k2))


def test_jnu_and_radiation_match_jax(coeffs):
    hc, k2c = coeffs
    f_t, k2_t = jcache.jnu_tables()
    rng = np.random.default_rng(3)
    n = 4096
    te = 10.0 ** rng.uniform(-1.0, 2.5, n)
    b = 10.0 ** rng.uniform(-2.0, 3.0, n)
    b[:16] = 0.0
    nu = 10.0 ** rng.uniform(8.0, 17.0, n)
    ne = 10.0 ** rng.uniform(0.0, 8.0, n)
    s = rng.uniform(0.0, 1.0, n)
    J = jnp.asarray
    close(jnu.k2_eval(T(te), T(k2_t)), jjnu.k2_eval(J(te), J(k2_t)))
    close(jnu.f_eval(T(te), T(b + 1e-3), T(nu), T(f_t)),
          jjnu.f_eval(J(te), J(b + 1e-3), J(nu), J(f_t)))
    ref = np.asarray(jjnu.ln_f_eval(J(te), J(b + 1e-3), J(nu), J(f_t)))
    got = jnu.ln_f_eval(T(te), T(b + 1e-3), T(nu), T(f_t)).numpy()
    assert np.array_equal(np.isneginf(ref), np.isneginf(got))
    fin = np.isfinite(ref)
    close(got[fin], ref[fin])
    close(jnu.synch_sin_c(T(nu), T(ne), T(te), T(b), T(s), k2c),
          jjnu.synch_sin_c(J(nu), J(ne), J(te), J(b), J(s), k2c))
    close(radiation.b_nu(T(nu), T(te)), jrad.b_nu(J(nu), J(te)))
    close(radiation.alpha_inv_scatt_c(T(nu), T(te), T(ne), T(hc)),
          jrad.alpha_inv_scatt_c(J(nu), J(te), J(ne), J(hc)))
    close(radiation.alpha_inv_abs_sin_c(T(nu), T(te), T(ne), T(b), T(s), k2c),
          jrad.alpha_inv_abs_sin_c(J(nu), J(te), J(ne), J(b), J(s), k2c))

    k = rng.normal(size=(4, n))
    u = rng.normal(size=(4, n))
    bc = rng.normal(size=(4, n))
    got = radiation.kinematics_sin_c(tuple(map(T, k)), tuple(map(T, u)),
                                     tuple(map(T, bc)), T(b), 7.0)
    ref = jrad.kinematics_sin_c(tuple(map(J, k)), tuple(map(J, u)),
                                tuple(map(J, bc)), J(b), 7.0)
    close(got[0], ref[0])
    close(got[1], ref[1])


def test_fluid_matches_jax(mc_pair):
    jmc, mc, prims = mc_pair
    cpu = torch.device("cpu")
    x_r, gcov_r, gcon_r, gdet_r = jfluid.precompute_zone_geometry(jmc)
    x_g, gcov_g, gcon_g, gdet_g = fluid.precompute_zone_geometry(mc, cpu)
    for g, r in ((x_g, x_r), (gcov_g, gcov_r), (gcon_g, gcon_r), (gdet_g, gdet_r)):
        close(g, r)
    fz_r = jfluid.get_fluid_zone(jnp.asarray(prims), gcov_r, gcon_r, jmc)
    fz_g = fluid.get_fluid_zone(T(prims), gcov_g, gcon_g, mc)
    for name in fz_r._fields:
        close(getattr(fz_g, name), getattr(fz_r, name), what=name)

    corner_r = jfluid.make_corner_table(prims, mc.n1, mc.n2)
    corner_g = fluid.make_corner_table(T(prims), mc.n1, mc.n2)
    np.testing.assert_array_equal(corner_g.numpy(), corner_r)
    close(fluid.pack_corner_rows(fluid.derived11(fz_g), mc.n2),
          jfluid.make_derived_corner_table(prims, jmc))

    rng = np.random.default_rng(4)
    x1, x2 = _points(rng, mc)
    ref = jfluid.get_fluid_params_c(jnp.asarray(x1), jnp.asarray(x2),
                                    jnp.asarray(corner_r), jmc)
    got = fluid.get_fluid_params_c(T(x1), T(x2), corner_g, mc)
    for name in ("n_e", "theta_e", "b"):
        close(getattr(got, name), getattr(ref, name), what=name)
    for name in ("u_con", "u_cov", "b_con", "b_cov"):
        for i in range(4):
            close(getattr(got, name)[i], getattr(ref, name)[i], what=f"{name}[{i}]")


def test_tetrads_match_jax(mc_pair):
    jmc, mc, prims = mc_pair
    rng = np.random.default_rng(5)
    x1, x2 = _points(rng, mc, 1024)
    x1 = np.clip(x1, mc.x_start[1] + 0.05, mc.x_stop[1] - 0.05)
    J = jnp.asarray
    g7_r = jgeo.gcov_c(J(x1), J(x2), mc.a, mc.h_slope, mc.r_0)
    g7_g = geometry.gcov_c(T(x1), T(x2), mc.a, mc.h_slope, mc.r_0)
    corner = jfluid.make_corner_table(prims, mc.n1, mc.n2)
    fl = jfluid.get_fluid_params_c(J(x1), J(x2), J(corner), jmc, g7=g7_r)
    u_con = tuple(np.asarray(c) for c in fl.u_con)
    trial = tuple(rng.normal(size=x1.size) for _ in range(4))
    trial[0][:8] = 1.0
    for c in trial[1:]:
        c[:8] = 0.0  # the degenerate time-axis trial vector
    e_con_r, e_cov_r = jtet.make_tetrad_c(tuple(map(J, u_con)), tuple(map(J, trial)), g7_r)
    e_con_g, e_cov_g = tetrads.make_tetrad_c(tuple(map(T, u_con)), tuple(map(T, trial)),
                                             g7_g)
    s_con = max(float(np.abs(np.asarray(c)).max()) for row in e_con_r for c in row)
    s_cov = max(float(np.abs(np.asarray(c)).max()) for row in e_cov_r for c in row)
    for i in range(4):
        for j in range(4):
            close(e_con_g[i][j], e_con_r[i][j], what=f"e_con[{i}][{j}]", scale=s_con)
            close(e_cov_g[i][j], e_cov_r[i][j], what=f"e_cov[{i}][{j}]", scale=s_cov)
    k = tuple(rng.normal(size=x1.size) for _ in range(4))
    for fn in ("coordinate_to_tetrad_c", "tetrad_to_coordinate_c"):
        r = getattr(jtet, fn)(e_cov_r, tuple(map(J, k)))
        g = getattr(tetrads, fn)(e_cov_g, tuple(map(T, k)))
        for i in range(4):
            close(g[i], r[i], what=f"{fn}[{i}]")
    p = (np.sqrt(1.0 + sum(c * c for c in k[1:])),) + k[1:]
    r = jtet.boost_c(tuple(map(J, k)), tuple(map(J, p)))
    g = tetrads.boost_c(tuple(map(T, k)), tuple(map(T, p)))
    for i in range(4):
        close(g[i], r[i], what=f"boost[{i}]")

    # batched (n1, n2) zone form, as the emission tables use it
    x_r, gcov_r, gcon_r, _ = jfluid.precompute_zone_geometry(jmc)
    fz = jfluid.get_fluid_zone(J(prims), gcov_r, gcon_r, jmc)
    b_hat = np.asarray(fz.b_con) / np.maximum(np.asarray(fz.b) / mc.b_unit, 1e-30)[..., None]
    ec_r, ev_r = jtet.make_tetrad(fz.u_con, J(b_hat), gcov_r)
    ec_g, ev_g = tetrads.make_tetrad(T(fz.u_con), T(b_hat), T(gcov_r))
    close(ec_g, ec_r)
    close(ev_g, ev_r)
    kt = rng.normal(size=ec_r.shape[:-1])
    close(tetrads.tetrad_to_coordinate(ec_g, T(kt)),
          jtet.tetrad_to_coordinate(ec_r, J(kt)))


def test_tables_loaded_by_path_match_jax_cache():
    np.testing.assert_array_equal(tables.hotcross_table(), np.asarray(jcache.hotcross_table()))
    for g, r in zip(tables.jnu_tables(), jcache.jnu_tables()):
        np.testing.assert_array_equal(g, np.asarray(r))
    np.testing.assert_array_equal(tables.theta_quantiles(),
                                  np.asarray(jcache.theta_quantiles()))
    assert math.isclose(tables.HC_XHI, jcheb.HC_XHI) and tables.K2_LO == jcheb.K2_LO


def test_spectrum_report_matches_jax(mc_pair):
    from grmonty_tpu.ops import spectrum as jspec
    from grmonty_tpu_torch.ops import spectrum

    jmc, mc, _ = mc_pair
    rng = np.random.default_rng(6)
    spec = rng.exponential(1.0, (consts.N_TH_BINS * consts.N_E_BINS + 1, 16))
    spec[::7] = 0.0  # empty bins
    assert spectrum.format_spectrum(spec, mc) == jspec.format_spectrum(spec, jmc)
    got, ref = spectrum.spectrum_rows(spec, mc), jspec.spectrum_rows(spec, jmc)
    for key in ("nu_lnu", "tau_abs", "tau_scatt", "x1i_av", "x2i_rms", "x3f_rms"):
        close(got[key], ref[key], what=key)
    assert got["luminosity"] == pytest.approx(ref["luminosity"], rel=1e-12)
