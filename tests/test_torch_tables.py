"""The port's torus writer, per-dump tables and Chebyshev fits against the
JAX package's, on the 64x32 synthetic torus (float64, CPU).

Tolerances: integers exact; float64 tables rtol 1e-9 with an absolute
floor of 1e-12 of the table's largest magnitude; the float32 emission CDF
tables to one float32 ulp (both sides round the same float64 values, which
agree to ~1e-13, so a value on a rounding boundary may land either side).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grmonty_tpu.models import torus as jtorus
from grmonty_tpu.ops import cheb as jcheb
from grmonty_tpu.ops import fluid as jfluid
from grmonty_tpu.transport import driver as jdriver
from grmonty_tpu.transport import engine as jengine
from grmonty_tpu.utils import cache as jcache
from grmonty_tpu_torch import convert
from grmonty_tpu_torch.models import harm, torus
from grmonty_tpu_torch.ops import fluid
from grmonty_tpu_torch.transport import driver
from grmonty_tpu_torch.utils import tables

PHOTON_N = 2000


def close(got, ref, rtol=1e-9, what=""):
    got = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    scale = np.abs(ref[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-12 * scale, err_msg=what)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    d = tmp_path_factory.mktemp("dumps")
    jpath, ppath = str(d / "jax_torus"), str(d / "port_torus")
    jtorus.write_torus_dump(jpath, n1=64, n2=32)
    torus.write_torus_dump(ppath, n1=64, n2=32)
    return jpath, ppath


def test_torus_writer_matches_jax(dumps):
    jpath, ppath = dumps
    with open(jpath) as f:
        jhead, jbody = f.readline(), np.loadtxt(f)
    with open(ppath) as f:
        phead, pbody = f.readline(), np.loadtxt(f)
    assert phead == jhead
    assert pbody.shape == jbody.shape == (64 * 32, 34)
    np.testing.assert_array_equal(pbody[:, :12], jbody[:, :12])  # primitives
    close(pbody, jbody, rtol=1e-12)
    a, b = harm.read_dump(ppath, 4e19), harm.read_dump(jpath, 4e19)
    assert a.bias_norm == pytest.approx(b.bias_norm, rel=1e-12)


@pytest.fixture(scope="module")
def both(dumps):
    """(JAX Simulation, the port's host tables, port mc) on one dump."""
    jpath, _ = dumps
    cfg = jengine.EngineConfig(n_pool=256, m_period=8, sec_cap=1024, derived_fluid=True)
    jsim = jdriver.Simulation(jpath, photon_n=PHOTON_N, mass_unit=4e19, config=cfg,
                              cdf_sampler=True)
    model = harm.read_dump(jpath, 4e19)
    mc = fluid.make_model_consts(model)
    host = driver.build_host_tables(model, mc, PHOTON_N, torch.device("cpu"))
    return jsim, host, mc


def test_host_tables_match_jax(both):
    jsim, host, mc = both
    h = jsim._host
    for name in ("zone_x", "g_cov_z", "g_con_z", "g_det_z", "weights", "dn_max",
                 "derived11"):
        close(host[name], h[name], what=name)
    # Emission tetrads.  Where the field lies along x2 and the flow has no
    # x2 component, Gram-Schmidt of the x2 axis leaves a zero vector, and
    # both tetrads there are rounding residue: not orthonormal (e2 = -e1),
    # or NaN on the port's side (those photons are dropped on load).  Both
    # sides find the same zones; everywhere else the two agree.
    e_con, e_cov = host["e_con_z"].numpy(), host["e_cov_z"].numpy()
    eta = np.diag([-1.0, 1.0, 1.0, 1.0])

    def degenerate(e):
        gram = np.einsum("...mi,...ij,...nj->...mn", e, h["g_cov_z"], e)
        dev = np.abs(gram - eta).max(axis=(-1, -2))
        return ~(dev <= 1e-6)

    degen = degenerate(h["e_con_z"])
    np.testing.assert_array_equal(degenerate(e_con), degen)
    assert degen.mean() < 0.01
    assert not np.isnan(e_con[~degen]).any() and not np.isnan(e_cov[~degen]).any()
    close(e_con[~degen], h["e_con_z"][~degen], what="e_con_z")
    close(e_cov[~degen], h["e_cov_z"][~degen], what="e_cov_z")
    close(host["nz"], jsim.nz, what="nz")
    fz = h["fluid_zone"]
    for name in fz._fields:
        close(getattr(host["fluid_zone"], name), getattr(fz, name), what=name)
    np.testing.assert_array_equal(host["nu_zone_map"].numpy(), h["nu_zone_map"])
    for name in ("nu_cdf", "nu_lnrho"):
        np.testing.assert_allclose(host[name].numpy(), h[name], rtol=1.2e-7, atol=0.0,
                                   err_msg=name)


def test_corner_tables_match_jax(both):
    jsim, host, mc = both
    tabs = driver.build_engine_tables(host, mc, torch.float64)
    jt = jsim._engine_tabs
    np.testing.assert_array_equal(tabs.corner_rows.numpy(), np.asarray(jt.corner_rows))
    close(tabs.hot_tab, np.asarray(jt.hot_tab), what="derived rows")
    close(tabs.hc_coeffs, np.asarray(jt.hc_coeffs), what="hotcross coefficients")
    close(tabs.k2_coeffs, jt.k2_coeffs, what="k2 coefficients")


def test_convert_tables_round_trip(both):
    jsim, host, mc = both
    conv = convert.from_jax_tables(jsim._host, mc, nz=jsim.nz)
    assert set(conv) == set(host)
    for name, v in conv.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == host[name].dtype, name
            assert v.shape == host[name].shape, name


def test_chebyshev_fits_match_jax():
    hc = tables.hotcross_table()
    close(tables.fit_hotcross(hc), jcheb.fit_hotcross(jcache.hotcross_table()),
          rtol=1e-12)
    close(tables.fit_k2(), jcheb.fit_k2(), rtol=1e-12)
    # the same surface the JAX hot path evaluates, at table-interior points
    x = np.linspace(tables.HC_XLO, tables.HC_XHI, 7)
    y = np.linspace(tables.HC_YLO, tables.HC_YHI, 5)
    xv, yv = np.meshgrid(x, y, indexing="ij")
    got = jcheb.eval2d(jnp.asarray(tables.fit_hotcross(hc)), jnp.asarray(xv.ravel()),
                       jnp.asarray(yv.ravel()), tables.HC_XLO, tables.HC_XHI,
                       tables.HC_YLO, tables.HC_YHI)
    assert np.all(np.isfinite(np.asarray(got)))
    assert os.path.exists(os.path.join(tables.DATA_DIR, tables.HOTCROSS_FILE))
    assert jfluid.DERIVED_COMPS == fluid.DERIVED_COMPS
