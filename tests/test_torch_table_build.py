"""The port's table builders and their file cache against the JAX package's
(CPU, numpy float64).

* ``utils/cache._key`` gives the three tracked names exactly
  (``hotcross_a94a8318dd69``, ``jnu_53254050ed24``,
  ``theta_q_79c4f4b83f1b``), the JAX package's keys, and ``repr`` makes it
  type-sensitive (an int for a float is another name); ``utils/tables``
  derives its file names from them.
* Each builder (``ops/hotcross.build_table``, ``ops/jnu.build_tables``,
  ``ops/emission.build_theta_quantiles``) rebuilds its tracked ``.npz`` and
  equals the JAX builder's output, to rtol 1e-12 (the float32 quantile
  table to every bit).
* On a miss the cache builds into ``CACHE_DIR`` (here ``tmp_path``), never
  into the tracked ``data/``, and the next lookup reads the file.
* ``ops/integration.adaptive_gauss_quad`` passes the analytic cases of
  tests/test_integration.py (the reference's ten integrals at 1e-6) and its
  scipy comparison.
"""

import math
import os

import numpy as np
import pytest

from grmonty_tpu_torch.ops import emission, hotcross, jnu
from grmonty_tpu_torch.ops.integration import adaptive_gauss_quad
from grmonty_tpu_torch.utils import cache, tables

TRACKED = {"hotcross": "a94a8318dd69", "jnu": "53254050ed24", "theta_q": "79c4f4b83f1b"}
TRACKED_DIR = cache.DATA_DIR
KEYS = {"hotcross": cache.hotcross_key, "jnu": cache.jnu_key, "theta_q": cache.theta_q_key}


def _tracked(name):
    with np.load(os.path.join(TRACKED_DIR, f"{name}_{TRACKED[name]}.npz")) as z:
        return [np.asarray(z[k]) for k in z.files]


def test_keys_are_the_tracked_names():
    from grmonty_tpu import consts as jconsts
    from grmonty_tpu.ops import emission as jemission
    from grmonty_tpu.utils import cache as jcache

    assert {name: key() for name, key in KEYS.items()} == TRACKED
    hc, j = jconsts.hotcross, jconsts.jnu
    assert jcache._key(hc.MIN_W, hc.MAX_W, hc.MIN_T, hc.MAX_T, hc.N_W, hc.N_T, hc.MAX_GAMMA,
                       hc.D_MU_E, hc.D_GAMMA_E) == TRACKED["hotcross"]
    assert jcache._key(j.MIN_K, j.MAX_K, j.MIN_T, j.MAX_T, jconsts.N_E_SAMP,
                       j.EPS_REL) == TRACKED["jnu"]
    assert jcache._key(jemission.TH_X_NODES, jemission.TH_U_NODES, jemission.TH_LX_MIN,
                       jemission.TH_LX_MAX, j.CST, "v1") == TRACKED["theta_q"]
    assert cache._key(1.0, 2) != cache._key(1, 2)  # repr: the trap of a changed type
    assert (tables.HOTCROSS_FILE, tables.JNU_FILE, tables.THETA_Q_FILE) == tuple(
        f"{name}_{key}.npz" for name, key in TRACKED.items())


def test_hotcross_builder_rebuilds_the_tracked_table():
    from grmonty_tpu.ops import hotcross as jhotcross

    got = hotcross.build_table()
    assert got.shape == (221, 81) and got.dtype == np.float64
    np.testing.assert_allclose(got, _tracked("hotcross")[0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, jhotcross.build_table(), rtol=1e-12, atol=0)


def test_jnu_builder_rebuilds_the_tracked_tables():
    from grmonty_tpu.ops import jnu as jjnu

    got = jnu.build_tables()
    for g, t, r in zip(got, _tracked("jnu"), jjnu.build_tables()):
        assert g.shape == (201,) and g.dtype == np.float64
        np.testing.assert_allclose(g, t, rtol=1e-12, atol=0)
        np.testing.assert_allclose(g, r, rtol=1e-12, atol=0)


def test_theta_quantile_builder_rebuilds_the_tracked_table():
    from grmonty_tpu.ops import emission as jemission

    got = emission.build_theta_quantiles()
    assert got.shape == (emission.TH_X_NODES, emission.TH_U_NODES) and got.dtype == np.float32
    assert np.array_equal(got, _tracked("theta_q")[0])
    assert np.array_equal(got, jemission.build_theta_quantiles())


def test_a_miss_builds_into_the_cache_dir(tmp_path, monkeypatch):
    data, build = tmp_path / "data", tmp_path / "build"
    data.mkdir()
    monkeypatch.setattr(cache, "DATA_DIR", str(data))
    monkeypatch.setattr(cache, "CACHE_DIR", str(build))
    tracked_before = sorted(os.listdir(TRACKED_DIR))
    f_t, k2_t = cache.jnu_tables()
    assert os.listdir(build) == [f"jnu_{TRACKED['jnu']}.npz"] and not os.listdir(data)
    np.testing.assert_allclose(f_t, _tracked("jnu")[0], rtol=1e-12, atol=0)

    def no_build():
        raise AssertionError("a cached table was rebuilt")

    monkeypatch.setattr(jnu, "build_tables", no_build)
    again = cache.jnu_tables()
    assert all(np.array_equal(a, b) for a, b in zip(again, (f_t, k2_t)))
    assert sorted(os.listdir(TRACKED_DIR)) == tracked_before


CASES = [
    ("const", lambda x: np.full_like(x, 3.0), 0.0, 2.0, 6.0),
    ("linear", lambda x: x, 0.0, 1.0, 0.5),
    ("square", lambda x: x * x, 0.0, 1.0, 1.0 / 3.0),
    ("sin", np.sin, 0.0, math.pi, 2.0),
    ("abs", np.abs, -1.0, 1.0, 1.0),
    ("sqrt", np.sqrt, 0.0, 1.0, 2.0 / 3.0),
    ("log", np.log, 1.0, math.e, 1.0),
    ("osc20", lambda x: np.sin(20.0 * x), 0.0, math.pi, (1.0 - math.cos(20.0 * math.pi)) / 20.0),
    ("peak", lambda x: 1.0 / (1.0e-4 + x * x), -1.0, 1.0, 2.0 / 1.0e-2 * math.atan(1.0 / 1.0e-2)),
    ("step", lambda x: (x > 0.5).astype(float), 0.0, 1.0, 0.5),
]


@pytest.mark.parametrize("name,f,a,b,expected", CASES, ids=[c[0] for c in CASES])
def test_analytic_integrals(name, f, a, b, expected):
    from grmonty_tpu.ops.integration import adaptive_gauss_quad as jquad

    got = adaptive_gauss_quad(f, a, b, eps_abs=0.0, eps_rel=1.0e-9, limit=2000)
    assert got == pytest.approx(expected, rel=1.0e-6, abs=1.0e-6)
    assert got == jquad(f, a, b, eps_abs=0.0, eps_rel=1.0e-9, limit=2000)


def test_empty_interval_and_scipy():
    import scipy.integrate

    assert adaptive_gauss_quad(np.sin, 1.0, 1.0) == 0.0
    f = lambda x: np.exp(-np.cbrt(x)) * np.sqrt(x)  # noqa: E731
    ref, _ = scipy.integrate.quad(f, 0.0, 50.0, epsrel=1e-10)
    assert adaptive_gauss_quad(f, 0.0, 50.0, eps_rel=1e-9) == pytest.approx(ref, rel=1e-8)
