"""The port's Python scalar tracker (``transport/cpu_reference.py``) against
the JAX package's ``CPUTracker`` and the native tracker, on the 64x32 torus
(CPU, float64).

* Its single-photon physics (``_seg``, ``_fluid``, ``_alphas``,
  ``_tetrad``, ``_init_dk``) at 20 emitted photon states (every other one
  moved off its zone centre) equals the JAX tracker's jitted helpers and the
  port binding's ``probe`` to the tolerances of
  tests/test_oracle_native.py:84-133 (1e-9 on the metric, the fluid and the
  segment; 1e-7 on the connection, the angle and the tetrad; 1e-6 on the
  absorption opacity).
* The bias and the two rejection samplers are numpy on both sides: the
  same inputs and seed give the same numbers, bit for bit.
* A ``limit=2`` run on the same photons and seed, under the gate's frozen
  bias (0.00025, 2.6) so that the cascade stays a few photons (the live
  feedback grows it to about 90 records and a minute here), matches the
  JAX tracker: the counts exactly, the spectrum to rtol 1e-10 (measured
  4e-14).  Photons 0 and 1 of the live batch end at once with nothing
  recorded, so the run takes photons 2 and 3, which scatter once and
  record 3.
* ``validate_accuracy --oracle python`` runs on the CPU at 6 photons.
"""

import math
import types

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.tools import validate_accuracy as va
from grmonty_tpu_torch.transport import cpu_reference, driver, engine, oracle_native, profiles

M_UNIT = 4.0e18
FREEZE = (0.00025, 2.6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Scalar work: intra-op threads only add overhead, and the test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dump") / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    return path


@pytest.fixture(scope="module")
def sim(dump):
    cfg = profiles.bench_config(pool=256, dtype=torch.float64)
    s = driver.Simulation(dump, photon_n=180, mass_unit=M_UNIT, config=cfg, device="cpu",
                          warmup=0)
    s.plan()
    return s


@pytest.fixture(scope="module")
def photons(sim):
    """The live photons among the first 64 of the plan (unscaled weights)."""
    ph = oracle_native.photons_from_rows(sim.emit_rows(0, 64), engine.WEIGHT_SCALE)
    live = np.nonzero(ph.w > 0)[0]
    return oracle_native.Photons(*[a[live] for a in ph])


@pytest.fixture(scope="module")
def jx(dump):
    """The JAX tracker's inputs: mc, the tables, the primitives."""
    import jax.numpy as jnp

    from grmonty_tpu.models import harm
    from grmonty_tpu.ops import fluid
    from grmonty_tpu.transport import cpu_reference as jcr
    from grmonty_tpu.transport import engine as jengine
    from grmonty_tpu.utils import cache

    model = harm.read_dump(dump, M_UNIT)
    f_t, k2_t = cache.jnu_tables()
    tabs = jengine.Tables(f_table=jnp.asarray(f_t), k2_table=jnp.asarray(k2_t),
                          hotcross=jnp.asarray(cache.hotcross_table()), weights=None)
    return types.SimpleNamespace(jnp=jnp, jcr=jcr, mc=fluid.make_model_consts(model),
                                 tabs=tabs, prims=np.asarray(model.data.stacked()))


@pytest.fixture(scope="module")
def trackers(sim, jx):
    """(port, JAX, native) trackers on the same primitives."""
    prims = sim.model.data.stacked()
    return (cpu_reference.CPUTracker(sim.mc, prims, seed=11),
            jx.jcr.CPUTracker(jx.mc, jx.tabs, jx.prims, seed=11),
            oracle_native.NativeTracker(sim.mc, prims, seed=7))


def _close(a, b, rtol, name, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol, err_msg=name)


def test_subfunctions_match_jax_and_the_native_probe(sim, photons, jx, trackers):
    mine, ref, native = trackers
    jnp = jx.jnp
    mc = sim.mc
    rng = np.random.default_rng(3)
    for n in range(20):
        x = np.asarray(photons.x[n], np.float64).copy()
        k = np.asarray(photons.k[n], np.float64).copy()
        if n % 2 == 1:  # off the zone centre: the bilinear stencil
            x[1] = float(np.clip(x[1] + (rng.uniform() - 0.5) * mc.dx[1],
                                 mc.x_start[1], mc.x_stop[1]))
            x[2] = float(np.clip(x[2] + (rng.uniform() - 0.5) * mc.dx[2],
                                 mc.x_start[2], mc.x_stop[2]))
        dk = mine._init_dk(x, k).numpy()
        _close(dk, ref._init_dk(jnp.asarray(x), jnp.asarray(k)), 1e-8, "init dkdlam",
               atol=1e-14)
        e0s = float(photons.e[n])
        dl = float(cpu_reference.geometry.step_size(torch.as_tensor(x), torch.as_tensor(k),
                                                    mc.x_stop[2]))
        probe = native.probe(x, k, dk, e0s, dl)
        xt = torch.as_tensor(x)
        geo = cpu_reference.geometry
        g_con = geo.gcon(xt, mc.a, mc.h_slope, mc.r_0).numpy()
        _close(g_con[[0, 0, 1, 1, 2, 3], [0, 1, 1, 3, 2, 3]], probe[7:13], 1e-9, "gcon6 (probe)")
        _close(geo.connection(xt, mc.a, mc.h_slope).reshape(-1), probe[13:53], 1e-7,
               "connection (probe)", atol=1e-12)
        _close(dl, probe[76], 1e-9, "step_size")
        _close(dk, probe[124:128], 1e-8, "init dkdlam (probe)", atol=1e-14)

        seg = [np.asarray(v) for v in mine._seg(x, k, dk, e0s, dl)]
        seg_j = [np.asarray(v) for v in ref._seg(jnp.asarray(x), jnp.asarray(k),
                                                 jnp.asarray(dk), e0s, dl)]
        for want, tag in ((seg_j, "jax"), ((probe[77:81], probe[81:85], probe[85:89],
                                            probe[89], probe[90], probe[91]), "probe")):
            _close(seg[0], want[0], 1e-9, f"seg x ({tag})")
            _close(seg[1], want[1], 1e-9, f"seg k ({tag})")
            _close(seg[2], want[2], 1e-8, f"seg dk ({tag})", atol=1e-14)
            _close(seg[3], want[3], 1e-9, f"seg e1 ({tag})")
            _close(seg[4], want[4], 1e-4, f"seg err ({tag})", atol=1e-10)
            _close(seg[5], want[5], 1e-4, f"seg err_e ({tag})", atol=1e-10)

        g_cov, fs = mine._fluid(x)
        g_cov_j, fs_j = ref._fluid(jnp.asarray(x))
        _close(g_cov, g_cov_j, 1e-9, "g_cov")
        g7 = g_cov.numpy()[[0, 0, 0, 1, 1, 2, 3], [0, 1, 3, 1, 3, 2, 3]]
        _close(g7, probe[0:7], 1e-9, "gcov7 (probe)")
        for name, want, rtol, atol in (("n_e", probe[53], 1e-9, 0.0),
                                       ("theta_e", probe[54], 1e-9, 0.0),
                                       ("b", probe[55], 1e-9, 0.0),
                                       ("u_con", probe[56:60], 1e-9, 0.0),
                                       ("u_cov", probe[60:64], 1e-9, 0.0),
                                       ("b_con", probe[64:68], 1e-8, 1e-18),
                                       ("b_cov", probe[68:72], 1e-8, 1e-18)):
            _close(getattr(fs, name), getattr(fs_j, name), rtol, name, atol=atol)
            _close(getattr(fs, name), want, rtol, f"{name} (probe)", atol=atol)

        al = [float(v) for v in mine._alphas(k, fs)]
        al_j = [float(v) for v in ref._alphas(jnp.asarray(k), fs_j)]
        for i, (name, rtol, atol) in enumerate((("theta", 1e-7, 0.0), ("nu", 1e-9, 0.0),
                                                 ("a_sc", 1e-8, 1e-280),
                                                 ("a_ab", 1e-6, 1e-280))):
            _close(al[i], al_j[i], rtol, name, atol=atol)
            _close(al[i], probe[72 + i], rtol, f"{name} (probe)", atol=atol)

        b_gauss = float(fs.b)
        trial = (fs.b_con.numpy() / (b_gauss / mc.b_unit) if b_gauss > 0.0
                 else np.array([0.0, 1.0, 0.0, 0.0]))
        e_con, e_cov = mine._tetrad(fs.u_con, trial, g_cov)
        e_con_j, e_cov_j = ref._tetrad(jnp.asarray(fs_j.u_con), jnp.asarray(trial), g_cov_j)
        for got, want, want_p, name in ((e_con, e_con_j, probe[92:108], "e_con"),
                                        (e_cov, e_cov_j, probe[108:124], "e_cov")):
            _close(got, want, 1e-7, name, atol=1e-12)
            _close(got.reshape(-1), want_p, 1e-7, f"{name} (probe)", atol=1e-12)


def test_bias_and_samplers_are_the_jax_numbers(sim, jx):
    mine = cpu_reference.CPUTracker(sim.mc, sim.model.data.stacked(), seed=5)
    ref = jx.jcr.CPUTracker(jx.mc, jx.tabs, jx.prims, seed=5)
    for tr in (mine, ref):
        tr.n_recorded, tr.n_scatt_rec, tr.max_tau_scatt = 40, 97, 3.1e-4
    for theta_e, w in ((0.3, 1e30), (4.0, 1e31), (20.0, 1e28)):
        assert mine.bias(theta_e, w) == ref.bias(theta_e, w)
        mine.bias_fixed = ref.bias_fixed = FREEZE
        assert mine.bias(theta_e, w) == ref.bias(theta_e, w)
        mine.bias_fixed = ref.bias_fixed = None
    k_tet = np.array([0.0, 0.8e-4, 0.5e-4, 0.4e-4])
    k_tet[0] = math.sqrt(np.sum(k_tet[1:] ** 2))
    p = np.array([1.25, 0.5, 0.3, 0.2])
    for theta_e in (0.6, 5.0):
        for _ in range(50):
            assert np.array_equal(mine._sample_electron(k_tet, theta_e),
                                  ref._sample_electron(k_tet, theta_e))
            assert np.array_equal(mine._sample_scattered(k_tet, p),
                                  ref._sample_scattered(k_tet, p))


def test_limit2_run_matches_the_jax_tracker(sim, photons, jx):
    ph = oracle_native.Photons(*[a[2:] for a in photons])
    mine = cpu_reference.CPUTracker(sim.mc, sim.model.data.stacked(), seed=11,
                                    bias_fixed=FREEZE)
    ref = jx.jcr.CPUTracker(jx.mc, jx.tabs, jx.prims, seed=11)
    ref.bias_fixed = FREEZE
    spec = mine.run(ph, limit=2)
    spec_j = ref.run(ph, limit=2)
    assert ref.n_recorded >= 2 and ref.n_scatt_rec >= 1
    assert (mine.n_recorded, mine.n_scatt_rec) == (ref.n_recorded, ref.n_scatt_rec)
    np.testing.assert_allclose(mine.max_tau_scatt, ref.max_tau_scatt, rtol=1e-10)
    np.testing.assert_allclose(spec, spec_j, rtol=1e-10, atol=0.0)
    assert spec.shape == spec_j.shape and np.isfinite(spec).all()


def test_gate_runs_with_the_python_oracle():
    out = va.run(va.parse_args(["--device", "cpu", "--photons", "6", "--oracle", "python",
                                "--freeze-bias", "0.0025"]))
    assert out["oracle"] == "python" and out["n_oracle"] == out["n_engine"] == 6
    assert out["engine_run"]["hot_iters"] > 0
    assert math.isfinite(out["lum_ratio"])
