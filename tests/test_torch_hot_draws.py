"""The hot step's own draws and its bias scale once a phase.

On the card each run of a block's hot steps is one launch
(tests/test_torch_hot_run.py): the kernel draws each step's two uniforms
from the lane's Philox4x64-10 stream (``HOT`` in ``ops/draws.py``), under
a key the block draws once, at the iteration's index in the block;
``draws.hot_uniforms`` is the plain version of those draws.  And a block computes the bias scale once after each phase, since no
hot step changes what it reads.  Here:

* the uniforms: in [0, 1), with the moments of a uniform and a KS test at
  65,536 lanes in float32 and float64; different between lanes, steps and
  keys, and from the event samplers' words under the same key; equal to
  ``draws.philox_words`` on the counters (lane, 5, step, 0) made uniforms
  by ``uniform_from_limbs``;
* the scale: ``hot_step_plain`` leaves the counters it reads as it found
  them, and blocks whose phases compute the scale once leave the state bit
  for bit where a loop that recomputes it before every hot step leaves it
  (the 64x32 torus, both semantics, both dtypes, live and frozen bias);
* the wrapper of the drawing instance takes the plain version on the CPU;
* on the card (marker ``cuda``): the drawing kernel against
  ``engine.hot_step_plain`` on ``hot_uniforms`` under the same key and
  step, in both dtypes at 65,536, 4,096, 1,024, 512, 513 and 1 lanes and on
  each side of every width where the instance changes, and bit for bit the
  explicit kernel's on those uniforms.  This file imports no JAX:
  ``python -m pytest --noconftest -m cuda tests/test_torch_hot_draws.py``.
"""

import numpy as np
import pytest
import scipy.stats
import torch

from grmonty_tpu_torch.models import harm, torus
from grmonty_tpu_torch.ops import draws, fluid
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

KEY = (0x0123456789ABCDEF, 0x7EDCBA9876543210)
N_KS = 65536
DTYPES = [torch.float32, torch.float64]
DT_IDS = ["f32", "f64"]
SEMANTICS = ("shipped", "reference")
# the counters a hot step must not change (the bias scale's inputs)
SCALE_INPUTS = ("max_tau_scatt", "n_scatt_rec", "n_recorded", "avg_ema")


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_hot_uniforms_are_uniform(dtype):
    u_roul, u_x1 = draws.hot_uniforms(KEY, 3, N_KS, dtype)
    for u in (u_roul, u_x1):
        assert u.dtype == dtype and u.shape == (N_KS,)
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        x = u.double().numpy()
        # the mean's and the variance's standard errors at 65,536 lanes:
        # sqrt(1/12/n) = 1.1e-3 and sqrt(1/180/n) = 2.9e-4
        assert abs(x.mean() - 0.5) < 5 * 1.13e-3
        assert abs(x.var() - 1.0 / 12.0) < 5 * 2.9e-4
        assert scipy.stats.kstest(x, "uniform").pvalue > 1e-3
    # the two slots are independent streams
    assert abs(np.corrcoef(u_roul.double().numpy(), u_x1.double().numpy())[0, 1]) < 0.02


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_hot_uniforms_differ_by_lane_step_and_key(dtype):
    n = 4096
    base = draws.hot_uniforms(KEY, 0, n, dtype)
    others = [draws.hot_uniforms(KEY, 1, n, dtype),
              draws.hot_uniforms((KEY[0] + 1, KEY[1]), 0, n, dtype),
              draws.hot_uniforms((KEY[0], KEY[1] ^ 1), 0, n, dtype)]
    for u, b in zip(base, base[::-1]):
        assert torch.unique(u).numel() > 0.99 * n  # lanes differ
        assert float((u == b).double().mean()) < 1e-3  # the two slots differ
    for other in others:
        for u, o in zip(base, other):
            assert float((u == o).double().mean()) < 1e-3
    # the event samplers' first words under the same key, at the same
    # (round, block): other numbers
    like = torch.zeros(n, dtype=dtype)
    src = draws.PhiloxDraws(KEY)
    for sampler in (draws.ELECTRON, draws.ELECTRON_DIR, draws.KLEIN_NISHINA, draws.THOMSON,
                    draws.SCATTER_DIR):
        s = src._slots(sampler, 0, like, 1, chunk=1)
        for u in base:
            assert float((u == s[0]).double().mean()) < 1e-3, sampler
            assert float((u == s[1]).double().mean()) < 1e-3, sampler
    assert draws.HOT == 5 and draws.HOT not in (draws.ELECTRON, draws.ELECTRON_DIR,
                                                draws.KLEIN_NISHINA, draws.THOMSON,
                                                draws.SCATTER_DIR)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("step", [0, 7, 63])
def test_hot_uniforms_are_the_generators_words(dtype, step):
    n = 1000
    lane = torch.arange(n, dtype=torch.int64)
    ctr = torch.stack([lane, torch.full_like(lane, draws.HOT), torch.full_like(lane, step),
                       torch.zeros_like(lane)], dim=1)
    words = draws.philox_words(ctr, torch.tensor(KEY, dtype=torch.int64))
    want = [draws.uniform_from_limbs(draws._word_limbs(words[:, j], words[:, j]), dtype)
            for j in (0, 1)]
    got = draws.hot_uniforms(torch.tensor(KEY, dtype=torch.int64), step, n, dtype)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return str(path)


@pytest.fixture(scope="module")
def setup(dump):
    """mc and the engine tables (float64) of the 64x32 torus."""
    model = harm.read_dump(dump, 4e19)
    mc = fluid.make_model_consts(model)
    host = driver.build_host_tables(model, mc, 2000, torch.device("cpu"))
    return mc, driver.build_engine_tables(host, mc, torch.float64)


def _step_inputs(setup, semantics, dtype, n=2048, seed=5):
    mc, tabs = setup
    make = profiles.reference_config if semantics == "reference" else profiles.bench_config
    cfg = make(pool=n, dtype=dtype)
    lanes = hot_kernels.synthetic_lanes(mc, n, seed, cfg.stall_steps, cfg.reference,
                                        events=True)
    tables = tabs._replace(**{f: getattr(tabs, f).to(dtype).contiguous()
                              for f in ("hc_coeffs", "corner_rows", "hot_tab")})
    return mc, tables, cfg, hot_kernels.synthetic_step(lanes, dtype, "cpu")


@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_plain_step_leaves_the_scale_inputs_as_found(setup, semantics, dtype):
    mc, tables, cfg, (pool, counters, u_roul, u_x1, bias) = _step_inputs(setup, semantics, dtype)
    counters = counters._replace(
        max_tau_scatt=torch.tensor(0.37, dtype=dtype), n_scatt_rec=torch.tensor(11),
        n_recorded=torch.tensor(5), avg_ema=torch.tensor(1.25, dtype=dtype))
    before = {f: getattr(counters, f).clone() for f in SCALE_INPUTS}
    q, c = engine.hot_step_plain(pool, counters, u_roul, u_x1, bias, mc, tables, cfg)
    for f in SCALE_INPUTS:
        assert torch.equal(getattr(c, f), before[f]), f
    # the step did run: the census moved
    assert int(c.ls_iters) == int(counters.ls_iters) + 1


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_drawn_wrapper_takes_the_plain_version_on_cpu(setup, semantics):
    mc, tables, cfg, (pool, counters, _, _, bias) = _step_inputs(setup, semantics,
                                                                 torch.float64)
    before = dict(hot_kernels.launches)
    key = torch.tensor(KEY, dtype=torch.int64)
    q, c = hot_kernels.hot_step_drawn(pool, counters, key, 9, bias, mc, tables, cfg)
    u_roul, u_x1 = draws.hot_uniforms(KEY, 9, pool.w.shape[0], torch.float64)
    ref_q, ref_c = engine.hot_step_plain(pool, counters, u_roul, u_x1, bias, mc, tables, cfg)
    for name, v in hot_kernels._flat(q._asdict()).items():
        assert torch.equal(v, hot_kernels._flat(ref_q._asdict())[name]), name
    assert hot_kernels.step_outputs(q, c, cfg.reference)[1] == hot_kernels.step_outputs(
        ref_q, ref_c, cfg.reference)[1]
    assert hot_kernels.launches == before
    with pytest.raises(ValueError, match="step"):
        hot_kernels.hot_step_drawn(pool, counters, key, -1, bias, mc, tables, cfg)


def test_drawing_entry_points_are_known():
    for dt in DTYPES:
        for ref in (False, True):
            name = hot_kernels.entry_point("hot_step", dt, ref, draw=True)
            assert name == hot_kernels.entry_point("hot_step", dt, ref) + "_draw"
            assert name in hot_kernels.HOT_DRAWS and name in hot_kernels.launches
            n_ptrs, n_scal = hot_kernels._ABI[name]  # the run's first step and its steps
            assert (n_ptrs, n_scal - 2) == hot_kernels._ABI[name[:-len("_draw")]]
            assert hot_kernels.KERNEL_TOLERANCE[name] == hot_kernels.KERNEL_TOLERANCE[
                name[:-len("_draw")]]
    with pytest.raises(ValueError, match="drawing"):
        hot_kernels.entry_point("row_gather", torch.float32, draw=True)


# -- the bias scale once a phase ----------------------------------------------

POOL = 256
M_PERIOD = 16
BLOCKS = 4
PRIME_BLOCKS = 40  # at most this many blocks before the first records
FROZEN = dict(bias_fixed_tau=0.0025, bias_fixed_avg=2.6)
CASES = [(sem, dt, bias) for sem in SEMANTICS for dt in DTYPES for bias in ("live", "frozen")]


def _sim(dump, semantics, dtype, bias):
    make = profiles.reference_config if semantics == "reference" else profiles.bench_config
    cfg = make(pool=POOL, dtype=dtype)._replace(m_period=M_PERIOD, sec_cap=64, stall_steps=2000,
                                                **(FROZEN if bias == "frozen" else {}))
    return driver.Simulation(dump, photon_n=600, mass_unit=4.0e19, seed=123, config=cfg,
                             device="cpu", warmup=0)


def _loop_block(eng, state, rows, n_valid, scales):
    """One block as the engine issued it before the scale was hoisted: the
    scale computed from the counters before every hot step (``scales``
    collects each step's)."""
    state = eng.periodic_phase(state, rows, n_valid)
    for bi_, nb in enumerate(eng.blocks):
        if bi_:
            state = eng.light_phase(state, rows, n_valid)
        for _ in range(nb):
            scales.append(eng._bias_scale(state.counters))
            state = eng.hot_step(state)
    return state


def _bits(t):
    if t.is_floating_point():
        return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)
    return t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("semantics,dtype,bias", CASES,
                         ids=[f"{s}-{str(d)[6:]}-{b}" for s, d, b in CASES])
def test_scale_once_a_phase_equals_the_scale_every_step(dump, semantics, dtype, bias):
    sim = _sim(dump, semantics, dtype, bias)
    sim.plan()
    rows = sim.emit_rows(0, 400)
    eng = sim.engine
    eng.reserve_backlog(rows.shape[0])
    eng._load(eng.fresh_state(), rows, rows.shape[0])
    # blocks until the first records, so that the live bias moves in the
    # blocks compared
    for _ in range(PRIME_BLOCKS):
        if int(eng._state.counters.n_recorded) > 0:
            break
        eng._body()
    start, g0 = engine.clone_state(eng._state), sim.gen.get_state()
    assert int(start.counters.n_recorded) > 0
    for _ in range(BLOCKS):
        eng._body()
    got = engine.clone_state(eng._state)
    gen_got = sim.gen.get_state()

    sim.gen.set_state(g0)
    state, scales = start, []
    for _ in range(BLOCKS):
        state = _loop_block(eng, state, rows, rows.shape[0], scales)
    for name, g, w in zip(driver._flat_state(state), engine.state_tensors(got),
                          engine.state_tensors(state), strict=True):
        assert torch.equal(_bits(g), _bits(w)), f"{name} differs"
    assert torch.equal(gen_got, sim.gen.get_state())
    assert int(got.counters.ls_iters) == int(start.counters.ls_iters) + BLOCKS * M_PERIOD
    # the scale moved between the phases under the live bias (the counters
    # it reads changed), and never under the frozen one
    distinct = len({float(s) for s in scales})
    assert distinct > 1 if bias == "live" else distinct == 1, distinct
    assert int(got.counters.n_recorded) > int(start.counters.n_recorded)


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the drawing kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_drawing_kernel_matches_plain_on_the_card(setup, semantics, dtype):
    _card()
    mc, tabs = setup
    dev = torch.device("cuda")
    name = hot_kernels.entry_point("hot_step", dtype, semantics == "reference", draw=True)
    widths = [65536, 4096, 1024, 512, 513, 1]
    for edge in hot_kernels.hot_step_shape_edges(name):
        widths += [edge, edge + 1]
    tables = tabs._replace(**{f: getattr(tabs, f).to(dev, dtype).contiguous()
                              for f in ("hc_coeffs", "corner_rows", "hot_tab")})
    for n in widths:
        make = profiles.reference_config if semantics == "reference" else profiles.bench_config
        cfg = make(pool=n, dtype=dtype)
        name = hot_kernels.entry_point("hot_step", dtype, cfg.reference, draw=True)
        lanes = hot_kernels.synthetic_lanes(mc, n, 13, cfg.stall_steps, cfg.reference,
                                            events=True)
        pool, counters, _, _, bias = hot_kernels.synthetic_step(lanes, dtype, dev)
        key = torch.tensor([0x5EED + n, 0xD4A5], dtype=torch.int64, device=dev)
        step = 3

        def census():
            return counters._replace(**{c: getattr(counters, c).clone()
                                        for c in hot_kernels.CENSUS})

        u_roul, u_x1 = draws.hot_uniforms(key, step, n, dtype)
        ref = engine.hot_step_plain(pool, census(), u_roul, u_x1, bias, mc, tables, cfg)
        n0 = hot_kernels.launches[name]
        got = hot_kernels.hot_step_drawn(pool, census(), key, step, bias, mc, tables, cfg)
        explicit = hot_kernels.hot_step(pool, census(), u_roul, u_x1, bias, mc, tables, cfg)
        torch.cuda.synchronize()
        assert hot_kernels.launches[name] == n0 + 1
        (ref_f, ref_c), (got_f, got_c), (exp_f, _) = (
            hot_kernels.step_outputs(*out, cfg.reference) for out in (ref, got, explicit))
        tol = hot_kernels.KERNEL_TOLERANCE[name]
        slack = hot_kernels.weight_slack(pool, ref_f, tol["rtol"])
        _, _, _, fails = hot_kernels.compare(ref_f, got_f, **tol, slack=slack)
        assert not fails, f"{name} at {n} lanes: {fails}"
        assert got_c == ref_c, n
        for f in hot_kernels.PHASE_A_FIELDS[cfg.reference]:
            assert torch.equal(got_f[f], ref_f[f]), (n, f)
        flat_got, flat_exp = hot_kernels._flat(got_f), hot_kernels._flat(exp_f)
        for f, v in flat_got.items():
            assert bool(hot_kernels._same_bits(v, flat_exp[f]).all()), (n, f)
