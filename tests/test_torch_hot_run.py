"""A block's run of hot steps as one launch, in place (``hot_kernels.hot_run``).

The JAX engine runs a block's hot steps as ``lax.fori_loop(0, nb, lambda i,
s: hot_step(s), state)`` (grmonty_tpu/transport/engine.py:2536-2545), the
pool its carry, updated in place.  On the card the port runs each such run
as one launch of the drawing hot step: a lane loads its state once, holds
it across the run's steps and stores it once into the pool's own tensors;
``engine.hot_run_plain`` is its plain version (the plain step on each
step's uniforms, ``draws.hot_uniforms`` at the step's index in the block,
written back into the pool's tensors).  On the CPU:

* ``hot_run_plain`` equals S drawn plain steps (``hot_kernels.hot_step_drawn``
  chained, each into new tensors) bit for bit, every pool field and census
  counter and ``Engine.hot_run``'s ``it``, in both semantics and dtypes at S
  = 1, 4 and 64; ``hot_run`` hands back the tensors it was given and
  refuses steps outside [1, ``MAX_RUN_STEPS``];
* S chained steps of the JAX package's own step (``hot_phase_a``, the
  corner rows, ``hot_phase_b``, the clamp, the capture and the census, as
  tests/test_torch_hot_step.py composes them) on the same uniforms match
  ``hot_run_plain``: float64 to rtol 1e-10 (absolute floor 1e-12 of the
  field's largest magnitude; ``dl_shrink``, ill conditioned, 1e-8) at
  every step, masks, integers and the census exactly;
  float32 (JAX traced with x64 off) at every step, on the lanes whose masks
  and integers agreed at every step so far and whose ``dl_shrink`` agreed
  to rtol 1e-4 at every earlier step (its ill conditioning, which
  tests/test_torch_hot.py allows on 1% of the lanes, parts the
  trajectories of the lanes it reaches), floats to rtol 1e-4 and atol
  1e-6 (``dl_shrink`` on all but 3% of the lanes compared a step, and
  everywhere within 50%: ``F32_ILL_CONDITIONED``), each mask on at most
  0.1% of the lanes a step, each census count within 0.1% of the lanes a
  step, and at least 95% of the lanes compared at the last step.

On the card (marker ``cuda``; this file imports JAX only inside the tests
that compare with it: ``python -m pytest --noconftest -m cuda
tests/test_torch_hot_run.py``), at every instance width (512, 1,024, 4,096,
16,384 and 65,536 lanes, and both sides of each width where the instance
changes), in both semantics and dtypes: one launch of S steps equals S
launches of one step bit for bit, census included; the launch is in place
(the same tensors, counted as one launch of S steps); and a graph replay of
the engine's block issues one hot-step launch a run and no copy of a pool
field, counted in ``torch.profiler``'s trace of the card.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.models import harm, torus
from grmonty_tpu_torch.ops import draws, fluid
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

SEMANTICS = ("shipped", "reference")
DTYPES = [torch.float64, torch.float32]
DT_IDS = ["f64", "f32"]
N = 512
KEY = (0x2B992DDFA23249D6, 0x3F1C2A4E5D6B7081)
STEP0 = 3
CENSUS = hot_kernels.CENSUS
# S chained steps against JAX (its eager CPU ops take about a second a step)
JAX_STEPS = 4
# The step controller's factor reads error estimates that are differences of
# nearly equal numbers (tests/test_torch_hot.py): an ulp of the chained
# state moves it by eps / (2 err).  In float64 it drifted to 1.4e-10
# relative in 4 steps and 6.7e-10 in 8 on these lanes, every other field
# within 1e-12 of its scale.
F64_RTOL = {"dl_shrink": 1e-8}
# In float32 the single step allows its factor beyond rtol 1e-4 on 1% of the
# lanes, all within 50%, from identical inputs; once the inputs carry a
# step's ulps it went beyond on 1.2% to 2.5% of the lanes compared a step
# (shipped, seeds 11 and 12; at most 25%), every other field within rtol.
F32_ILL_CONDITIONED = {"dl_shrink": (0.03, 0.5)}


def _sibling(name):
    """The test module ``name`` of this directory (its helpers, not its
    tests)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """mc and the engine tables (float64) of a 64x32 torus."""
    path = str(tmp_path_factory.mktemp("dump") / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    model = harm.read_dump(path, 4e19)
    mc = fluid.make_model_consts(model)
    host = driver.build_host_tables(model, mc, 2000, torch.device("cpu"))
    return mc, driver.build_engine_tables(host, mc, torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(semantics, dtype, n=N):
    make = profiles.reference_config if semantics == "reference" else profiles.bench_config
    return make(pool=n, dtype=dtype)


def _inputs(setup, semantics, dtype, n=N, seed=11, device="cpu"):
    """(lanes, cfg, tables, pool, counters, bias) of synthetic lanes at n."""
    mc, tabs = setup
    cfg = _config(semantics, dtype, n)
    lanes = hot_kernels.synthetic_lanes(mc, n, seed, cfg.stall_steps, cfg.reference,
                                        events=True)
    tables = tabs._replace(**{f: getattr(tabs, f).to(device, dtype).contiguous()
                              for f in ("hc_coeffs", "corner_rows", "hot_tab")})
    pool, counters, _, _, bias = hot_kernels.synthetic_step(lanes, dtype, device)
    return lanes, cfg, tables, pool, counters, bias


def _bits(t):
    if t.is_floating_point():
        return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)
    return t


def _assert_same_pool(got, want, what):
    for name, g, w in zip(engine.Pool._fields, got, want, strict=True):
        for a, b in zip(*((v if isinstance(v, tuple) else (v,)) for v in (g, w)), strict=True):
            assert torch.equal(_bits(a), _bits(b)), f"{what}: {name} differs"


def _chained(pool, counters, key, step0, steps, bias, mc, tables, cfg):
    """``steps`` drawn steps, each its own call into new tensors."""
    for j in range(steps):
        pool, counters = hot_kernels.hot_step_drawn(pool, counters, key, step0 + j, bias, mc,
                                                    tables, cfg)
    return pool, counters


def _copy(pool, counters):
    return engine.clone_pool(pool), counters._replace(
        **{c: getattr(counters, c).clone() for c in CENSUS})


@pytest.mark.parametrize("steps", [1, 4, 64])
@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_plain_run_equals_chained_drawn_steps(setup, semantics, dtype, steps):
    mc, _ = setup
    _, cfg, tables, pool, counters, bias = _inputs(setup, semantics, dtype)
    key = torch.tensor(KEY, dtype=torch.int64)
    want_p, want_c = _chained(pool, counters, key, STEP0, steps, bias, mc, tables, cfg)
    got_p, got_c = _copy(pool, counters)
    out = engine.hot_run_plain(got_p, got_c, key, STEP0, steps, bias, mc, tables, cfg)
    assert out[0] is got_p and out[1] is got_c
    _assert_same_pool(got_p, want_p, f"{steps} steps")
    assert hot_kernels.step_outputs(got_p, got_c, cfg.reference)[1] == \
        hot_kernels.step_outputs(want_p, want_c, cfg.reference)[1]
    assert int(got_c.ls_iters) == int(counters.ls_iters) + steps
    assert int(got_c.ls_slots) == int(counters.ls_slots) + steps * N
    # the lanes moved: the run did steps
    assert not torch.equal(got_p.x[1], pool.x[1])


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_engine_run_of_steps_counts_its_iterations(setup, semantics):
    mc, _ = setup
    _, cfg, tables, pool, counters, bias = _inputs(setup, semantics, torch.float64)
    eng = engine.Engine(mc, cfg, tables, "cpu", torch.Generator().manual_seed(1))
    state = eng.fresh_state()._replace(pool=engine.clone_pool(pool), counters=counters, it=40)
    key = torch.tensor(KEY, dtype=torch.int64)
    out = eng.hot_run(state, 7, bias, key, STEP0)
    assert out.it == 47 and out.pool is state.pool and out.counters is state.counters
    want_p, _ = _chained(pool, counters, key, STEP0, 7, bias, mc, tables, cfg)
    _assert_same_pool(out.pool, want_p, "Engine.hot_run")


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_wrapper_runs_in_place_on_the_tensors_given(setup, semantics):
    mc, _ = setup
    _, cfg, tables, pool, counters, bias = _inputs(setup, semantics, torch.float32)
    key = torch.tensor(KEY, dtype=torch.int64)
    before = (dict(hot_kernels.launches), dict(hot_kernels.run_steps))
    held = engine.pool_tensors(pool) + list(counters)
    p, c = hot_kernels.hot_run(pool, counters, key, STEP0, 5, bias, mc, tables, cfg)
    assert p is pool and c is counters
    assert all(a is b for a, b in zip(engine.pool_tensors(p) + list(c), held, strict=True))
    # the plain path counts no launch
    assert (dict(hot_kernels.launches), dict(hot_kernels.run_steps)) == before
    for step0, steps in ((0, 0), (-1, 2), (0, hot_kernels.MAX_RUN_STEPS + 1), (0.0, 2)):
        with pytest.raises(ValueError, match="step"):
            hot_kernels.hot_run(pool, counters, key, step0, steps, bias, mc, tables, cfg)


def _np_fields(pool):
    """The JAX step's lanes from a pool: {field: numpy (4-tuples)}."""
    fields = hot_kernels.STEP_FIELDS + hot_kernels.EVENT_FIELDS
    return {f: (tuple(v.numpy() for v in getattr(pool, f)) if isinstance(getattr(pool, f), tuple)
                else getattr(pool, f).numpy()) for f in fields}


def _on(d, lanes):
    return {k: (tuple(c[lanes] for c in v) if isinstance(v, tuple) else v[lanes])
            for k, v in d.items()}


@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_plain_run_matches_jax_chained_steps(setup, semantics, dtype):
    hs = _sibling("test_torch_hot_step")
    hs._F32_ILL_CONDITIONED = F32_ILL_CONDITIONED  # this module's copy
    mc, tabs = setup
    lanes, cfg, tables, pool, counters, bias = _inputs(setup, semantics, dtype)
    key = torch.tensor(KEY, dtype=torch.int64)
    census = hot_kernels.step_outputs(pool, counters, cfg.reference)[1]
    state = _np_fields(pool)
    got_p, got_c = _copy(pool, counters)
    # float32: the lanes whose masks and integers agreed at every step, and
    # whose step factor, ill conditioned (tests/test_torch_hot.py), agreed to
    # rtol at every earlier step (where it did not, the next steps' segments
    # differ and the trajectories part, as two float32 runs of one photon do)
    agree = torch.ones(N, dtype=torch.bool)
    for j in range(JAX_STEPS):
        u_roul, u_x1 = draws.hot_uniforms(key, STEP0 + j, N, dtype)
        step_lanes = {**state, "u_roul": u_roul.numpy(), "u_x1": u_x1.numpy(),
                      "bias_scale": lanes["bias_scale"]}
        out, new_census = hs._jax_step(mc, tabs, cfg, step_lanes, census,
                                       x64=dtype == torch.float64)
        engine.hot_run_plain(got_p, got_c, key, STEP0 + j, 1, bias, mc, tables, cfg)
        got, got_census = hot_kernels.step_outputs(got_p, got_c, cfg.reference)
        ref = hs._as_torch(out)
        if dtype == torch.float64:
            assert got_census == new_census, j
            for name, g in hot_kernels._flat(got).items():
                r = hot_kernels._flat(ref)[name].numpy()
                g = g.numpy()
                if g.dtype.kind in "bi":
                    assert np.array_equal(g, r.astype(g.dtype)), (j, name)
                    continue
                fin = np.isfinite(r)
                scale = np.abs(r[fin]).max() if fin.any() else 0.0
                np.testing.assert_allclose(g, r, rtol=F64_RTOL.get(name, 1e-10),
                                           atol=1e-12 * scale, err_msg=f"step {j}: {name}")
        else:
            for name in CENSUS:  # within 0.1% of the lanes a step
                assert abs(got_census[name] - new_census[name]) <= 1e-3 * N * (j + 1), (j, name)
            for name, a in hot_kernels._flat(ref).items():
                if not a.dtype.is_floating_point:
                    same = a == hot_kernels._flat(got)[name].to(a.dtype)
                    assert 1.0 - float(same.double().mean()) <= 1e-3, (j, name)
                    agree &= same
            assert float(agree.double().mean()) > 0.95, j
            fails = hs._f32_failures(_on(ref, agree), _on(got, agree))
            assert not fails, (j, fails)
            a, b = ref["dl_shrink"].double(), got["dl_shrink"].double()
            agree &= torch.abs(a - b) <= 1e-4 * torch.abs(a)
        state.update(out)
        census = new_census


# -- on the card ------------------------------------------------------------

RUN_WIDTHS = (512, 1024, 4096, 16384, 65536)
CARD_STEPS = (4, 64)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the run is one CUDA launch")


def _card_widths(dtype, semantics):
    name = hot_kernels.entry_point("hot_step", dtype, semantics == "reference", draw=True)
    widths = set(RUN_WIDTHS)
    for edge in hot_kernels.hot_step_shape_edges(name):
        widths |= {edge, edge + 1}
    return sorted(widths)


@pytest.mark.cuda
@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_one_launch_of_s_steps_equals_s_launches(setup, semantics, dtype):
    _card()
    mc, _ = setup
    dev = torch.device("cuda")
    key = torch.tensor(KEY, dtype=torch.int64, device=dev)
    for n in _card_widths(dtype, semantics):
        _, cfg, tables, pool, counters, bias = _inputs(setup, semantics, dtype, n=n, seed=n,
                                                       device=dev)
        name = hot_kernels.entry_point("hot_step", dtype, cfg.reference, draw=True)
        for steps in CARD_STEPS:
            want_p, want_c = _chained(*_copy(pool, counters), key, STEP0, steps, bias, mc,
                                      tables, cfg)
            got_p, got_c = _copy(pool, counters)
            held = [t.data_ptr() for t in engine.pool_tensors(got_p)]
            n0, s0 = hot_kernels.launches[name], hot_kernels.run_steps[name]
            out = hot_kernels.hot_run(got_p, got_c, key, STEP0, steps, bias, mc, tables, cfg)
            torch.cuda.synchronize()
            assert out[0] is got_p and out[1] is got_c
            assert [t.data_ptr() for t in engine.pool_tensors(got_p)] == held
            assert hot_kernels.launches[name] == n0 + 1
            assert hot_kernels.run_steps[name] == s0 + steps
            _assert_same_pool(got_p, want_p, f"{name} at {n} lanes, {steps} steps")
            assert (hot_kernels.step_outputs(got_p, got_c, cfg.reference)[1]
                    == hot_kernels.step_outputs(want_p, want_c, cfg.reference)[1]), (n, steps)


def _traced(fn):
    """The names of the card's activities during ``fn``, in
    ``torch.profiler``'s trace (after a session of its own: a process's
    first session can miss the card's first launches)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        torch.cuda._sleep(1 << 10)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_a_replayed_body_runs_one_launch_a_run_and_copies_no_pool_field(
        tmp_path, semantics, dtype, monkeypatch):
    _card()
    path = str(tmp_path / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    cfg = _config(semantics, dtype, 1024)
    sim = driver.Simulation(path, photon_n=2000, mass_unit=4e19, seed=5, config=cfg,
                            device="cuda", warmup=0)
    sim.plan()
    rows = sim.emit_rows(0, 1500)
    eng = sim.engine
    eng.reserve_backlog(rows.shape[0])
    eng.capture(eng.fresh_state(), rows, rows.shape[0])
    # what the block's closing assign_state copies, by field, in an eager
    # block (the captured one issues the same operations)
    copied = []
    assign = engine.assign_state

    def watched(dst, src):
        for name, d, s in zip(driver._flat_state(dst), engine.state_tensors(dst),
                              engine.state_tensors(src), strict=True):
            if s is not d:
                copied.append(name)
        assign(dst, src)

    eng._load(eng.fresh_state(), rows, rows.shape[0])
    monkeypatch.setattr(engine, "assign_state", watched)
    eng._body()
    monkeypatch.setattr(engine, "assign_state", assign)
    assert not [name for name in copied if name.startswith("pool.")], copied
    eng._load(eng.fresh_state(), rows, rows.shape[0])
    eng._exit_test()  # the run's entry test: the replay's blocks all run
    names = _traced(eng._replay)
    assert int(eng._exit_word[3]) == 1 + eng.graph_bodies  # the blocks run, and the next
    runs = sum("hot_step_kernel" in name for name in names)
    copies = sum("memcpy" in name.lower() or "copy" in name.lower() for name in names)
    assert runs == eng.graph_bodies * len(eng.blocks), (runs, eng.blocks)
    assert copies == eng.graph_bodies * len(copied), (copies, copied, sorted(set(names)))
