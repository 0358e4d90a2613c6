"""The run's closing flush as one record, the exit test at the end of a block,
and the gated sweep that guards a block (CPU).

* The flush: ``Engine.run`` ends with one ``Engine.spectrum_add`` at the
  pool's width, queued behind the blocks with nothing read on the host,
  where the JAX engine's ``run`` loops ``spectrum_add`` at ``EV_K`` lanes a
  call while a pending lane holds no event (``grmonty_tpu/transport/
  engine.py:2557-2572``).  On seeded JAX states (float32 and float64, both
  semantics) whose exit holds at entry, so that each run is its flush
  alone, with no pending lane, fewer than ``EV_K``, more than ``EV_K``, and
  pending lanes that still hold an event: the spectrum within 1e-6 relative
  (float32) or 1e-12 (float64), every counter, the ratchet and the pool's
  flags equal, converted by ``convert.from_jax_state``.
* The exit word: an eager CPU run's words (each block its gated sweep,
  the rest of it and ``engine.exit_test_plain`` at its end) and its final
  state equal those of the loop of ungated full phases, hot steps and the
  test after each block, bit for bit; each word is the JAX ``cond``
  formula evaluated with ``jnp`` on the state it was taken on.
* The gated sweep's plain version (``engine.gated_sweep_plain`` through
  ``hot_kernels.record_phase`` with ``go``): with ``go`` clear it changes
  no tensor, the bias's terms included; with ``go`` set it equals the
  sweep, bit for bit.
"""

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

N = 256
EV_K = N // 4
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# the pending lanes of each case (before the lanes made to hold an event)
PENDING = {"none": 0, "few": EV_K // 3, "many": 3 * EV_K + 5, "with_events": 2 * EV_K}


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return str(path)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[(s, d) for s in ("shipped", "reference") for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def jax_flush(request, dump):
    """A JAX engine of one semantics and dtype (N lanes, ``EV_K`` a record
    call), its jitted ``run``, a state that went through two light phases
    from a fresh one, and the port's engine of the same config on the same
    tables."""
    import jax
    import jax.numpy as jnp
    from jax import random

    from grmonty_tpu.transport import driver as jdriver
    from grmonty_tpu.transport import engine as jengine

    from grmonty_tpu_torch import convert
    from grmonty_tpu_torch.models import harm
    from grmonty_tpu_torch.ops import fluid

    semantics, dname = request.param
    physics = convert._REFERENCE if semantics == "reference" else convert._SHIPPED
    jdt = jnp.float32 if dname == "f32" else jnp.float64
    jcfg = jengine.EngineConfig(
        n_pool=N, m_period=16, sec_cap=4 * N, ev_k=EV_K, refill_k=N // 2, light_k=N // 4,
        refill_period=4, dtype=jdt,
        **({} if semantics == "reference" else {"grow_cap": 8.0}), **physics)
    jsim = jdriver.Simulation(dump, photon_n=2000, mass_unit=4e19, config=jcfg,
                              cdf_sampler=True, emit_stride=True, warmup=0)
    backlog = jnp.asarray(np.array(jsim.emit_packed(jsim.plan(), 0, 4 * N)), jdt)
    light = jax.jit(jsim.engine["light_phase"])
    state = jsim.engine["fresh_state"](random.PRNGKey(3))
    state = light(light(state, backlog), backlog)
    mc = fluid.make_model_consts(harm.read_dump(dump, 4e19))
    dt = DTYPES[dname]
    port = engine.Engine(mc, convert.from_jax_config(jcfg),
                         convert.from_jax_engine_tables(jsim._engine_tabs, dtype=dt),
                         torch.device("cpu"), torch.Generator())
    return dict(run=jax.jit(jsim.engine["run"]), state=state, backlog=backlog, port=port,
                dt=dt, jdt=jdt, detached=jcfg.detached_events)


def _pending_state(jf, case):
    """The fixture's state with seeded lanes made escaped (pending a
    record, not alive, seeded tau_scatt and n_scatt), under "with_events"
    some of them still holding an event, a few with a NaN weight (freed
    unrecorded), and an empty ring, so that the run's exit holds at entry
    and the run is its flush alone."""
    import jax.numpy as jnp

    st = jf["state"]
    p = st.pool
    rng = np.random.default_rng(sum(map(ord, case)))
    occupied = np.flatnonzero(np.asarray(p.occupied))
    m = min(PENDING[case], occupied.size)
    esc = np.zeros(N, bool)
    esc[rng.choice(occupied, m, replace=False)] = True
    ev = np.asarray(p.ev_pending).copy()
    if case == "with_events" and jf["detached"]:  # reference semantics park events
        ev[np.flatnonzero(esc)[::3]] = True
    w = np.asarray(p.w).copy()
    if m:
        w[np.flatnonzero(esc)[1::11]] = np.nan
    tau = np.where(esc, rng.exponential(0.02, N), np.asarray(p.tau_scatt))
    nsc = np.where(esc, rng.integers(0, 6, N), np.asarray(p.n_scatt)).astype(np.int32)
    jdt = jf["jdt"]
    pool = p._replace(record_pending=jnp.asarray(esc), alive=jnp.asarray(np.asarray(p.alive) & ~esc),
                      tau_scatt=jnp.asarray(tau, jdt), n_scatt=jnp.asarray(nsc),
                      w=jnp.asarray(w, jdt), ev_pending=jnp.asarray(ev))
    return st._replace(pool=pool, sec=st.sec._replace(count=jnp.zeros((), st.sec.count.dtype)))


@pytest.mark.parametrize("case", list(PENDING))
def test_one_flush_call_is_the_jax_flush_loop(jax_flush, case):
    from grmonty_tpu_torch import convert

    jf, port = jax_flush, jax_flush["port"]
    jstate = _pending_state(jf, case)
    pending = np.asarray(jstate.pool.record_pending)
    held = pending & (np.asarray(jstate.pool.ev_pending) if jf["detached"] else False)
    if case == "many":
        assert pending.sum() > EV_K
    if case == "with_events":
        assert held.any() == jf["detached"] and (pending & ~held).sum() > EV_K
    # the exit holds at entry (no lane above the pool, no row, no
    # secondary): JAX's run is its flush loop alone, and so is the port's
    want = convert.from_jax_state(jf["run"](jstate, jf["backlog"], N, 0), dtype=jf["dt"])
    state = convert.from_jax_state(jstate, dtype=jf["dt"])
    port.reserve_backlog(jf["backlog"].shape[0])
    flushes0 = port.flushes
    got = port.run(state, torch.as_tensor(np.array(jf["backlog"])), tail_exit=N, n_valid=0)
    assert port.flushes == flushes0 + 1 and port.bodies == 0
    # XLA on the CPU flushes float32 subnormals, torch keeps them
    rtol = 1e-6 if jf["dt"] == torch.float32 else 1e-12
    torch.testing.assert_close(got.spec, want.spec, rtol=rtol,
                               atol=torch.finfo(jf["dt"]).tiny)
    for f in engine.Counters._fields:
        assert torch.equal(getattr(got.counters, f), getattr(want.counters, f)), f
    for f in engine.SWEPT:
        assert torch.equal(getattr(got.pool, f), getattr(want.pool, f)), f
    # no pending lane is left but one still holding an event
    left = got.pool.record_pending
    assert not bool((left & ~got.pool.ev_pending).any()) if jf["detached"] else not left.any()
    assert bool(left.any()) == (case == "with_events" and jf["detached"])
    recorded = int(got.counters.n_recorded) - int(state.counters.n_recorded)
    assert recorded > EV_K if case == "many" else True
    assert (recorded == 0) == (case == "none")


# -- the exit word -------------------------------------------------------------

POOL = 256
WAVE = 150
M_PERIOD = 8
CASES = [(ref, dt) for ref in (False, True) for dt in DTYPES.values()]
IDS = [f"{'reference' if ref else 'shipped'}-{str(dt)[6:]}" for ref, dt in CASES]


def _sim(dump, reference, dtype):
    make = profiles.reference_config if reference else profiles.bench_config
    cfg = make(pool=POOL, dtype=dtype)._replace(m_period=M_PERIOD, sec_cap=32,
                                                stall_steps=2000)
    return driver.Simulation(dump, photon_n=600, mass_unit=4.0e18, seed=123, config=cfg,
                             device="cpu", warmup=0, tail_stall_steps=2000)


def _loop_before(eng, state, rows, tail_exit):
    """The run's loop with the exit test after each block: the entry test,
    then while its word says go, a block (its sweep ungated) and the test;
    the words read and the states they were taken on."""
    eng._load(state, rows, rows.shape[0], tail_exit)
    seen = []

    def test():
        eng._exit_test()
        seen.append((eng._read_word(), engine.clone_state(eng._state)))

    test()
    while seen[-1][0].go:
        st = eng._state
        s = eng.periodic_phase(st, eng._backlog, eng._n_valid)
        for bi_, nb in enumerate(eng.blocks):
            if bi_:
                s = eng.light_phase(s, eng._backlog, eng._n_valid)
            for _ in range(nb):
                s = eng.hot_step(s, bias_scale=eng._bias.scale)
        engine.assign_state(st, s)
        test()
    return seen


def _bits(t):
    if t.is_floating_point():
        return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)
    return t


@pytest.mark.parametrize("reference,dtype", CASES, ids=IDS)
def test_eager_run_words_are_the_loops_with_the_test_alone(dump, reference, dtype,
                                                           monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setattr(engine, "MAX_OUTER", 6 * M_PERIOD)
    sim = _sim(dump, reference, dtype)
    sim.plan()
    rows = sim.emit_rows(0, WAVE)
    eng = sim.engine
    eng.reserve_backlog(WAVE)
    g0 = sim.gen.get_state()
    tail_exit = POOL // 8
    words = []
    read = eng._read_word

    def reading():
        words.append(read())
        return words[-1]

    monkeypatch.setattr(eng, "_read_word", reading)
    eng.run(eng.fresh_state(), rows, tail_exit=tail_exit)
    got = engine.clone_state(eng._state)
    monkeypatch.setattr(eng, "_read_word", read)
    sim.gen.set_state(g0)
    seen = _loop_before(eng, eng.fresh_state(), rows, tail_exit)
    assert words == [w for w, _ in seen]
    assert len(words) > 2 and words[-1].go == 0 and words[-2].go == 1
    for name, a, b in zip(driver._flat_state(got), engine.state_tensors(got),
                          engine.state_tensors(eng._state), strict=True):
        assert torch.equal(_bits(a), _bits(b)), name
    # each word the JAX cond on the state it was taken on
    for word, st in seen:
        occ = jnp.asarray(st.pool.occupied.numpy())
        cond = bool(((jnp.sum(occ) > tail_exit) | (jnp.asarray(int(st.backlog_pos)) < WAVE)
                     | (jnp.asarray(int(st.sec.count)) > 0))
                    & ((word.bodies - word.go) * M_PERIOD < engine.MAX_OUTER))
        assert (word.occ, word.pos, word.sec) == (int(occ.sum()), int(st.backlog_pos),
                                                 int(st.sec.count))
        assert word.go == cond, word


# -- the gated sweep -------------------------------------------------------------

@pytest.mark.parametrize("reference", [False, True], ids=["shipped", "reference"])
@pytest.mark.parametrize("dtype", list(DTYPES.values()), ids=list(DTYPES))
@pytest.mark.parametrize("go", [False, True], ids=["go-clear", "go-set"])
def test_gated_sweep_plain_is_nothing_or_the_sweep(dump, go, dtype, reference):
    from grmonty_tpu_torch.models import harm
    from grmonty_tpu_torch.ops import fluid

    mc = fluid.make_model_consts(harm.read_dump(dump, 4e19))
    pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, 512, 128, 31, dtype, "cpu",
                                                             reference)
    poisoned = pool.occupied & (engine.isnan4(pool.x) | engine.isnan4(pool.k)
                                | torch.isnan(pool.w))
    assert bool(poisoned.any())
    before = hot_kernels.clone_record(pool, spec, counters)
    bias = hot_kernels.record_bias(dtype, "cpu")
    got = hot_kernels.record_phase(pool, spec, counters, 128, mc, cfg, sweep=True,
                                   record=False, free=False, bias=bias,
                                   go=torch.tensor(go))
    if go:
        want_bias = hot_kernels.record_bias(dtype, "cpu")
        want = hot_kernels.record_phase(*before, 128, mc, cfg, sweep=True, record=False,
                                        free=False, bias=want_bias)
    else:
        want, want_bias = before, hot_kernels.record_bias(dtype, "cpu")
    for a, b in zip(engine.pool_tensors(got[0]) + [got[1], *got[2]],
                    engine.pool_tensors(want[0]) + [want[1], *want[2]], strict=True):
        assert torch.equal(_bits(a), _bits(b))
    for a, b in zip(bias, want_bias, strict=True):
        assert torch.equal(_bits(a), _bits(b))
    assert bool(got[0].occupied[poisoned].any()) != go
    with pytest.raises(ValueError, match="only the sweep alone"):
        hot_kernels.record_phase(pool, spec, counters, 128, mc, cfg, go=torch.tensor(go))
