"""Checkpoint/resume of the port's run (CPU), the port of tests/test_checkpoint.py.

A run interrupted between waves resumes from the disk checkpoint in a new
``Simulation`` and reproduces the uninterrupted run: the spectrum to rtol
1e-6 (on the card the spectrum sums with float atomics; on the CPU it
agrees to every bit), the counts exactly, and the completed run deletes the
checkpoint.  The resumed run's phase counts (``full_phases``,
``light_phases``) and ``hot_iters`` equal the uninterrupted run's, and its
``elapsed_s`` covers the interrupted part too: the checkpoint carries the
run's clocks.  A checkpoint of another run setup is refused, and one save
and load restores every tensor of the state, the host spectrum and the
generator.
"""

import os
import time

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.transport import driver, engine, profiles


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pools of a few hundred lanes: intra-op threads only add overhead, and
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return str(path)


def _make_sim(dump, **kw):
    # step caps cut to 5000 to bound the CPU drain
    cfg = profiles.bench_config(pool=256, dtype=torch.float64)._replace(
        m_period=8, sec_cap=4096, stall_steps=5000)
    args = dict(photon_n=60, mass_unit=4.0e18, config=cfg, device="cpu", emit_chunk=512,
                warmup=128, tail_stall_steps=5000)
    args.update(kw)
    return driver.Simulation(dump, **args)


class _Boom(Exception):
    pass


@pytest.fixture(scope="module")
def resumed(dump, tmp_path_factory):
    """The uninterrupted run, the run that crashes after its second wave
    (its wall seconds and the checkpoint's clocks) and the resumed run, as a
    dict."""
    spec_ref, stats_ref = _make_sim(dump).run()
    assert stats_ref["waves"] >= 4  # the ramp: the crash lands inside it

    ck = str(tmp_path_factory.mktemp("resume") / "resume.npz")
    sim2 = _make_sim(dump)
    orig = sim2._run_wave
    calls = []

    def crashing(*a, **kw):
        if len(calls) == 2:
            raise _Boom()
        calls.append(1)
        return orig(*a, **kw)

    sim2._run_wave = crashing
    t0 = time.monotonic()
    with pytest.raises(_Boom):
        sim2.run(checkpoint_path=ck)
    interrupted_s = time.monotonic() - t0
    assert os.path.exists(ck), "the checkpoint must survive the crash"
    with np.load(ck) as dat:
        clocks, phases = dat["clocks"].copy(), dat["phases"].copy()

    sim3 = _make_sim(dump)  # a fresh process stands in
    spec_res, stats_res = sim3.run(checkpoint_path=ck)
    return dict(spec_ref=spec_ref, stats_ref=stats_ref, spec_res=spec_res,
                stats_res=stats_res, ck=ck, interrupted_s=interrupted_s, clocks=clocks,
                phases=phases, crashed=sim2)


def test_resume_reproduces_uninterrupted_run(resumed):
    spec_ref, stats_ref = resumed["spec_ref"], resumed["stats_ref"]
    spec_res, stats_res, ck = resumed["spec_res"], resumed["stats_res"], resumed["ck"]
    np.testing.assert_allclose(spec_res, spec_ref, rtol=1e-6, atol=0)
    for key in ("n_recorded", "n_scatt_recorded", "n_tracked", "hot_iters",
                "n_secondary_dropped", "n_stall_killed"):
        assert stats_res[key] == stats_ref[key], key
    assert stats_res["pilot"] is None and stats_ref["pilot"]["photons"] == 128
    assert not os.path.exists(ck), "a completed run must delete the checkpoint"


def test_resume_carries_the_runs_clocks_and_phase_counts(resumed):
    """The random stream replays bit for bit, so the resumed run's phase
    counts and hot iterations equal the uninterrupted run's exactly; its
    wall seconds include the interrupted part's (the checkpoint's clocks,
    written after the second wave, just before the crash)."""
    ref, res = resumed["stats_ref"], resumed["stats_res"]
    for key in ("full_phases", "light_phases", "hot_iters"):
        assert res[key] == ref[key], key
    assert ref["full_phases"] > 0 and ref["light_phases"] > 0
    crashed = resumed["crashed"].engine.phases
    assert list(resumed["phases"]) == [crashed["full"], crashed["light"]]
    assert 0.0 < resumed["clocks"][0] <= resumed["interrupted_s"]
    assert np.isnan(resumed["clocks"][1])  # no device window on the CPU
    assert res["elapsed_s"] >= resumed["interrupted_s"]
    assert res["elapsed_s"] > resumed["clocks"][0]
    assert res["device_s"] is None and res["photon_rate"] == res["n_created"] / res["elapsed_s"]


def test_checkpoint_refuses_mismatched_setup(dump, tmp_path):
    ck = str(tmp_path / "mismatch.npz")
    sim = _make_sim(dump)
    sim.save_checkpoint(ck, 1, sim.engine.fresh_state())
    other = _make_sim(dump, photon_n=61)
    with pytest.raises(ValueError, match="different run setup"):
        other.load_checkpoint(ck)
    ref = _make_sim(dump, config=profiles.reference_config(pool=256, dtype=torch.float64))
    with pytest.raises(ValueError, match="different run setup"):
        ref.load_checkpoint(ck)


def test_checkpoint_round_trips_state_spectrum_and_generator(dump, tmp_path):
    ck = str(tmp_path / "round.npz")
    sim = _make_sim(dump)
    sim.plan()
    state = sim.engine.fresh_state()
    state = sim.engine.periodic_phase(state, sim.emit_rows(0, 512))
    state = sim.engine.hot_step(state)._replace(it=7)
    sim.spec_acc[3, 1] = 2.5
    sim._warm_counts = (11, 13)
    sim.save_checkpoint(ck, 3, state)
    u_ref = torch.rand(5, generator=sim.gen, dtype=torch.float64)

    other = _make_sim(dump)
    waves_done, got = other.load_checkpoint(ck)
    assert waves_done == 3 and got.it == 7 and other._warm_counts == (11, 13)
    assert other.spec_acc[3, 1] == 2.5
    flat_got, flat_ref = driver._flat_state(got), driver._flat_state(state)
    assert flat_got.keys() == flat_ref.keys()
    for name, ref in flat_ref.items():
        assert flat_got[name].dtype == ref.dtype and torch.equal(flat_got[name], ref), name
    assert int(state.pool.occupied.sum()) > 0 and isinstance(got.pool, engine.Pool)
    assert torch.equal(torch.rand(5, generator=other.gen, dtype=torch.float64), u_ref)


def test_checkpoint_refuses_another_dtype(dump, tmp_path):
    """A float32 checkpoint resumed into a float64 run (the same setup
    otherwise) is refused before any state loads: the file names the dtype
    in its setup, and the sharded run's rank files carry the same fields."""
    from grmonty_tpu_torch.parallel import sharding

    ck = str(tmp_path / "f32.npz")
    f32 = profiles.bench_config(pool=256, dtype=torch.float32)._replace(
        m_period=8, sec_cap=4096, stall_steps=5000)
    sim = _make_sim(dump, config=f32)
    sim.save_checkpoint(ck, 1, sim.engine.fresh_state())
    assert sim.checkpoint_setup(ck)[-1] == 32
    other = _make_sim(dump)
    gen_before = other.gen.get_state()
    refused = r"different run setup: .*/dtype \(.*, 32\) != \(.*, 64\)"
    with pytest.raises(ValueError, match=refused):
        other.load_checkpoint(ck)
    assert torch.equal(other.gen.get_state(), gen_before)
    with pytest.raises(ValueError, match=refused):
        other.run(checkpoint_path=ck)
    assert not other.spec_acc.any() and other.pilot is None
    assert os.path.exists(ck)
    assert sharding.ShardedSimulation.SETUP_FIELDS == (
        driver.Simulation.SETUP_FIELDS + ("world_size", "rank"))
    assert "dtype" in sharding.ShardedSimulation.SETUP_FIELDS
