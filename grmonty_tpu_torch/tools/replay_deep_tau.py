"""Deep-tau path replay: is the engine's deepest recorded optical depth the
true tail, or an artifact of grown steps?

    python -m grmonty_tpu_torch.tools.replay_deep_tau --bench-profile \\
        --photons 2000 --mass-unit 4e20 --seed 123 --json REPLAY_torch_M4e20.json
    python -m grmonty_tpu_torch.tools.replay_deep_tau   # reference semantics, float64
    python -m grmonty_tpu_torch.tools.replay_deep_tau --device cpu --bench-profile \\
        --photons 64 --pool 256

Port of the JAX package's ``tools/replay_deep_tau.py``, with its arguments,
keys and verdicts.  The engine runs with ``EngineConfig.trace_birth``: it
captures the birth state (x, k, w and the generation) of the photon that
holds the ``max_tau_scatt`` ratchet (``Counters.mt_*``).  Biased scattering
never deflects the parent and roulette only kills, so a photon's path is
fixed by its birth state: that state is replayed through the native
tracker's nominal-step integrator (reference stepping, no growth) at three
seeds, giving the reference-discretised optical depth of the same geodesic.
Where the engine grows its steps, it runs again at ``grow_cap`` 1 (nominal
steps) to triangulate.

Profiles (the JAX tool's, on the n1 x n2 synthetic torus, ``emit_chunk``
4,096, a 256-photon pilot, seed ``--seed``, ``--pool`` lanes, a 16,384-row
ring):

* default: reference semantics in float64, the JAX default's bare config
  (``profiles.reference_config`` at a 100,000-step cap, the full phase
  every 8 iterations); no step grows, so there is no nominal-step run;
* ``--bench-profile``: the shipped profile (float32, growth to 8) with the
  tail cascade of ``profiles.bench_sim_kwargs`` (its ``tail_grow_cap`` and
  ``tail_stall_steps``).  The nominal-step run keeps the JAX tool's
  ``tail_grow_cap`` of 16, so its cascade still grows its steps; the JSON
  records each run's wave and tail grow caps (``grow_caps``).

The engine runs on the card unless ``--device cpu``; the replays run on the
host.  Writes one JSON object (``--json``) and prints it.
"""

import argparse
import json
import time

import numpy as np

POOL = 1024
SEC_CAP = 16384
EMIT_CHUNK = 4096
PILOT = 256
REPLAY_SEEDS = (7, 101, 503)  # replay seeds, offsets from --seed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--photons", type=int, default=2000)
    ap.add_argument("--mass-unit", type=float, default=4e20)
    ap.add_argument("--n1", type=int, default=64)
    ap.add_argument("--n2", type=int, default=32)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--pool", type=int, default=POOL, help="the engine's lanes")
    ap.add_argument("--json", default=None)
    ap.add_argument("--bench-profile", action="store_true",
                    help="trace the shipped profile (float32, grown steps) instead of "
                         "reference semantics in float64")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config(args):
    """(EngineConfig, the Simulation's tail overrides) of ``args``'s
    profile, the birth trace on."""
    import torch

    from grmonty_tpu_torch.transport import profiles

    if args.bench_profile:
        cfg = profiles.bench_config(args.pool)._replace(sec_cap=SEC_CAP)
        kw = profiles.bench_sim_kwargs(args.pool)
        sim_kw = dict(tail_grow_cap=kw["tail_grow_cap"],
                      tail_stall_steps=kw["tail_stall_steps"])
    else:
        cfg = profiles.reference_config(args.pool, torch.float64, stall_steps=100000)
        cfg = cfg._replace(m_period=8, sec_cap=SEC_CAP)
        sim_kw = {}
    return cfg._replace(trace_birth=True), sim_kw


def run_engine(args, cfg, sim_kw, dump):
    """One traced engine run; returns (sim, stats, counters, seconds)."""
    import torch

    from grmonty_tpu_torch.transport import driver

    sim = driver.Simulation(dump, photon_n=args.photons, mass_unit=args.mass_unit,
                            config=cfg, device=args.device, emit_chunk=EMIT_CHUNK,
                            seed=args.seed, warmup=PILOT, **sim_kw)
    t0 = time.time()
    _, stats = sim.run()
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    return sim, stats, sim.state.counters, time.time() - t0


def _run_record(sim, stats, seconds):
    """What a reader needs of one engine run: its counts, windows and grow
    caps."""
    keys = ("n_created", "n_recorded", "hot_iters", "full_phases", "light_phases",
            "device_s", "compile_s", "n_stall_killed", "n_secondary_dropped")
    tail = sim.tail_grow_cap if sim.tail_grow_cap is not None else sim.cfg.grow_cap
    return {**{k: stats[k] for k in keys}, "seconds": seconds,
            "grow_caps": {"wave": sim.cfg.grow_cap, "tail": tail}}


def birth_photon(sim, c):
    """The captured birth state as a one-photon ``oracle_native.Photons``
    batch in float64 with an unscaled weight (at least 1), and the null
    residual |k.k| / |k_0 k^0| of its wave vector."""
    import torch

    from grmonty_tpu_torch.ops import fluid, geometry
    from grmonty_tpu_torch.transport import engine
    from grmonty_tpu_torch.transport.oracle_native import Photons

    mc = sim.mc
    bx = torch.as_tensor(np.asarray(c.mt_bx.cpu(), np.float64))[None, :]
    bk = np.asarray(c.mt_bk.cpu(), np.float64)
    g = geometry.gcov(bx, mc.a, mc.h_slope, mc.r_0)
    k_cov = g[0].numpy() @ bk
    e_ph, l_ph = -k_cov[0], k_cov[3]
    prims = torch.as_tensor(sim.model.data.stacked(), dtype=torch.float64)
    fs = fluid.get_fluid_params(bx, g, prims, mc)
    batch = Photons(
        x=bx.numpy(), k=bk[None, :],
        w=np.asarray([max(float(c.mt_bw) / engine.WEIGHT_SCALE, 1.0)]),
        e=np.asarray([e_ph]), l=np.asarray([l_ph]),
        n_e_0=fs.n_e.numpy(), theta_e_0=fs.theta_e.numpy(), b_0=fs.b.numpy(),
        e_0=np.asarray([e_ph]), n_scatt=np.asarray([int(c.mt_nsc0)], np.int32))
    return batch, abs(float(k_cov @ bk)) / max(abs(k_cov[0] * bk[0]), 1e-300)


def verdict(out):
    """The JAX tool's verdict from the engine/replay ratio and the
    nominal-step run."""
    if out["tau_ratio_engine_over_replay"] < 3.0:
        return "true-tail (replay reproduces the depth)"
    if out.get("engine_max_tau_nominal_steps", 0.0) > 10.0 * out["replay_max_tau"]:
        # the engine without step growth also reaches depths far beyond the
        # replay: growth is exonerated, and the per-photon replay is not
        # probative on chaotic near-photon-orbit trajectories
        return ("true-tail (nominal-step engine reaches comparable depth; per-photon "
                "replay non-probative on chaotic near-orbit trajectories)")
    return "stepping-artifact-suspected"


def run(args):
    """The traced run, the three replays and the nominal-step run; returns
    the JAX tool's JSON object (with ``device``, ``dtype``, ``pool``,
    ``runs``, ``mt_birth_null_residual`` and ``mt_birth_n_e``, the electron
    density at the birth position, added)."""
    import torch

    from grmonty_tpu_torch.tools.validate_accuracy import _device_record, _torus
    from grmonty_tpu_torch.transport.oracle_native import NativeTracker

    dump = _torus(args.n1, args.n2)
    cfg, sim_kw = config(args)
    sim, stats, c, t_eng = run_engine(args, cfg, sim_kw, dump)
    batch, null_res = birth_photon(sim, c)
    out = {
        "photons": args.photons,
        "mass_unit": args.mass_unit,
        "seed": args.seed,
        "bench_profile": bool(args.bench_profile),
        "device": _device_record(torch.device(args.device)),
        "dtype": str(cfg.dtype).removeprefix("torch."),
        "pool": cfg.n_pool,
        "engine_max_tau": float(c.max_tau_scatt),
        "engine_s": round(t_eng, 1),
        "mt_birth_x": batch.x[0].tolist(),
        "mt_birth_k": batch.k[0].tolist(),
        "mt_birth_w": float(c.mt_bw),
        "mt_birth_nsc0": int(c.mt_nsc0),
        "mt_birth_null_residual": null_res,
        "mt_birth_n_e": float(batch.n_e_0[0]),
        "runs": {"engine": _run_record(sim, stats, t_eng)},
    }

    prims = sim.model.data.stacked()
    replays = []
    for off in REPLAY_SEEDS:
        tr = NativeTracker(sim.mc, prims, seed=args.seed + off)
        t0 = time.time()
        tr.run(batch, progress_every=0)
        replays.append({"seed": args.seed + off, "replay_max_tau": float(tr.max_tau_scatt),
                        "n_recorded_family": int(tr.n_recorded),
                        "replay_s": round(time.time() - t0, 1)})
    out["replays"] = replays
    best = max(r["replay_max_tau"] for r in replays)
    out["replay_max_tau"] = best
    out["tau_ratio_engine_over_replay"] = float(c.max_tau_scatt) / max(best, 1e-300)

    if cfg.grow_cap > 1.0:
        # nominal steps in the waves; the tail keeps sim_kw's grow cap, as
        # the JAX tool's nominal run does
        sim1, stats1, c1, t1 = run_engine(args, cfg._replace(grow_cap=1.0), sim_kw, dump)
        out["engine_max_tau_nominal_steps"] = float(c1.max_tau_scatt)
        out["engine_nominal_s"] = round(t1, 1)
        out["runs"]["nominal"] = _run_record(sim1, stats1, t1)
    out["verdict"] = verdict(out)
    return out


def main(argv=None):
    args = parse_args(argv)
    from grmonty_tpu_torch.utils.logging import setup

    setup("info")
    out = run(args)
    text = json.dumps(out, indent=2)
    print(text)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
