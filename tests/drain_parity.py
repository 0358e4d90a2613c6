"""The long float64 reference drain: the port's engine against the JAX
engine and the native tracker on the CPU, on one setup and several seeds.

    python tests/drain_parity.py [--seeds 123,124,125] [--photons 200] \
        [--json drain_parity.json]
    python3 tests/drain_parity.py --trackers port --device cuda --seeds 1-40   # the card

The setup of ROADMAP Queue 3 item 3: the 64x32 torus, M = 4e19, reference
semantics (the port's ``profiles.reference_config``, the JAX
``bench_config(ref_mode=True)``), pool 1,024, float64, the bias live on
every side.  Each seed runs up to three trackers (``--trackers``) on the
same photons: the native tracker (``Simulation.run_native_cpu``, the
port's ``--backend cpu``), the port's engine (on ``--device``: the CPU,
or the card, where its hot steps draw their uniforms in the kernel) and
the JAX engine on the CPU.  One JSON line a (seed, tracker): the hot
iterations, the cascade's stages and the photons killed at the step cap
(the engines), the records, the recorded scatters, ``max_tau_scatt`` and
the luminosity; then one summary line: each engine's records and
luminosity over the native tracker's where it ran, and each engine's
hot iterations and step-cap kills over the seeds.

``--jax-slice-iters`` sets the JAX driver's dispatch slice (8,192 in its
profile; the JAX engine's random stream depends on it) and
``--trace-tail`` prints, after each slice of the JAX tail cascade, its
occupied lane with the most steps: position, wave vector and null
residual |k.k| / |k^0 k_0| (the metric from the port's
``geometry.gcov_c``; 0 for a photon).

This module imports the JAX package only to run the JAX engine (the card's
machine has no JAX); it is not a test (pytest does not collect it)
because one JAX seed takes minutes.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

POOL = 1024
MASS_UNIT = 4.0e19


def torus_dump(root):
    from grmonty_tpu_torch.models import torus

    path = os.path.join(root, "torus_64x32_dump")
    if not os.path.exists(path):
        torus.write_torus_dump(path, n1=64, n2=32)
    return path


def run_port(dump, photons, seed, out_dir, native=False, device="cpu"):
    import torch

    from grmonty_tpu_torch.transport import driver, profiles

    sim = driver.Simulation(dump, photon_n=photons, mass_unit=MASS_UNIT, seed=seed,
                            config=profiles.reference_config(pool=POOL, dtype=torch.float64),
                            device=device, **profiles.reference_sim_kwargs(POOL))
    spec, st = sim.run_native_cpu() if native else sim.run()
    rows = sim.report(os.path.join(out_dir, f"spec_port_{native}_{seed}"), spec)
    rec = {k: st.get(k) for k in ("n_created", "n_recorded", "n_scatt_recorded",
                                  "max_tau_scatt", "hot_iters", "n_stall_killed",
                                  "w_stall_frac", "steps_per_photon")}
    if not native:
        rec["tail_stages"] = [[s["pool"], s["iters"]] for s in st["tail_stages"]]
    return rec, rows["luminosity"]


def null_residual(x1, x2, k):
    """|k.k| / |k^0 k_0| of the wave vector ``k`` at (x1, x2) (floats)."""
    import torch

    from grmonty_tpu_torch.models import harm
    from grmonty_tpu_torch.ops import fluid, geometry

    mc = fluid.make_model_consts(harm.read_dump(null_residual.dump, MASS_UNIT))
    t = lambda v: torch.tensor([v], dtype=torch.float64)  # noqa: E731
    g00, g01, g03, g11, g13, g22, g33 = (float(c) for c in geometry.gcov_c(
        t(x1), t(x2), mc.a, mc.h_slope, mc.r_0))
    k0, k1, k2, k3 = k
    kk = (g00 * k0 * k0 + 2 * g01 * k0 * k1 + 2 * g03 * k0 * k3 + g11 * k1 * k1
          + 2 * g13 * k1 * k3 + g22 * k2 * k2 + g33 * k3 * k3)
    return abs(kk) / max(abs(k0 * (g00 * k0 + g01 * k1 + g03 * k3)), 1e-300)


def trace_tail(driver_mod, engine_mod):
    """The JAX driver's ``_drain_tail`` with a line after each slice: the
    occupied lane with the most steps (a copy of its loop; the JAX package
    is not changed)."""
    import jax
    import jax.numpy as jnp

    def lane_line(tag, pool):
        ns, occ = np.asarray(pool.n_step), np.asarray(pool.occupied)
        if not occ.any():
            return print(json.dumps({"tail": tag, "occupied": 0}), flush=True)
        i = int(np.argmax(np.where(occ, ns, -1)))
        x = [float(np.asarray(c)[i]) for c in pool.x]
        k = [float(np.asarray(c)[i]) for c in pool.k]
        print(json.dumps({"tail": tag, "occupied": int(occ.sum()), "lane": i,
                          "n_step": int(ns[i]), "r": float(np.exp(x[1])), "x2": x[2], "k": k,
                          "null_residual": null_residual(x[1], x[2], k),
                          "n_scatt": int(np.asarray(pool.n_scatt)[i])}), flush=True)

    def _drain_tail(self, state):
        sizes = self._tail_sizes()
        zero_backlog = jnp.zeros((1, engine_mod.ROW_WIDTH), self.cfg.dtype)
        for si, n_t in enumerate(sizes):
            exit_occ = sizes[si + 1] if si + 1 < len(sizes) else 0
            _, run = self._tail_engine(n_t, exit_occ)
            gather_fn, merge_fn, census = self._drain_jits(n_t)
            while True:
                occ_n, sec_n = (int(v) for v in jax.device_get(census(state.pool, state.sec)))
                if occ_n <= exit_occ and sec_n == 0:
                    break
                small, wide = gather_fn(state.pool)
                tstate = engine_mod.State(
                    pool=small, spec=state.spec, counters=state.counters, sec=state.sec,
                    backlog_pos=jnp.zeros((), jnp.int32), key=state.key,
                    it=jnp.zeros((), jnp.int32))
                tstate, sl = run(tstate, zero_backlog), 0
                while True:
                    t_occ, t_sec = (int(v) for v in jax.device_get(
                        census(tstate.pool, tstate.sec)))
                    lane_line(f"pool {n_t} slice {sl}", tstate.pool)
                    if t_occ <= exit_occ and t_sec == 0:
                        break
                    sl += 1
                    tstate = run(tstate._replace(it=jnp.zeros((), jnp.int32)), zero_backlog)
                state = state._replace(pool=merge_fn(wide, tstate.pool), spec=tstate.spec,
                                       counters=tstate.counters, sec=tstate.sec,
                                       key=tstate.key)
        return state

    driver_mod.Simulation._drain_tail = _drain_tail


def run_jax(dump, photons, seed, out_dir, slice_iters=None, traced=False):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from grmonty_tpu.transport import driver, profiles
    from grmonty_tpu.transport import engine as engine_mod

    if traced:
        null_residual.dump = dump
        trace_tail(driver, engine_mod)
    cfg = profiles.bench_config(pool=POOL, dtype=jnp.float64, ref_mode=True, env={})
    kw = profiles.bench_sim_kwargs(POOL, ref_mode=True, env={})
    if slice_iters:
        kw["slice_iters"] = slice_iters
    sim = driver.Simulation(dump, photon_n=photons, mass_unit=MASS_UNIT, seed=seed,
                            config=cfg, **kw)
    spec, st = sim.run()
    rows = sim.report(os.path.join(out_dir, f"spec_jax_{seed}"), spec)
    rec = {k: st.get(k) for k in ("n_created", "n_recorded", "n_scatt_recorded",
                                  "max_tau_scatt", "hot_iters", "n_stall_killed",
                                  "w_stall_frac", "steps_per_photon")}
    return rec, rows["luminosity"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="123,124,125",
                    help="comma-separated seeds, or a range a-b")
    ap.add_argument("--photons", type=int, default=200)
    ap.add_argument("--trackers", default="native,port,jax")
    ap.add_argument("--device", default="cpu", help="the port's engine's device")
    ap.add_argument("--jax-slice-iters", type=int, default=None,
                    help="the JAX driver's dispatch slice (its profile's 8,192 when unset)")
    ap.add_argument("--trace-tail", action="store_true",
                    help="a line per slice of the JAX tail cascade: its longest-running lane")
    ap.add_argument("--json", default=None, help="also write the lines here")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out_dir = tempfile.mkdtemp(prefix="drain_parity_")
    dump = torus_dump(out_dir)
    if "-" in args.seeds:
        lo, hi = (int(v) for v in args.seeds.split("-"))
        seeds = list(range(lo, hi + 1))
    else:
        seeds = [int(v) for v in args.seeds.split(",")]
    trackers = args.trackers.split(",")
    run = {"native": lambda seed: run_port(dump, args.photons, seed, out_dir, True),
           "port": lambda seed: run_port(dump, args.photons, seed, out_dir, device=args.device),
           "jax": lambda seed: run_jax(dump, args.photons, seed, out_dir,
                                       args.jax_slice_iters, args.trace_tail)}
    lines, got = [], {t: [] for t in trackers}
    for seed in seeds:
        for tracker in trackers:
            t0 = time.monotonic()
            rec, lum = run[tracker](seed)
            got[tracker].append((rec, lum))
            line = {"seed": seed, "tracker": tracker, "photons": args.photons, **rec,
                    "luminosity": lum, "seconds": time.monotonic() - t0}
            if tracker == "port":
                line["device"] = args.device
            if tracker == "jax":
                line["slice_iters"] = args.jax_slice_iters or 8192
            lines.append(line)
            print(json.dumps(line), flush=True)
    summary = {"summary": True, "seeds": seeds, "photons": args.photons}
    for eng in ("port", "jax"):
        if eng not in got:
            continue
        recs = got[eng]
        out = {"hot_iters": [r["hot_iters"] for r, _ in recs],
               "n_stall_killed": [r["n_stall_killed"] for r, _ in recs],
               "seeds_with_a_stall_kill": sum(1 for r, _ in recs if r["n_stall_killed"])}
        if "native" in got:
            arr = np.asarray([(r["n_recorded"] / max(n["n_recorded"], 1), lum / n_lum)
                              for (r, lum), (n, n_lum) in zip(recs, got["native"])])
            out.update(rec_over_native=arr[:, 0].tolist(), lum_over_native=arr[:, 1].tolist(),
                       rec_mean=float(arr[:, 0].mean()), lum_mean=float(arr[:, 1].mean()),
                       rec_std=float(arr[:, 0].std(ddof=1)) if len(arr) > 1 else None,
                       lum_std=float(arr[:, 1].std(ddof=1)) if len(arr) > 1 else None)
        summary[eng] = out
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main()
