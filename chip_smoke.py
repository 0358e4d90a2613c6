#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--photon-n 1e5]     # --photon-n 1e6 for the long run

Phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the two hot-step kernels from ``grmonty_tpu_torch/csrc`` (nvcc);
3. generate the 256x256 synthetic torus into ``.cache/`` with the port's
   writer and build the per-dump tables on the card;
4. kernel A and kernel B against their plain PyTorch versions at
   N = 65,536 on synthetic lane states (seeded numpy; the rows come from
   the torus's derived table), on every lane: kernel A exactly equal,
   kernel B within the Pallas-vs-XLA parity contract
   (``hot_kernels.KERNEL_TOLERANCE``), with the time per call of kernel and
   plain when the host calls them back to back (``ms``, ``plain_ms``, CUDA
   events) and the kernel's device time per launch (``device_ms``: launches
   queued behind a GPU sleep, so the host's launch cost is hidden; the
   plain versions launch too many kernels per call to queue that way);
5. the slice end to end with the shipped profile at M = 4e19, seed 123,
   float32, pool 65,536: every hot step must go through both kernels, the
   spectrum must be finite with a photon count equal to ``n_recorded``, no
   secondary may be dropped, and the luminosity must lie within 10% of the
   JAX engine's 12694.3 on the same torus and seed.

The last three lines of standard output are the card's name and power
limit, one JSON object describing the kernels, and the result line.
"""

import argparse
import json
import logging
import math
import os
import subprocess
import sys
import time

REF_LUMINOSITY = 12694.3  # JAX engine, 256x256 torus, M=4e19, seed 123
N_CHECK = 65536
REPS = 20
TOLERANCE = {
    "hot_phase_a": "exactly equal on every lane",
    "hot_phase_b": "masks and integers differ on at most 0.1% of lanes; floats within "
                   "rtol 1e-4 atol 1e-6 on every lane",
}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS, queued=False):
    """Mean milliseconds per call of ``fn`` by CUDA events, after a warm-up;
    the host's launch pace is part of the time.  ``queued``: the calls are
    enqueued while the stream runs a GPU sleep, so the events time the
    device's work alone; the sleep is lengthened until it outlasts the
    enqueueing.  ``fn`` must launch few kernels: the device queues about a
    thousand launches, and the host blocks beyond that."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 26  # ~35 ms at 1.98 GHz
    for _ in range(4):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        covered = not t0.query()
        t1.synchronize()
        if covered or not queued:
            return t0.elapsed_time(t1) / reps
        cycles *= 4
    fail("the GPU sleep never outlasted the enqueueing of the timed calls")


def make_simulation(root, photon_n):
    """The smoke cell's ``Simulation`` on the card: the 256x256 synthetic
    torus (written into ``root/.cache`` once), M = 4e19, seed 123, float32,
    the shipped profile at pool 65,536."""
    import torch

    from grmonty_tpu_torch.models import torus
    from grmonty_tpu_torch.transport import driver, profiles

    cache = os.path.join(root, ".cache")
    os.makedirs(cache, exist_ok=True)
    dump = os.path.join(cache, "torus_256x256_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=256, n2=256)
    pool = 65536
    cfg = profiles.bench_config(pool=pool, dtype=torch.float32)
    return driver.Simulation(dump, photon_n=int(photon_n), mass_unit=4.0e19, seed=123,
                             config=cfg, device="cuda", **profiles.bench_sim_kwargs(pool))


def kernel_checks(sim):
    """Phase 4: kernels A and B vs their plain versions at N_CHECK lanes."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    mc, cfg, tabs = sim.mc, sim.cfg, sim.tables
    dev, f32 = sim.device, torch.float32
    lanes = hot_kernels.synthetic_lanes(mc, N_CHECK, 2024, cfg.stall_steps)

    def t(v):
        if isinstance(v, tuple):
            return tuple(t(c) for c in v)
        a = torch.as_tensor(v, device=dev)
        return a if a.dtype in (torch.bool, torch.int32) else a.to(f32)

    s = {k: t(v) for k, v in lanes.items() if k != "bias_scale"}
    bias_scale = torch.tensor(lanes["bias_scale"], dtype=f32, device=dev)
    a_args = (s["x"], s["k"], s["dkdlam"], s["e_0_s"], s["dl_shrink"], s["pend_dl"],
              s["pend_push"], s["at_event"], s["alive"], s["w"], s["record_pending"],
              s["u_roul"], s["alpha_scatti"], s["bi"], mc, cfg.grow_cap)
    plain_a = lambda: engine.hot_phase_a(*a_args)  # noqa: E731
    kern_a = lambda: hot_kernels.phase_a(*a_args)  # noqa: E731
    ref_a = plain_a()
    got_a = kern_a()
    torch.cuda.synchronize()

    A = ref_a
    b_tail = (A["x"], A["k"], A["dkdlam"], A["e_0_s"], A["w"], s["alpha_scatti"],
              s["alpha_absi"], s["bi"], s["tau_abs"], s["tau_scatt"], s["interacting"],
              A["pend_dl"], A["pend_push"], s["sec_w"], s["n_step"], A["alive"],
              s["x"], s["k"], s["dkdlam"], s["e_0_s"], A["seg"], A["commit"],
              A["moving"], A["was_pend"], A["stopped"], s["u_x1"], A["grown"], bias_scale,
              mc, tabs.hc_coeffs, tabs.k2_coeffs, cfg.stall_steps)
    plain_b = lambda: engine.hot_phase_b(tabs.hot_tab[A["z"].long()], *b_tail)  # noqa: E731
    kern_b = lambda: hot_kernels.phase_b(tabs.hot_tab, A["z"], *b_tail)  # noqa: E731
    ref_b = plain_b()
    got_b = kern_b()
    torch.cuda.synchronize()

    out = []
    for name, ref, got, plain, kern, line in (
            ("hot_phase_a", ref_a, got_a, plain_a, kern_a, 104),
            ("hot_phase_b", ref_b, got_b, plain_b, kern_b, 152)):
        err, rel, mask, fails = hot_kernels.compare(ref, got,
                                                    **hot_kernels.KERNEL_TOLERANCE[name])
        # plain, kernel, kernel, plain: one pair of each per call, averaged
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
        device_ms = cuda_ms(kern, queued=True)
        rec = {"name": name, "route": "cuda", "source": "grmonty_tpu_torch/csrc/hot_step.cu",
               "replaces": f"grmonty_tpu/transport/hotstep_pallas.py:{line}",
               "max_abs_err": err, "max_rel_err": rel, "mask_mismatch": mask,
               "tolerance": TOLERANCE[name],
               "ms": 0.5 * (k1 + k2), "plain_ms": 0.5 * (p1 + p2),
               "device_ms": device_ms, "n": N_CHECK}
        print(f"kernel check {name}: {json.dumps(rec)}")
        if fails:
            fail(f"{name} disagrees with its plain version: " + "; ".join(fails))
        out.append(rec)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--photon-n", type=float, default=1e5)
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from grmonty_tpu_torch.transport import hot_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    path, build_s, log = hot_kernels.build()
    print(f"kernel build: {build_s:.1f} s -> {os.path.relpath(path, root)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    t0 = time.monotonic()
    sim = make_simulation(root, args.photon_n)
    torch.cuda.synchronize()
    print(f"torus + tables: {time.monotonic() - t0:.1f} s")

    kernels = kernel_checks(sim)

    hot_kernels.reset_launches()
    spec, stats = sim.run()
    counts = dict(hot_kernels.launches)
    rows = sim.report(os.path.join(root, ".cache", "chip_smoke_spectrum"))
    lum = rows["luminosity"]
    n_ph = float(spec[:, 2].sum())
    result = {
        "photon_n": int(args.photon_n), "n_created": stats["n_created"],
        "n_tracked": stats["n_tracked"], "n_recorded": stats["n_recorded"],
        "luminosity": lum, "lum_ratio": lum / REF_LUMINOSITY,
        "rate_device": stats["photon_rate_device"], "rate_wall": stats["photon_rate"],
        "device_s": stats["device_s"], "elapsed_s": stats["elapsed_s"],
        "steps_per_photon": stats["steps_per_photon"],
        "n_sec_drop": stats["n_secondary_dropped"], "n_stall": stats["n_stall_killed"],
        "n_hc_clamp": stats["n_hc_clamp"], "hot_iters": stats["hot_iters"],
        "launches_a": counts["hot_phase_a"], "launches_b": counts["hot_phase_b"],
        "util": [stats.get(k) for k in ("util_occupied", "util_moving",
                                         "util_committed", "util_parked")],
        "max_tau_scatt": stats["max_tau_scatt"], "spectrum_photons": n_ph,
    }
    print(json.dumps(result))

    if not (counts["hot_phase_a"] == counts["hot_phase_b"] == stats["hot_iters"] > 0):
        fail(f"kernel launches {counts} != hot iterations {stats['hot_iters']}")
    if not bool(torch.isfinite(torch.as_tensor(spec)).all()):
        fail("spectrum has non-finite entries")
    if n_ph != stats["n_recorded"]:
        fail(f"spectrum photon count {n_ph} != n_recorded {stats['n_recorded']}")
    if stats["n_secondary_dropped"] != 0:
        fail(f"{stats['n_secondary_dropped']} secondaries dropped")
    if not (math.isfinite(lum) and abs(lum / REF_LUMINOSITY - 1.0) <= 0.10):
        fail(f"luminosity {lum} not within 10% of {REF_LUMINOSITY}")

    for rec in kernels:
        rec["launches"] = counts[rec["name"]]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
