"""The full scatter-sampling chain by distribution: the engine's deferring
samplers against the native scalar ones.

    python -m grmonty_tpu_torch.tools.probe_scatter_dist [out.json]   # PROBE_N (40,000)

Port of the JAX package's ``tools/probe_scatter_dist.py``, with its names
and keys.  Per (theta_e, k0) cell of the 3 x 3 grid theta_e in {2, 8, 20}
x k0 in {1e-6, 1e-3, 1e-1}, ``PROBE_N`` photons of tetrad-frame wave
vector (k0, k0, 0, 0) scatter through the complete chain (electron draw ->
boost -> Klein-Nishina energy -> angle -> boost back), and the
amplification A = k'_tet[0] / k0 is compared:

* :func:`engine_chain`: the engine's samplers with their round caps
  (``hot_kernels.scatter_chain``: on the card one launch of the
  ``scatter_chain_f64`` kernel of ``csrc/scatter_event.cu`` a phase, its
  Philox key drawn from one ``torch.Generator``; on the CPU the plain
  ``ops.proba.sample_electron_distr_p_c`` then ``ops.scattering.
  sample_scattered_photon_c`` from that generator), in float64 on
  ``device``; a lane whose draw was not accepted within the caps redraws
  in the next of up to 64 phases, as a deferred scatter event does in the
  engine's event phase (without its theta_e halving or forcing, which the
  engine applies only after 16 and 32 defers);
* :func:`oracle_chain`: the native tracker's scalar samplers
  (``NativeTracker.sample_electron`` / ``sample_scattered``), the
  transcriptions of the reference's nested rejection loops.

Each cell (:func:`cell`) gives both sides' :func:`stats` (mean, quantiles
0.5 / 0.9 / 0.99 / 0.999, P(A > 10), P(A > 100)) and the ratios
``mean_ratio``, ``q99_ratio`` and ``p10_ratio`` (None where the oracle's
P(A > 10) is at most 1e-4), and :func:`ratio_errors` the Monte Carlo
standard errors of the first two.  :func:`main` runs on the card only
(with no CUDA device it exits 2), prints one JSON line per cell and writes
``{"cells": [...], "ratio_errors": [...], "card": ..., "n": ...,
"seconds": ...}`` to ``argv[1]`` when given.
"""

import json
import math
import os
import sys
import time

import numpy as np
import torch

from grmonty_tpu_torch.transport import hot_kernels

THETAS = (2.0, 8.0, 20.0)
K0S = (1e-6, 1e-3, 1e-1)
PHASES = 64  # defer-and-redraw phases, far beyond the observed depth
ENGINE_SEED = 11
ORACLE_SEED = 77


def engine_chain(theta_e, k0, n, seed, device="cpu"):
    """The amplified energies k'_tet[0] of ``n`` photons through the
    engine's deferring chain (fresh draws each phase, the engine's caps);
    the lanes that never accepted are left out."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def full(v):
        return torch.full((n,), v, dtype=torch.float64, device=device)

    k_tet = (full(k0), full(k0), full(0.0), full(0.0))
    th = full(theta_e)
    out = np.zeros(n)
    done = np.zeros(n, bool)
    for _ in range(PHASES):
        res = hot_kernels.scatter_chain(k_tet, th, gen=gen)
        ok = (res.ok_el & res.ok_kn).cpu().numpy()
        take = ok & ~done
        out[take] = res.k_tet_p[0].cpu().numpy()[take]
        done |= take
        if done.all():
            break
    return out[done]


def oracle_chain(native, theta_e, k0, n, seed):
    """The amplified energies of ``n`` photons through the native scalar
    samplers: ``n`` electrons, then one scattered photon off each."""
    k_tet = np.array([k0, k0, 0.0, 0.0])
    electrons = native.sample_electron(k_tet, theta_e, n, seed=seed)
    out = np.empty(n)
    for i in range(n):
        out[i] = native.sample_scattered(k_tet, electrons[i], 1, seed=seed + 1 + i)[0, 0]
    return out


def stats(a, k0):
    """Amplification moments, quantiles and tail probabilities."""
    amp = a / k0
    qs = np.quantile(amp, [0.5, 0.9, 0.99, 0.999])
    return {
        "mean_amp": float(amp.mean()),
        "q50": float(qs[0]), "q90": float(qs[1]),
        "q99": float(qs[2]), "q999": float(qs[3]),
        "p_amp_gt10": float((amp > 10).mean()),
        "p_amp_gt100": float((amp > 100).mean()),
        "n": int(amp.size),
    }


def native_tracker(device="cpu"):
    """The native tracker on the 64x32 synthetic torus (M = 4e19), from a
    small ``Simulation`` on ``device``, as the JAX tool builds it."""
    from grmonty_tpu_torch.tools import validate_accuracy
    from grmonty_tpu_torch.transport import driver, engine
    from grmonty_tpu_torch.transport.oracle_native import NativeTracker

    sim = driver.Simulation(
        validate_accuracy._torus(64, 32), photon_n=100, mass_unit=4e19,
        config=engine.EngineConfig(n_pool=64, m_period=8, sec_cap=256), device=device,
        emit_chunk=256, warmup=0)
    return NativeTracker(sim.mc, sim.model.data.stacked(), seed=3)


def ratio_errors(e, o):
    """One Monte Carlo standard error of ``mean_ratio`` and ``q99_ratio``
    for the amplified energies ``e`` (engine) and ``o`` (oracle): the
    means' from the samples' variances; each 99th percentile's
    distribution-free, half the spread of the quantiles one binomial
    standard error of rank to either side (0.99 -+ sqrt(0.99 * 0.01 / n))."""
    def q99_rel(a):
        d = math.sqrt(0.99 * 0.01 / a.size)
        lo, q, hi = np.quantile(a, [0.99 - d, 0.99, 0.99 + d])
        return 0.5 * (hi - lo) / q

    mean_rel = math.hypot(e.std() / (e.mean() * math.sqrt(e.size)),
                          o.std() / (o.mean() * math.sqrt(o.size)))
    return {"mean_ratio": e.mean() / o.mean() * mean_rel,
            "q99_ratio": (np.quantile(e, 0.99) / np.quantile(o, 0.99)
                          * math.hypot(q99_rel(e), q99_rel(o)))}


def summarize(theta_e, k0, e, o):
    """The cell of the amplified energies ``e`` (engine) and ``o``
    (oracle): both sides' stats and their ratios."""
    se, so = stats(e, k0), stats(o, k0)
    return {"theta_e": theta_e, "k0": k0, "engine": se, "oracle": so,
            "mean_ratio": se["mean_amp"] / max(so["mean_amp"], 1e-300),
            "q99_ratio": se["q99"] / max(so["q99"], 1e-300),
            "p10_ratio": (se["p_amp_gt10"] / max(so["p_amp_gt10"], 1e-300)
                          if so["p_amp_gt10"] > 1e-4 else None)}


def cell(native, theta_e, k0, n, device="cpu"):
    """One (theta_e, k0) cell at ``n`` photons with the probe's seeds."""
    return summarize(theta_e, k0, engine_chain(theta_e, k0, n, ENGINE_SEED, device),
                     oracle_chain(native, theta_e, k0, n, ORACLE_SEED))


def measure(n, device, out=print):
    """Every cell of the grid at ``n`` photons on ``device``, each passed to
    ``out`` as a JSON line when it is done; returns (the cells, their
    :func:`ratio_errors`)."""
    native = native_tracker(device)
    cells, errors = [], []
    for theta_e in THETAS:
        for k0 in K0S:
            e = engine_chain(theta_e, k0, n, ENGINE_SEED, device)
            o = oracle_chain(native, theta_e, k0, n, ORACLE_SEED)
            cells.append(summarize(theta_e, k0, e, o))
            errors.append(ratio_errors(e, o))
            out(json.dumps(cells[-1]))
    return cells, errors


def main():
    from grmonty_tpu_torch.tools import card, require_cuda

    require_cuda("probe_scatter_dist")
    n = int(os.environ.get("PROBE_N", "40000"))
    t0 = time.monotonic()
    cells, errors = measure(n, torch.device("cuda"), out=lambda line: print(line, flush=True))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump({"cells": cells, "ratio_errors": errors, "card": card(), "n": n,
                       "seconds": time.monotonic() - t0}, f, indent=2)


if __name__ == "__main__":
    main()
