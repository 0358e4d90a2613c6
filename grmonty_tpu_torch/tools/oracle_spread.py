"""The native oracle's spread over seeds on the accuracy gate's sample.

    python -m grmonty_tpu_torch.tools.oracle_spread --reference --device cpu \\
        --photons 10000 --mass-unit 4e19 --seed 123 --freeze-bias 0.0025 \\
        --first-seed 300 --n-seeds 100

The sample is the one ``validate_accuracy`` builds from the same arguments
(``validate_accuracy.gate_sample``); the native tracker then tracks it once
per seed ``--first-seed`` ... ``--first-seed + --n-seeds - 1`` (the gate's replicates
are seeds seed + 1 ... seed + R), with the frozen bias, in threads.  Prints
one JSON line per seed (``n_recorded``, ``max_tau_scatt`` and
``n_sec``, the secondaries the spectrum records) and a summary: the seeds
whose ``max_tau_scatt`` exceeds ``--explode-tau`` (a run whose bias
feedback met a cascade), and the median and spread of ``n_sec``.  This is
how one exploding replicate is told from a shifted median.
"""

import argparse
import concurrent.futures
import json
import os
import sys

import numpy as np


def main(argv=None):
    from grmonty_tpu_torch.tools import validate_accuracy

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    ap.add_argument("--first-seed", type=int, default=None,
                    help="the first tracker seed (default: the gate's, seed + 1)")
    ap.add_argument("--n-seeds", type=int, default=5, help="how many tracker seeds")
    ap.add_argument("--explode-tau", type=float, default=0.01,
                    help="a seed whose max_tau_scatt exceeds this exploded")
    own, rest = ap.parse_known_args(argv)
    args = validate_accuracy.parse_args(rest)
    if args.freeze_bias <= 0.0:
        sys.exit("oracle_spread: give --freeze-bias (a live bias makes seeds incomparable)")

    from grmonty_tpu_torch.transport import engine, oracle_native

    sim, rows = validate_accuracy.gate_sample(args)
    prims = sim.model.data.stacked()
    seed0 = args.seed + 1 if own.first_seed is None else own.first_seed

    def one(seed):
        tr = oracle_native.NativeTracker(sim.mc, prims, seed=seed,
                                         bias_fixed=(args.freeze_bias, args.freeze_avg))
        tr.run(oracle_native.photons_from_rows(rows, engine.WEIGHT_SCALE), progress_every=0)
        return {"seed": seed, "n_recorded": int(tr.n_recorded),
                "max_tau_scatt": float(tr.max_tau_scatt), "n_sec": float(tr.spec[..., 14].sum())}

    with concurrent.futures.ThreadPoolExecutor(max_workers=min(4, os.cpu_count() or 1)) as ex:
        runs = list(ex.map(one, range(seed0, seed0 + own.n_seeds)))
    for r in runs:
        print(json.dumps(r))
    n_sec = np.array([r["n_sec"] for r in runs])
    print(json.dumps({"photons": int(rows.shape[0]), "seeds": [seed0, seed0 + own.n_seeds - 1],
                      "exploded": [r["seed"] for r in runs if r["max_tau_scatt"] > own.explode_tau],
                      "explode_tau": own.explode_tau, "n_sec_median": float(np.median(n_sec)),
                      "n_sec_min": float(n_sec.min()), "n_sec_max": float(n_sec.max())}))


if __name__ == "__main__":
    main()
