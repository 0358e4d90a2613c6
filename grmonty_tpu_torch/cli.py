"""Command-line entry point of the PyTorch/CUDA port.

Port of ``grmonty_tpu/cli.py`` (the reference's ``main.cpp:19-56``): the same
five flags with the same defaults (``--photon_n``, ``--mass_unit``,
``--harm_dump_path``, ``--spectrum_path``, ``--verbosity``), driving read ->
init -> run -> report::

    python -m grmonty_tpu_torch --harm_dump_path DUMP [--photon_n 5e6] ...

The run is the shipped profile (``profiles.bench_config`` and
``bench_sim_kwargs`` at ``--pool`` lanes) or, with ``--reference``,
reference semantics (``reference_config``, ``reference_sim_kwargs``): that
one switch stands in for the JAX flags ``--grow_cap``, ``--detach``,
``--no-cdf_sampler`` and ``--period``.  It runs on the CUDA card unless
``--device cpu`` asks for the CPU, in float32 (the shipped profile's dtype,
the default) or with ``--dtype float64`` in double precision (the JAX
package's parity dtype), on the card through the float64 instantiations
of the hand-written kernels.  ``--backend cpu`` tracks with the native
scalar tracker instead of the engine.  ``--devices N`` (N > 1) shards the photon
plan over N ranks (``parallel/sharding.py``): N cards under NCCL, or with
``--device cpu`` N CPU processes under gloo; rank 0 writes the spectrum.
"""

import argparse
import contextlib
import os
import sys


def build_parser():
    p = argparse.ArgumentParser(
        prog="grmonty-tpu-torch",
        description="General-relativistic Monte Carlo radiative transport on PyTorch/CUDA",
    )
    p.add_argument("--photon_n", type=float, default=5_000_000,
                   help="estimate of the number of superphotons to emit")
    p.add_argument("--mass_unit", type=float, default=4.0e19,
                   help="mass unit [g] scaling the dump's density")
    p.add_argument("--harm_dump_path", type=str, required=True,
                   help="path to the HARM dump file")
    p.add_argument("--spectrum_path", type=str, default="spectrum",
                   help="output spectrum file path")
    p.add_argument("--verbosity", type=str, default="info",
                   help="log level: trace|debug|info|warn|err|critical|off")
    p.add_argument("--pool", type=int, default=16384, help="photon pool size (lanes)")
    p.add_argument("--seed", type=int, default=123, help="RNG seed")
    p.add_argument("--reference", action="store_true",
                   help="reference semantics (the ladder step control, parked scatter "
                   "events, the cumulative bias, raw corner rows, rejection emission in "
                   "plan order) instead of the shipped profile")
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "float64"],
                   help="transport dtype (float64: the reference's double precision, on "
                   "either device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the CUDA card)")
    p.add_argument("--backend", choices=("accel", "cpu"), default="accel",
                   help="'accel': the batched engine on --device (default); 'cpu': the "
                   "native scalar tracker on the host, emission on --device (the "
                   "reference CPU build's equivalent, harm_model.cpp:362-404)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="write a resume point here after the pilot and every wave, and "
                   "resume from it if it exists (a completed run deletes it)")
    p.add_argument("--devices", type=int, default=0,
                   help="shard the photon plan over this many ranks (0 or 1 = one device): "
                   "cards cuda:0..N-1, or CPU processes with --device cpu")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the run into this directory "
                   "(trace.json, for chrome://tracing or Perfetto)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from grmonty_tpu_torch.utils.logging import setup

    log = setup(args.verbosity)

    import torch

    from grmonty_tpu_torch.transport import driver, profiles

    device = torch.device(args.device)
    dtype = torch.float32 if args.dtype == "float32" else torch.float64
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    if args.backend == "cpu" and args.checkpoint:
        raise SystemExit("--checkpoint applies to the engine only (a --backend cpu run "
                         "restarts by running again)")
    if args.reference:
        cfg = profiles.reference_config(pool=args.pool, dtype=dtype)
        kw = profiles.reference_sim_kwargs(args.pool)
    else:
        cfg = profiles.bench_config(pool=args.pool, dtype=dtype)
        kw = profiles.bench_sim_kwargs(args.pool)
    if args.devices > 1:
        return _main_sharded(args, device, cfg, kw, log)
    sim = driver.Simulation(args.harm_dump_path, photon_n=int(args.photon_n),
                            mass_unit=args.mass_unit, seed=args.seed, config=cfg,
                            device=device, **kw)
    prof = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        prof = profile(activities=acts)
    with prof:
        if args.backend == "cpu":
            spec, stats = sim.run_native_cpu()
        else:
            spec, stats = sim.run(checkpoint_path=args.checkpoint or None)
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    sim.report(args.spectrum_path, spec)
    log.info("Super photons: created %d, recorded %d", stats["n_created"],
             stats["n_recorded"])
    log.info("Done: %.0f photons/s; kernel build %.3g s", stats["photon_rate"],
             stats["compile_s"])
    if stats.get("device_s") is not None:
        log.info("Engine: %d hot iterations, %d full and %d light phases, %d blocks in %d "
                 "graph replays (%d ran none; capture %.3g s); device window %.6g s, %.6g "
                 "photons/s",
                 stats["hot_iters"], stats["full_phases"], stats["light_phases"],
                 stats["bodies"], stats["replays"], stats["skipped_replays"],
                 stats["capture_s"], stats["device_s"],
                 stats["photon_rate_device"])
    return 0


def _main_sharded(args, device, cfg, kw, log):
    """``--devices N``: the run on N spawned ranks; rank 0 writes the spectrum."""
    from grmonty_tpu_torch.parallel import sharding

    if args.backend == "cpu":
        raise SystemExit("--backend cpu is single-process (the scalar tracker has no "
                         "sharded mode); drop --devices")
    if args.checkpoint:
        raise SystemExit("--checkpoint is not supported with --devices>1 (the sharded "
                         "run loop has its own drain logic)")
    if args.profile_dir:
        raise SystemExit("--profile_dir traces one process; drop --devices")
    try:
        sharding.check_devices(args.devices, device.type)
    except ValueError as exc:
        raise SystemExit(str(exc)) from None
    _, stats = sharding.run_sharded(
        args.harm_dump_path, args.devices, device.type, spectrum_path=args.spectrum_path,
        verbosity=args.verbosity, photon_n=int(args.photon_n), mass_unit=args.mass_unit,
        seed=args.seed, config=cfg, **kw)
    log.info("Super photons: created %d, recorded %d over %d ranks", stats["n_created"],
             stats["n_recorded"], stats["n_devices"])
    log.info("Done: %.0f photons/s; reduce %.3g s", stats["photon_rate"], stats["reduce_s"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
