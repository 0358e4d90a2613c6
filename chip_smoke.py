#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths once on one CUDA card and check them.

    python3 chip_smoke.py [--photon-n 1e5] [--ref-photon-n 5e4]
    python3 chip_smoke.py --f64-only    # phases 1, 2 and 12

Phases, each of which exits non-zero on failure:

1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build the kernels from ``grmonty_tpu_torch/csrc`` (one nvcc per source,
   in parallel);
3. generate the 256x256 synthetic torus into ``.cache/`` with the port's
   writer and build the per-dump tables on the card;
4. every kernel of the two paths against its plain PyTorch version at
   N = 65,536: the fused hot step in its shipped and reference variants
   (``hot_step``, ``hot_step_ref``) on synthetic lane states (seeded
   numpy, ``hot_kernels.synthetic_lanes(events=True)``, at each path's own
   step cap) against ``engine.hot_step_plain``, on every lane within the
   Pallas-vs-XLA parity contract (``hot_kernels.KERNEL_TOLERANCE``, the
   weight also within ``hot_kernels.weight_slack``) and with the census
   counters exactly equal; the row gather on the raw corner table at
   seeded indices, bitwise equal to ``table[idx]``.  Each with the time per call of kernel
   and plain when the host calls them back to back (``ms``, ``plain_ms``,
   CUDA events), the kernel's device time per launch (``device_ms``:
   launches queued behind a GPU sleep, so the host's launch cost is
   hidden), the one PyTorch call that computes the same function where
   there is one (``library_ms``, and queued the same way
   ``library_device_ms``), and the least time the card could take
   (``bound_ms``: the bytes the call must move at 3.35 TB/s or its
   operations at the card's rate for their type, 67 TFLOP/s in float32 and
   33.5 in float64, the larger; ``bound_by`` says which); for the hot
   step also its registers and spills (``ptxas``), the shared-memory
   loads in its SASS (``lds``, by cuobjdump) and the instance the width
   launches (``group``: threads a lane, ``threads`` a block,
   ``blocks_per_sm``), and on a line of its own the weight's worst lane
   and an estimate of the float32 issue floor.  The hot step is checked
   and timed the same way at the tail cascade's widths, N = 4,096 and 512
   (``kernel check hot_step@4096: ...``; float64 also at the accuracy
   gate's 1,024).  Every
   run of phases 5-12 must launch exactly what its path runs
   (``path_launches``: the hot step of its dtype and semantics once per hot
   iteration, the row gather of its dtype once per full phase and, under
   reference semantics, once per fresh-lane init, no other entry point) and
   no plain hot step;
5. the shipped profile end to end at M = 4e19, seed 123, float32, pool
   65,536, the JAX driver's whole schedule: the pilot (8,192 photons on the
   host tracker; its seconds and counters printed), the waves (the first
   chunk ramped), the tail cascade (each stage's width, iterations and
   device window printed); every hot step of every engine must be one
   launch of ``hot_step`` and the row gather must run once per full phase
   of every engine (its event samplers) and nowhere else, the cascade must
   end with the pool empty, the spectrum must be finite with a photon
   count equal to ``n_recorded`` (the pilot's records debited), no
   secondary may be dropped, and the luminosity must lie within 10% of the
   JAX engine's 12694.3 on the same torus and seed;
6. reference semantics end to end on the same cell (``--ref-photon-n``
   photons, ``profiles.reference_config`` with its step cap cut to
   ``--ref-stall-steps``, the same schedule): every hot step must be one
   launch of ``hot_step_ref`` and the row gather must run once per full
   phase and once per fresh-lane init (one in each full and light phase),
   with the same checks of the schedule, the spectrum and the luminosity;
7. the gather probes (``grmonty_tpu_torch/tools/``): (a) the five kernels
   of ``csrc/gather_probe.cu`` against their plain versions at N = Z =
   65,536 and w = 32 and 216 (where the table outgrows L2 and 54 float4s
   fall unevenly on a warp), the staged row sum at blk 256 and also at the
   probe's blk 8,192, on a seeded table at seeded indices with 0 and Z-1
   included: the four row sums within ``hot_kernels.rowsum_slack`` on
   every index, the row copy bitwise; each record also gives ``floor_ms``,
   the device time of a one-row launch.  The records that no phase
   launches (w = 216, blk 8,192) carry the names ``<kernel>@216`` and
   ``gather_rowsum_smem@blk8192`` and ``launches`` null; (b) then, with
   every launch count set to 0, the three probes,
   each printed as ``probe <name>: {...}``; each of the five kernels must
   have been launched.  The chained probes replay CUDA graphs, and a
   replayed launch does not pass through the wrapper: the counts see the
   captures and the probes' eager calls only;
8. checkpoint/resume: the shipped profile at ``--resume-photon-n`` photons
   with 65,536-photon waves (the ramp and several whole waves) and the
   cascade's step cap cut to ``RESUME_TAIL_STALL``, three times: uninterrupted; with a checkpoint and a failure injected after its
   second wave (in this phase only); resumed from the checkpoint in a fresh
   ``Simulation``.  The uninterrupted run's phases are clocked by CUDA
   events (``profile_slice.clock_phases``) for phase 12b.  The resumed
   spectrum must match the uninterrupted one to rtol 1e-6 (float atomics
   sum it on the card), every count exactly (the full and light phases
   among them), the checkpoint must be gone, the resumed ``device_s`` must
   be the sum of its two parts' device windows (to rel 1e-9) and its
   ``elapsed_s`` at least the interrupted part's wall seconds;
9. the command line, ``python -m grmonty_tpu_torch`` on the card in a
   subprocess at ``--resume-photon-n`` photons and the cells' pool of
   65,536 (``CLI_POOL``): exit 0, a 200 x 37 spectrum file, and a kernel
   build time (``compile_s``, the fresh process's load of the kernels in
   ``Simulation.__init__``) above 0 in its log;
10. the accuracy gate (``grmonty_tpu_torch.tools.validate_accuracy``) at
   the shipped bar's setup (``GATE_ARGS``: the shipped profile at pool
   1,024, float32, the 64x32 torus, M = 4e19, seed 123, 20,000 photons, 5
   oracle replicates, the bias frozen at (0.0025, 2.6)), with
   every launch count set to 0 just before: the engine on the card against
   the native tracker on the host.  It must pass the gate's hard gates
   (``chi2_sec_gen_per_dof`` < 5, no hotcross clamp), its luminosity ratio
   must lie within 1 +- 0.10, every hot step of its engines must be one
   launch of ``hot_step`` and the row gather must run once per full
   phase; its numbers are printed on one line (``{"phase": "accuracy",
   ...}``);
11. the sharded path and the native dump parser on the 256x256 torus:
   the dump parsed by the native parser (``models/harmio_native``) must
   equal numpy's parse bit for bit; ``Simulation`` and
   ``parallel.sharding.ShardedSimulation`` at world size 1 over NCCL (a
   ``file://`` rendezvous in ``.cache/``), the shipped profile at
   ``--resume-photon-n`` photons with phase 8's waves and cascade step cap,
   the same seed (the ``Simulation`` run is phase 8's uninterrupted one):
   every count equal and the spectrum within rtol 1e-6, with
   the launch counts set to 0 just before the sharded run (one
   ``hot_step`` launch per hot iteration, one row gather per full phase);
   ``python -m grmonty_tpu_torch --devices N`` with one rank more than the
   machine has cards must exit non-zero with "need N devices".  The
   set-up seconds of each ``Simulation`` made here (the dump read and the
   per-dump tables on the card) are printed; the numbers go on one line
   (``{"phase": "sharded", ...}``);
12. float64 on the card: (a) phase 4's checks in float64 (``hot_step_f64``,
   ``hot_step_ref_f64`` at N = 65,536, 4,096, 1,024 and 512, ``row_gather_f64``
   bitwise), on the tables of a float64 ``Simulation`` of the cell; (b)
   that ``Simulation`` end to end, the shipped profile at
   ``--resume-photon-n`` photons with phase 8's waves and cascade step cap,
   under phase 5's checks (``"path": "shipped_f64"``), its phases clocked,
   and one line (``{"phase": "f64_vs_f32", ...}``) with its window, rate
   and counts beside phase 8's float32 run; (c) the accuracy gate at
   reference semantics in float64 (``F64_GATE_ARGS``): its hard gates, the
   luminosity ratio within 3 of the tool's sigmas, one ``hot_step_ref_f64``
   launch per hot iteration; (d) ``python -m grmonty_tpu_torch --dtype
   float64 --reference`` on the 64x32 torus at ``--photon_n`` 200
   (``F64_CLI_PHOTON_N``), as phase 9;
13. the scatter-chain distribution probe
   (``grmonty_tpu_torch.tools.probe_scatter_dist``) on the card at its full
   ``PROBE_N`` of 40,000 photons a cell over its 3 x 3 grid of (theta_e,
   k0): the engine's deferring samplers in float64 against the native
   tracker's scalar ones, one line a cell (``scatter cell: {...}``) and one
   summary (``{"phase": "scatter_dist", ...}``); every photon must accept
   within the probe's 64 phases, and ``mean_ratio`` and ``q99_ratio`` must
   lie within 1 +- ``SCATTER_TOL``, or within ``SCATTER_SIGMAS`` of their
   Monte Carlo errors (``probe_scatter_dist.ratio_errors``) where those are
   wider, in every cell;
14. the deep-tau replay harness (``grmonty_tpu_torch.tools.replay_deep_tau
   --bench-profile``) at M = 4e20, its photons cut from 2,000 to
   ``REPLAY_PHOTONS``, with every launch count set to 0 just before: the
   traced run and its nominal-step rerun must launch exactly what their
   path runs (``path_launches`` over both runs; no plain hot step), the
   captured ``mt_*`` must be a birth state (a positive weight, a finite
   wave vector with k^0 > 0, plasma at the birth position; its null
   residual is printed, not held: secondaries born near r = 27 M on the
   64x32 torus carry non-null wave vectors in the JAX engine too), and the
   three replays through the native tracker must have run
   (``{"phase": "replay", ...}``).

With ``--probe-kernels-only`` the script runs phases 1, 2 and 7a and
prints the card line and the kernels line (no result line); a copy of it
placed in another commit's checkout times that commit's probe kernels
the same way, which is how two versions are compared in one call.  With
``--sharded-only`` it runs phases 1, 2 and 11 and prints the card line
(no kernels line, no result line); with ``--ab-hot-step DIR`` phases 1
and 2, then this checkout's hot step against the one of the checkout at
DIR in turns (float32 at 65,536 lanes with both SASS listings compared,
float64 at ``AB_F64_WIDTHS``), then the card line; with ``--f64-only``
phases 1, 2 and 12 (and phase 12b's float32 run of the same setup in
place of phase 8's) and prints the card line and the kernels line (no
result line).

The last three lines of standard output are the card's name and power
limit, one JSON object describing the kernels, and the result line.
"""

import argparse
import contextlib
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import time

REF_LUMINOSITY = 12694.3  # JAX engine, 256x256 torus, M=4e19, seed 123
N_CHECK = 65536
TAIL_CHECKS = (4096, 512)  # the tail cascade's narrower pools
# Float64 also at the accuracy gate's pool of 1,024 lanes (phase 12c).
TAIL_CHECKS_F64 = (4096, 1024, 512)
# --ab-hot-step's float64 widths: the pool, the cascade's and the gate's.
AB_F64_WIDTHS = (N_CHECK, 4096, 1024, 512)
RESUME_PHOTON_N = 2e4
RESUME_CHUNK = 1 << 16
# The resume phase's step cap in the tail cascade, cut from the shipped
# profile's 50,000: at 50,000 one photon ran to the cap and each of the
# phase's three runs drained for 51,200 iterations of the 512-lane pool
# (48 s on an H100 80GB HBM3 at 700 W, PERF.md).
RESUME_TAIL_STALL = 5000
# The command line's pool in phase 9: the cells' width.  At the command
# line's default of 16,384 the same 2e4 photons drained for 237,056
# iterations of the 512-lane pool (308-376 s); at 65,536, 12,928 (42 s; an
# H100 80GB HBM3 at 700 W, PERF.md).
CLI_POOL = 65536
REPS = 20
# The reference path's per-photon step cap, cut from the reference's
# 150,000: at 150,000 its drain ran 415,200 hot iterations (754 s of device
# window on an H100 80GB HBM3 at 700 W), chains of secondaries near the hole
# outliving any one photon's cap (PERF.md, the reference cell).
REF_STALL_STEPS = 50000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# H100 SXM float64 outside the tensor cores: the FP64 pipes run at half the
# float32 rate (NVIDIA's data sheet: 34 TFLOP/s against 67).
FP64_OPS_PER_S = FP32_OPS_PER_S / 2
OPS_PER_S = {"float32": FP32_OPS_PER_S, "float64": FP64_OPS_PER_S}
# The instruction issue rate: the peak rates count a fused multiply-add as
# two operations, and the kernels are built with -fmad=false, so each
# multiply and each add issues on its own at half that rate.
ISSUE_PER_S = {dt: ops / 2 for dt, ops in OPS_PER_S.items()}
# Operations per lane, counted from csrc/hot_step.cu (every add, multiply,
# compare-select, division, square root and transcendental as one; the same
# count in float32 and float64): about 600 in phase A (the 40-term
# connection and two fixed-point rounds of the 40-term geodesic right-hand
# side) and 3,200 in phase B (the 41x31 hotcross Chebyshev sum, 2,542
# multiplies and adds); the raw rows' metric pair adds about 50.  The row
# gathers do no arithmetic; a row sum of width w does w - 1 additions
# (W_PROBE here; the w = 216 checks pass their own).
W_PROBE = 32
PROBE_BLK = 8192  # probe_pallas_gather's default blk (PROBE_BLK) for dsB
ROWSUMS = tuple(f"gather_rowsum_{s}" for s in ("coop", "persistent", "rowloop", "smem"))
OPS_PER_LANE = {"hot_step": 3800, "hot_step_ref": 3840, "row_gather": 0,
                "hot_step_f64": 3800, "hot_step_ref_f64": 3840, "row_gather_f64": 0,
                **{name: W_PROBE - 1 for name in ROWSUMS}, "row_gather_rowloop": 0}
TOLERANCE = {
    "hot_step": "masks and integers differ on at most 0.1% of lanes; floats within "
                "rtol 1e-4 atol 1e-6 on every lane; census counters exactly equal",
    "hot_step_ref": "masks and integers differ on at most 0.1% of lanes; floats within "
                    "rtol 1e-4 atol 1e-6 on every lane; census counters exactly equal",
    "row_gather": "bitwise equal",
    "hot_step_f64": "masks and integers equal on every lane; floats within rtol 1e-11 "
                    "atol 1e-30 on every lane; census counters exactly equal",
    "hot_step_ref_f64": "masks and integers equal on every lane; floats within rtol 1e-11 "
                        "atol 1e-30 on every lane; census counters exactly equal",
    "row_gather_f64": "bitwise equal",
    **{name: "|kernel - plain| <= w * 2^-23 * sum_j |table[idx, j]| on every index"
       for name in ROWSUMS},
    "row_gather_rowloop": "bitwise equal",
}
SOURCES = {"hot_step": ("hot_step.cu", "grmonty_tpu/transport/hotstep_pallas.py:104, "
                        "grmonty_tpu/transport/hotstep_pallas.py:152"),
           "hot_step_ref": ("hot_step.cu", "grmonty_tpu/transport/hotstep_pallas.py:104, "
                            "grmonty_tpu/transport/hotstep_pallas.py:152, "
                            "grmonty_tpu/ops/gather.py:63"),
           "row_gather": ("row_gather.cu", "grmonty_tpu/ops/gather.py:63"),
           "gather_rowsum_coop": ("gather_probe.cu", "tools/probe_gather.py:104, "
                                  "tools/probe_pallas_gather.py:99, "
                                  "tools/probe_vmem_gather.py:106, "
                                  "tools/probe_vmem_gather.py:142"),
           "gather_rowsum_persistent": ("gather_probe.cu", "tools/probe_pallas_gather.py:74"),
           "gather_rowsum_rowloop": ("gather_probe.cu", "tools/probe_gather.py:133"),
           "gather_rowsum_smem": ("gather_probe.cu", "tools/probe_pallas_gather.py:125"),
           "row_gather_rowloop": ("gather_probe.cu", "tools/probe_vmem_gather.py:178")}
# The float64 instantiations replace what their float32 kernels replace.
SOURCES.update({f"{name}_f64": SOURCES[name]
                for name in ("hot_step", "hot_step_ref", "row_gather")})
# Phase 7's probes, by module name under grmonty_tpu_torch/tools.
PROBES = ("probe_gather", "probe_pallas_gather", "probe_vmem_gather")
# Phase 10: the accuracy gate at the setup of the tracked shipped bar
# ACCURACY_r5_M4e19_frozen_sc06.json (the tool's own pool of 1,024 and the
# 64x32 torus), and the luminosity ratio it must hold.
GATE_ARGS = ["--bench-profile", "--photons", "20000", "--mass-unit", "4e19", "--seed", "123",
             "--oracle-reps", "5", "--freeze-bias", "0.0025", "--freeze-avg", "2.6"]
GATE_LUM_TOL = 0.10
# Phase 12c: the accuracy gate at reference semantics in float64, the JAX
# tool's default run (ACCURACY.md, "reference semantics, f64"), on the same
# torus, mass, seed, replicates and frozen bias as GATE_ARGS; the luminosity
# ratio within F64_GATE_SIGMAS of the tool's sigma.  The photons are cut
# from the JAX row's 20,000 to 10,000 (the first 10,000 of the plan took
# 36 s; the whole plan of 31,590 drained for 278,464 iterations in the
# first run of phase 12d, a chain of secondaries past the step cap; an H100
# 80GB HBM3 at 700 W, PERF.md).
F64_GATE_ARGS = ["--reference", "--photons", "10000", "--mass-unit", "4e19", "--seed", "123",
                 "--oracle-reps", "5", "--freeze-bias", "0.0025", "--freeze-avg", "2.6"]
F64_GATE_SIGMAS = 3.0
# Phase 12d: the command line in float64 under reference semantics on the
# 64x32 torus, at the accuracy gate's pool.  Its photon_n is cut from 2,000
# (31,590 superphotons) to 200: at 2,000 its 512-lane drain ran 278,464
# iterations (376 s on an H100 80GB HBM3 at 700 W, PERF.md).
F64_CLI_ARGS = ["--dtype", "float64", "--reference", "--pool", "1024"]
F64_CLI_PHOTON_N = 200
# Phase 13: the scatter-chain probe's bar, the JAX tool's finding on the
# same grid at the same 40,000 photons a cell ("within 1-4%", ACCURACY.md),
# widened to SCATTER_SIGMAS Monte Carlo errors where those are wider: the
# q99 ratio's error is about 2% at 40,000, and the JAX chain itself reads
# 1.0569 and 1.0574 on (2, 1e-3) at two of ten seeds (PERF.md).
SCATTER_N = 40000
SCATTER_TOL = 0.05
SCATTER_SIGMAS = 3.0
# Phase 14: the replay harness's photons, cut from the JAX run's 2,000
# (REPLAY_r5_M4e20.json; REPLAY_torch_M4e20.json holds the port's run at
# 2,000) to 200: at 500 the nominal-step rerun drained for 291,152
# iterations and the two runs took 501 s; at 200, 70 s (an H100 80GB HBM3
# at 700 W, PERF.md).
REPLAY_PHOTONS = 200


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


def nbytes(*objs):
    """Bytes of every tensor in ``objs`` (nested tuples, lists and dicts)."""
    import torch

    total = 0
    for o in objs:
        if isinstance(o, torch.Tensor):
            total += o.numel() * o.element_size()
        elif isinstance(o, dict):
            total += nbytes(*o.values())
        elif isinstance(o, (tuple, list)):
            total += nbytes(*o)
    return total


def bound(moved_bytes, ops, dtype="float32"):
    """(least ms, what bounds it) for ``moved_bytes`` of traffic and
    ``ops`` operations in ``dtype`` ("float32" or "float64") on the card."""
    t_bytes, t_ops = moved_bytes / HBM_BYTES_PER_S, ops / OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def torus_dump(root):
    """The 256x256 synthetic torus, written into ``root/.cache`` once."""
    from grmonty_tpu_torch.models import torus

    cache = os.path.join(root, ".cache")
    os.makedirs(cache, exist_ok=True)
    dump = os.path.join(cache, "torus_256x256_dump")
    if not os.path.exists(dump):
        torus.write_torus_dump(dump, n1=256, n2=256)
    return dump


def make_simulation(root, photon_n, reference=False, stall_steps=REF_STALL_STEPS, cls=None,
                    dtype=None, **over):
    """The smoke cell's ``Simulation`` (or ``cls``) on the card: the
    256x256 synthetic torus, M = 4e19, seed 123, float32 (or ``dtype``),
    the shipped profile (or reference semantics) at pool 65,536; ``over``
    replaces the profile's driver arguments."""
    import torch

    from grmonty_tpu_torch.transport import driver, profiles

    dump = torus_dump(root)
    pool = 65536
    dtype = dtype or torch.float32
    if reference:
        cfg = profiles.reference_config(pool=pool, dtype=dtype, stall_steps=stall_steps)
        kw = profiles.reference_sim_kwargs(pool)
    else:
        cfg = profiles.bench_config(pool=pool, dtype=dtype)
        kw = profiles.bench_sim_kwargs(pool)
    kw.update(over)
    return (cls or driver.Simulation)(dump, photon_n=int(photon_n), mass_unit=4.0e19, seed=123,
                                      config=cfg, device="cuda", **kw)


def time_kernel(name, ref, got, plain, kern, moved_bytes, library=None, ops=None,
                slack=None, n=N_CHECK, extra=None):
    """Hold ``got`` against ``ref`` under the kernel's tolerance (plus
    ``slack`` per lane where given), time plain, kernel, kernel, plain (one
    pair of each per call, averaged), the kernel's device time and the
    library call, and return the record, updated by ``extra``; ``ops`` is
    the call's work, ``OPS_PER_LANE`` over ``n`` lanes unless given, in
    float64 for a float64 instantiation (``*_f64``), else float32."""
    from grmonty_tpu_torch.transport import hot_kernels

    err, rel, mask, fails = hot_kernels.compare(ref, got, **hot_kernels.KERNEL_TOLERANCE[name],
                                                slack=slack)
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
    ops = OPS_PER_LANE[name] * n if ops is None else ops
    bound_ms, bound_by = bound(moved_bytes, ops, kernel_dtype(name))
    src, replaces = SOURCES[name]
    rec = {"name": name, "route": "cuda", "source": f"grmonty_tpu_torch/csrc/{src}",
           "replaces": replaces, "max_abs_err": err, "max_rel_err": rel,
           "mask_mismatch": mask, "tolerance": TOLERANCE[name],
           "ms": 0.5 * (k1 + k2), "plain_ms": 0.5 * (p1 + p2),
           "device_ms": cuda_ms(kern, queued=True),
           "library_ms": None if library is None else cuda_ms(library),
           "library_device_ms": None if library is None else cuda_ms(library, queued=True),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved_bytes, "n": n,
           "group": None, "threads": None, "blocks_per_sm": None}
    rec.update(extra or {})
    print(f"kernel check {rec['name']}{'' if n == N_CHECK else f'@{n}'}: {json.dumps(rec)}")
    if fails:
        fail(f"{name} disagrees with its plain version: " + "; ".join(fails))
    return rec


def kernel_dtype(name):
    """"float64" for a float64 instantiation (``*_f64``), else "float32"."""
    return "float64" if name.endswith("_f64") else "float32"


def ptxas_usage(log):
    """{kernel function: registers and spill bytes} from nvcc's -Xptxas -v
    output: the first properties line after an entry function is its own
    (those of the functions it calls, such as the trigonometric slow path,
    follow)."""
    usage, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn and "spill_stores" not in usage[fn]:
            usage[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn]["registers"] = int(m.group(1))
    return usage


def sass_listing(path):
    """{kernel function: [its SASS instructions, without addresses and
    encodings]} of a built library, by cuobjdump; {} where cuobjdump is
    missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                             timeout=300).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    listing, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            listing[fn] = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if fn and m:
            listing[fn].append(m.group(1))
    return listing


def sass_counts(path):
    """{kernel function: (shared-memory loads LDS, instructions)} in the SASS
    of a built library (:func:`sass_listing`)."""
    return {fn: (sum(1 for ins in lst if re.search(r"\bLDS(\.[A-Z0-9]+)*\b", ins)), len(lst))
            for fn, lst in sass_listing(path).items()}


def hot_step_variant(fn):
    """(reference, type, group, threads) of a mangled hot_step_kernel
    instantiation: the type "float" for the float-only kernels before the
    float64 ones; the group (threads a lane) 1 and the threads a block None
    for those before the group instances."""
    m = re.search(r"hot_step_kernelILb([01])E(?:([fd])(?:Li(\d+)E)?(?:Li(\d+)E)?E)?", fn)
    if m is None:
        return None
    return (m.group(1) == "1", {"f": "float", "d": "double"}.get(m.group(2), "float"),
            int(m.group(3) or 1), m.group(4) and int(m.group(4)))


def ab_hot_step(root, sims, other, usage, ref_stall_steps, turns=2):
    """``--ab-hot-step``: this checkout's hot step against the one of the
    checkout at ``other`` (its ``csrc/hot_step.cu`` built with this build's
    flags; its C interface is the same, so this wrapper launches it on the
    same arguments), each variant in float32 at N_CHECK lanes and in float64
    at AB_F64_WIDTHS, on phase 4's lanes (``sims``: a float32 and a float64
    ``Simulation`` of the cell): each side's worst errors against the plain
    version and census, its device time in turns (this, other, other, this,
    ``turns`` times), its ptxas registers and spills, this side's group and
    blocks an SM, and whether the two SASS listings of each float32 variant
    are identical.  Prints one line per variant and width; fails if a census
    differs."""
    import ctypes

    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels, profiles

    src = os.path.join(other, "grmonty_tpu_torch", "csrc", "hot_step.cu")
    lib_path = os.path.join(root, "build", "grmonty_tpu_torch", "ab_other_hot_step.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = subprocess.run([nvcc, *hot_kernels.NVCC_FLAGS, "-o", lib_path, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        fail(f"ab: nvcc failed for {src}:\n{out.stdout}{out.stderr}")
    other_usage = {hot_step_variant(f): v for f, v in ptxas_usage(out.stdout + out.stderr).items()
                   if hot_step_variant(f)}
    this_usage = {hot_step_variant(f): v for f, v in usage.items() if hot_step_variant(f)}
    lib = ctypes.CDLL(lib_path)
    mine_sass = {hot_step_variant(f): v for path in hot_kernels._Build.paths
                 for f, v in sass_listing(path).items() if hot_step_variant(f)}
    other_sass = {hot_step_variant(f): v for f, v in sass_listing(lib_path).items()
                  if hot_step_variant(f)}
    for sim in sims:
        mc, tabs, dev, dt = sim.mc, sim.tables, sim.device, sim.cfg.dtype
        for reference in (False, True):
            name = hot_kernels.entry_point("hot_step", dt, reference)
            theirs = getattr(lib, f"{name}_launch")
            theirs.argtypes = hot_kernels._Build.fns[name].argtypes
            theirs.restype = ctypes.c_int
            fns = {"this": hot_kernels._Build.fns[name], "other": theirs}
            for n in (N_CHECK,) if dt == torch.float32 else AB_F64_WIDTHS:
                cfg = (profiles.reference_config(pool=n, dtype=dt, stall_steps=ref_stall_steps)
                       if reference else sim.cfg._replace(n_pool=n))
                lanes = hot_kernels.synthetic_lanes(mc, n, 2024, cfg.stall_steps, reference,
                                                    events=True)
                pool, counters, u_roul, u_x1, bias = hot_kernels.synthetic_step(lanes, dt, dev)

                def step(fn, c=None):
                    if c is None:
                        c = counters._replace(**{k: getattr(counters, k).clone()
                                                 for k in hot_kernels.CENSUS})
                    return fn(pool, c, u_roul, u_x1, bias, mc, tabs, cfg)

                ref_f, ref_c = hot_kernels.step_outputs(*step(engine.hot_step_plain), reference)
                slack = hot_kernels.weight_slack(pool, ref_f,
                                                 hot_kernels.KERNEL_TOLERANCE[name]["rtol"])
                shape = hot_kernels.hot_step_shape(name, n)
                rec = {"name": name, "n": n, **shape, "device_ms": {"this": [], "other": []}}
                try:
                    for side, fn in fns.items():
                        hot_kernels._Build.fns[name] = fn
                        got_f, got_c = hot_kernels.step_outputs(*step(hot_kernels.hot_step),
                                                                reference)
                        torch.cuda.synchronize()
                        err, rel, mask, fails = hot_kernels.compare(
                            ref_f, got_f, **hot_kernels.KERNEL_TOLERANCE[name], slack=slack)
                        rec[side] = {"max_abs_err": err, "max_rel_err": rel,
                                     "mask_mismatch": mask, "fails": fails,
                                     "census_equal": got_c == ref_c}
                    # timed as phase 4 times it: the census added to one set of
                    # counters, no copies between the launches
                    kc = counters._replace(**{k: getattr(counters, k).clone()
                                              for k in hot_kernels.CENSUS})
                    for _ in range(turns):
                        for side in ("this", "other", "other", "this"):
                            hot_kernels._Build.fns[name] = fns[side]
                            rec["device_ms"][side].append(
                                cuda_ms(lambda: step(hot_kernels.hot_step, kc), queued=True))
                finally:
                    hot_kernels._Build.fns[name] = fns["this"]
                typ = "double" if dt == torch.float64 else "float"
                key = (reference, typ, shape["group"], shape["threads"])
                # the same instance in the other checkout, or its one instance of
                # the variant and type where it builds a single one (an older
                # hot_step.cu)
                theirs_key = key if key in other_sass else next(
                    (k for k in other_sass if k[:2] == key[:2]), None)
                rec["ptxas"] = {"this": this_usage.get(key), "other": other_usage.get(theirs_key)}
                theirs_sass = other_sass.get(theirs_key)
                mine = mine_sass.get(key)
                rec["sass_identical"] = theirs_sass is not None and mine == theirs_sass
                rec["sass_instructions"] = {"this": len(mine or []),
                                            "other": len(theirs_sass or [])}
                print(f"ab {name}@{n}: {json.dumps(rec)}")
                if not (rec["this"]["census_equal"] and rec["other"]["census_equal"]):
                    fail(f"ab {name}@{n}: a census differs from the plain version's")


def hot_step_checks(sim, usage, sass, ref_stall_steps, n=N_CHECK):
    """Phase 4a (and 12a): the hot step of each semantics, in ``sim``'s
    dtype, against its plain version at ``n`` lanes of synthetic state
    drawn at the path's step cap (the shipped ``sim.cfg``'s,
    ``ref_stall_steps`` under reference semantics), its census counters
    exactly; ``usage``/``sass``: the build's ptxas and SASS counts by
    kernel function."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels, profiles

    mc, tabs, dev, dt = sim.mc, sim.tables, sim.device, sim.cfg.dtype
    out = []
    for reference in (False, True):
        cfg = (profiles.reference_config(pool=n, dtype=dt, stall_steps=ref_stall_steps)
               if reference else sim.cfg._replace(n_pool=n))
        name = hot_kernels.entry_point("hot_step", dt, reference)
        lanes = hot_kernels.synthetic_lanes(mc, n, 2024, cfg.stall_steps, reference,
                                            events=True)
        pool, counters, u_roul, u_x1, bias = hot_kernels.synthetic_step(lanes, dt, dev)

        def fresh():
            return counters._replace(**{c: getattr(counters, c).clone()
                                        for c in hot_kernels.CENSUS})

        def step(fn, c=None):
            return fn(pool, fresh() if c is None else c, u_roul, u_x1, bias, mc, tabs, cfg)

        kc = fresh()  # the kernel adds its census to these in place
        plain = lambda: step(engine.hot_step_plain, counters)  # noqa: E731
        kern = lambda: step(hot_kernels.hot_step, kc)  # noqa: E731
        ref_f, ref_c = hot_kernels.step_outputs(*plain(), reference)
        got_f, got_c = hot_kernels.step_outputs(*step(hot_kernels.hot_step), reference)
        torch.cuda.synchronize()
        if got_c != ref_c:
            fail(f"{name}: census {got_c} != the plain version's {ref_c}")
        # the bytes: every input read once, every output written once, and
        # each table row the lanes' cells touch
        z = engine.hot_phase_a(pool.x, pool.k, pool.dkdlam, pool.e_0_s, pool.dl_shrink,
                               pool.pend_dl, pool.pend_push, pool.at_event, pool.alive,
                               pool.w, pool.record_pending, u_roul, pool.alpha_scatti,
                               pool.bi, mc, cfg.grow_cap, reference=reference)["z"]
        table = tabs.corner_rows if reference else tabs.hot_tab
        ins = (hot_kernels._pool_cols(pool), pool.occupied, u_roul, u_x1, bias, tabs.hc_coeffs,
               [getattr(counters, c) for c in hot_kernels.CENSUS],
               [] if reference else hot_kernels._ev_cols(pool))
        moved = (nbytes(ins, got_f, [getattr(counters, c) for c in hot_kernels.CENSUS])
                 + torch.unique(z).numel() * table.shape[1] * table.element_size())
        slack = hot_kernels.weight_slack(pool, ref_f,
                                         hot_kernels.KERNEL_TOLERANCE[name]["rtol"])
        # the weight's worst lane, with the optical depth that decayed it
        w_rel = (got_f["w"].double() - ref_f["w"].double()).abs() / ref_f["w"].double().abs()
        i = int(torch.argmax(torch.nan_to_num(w_rel, nan=0.0)))
        print(f"  {name}@{n}: w's worst lane {i}: relative error {float(w_rel[i])} at d_tau "
              f"{float(hot_kernels.step_d_tau(pool, ref_f)[i])}; issue floor (estimate, "
              f"OPS_PER_LANE) {1e3 * OPS_PER_LANE[name] * n / ISSUE_PER_S[kernel_dtype(name)]}"
              " ms")
        # the instance this width launches: hot_step_kernel<reference, type, group, threads>
        shape = hot_kernels.hot_step_shape(name, n)
        inst = (reference, "double" if dt == torch.float64 else "float", shape["group"],
                shape["threads"])
        rec = time_kernel(name, ref_f, got_f, plain, kern, moved, slack=slack, n=n,
                          extra=shape)
        rec["census"] = got_c
        rec["ptxas"] = next((v for f, v in usage.items() if hot_step_variant(f) == inst), None)
        rec["lds"], rec["sass_instructions"] = next(
            (v for f, v in sass.items() if hot_step_variant(f) == inst), (None, None))
        print(f"  {name}@{n}: census {got_c}; group {shape['group']}, {shape['threads']}-thread "
              f"blocks, {shape['blocks_per_sm']} an SM; ptxas {rec['ptxas']}; {rec['lds']} LDS "
              f"in {rec['sass_instructions']} instructions")
        out.append(rec)
    return out


def kernel_checks(sim, usage, sass, ref_stall_steps):
    """Phase 4 (and 12a): every kernel of the path in ``sim``'s dtype vs its
    plain version at N_CHECK lanes (the records returned), and the hot step
    at the cascade's widths (printed)."""
    import numpy as np
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    out = hot_step_checks(sim, usage, sass, ref_stall_steps)
    for n in TAIL_CHECKS_F64 if sim.cfg.dtype == torch.float64 else TAIL_CHECKS:
        hot_step_checks(sim, usage, sass, ref_stall_steps, n=n)
    # the row gather on the raw corner table, indices 0 and Z-1 included
    table = sim.tables.corner_rows
    z_n = table.shape[0]
    idx_np = np.random.default_rng(2025).integers(0, z_n, N_CHECK).astype(np.int32)
    idx_np[:2] = (0, z_n - 1)
    idx = torch.as_tensor(idx_np, device=sim.device)
    name = hot_kernels.entry_point("row_gather", table.dtype)
    plain_g = lambda: table[idx.long()]  # noqa: E731
    kern_g = lambda: hot_kernels.row_gather(table, idx)  # noqa: E731
    library_g = lambda: torch.index_select(table, 0, idx)  # noqa: E731
    ref_g, got_g = plain_g(), kern_g()
    torch.cuda.synchronize()
    if not (got_g.dtype == table.dtype and torch.equal(ref_g, got_g)):
        fail(f"{name} is not bitwise equal to table[idx]")
    moved = (nbytes(idx, ref_g)
             + torch.unique(idx).numel() * table.shape[1] * table.element_size())
    out.append(time_kernel(name, {"rows": ref_g}, {"rows": got_g}, plain_g, kern_g,
                           moved, library=library_g))
    return out


def probe_kernel_checks():
    """Phase 7a: the five gather-probe kernels vs their plain versions at N =
    Z = N_CHECK and w = W_PROBE and 216 (blk 256), and the staged row sum
    also at the probe's own blk (PROBE_BLK).  Each record also carries
    ``floor_ms``, the device time of a one-row launch (queued as
    ``device_ms`` is).  Returns the records, those that phase 7b's probes
    do not run named ``<kernel>@216`` and ``gather_rowsum_smem@blk8192``."""
    import numpy as np
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    dev = torch.device("cuda")
    out = []
    for w in (W_PROBE, 216):
        rng = np.random.default_rng(w)
        table = torch.as_tensor(rng.standard_normal((N_CHECK, w)).astype(np.float32), device=dev)
        idx_np = rng.integers(0, N_CHECK, N_CHECK).astype(np.int32)
        idx_np[:2] = (0, N_CHECK - 1)
        idx = torch.as_tensor(idx_np, device=dev)
        one = idx[:1]
        # the rows these indices touch, once, and the indices
        moved_in = nbytes(idx) + torch.unique(idx).numel() * w * 4
        cases = [(name, 256) for name in ROWSUMS + ("row_gather_rowloop",)]
        if w == W_PROBE:
            cases.insert(ROWSUMS.index("gather_rowsum_smem") + 1,
                         ("gather_rowsum_smem", PROBE_BLK))
        for name, blk in cases:
            label = (name + ("" if w == W_PROBE else f"@{w}")
                     + ("" if blk == 256 else f"@blk{blk}"))
            extra = {"w": w}
            if label != name:
                # phase 7b's probes launch at w = W_PROBE and their own blk
                # only, counted on the kernel's own record: none here
                extra.update(name=label, launches=None)
            if name == "row_gather_rowloop":
                plain = lambda: table[idx.long()]  # noqa: E731
                kern = lambda i=idx: hot_kernels.row_gather_rowloop(table, i)  # noqa: E731
                ref, got = plain(), kern()
                torch.cuda.synchronize()
                if not torch.equal(ref, got):
                    fail(f"{label} is not bitwise equal to table[idx]")
                extra["floor_ms"] = cuda_ms(lambda: kern(one), queued=True)
                rec = time_kernel(name, {"rows": ref}, {"rows": got}, plain, kern,
                                  moved_in + nbytes(ref), ops=0,
                                  library=lambda: torch.index_select(table, 0, idx),
                                  extra=extra)
            else:
                strategy = name.removeprefix("gather_rowsum_")
                plain = lambda: hot_kernels.plain_rowsum(table, idx)  # noqa: E731
                kern = lambda i=idx: hot_kernels.gather_rowsum(  # noqa: E731
                    table, i, strategy, blk=blk)
                ref, got = plain(), kern()
                torch.cuda.synchronize()
                extra["floor_ms"] = cuda_ms(lambda: kern(one), queued=True)
                # no one PyTorch call gathers and sums: library_ms stays null
                # and the probe's two-op torch_ms is added beside it
                rec = time_kernel(name, {"sum": ref}, {"sum": got}, plain, kern,
                                  moved_in + nbytes(ref), ops=(w - 1) * N_CHECK,
                                  slack=hot_kernels.rowsum_slack(table, idx), extra=extra)
            out.append(rec)
    return out


def run_probes():
    """Phase 7b: the three probes with every launch count set to 0 just
    before; prints each line and returns (results by probe, counts)."""
    import importlib

    from grmonty_tpu_torch.transport import hot_kernels

    hot_kernels.reset_launches()
    results = {}
    for name in PROBES:
        t0 = time.monotonic()
        results[name] = importlib.import_module(f"grmonty_tpu_torch.tools.{name}").measure()
        print(f"probe {name}: {json.dumps(results[name])}")
        print(f"  ({time.monotonic() - t0:.1f} s)")
    return results, dict(hot_kernels.launches)


def check_schedule(sim, stats, label):
    """Print the pilot's and the cascade's lines and fail unless the run
    went through the JAX driver's schedule: the pilot on the host tracker,
    the waves of ``driver.wave_list`` (the first chunk ramped), and cascade
    stages of decreasing width from ``_tail_sizes`` that leave the pool
    empty."""
    from grmonty_tpu_torch.transport import driver

    pilot, stages = stats["pilot"], stats["tail_stages"]
    print(f"{label} pilot: {json.dumps(pilot)}")
    for st in stages:
        print(f"{label} cascade stage: {json.dumps(st)}")
    waves = driver.wave_list(stats["n_created"], sim.emit_chunk, sim.cfg.n_pool,
                             sim._wave_tail_exit)
    widths = [st["pool"] for st in stages]
    if pilot is None or pilot["photons"] != min(sim.warmup, stats["n_created"]):
        fail(f"{label}: the pilot did not run ({pilot})")
    if stats["waves"] != len(waves):
        fail(f"{label}: {stats['waves']} waves, the schedule has {len(waves)}")
    if (not widths or widths != sorted(set(widths), reverse=True)
            or not set(widths) <= set(sim._tail_sizes())):
        fail(f"{label}: cascade stages {widths} against the widths {sim._tail_sizes()}")
    if int(sim.state.pool.occupied.sum()) != 0 or int(sim.state.sec.count) != 0:
        fail(f"{label}: the cascade left photons behind")


def path_launches(cfg, stats):
    """{entry point: launches} that a run of ``cfg`` with the counters
    ``stats`` (hot_iters, full_phases, light_phases) must show: the fused
    hot step of its dtype and semantics once per hot iteration of every
    engine, the row gather of its dtype once in each full phase's event
    samplers and, under reference semantics, once in each phase's
    fresh-lane init; every other entry point never."""
    from grmonty_tpu_torch.transport import hot_kernels

    hot = hot_kernels.entry_point("hot_step", cfg.dtype, cfg.reference)
    gather = hot_kernels.entry_point("row_gather", cfg.dtype)
    gathers = stats["full_phases"] + (stats["full_phases"] + stats["light_phases"]
                                      if cfg.reference else 0)
    want = {hot: stats["hot_iters"], gather: gathers}
    return {name: want.get(name, 0) for name in hot_kernels.launches}


def launch_failures(cfg, stats, counts):
    """What is wrong with a run's launch ``counts`` against
    :func:`path_launches` (empty when they match and a hot step ran)."""
    want = path_launches(cfg, stats)
    if counts == want and stats["hot_iters"] > 0:
        return ""
    return (f"launches {counts} against {want} ({stats['hot_iters']} hot iterations, "
            f"{stats['full_phases']} full and {stats['light_phases']} light phases)")


@contextlib.contextmanager
def counting_plain_steps():
    """Count the calls of the plain hot step (``engine.hot_step_plain``)
    made inside: a run on the card must make none."""
    from grmonty_tpu_torch.transport import engine

    plain, calls = engine.hot_step_plain, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    engine.hot_step_plain = counted
    try:
        yield calls
    finally:
        engine.hot_step_plain = plain


@contextlib.contextmanager
def phase_clocks():
    """The engine's phases bracketed by CUDA events for the run inside
    (``profile_slice.clock_phases``, which synchronises nothing); yields
    {phase: [(event, event)]}, read by :func:`clock_summary`."""
    import profile_slice
    from grmonty_tpu_torch.transport import engine

    saved = {name: getattr(engine.Engine, name) for name in profile_slice.PHASES}
    clocks = {name: [] for name in profile_slice.PHASES}
    profile_slice.clock_phases(engine.Engine, clocks)
    try:
        yield clocks
    finally:
        for name, fn in saved.items():
            setattr(engine.Engine, name, fn)


def clock_summary(clocks, device_s):
    """{phase: {calls, ms, ms_per_call, share of the device window}}."""
    out = {}
    for name, pairs in clocks.items():
        ms = sum(e0.elapsed_time(e1) for e0, e1 in pairs)
        out[name] = {"calls": len(pairs), "ms": ms, "ms_per_call": ms / max(1, len(pairs)),
                     "share": ms / (1e3 * device_s)}
    return out


def drive(sim, label, clocks=False):
    """Run ``sim`` with every launch count set to 0 just before, check its
    schedule, its spectrum, its luminosity and its launches
    (:func:`path_launches`; no plain hot step), print its result line (with
    ``clocks``, also the phase clocks of :func:`phase_clocks`); returns
    (stats, counts)."""
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    root = os.path.dirname(os.path.abspath(__file__))
    with (phase_clocks() if clocks else contextlib.nullcontext()) as clocked, \
            counting_plain_steps() as plain_steps:
        hot_kernels.reset_launches()
        spec, stats = sim.run()
        counts = dict(hot_kernels.launches)
    rows = sim.report(os.path.join(root, ".cache", f"chip_smoke_spectrum_{label}"))
    lum = rows["luminosity"]
    n_ph = float(spec[:, 2].sum())
    result = {
        "path": label, "photon_n": sim.photon_n, "n_created": stats["n_created"],
        "n_tracked": stats["n_tracked"], "n_recorded": stats["n_recorded"],
        "luminosity": lum, "lum_ratio": lum / REF_LUMINOSITY,
        "rate_device": stats["photon_rate_device"], "rate_wall": stats["photon_rate"],
        "device_s": stats["device_s"], "elapsed_s": stats["elapsed_s"],
        "compile_s": stats["compile_s"], "steps_per_photon": stats["steps_per_photon"],
        "n_sec_drop": stats["n_secondary_dropped"], "n_stall": stats["n_stall_killed"],
        "w_stall_frac": stats["w_stall_frac"],
        "n_hc_clamp": stats["n_hc_clamp"], "hot_iters": stats["hot_iters"],
        "launches": counts, "full_phases": stats["full_phases"],
        "light_phases": stats["light_phases"],
        "util": [stats.get(k) for k in ("util_occupied", "util_moving",
                                         "util_committed", "util_parked")],
        "max_tau_scatt": stats["max_tau_scatt"], "spectrum_photons": n_ph,
        "waves": stats["waves"], "pilot_host_s": stats["pilot"] and stats["pilot"]["host_s"],
        "tail_stages": [[st["pool"], st["iters"], st["device_s"]] for st in stats["tail_stages"]],
        "util_waves": stats.get("util_waves"), "dtype": str(sim.cfg.dtype).removeprefix("torch."),
        "plain_steps": plain_steps[0],
    }
    if clocks:
        result["phases"] = clock_summary(clocked, stats["device_s"])
    print(json.dumps(result))
    check_schedule(sim, stats, label)
    if not bool(torch.isfinite(torch.as_tensor(spec)).all()):
        fail(f"{label}: spectrum has non-finite entries")
    if n_ph != stats["n_recorded"]:
        fail(f"{label}: spectrum photon count {n_ph} != n_recorded {stats['n_recorded']}")
    if stats["n_secondary_dropped"] != 0:
        fail(f"{label}: {stats['n_secondary_dropped']} secondaries dropped")
    if not (math.isfinite(lum) and abs(lum / REF_LUMINOSITY - 1.0) <= 0.10):
        fail(f"{label}: luminosity {lum} not within 10% of {REF_LUMINOSITY}")
    bad = launch_failures(sim.cfg, stats, counts)
    if bad or plain_steps[0]:
        fail(f"{label}: {bad or ''} {plain_steps[0]} plain hot steps")
    return stats, counts


class InjectedFailure(Exception):
    """The failure phase 8 injects into a run after its second wave."""


def resume_check(root, photon_n):
    """Phase 8: an uninterrupted run (its phases clocked,
    :func:`phase_clocks`), a run that fails after its second wave with a
    checkpoint, and its resumption in a fresh ``Simulation``.  Returns
    ((spectrum, stats) of the uninterrupted run, its phase clocks)."""
    import numpy as np

    ck = os.path.join(root, ".cache", "chip_smoke_resume.npz")
    if os.path.exists(ck):
        os.remove(ck)

    def sim():
        return make_simulation(root, photon_n, emit_chunk=RESUME_CHUNK,
                               tail_stall_steps=RESUME_TAIL_STALL)

    t0 = time.monotonic()
    with phase_clocks() as clocks:
        spec_ref, st_ref = sim().run()
    ref = (spec_ref, st_ref)
    phases_ref = clock_summary(clocks, st_ref["device_s"])
    crashing = sim()
    wave, done = crashing._run_wave, []

    def fail_after_two(*a, **kw):
        if len(done) == 2:
            raise InjectedFailure()
        done.append(1)
        return wave(*a, **kw)

    crashing._run_wave = fail_after_two
    t_crash = time.monotonic()
    try:
        crashing.run(checkpoint_path=ck)
        fail("resume: the injected failure did not stop the run")
    except InjectedFailure:
        pass
    crashed_s = time.monotonic() - t_crash
    if not os.path.exists(ck):
        fail("resume: no checkpoint after the failure")
    resumed, windows = sim(), []
    timed = resumed._timed_run

    def own_windows(*a, **kw):  # the resumed part's own device windows
        state, secs = timed(*a, **kw)
        windows.append(secs)
        return state, secs

    resumed._timed_run = own_windows
    spec_res, st_res = resumed.run(checkpoint_path=ck)
    # the resumed device window: the interrupted part's (its two waves)
    # and the resumed part's own
    parts_s = crashing.device_s + sum(windows)
    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(spec_res - spec_ref) / np.abs(spec_ref)
    max_rel = float(np.nanmax(np.where(spec_ref == spec_res, 0.0, rel)))
    counts = ("n_recorded", "n_scatt_recorded", "n_tracked", "hot_iters", "n_stall_killed",
              "n_secondary_dropped", "full_phases", "light_phases")
    result = {"phase": "resume", "photon_n": photon_n, "waves": st_ref["waves"],
              "max_rel_spec_diff": max_rel, "seconds": time.monotonic() - t0,
              **{k: [st_ref[k], st_res[k]] for k in counts},
              "device_s": [st_ref["device_s"], st_res["device_s"], crashing.device_s,
                           sum(windows)],
              "elapsed_s": [st_ref["elapsed_s"], st_res["elapsed_s"], crashed_s]}
    print(json.dumps(result))
    if st_ref["waves"] <= 3:
        fail(f"resume: {st_ref['waves']} waves, too few to fail after the second")
    if not np.allclose(spec_res, spec_ref, rtol=1e-6, atol=0.0):
        fail(f"resume: the resumed spectrum differs by {max_rel} relative")
    moved = [k for k in counts if st_ref[k] != st_res[k]]
    if moved:
        fail(f"resume: counts moved across the resume: {moved}")
    if os.path.exists(ck):
        fail("resume: the completed run left its checkpoint")
    if not (crashing.device_s > 0.0 and math.isclose(st_res["device_s"], parts_s,
                                                     rel_tol=1e-9)):
        fail(f"resume: device_s {st_res['device_s']} is not the sum of its parts, "
             f"{crashing.device_s} before the failure and {sum(windows)} after")
    if not st_res["elapsed_s"] >= crashed_s:
        fail(f"resume: elapsed_s {st_res['elapsed_s']} is below the interrupted part's "
             f"{crashed_s}")
    return ref, phases_ref


def cli_check(root, photon_n, extra=None, dump=None, label="cli"):
    """Phase 9 (and 12d): ``python -m grmonty_tpu_torch`` on the card, in a
    subprocess, on ``dump`` (the 256x256 torus unless given) with ``extra``
    flags (``--pool CLI_POOL`` unless given)."""
    out_path = os.path.join(root, ".cache", f"chip_smoke_{label}_spectrum")
    if os.path.exists(out_path):
        os.remove(out_path)
    extra = ["--pool", str(CLI_POOL)] if extra is None else list(extra)
    cmd = [sys.executable, "-m", "grmonty_tpu_torch", "--harm_dump_path",
           dump or torus_dump(root), "--photon_n", str(photon_n), *extra,
           "--spectrum_path", out_path]
    t0 = time.monotonic()
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=900)
    secs = time.monotonic() - t0
    tail = out.stderr.strip().splitlines()[-4:]
    m = re.search(r"kernel build (\S+) s", out.stderr)
    compile_s = float(m.group(1)) if m else None
    print(json.dumps({"phase": label, "cmd": " ".join(cmd[1:]), "rc": out.returncode,
                      "seconds": secs, "compile_s": compile_s, "log_tail": tail}))
    if out.returncode != 0:
        fail(f"{label}: exit {out.returncode}:\n{out.stderr[-3000:]}")
    # a fresh process loads the kernels in Simulation.__init__, outside its
    # device window, and reports the seconds
    if not (compile_s and compile_s > 0.0):
        fail(f"{label}: no kernel build time in its log (compile_s {compile_s})")
    if not os.path.exists(out_path):
        fail(f"{label}: no spectrum file")
    with open(out_path) as f:
        lines = f.read().splitlines()
    if len(lines) != 200 or any(len(line.split()) != 37 for line in lines):
        fail(f"{label}: the spectrum file is not 200 x 37 ({len(lines)} lines)")


def accuracy_check(root, gate_args=GATE_ARGS, label="accuracy", sigmas=None):
    """Phase 10 (and 12c): the accuracy gate on the card with ``gate_args``,
    its launches counted (:func:`path_launches`; no plain hot step).  Its
    luminosity ratio must lie within 1 +- GATE_LUM_TOL or, with
    ``sigmas``, within that many of the tool's own sigmas.  Returns the
    launch counts."""
    import io

    from grmonty_tpu_torch.tools import validate_accuracy
    from grmonty_tpu_torch.transport import hot_kernels

    args = validate_accuracy.parse_args(
        gate_args + ["--json", os.path.join(root, ".cache", f"chip_smoke_{label}.json")])
    cfg = validate_accuracy._config(args)[0]
    t0 = time.monotonic()
    # the tool's JSON goes to the file
    with contextlib.redirect_stdout(io.StringIO()), counting_plain_steps() as plain_steps:
        hot_kernels.reset_launches()
        out = validate_accuracy.run(args)
        counts = dict(hot_kernels.launches)
    decomp, run = out["origin_decomp"] or {}, out["engine_run"]
    line = {"phase": label, "photons": out["n_engine"], "mass_unit": out["mass_unit"],
            "reference": out["engine_config"]["reference"],
            "dtype": out["engine_config"]["dtype"],
            "freeze_bias": out["freeze_bias"], "oracle_reps": out["oracle_reps"],
            "lum_ratio": out["lum_ratio"], "lum_ratio_rel_sigma": out["lum_ratio_rel_sigma"],
            "rec_ratio": out["rec_ratio"], "chi2_per_dof": out["chi2_per_dof"],
            "dof": out["dof"], "chi2_counts_per_dof": out["chi2_counts_per_dof"],
            **{k: decomp.get(k) for k in ("chi2_prim_per_dof", "kappa_fit", "kappa_gen_fit",
                                          "chi2_sec_gen_per_dof", "dof_sec_gen",
                                          "n_sec_engine", "n_sec_oracle")},
            "n_hc_clamp_engine": out["n_hc_clamp_engine"],
            "n_stall_engine": out["n_stall_engine"],
            "max_tau_scatt": [out["max_tau_scatt_engine"], out["max_tau_scatt_oracle"]],
            "engine_s": out["engine_s"], "oracle_s": out["oracle_s"],
            "device_s": run["device_s"], "hot_iters": run["hot_iters"],
            "full_phases": run["full_phases"], "light_phases": run["light_phases"],
            "tail_stages": run["tail_stages"], "launches": counts,
            "plain_steps": plain_steps[0], "seconds": time.monotonic() - t0}
    print(json.dumps(line))
    fails = validate_accuracy.gate_failures(out)
    if fails:
        fail(f"{label} gate: " + "; ".join(fails))
    tol = GATE_LUM_TOL if sigmas is None else sigmas * out["lum_ratio_rel_sigma"]
    if not abs(out["lum_ratio"] - 1.0) <= tol:
        fail(f"{label} gate: lum_ratio {out['lum_ratio']} not within 1 +- {tol}")
    bad = launch_failures(cfg, run, counts)
    if bad or plain_steps[0]:
        fail(f"{label} gate: {bad or ''} {plain_steps[0]} plain hot steps")
    return counts


def sharded_check(root, photon_n, ref=None):
    """Phase 11: the native dump parse against numpy's; ``Simulation``
    (``ref``: phase 8's uninterrupted run, the same setup, or run here)
    against ``ShardedSimulation`` at world size 1 over NCCL, the sharded
    run's launches counted; ``--devices`` beyond the machine's cards
    refused."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from grmonty_tpu_torch.models import harm
    from grmonty_tpu_torch.parallel import sharding
    from grmonty_tpu_torch.transport import hot_kernels

    t_all = time.monotonic()
    dump = torus_dump(root)
    t0 = time.monotonic()
    m_nat = harm.read_dump(dump, 4.0e19)
    parse_native_s = time.monotonic() - t0
    t0 = time.monotonic()
    m_np = harm.read_dump(dump, 4.0e19, native=False)
    parse_numpy_s = time.monotonic() - t0
    parse_equal = bool(m_nat.data.stacked().tobytes() == m_np.data.stacked().tobytes()
                       and m_nat.bias_norm == m_np.bias_norm)

    over = dict(emit_chunk=RESUME_CHUNK, tail_stall_steps=RESUME_TAIL_STALL)
    setup_s = []
    if ref is None:
        t0 = time.monotonic()
        sim = make_simulation(root, photon_n, **over)
        torch.cuda.synchronize()
        setup_s.append(time.monotonic() - t0)
        ref = sim.run()
        del sim
    spec_ref, st_ref = ref
    rdv = tempfile.mkdtemp(prefix="chip_smoke_rdv_", dir=os.path.join(root, ".cache"))
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(rdv, 'rendezvous')}",
                            rank=0, world_size=1)
    try:
        t0 = time.monotonic()
        sim = make_simulation(root, photon_n, cls=sharding.ShardedSimulation, **over)
        torch.cuda.synchronize()
        setup_s.append(time.monotonic() - t0)
        hot_kernels.reset_launches()
        spec, st = sim.run()
        counts = dict(hot_kernels.launches)
        backend = dist.get_backend()
        sim_cfg = sim.cfg
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    del sim

    n_over = torch.cuda.device_count() + 1
    cmd = [sys.executable, "-m", "grmonty_tpu_torch", "--harm_dump_path", dump,
           "--devices", str(n_over), "--photon_n", "1000",
           "--spectrum_path", os.path.join(root, ".cache", "chip_smoke_devices_spectrum")]
    out = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
    refusal = out.stderr.strip().splitlines()[-1:] or [""]

    with np.errstate(invalid="ignore", divide="ignore"):
        rel = np.abs(spec - spec_ref) / np.abs(spec_ref)
    max_rel = float(np.nanmax(np.where(spec_ref == spec, 0.0, rel)))
    keys = ("n_created", "n_recorded", "n_scatt_recorded", "n_tracked", "hot_iters",
            "full_phases", "light_phases", "waves", "n_stall_killed", "n_secondary_dropped")
    result = {"phase": "sharded", "backend": backend, "world_size": st["n_devices"],
              "photon_n": photon_n, "max_rel_spec_diff": max_rel,
              **{k: [st_ref[k], st[k]] for k in keys},
              "device_s": [st_ref["device_s"], st["device_s"]], "reduce_s": st["reduce_s"],
              "setup_s": setup_s, "launches": counts,
              "parse_equal": parse_equal, "parse_s": [parse_native_s, parse_numpy_s],
              "devices_cmd": " ".join(cmd[3:5] + cmd[5:7]), "devices_rc": out.returncode,
              "devices_refusal": refusal[0], "seconds": time.monotonic() - t_all}
    print(json.dumps(result))
    if not parse_equal:
        fail("sharded: the native dump parse differs from numpy's")
    if backend != "nccl" or st["n_devices"] != 1:
        fail(f"sharded: ran on {backend} with {st['n_devices']} ranks")
    if not np.allclose(spec, spec_ref, rtol=1e-6, atol=0.0):
        fail(f"sharded: the spectrum differs from Simulation's by {max_rel} relative")
    moved = [k for k in keys if st_ref[k] != st[k]]
    if moved:
        fail(f"sharded: counts differ from Simulation's: {moved}")
    bad = launch_failures(sim_cfg, st, counts)
    if bad:
        fail(f"sharded: {bad}")
    if out.returncode == 0 or f"need {n_over} devices" not in out.stderr:
        fail(f"sharded: --devices {n_over} was not refused (rc {out.returncode}):\n"
             f"{out.stderr[-2000:]}")


def f64_checks(root, args, usage, sass, ref32=None):
    """Phase 12: float64 on the card.  (a) The float64 kernels against their
    plain float64 versions (:func:`kernel_checks` on a float64
    ``Simulation`` of the smoke cell); (b) that ``Simulation``, the shipped
    profile in float64 with phase 8's waves and cascade step cap, end to
    end (:func:`drive`, its phases clocked) beside ``ref32`` ((stats, phase
    clocks) of phase 8's float32 run of the same setup; run here when
    None); (c) the accuracy gate at reference semantics in float64
    (``F64_GATE_ARGS``); (d) the command line in float64 under reference
    semantics on the 64x32 torus.  Returns the kernel records, each with
    the launches of its path's run."""
    import torch

    from grmonty_tpu_torch.tools import validate_accuracy

    over = dict(emit_chunk=RESUME_CHUNK, tail_stall_steps=RESUME_TAIL_STALL)
    t0 = time.monotonic()
    sim = make_simulation(root, args.resume_photon_n, dtype=torch.float64, **over)
    recs = {rec["name"]: rec for rec in kernel_checks(sim, usage, sass, args.ref_stall_steps)}
    t_kernels = time.monotonic() - t0
    if ref32 is None:
        sim32 = make_simulation(root, args.resume_photon_n, **over)
        with phase_clocks() as clocks:
            _, st32 = sim32.run()
        ref32 = (st32, clock_summary(clocks, st32["device_s"]))
        del sim32
    t0 = time.monotonic()
    stats, counts = drive(sim, "shipped_f64", clocks=True)
    for name in ("hot_step_f64", "row_gather_f64"):
        recs[name]["launches"] = counts[name]
    st32, phases32 = ref32
    keys = ("device_s", "photon_rate_device", "hot_iters", "full_phases", "light_phases",
            "n_recorded", "n_created")
    print(json.dumps({"phase": "f64_vs_f32", "photon_n": args.resume_photon_n,
                      **{k: [st32[k], stats[k]] for k in keys},
                      "tail_stages": [[[st["pool"], st["iters"], st["device_s"]]
                                       for st in s["tail_stages"]] for s in (st32, stats)],
                      "phases_f32": phases32, "kernel_checks_s": t_kernels,
                      "run_s": time.monotonic() - t0}))
    del sim
    counts = accuracy_check(root, F64_GATE_ARGS, "accuracy_f64", sigmas=F64_GATE_SIGMAS)
    recs["hot_step_ref_f64"]["launches"] = counts["hot_step_ref_f64"]
    cli_check(root, F64_CLI_PHOTON_N, extra=F64_CLI_ARGS,
              dump=validate_accuracy._torus(64, 32), label="cli_f64")
    return list(recs.values())


def scatter_dist_check():
    """Phase 13: the scatter-chain probe on the card at SCATTER_N photons a
    cell; every cell's mean and q99 ratios within 1 +- SCATTER_TOL, or
    within SCATTER_SIGMAS of their Monte Carlo errors where wider."""
    import torch

    from grmonty_tpu_torch.tools import probe_scatter_dist

    t0 = time.monotonic()
    cells, errors = probe_scatter_dist.measure(
        SCATTER_N, torch.device("cuda"), out=lambda line: print(f"scatter cell: {line}"))
    keys = ("mean_ratio", "q99_ratio")
    # each ratio's distance from 1 in units of its bar
    over = [{k: abs(c[k] - 1.0) / max(SCATTER_TOL, SCATTER_SIGMAS * err[k]) for k in keys}
            for c, err in zip(cells, errors)]
    print(json.dumps({"phase": "scatter_dist", "n": SCATTER_N, "cells": len(cells),
                      **{f"worst_{k}": max((c[k] for c in cells), key=lambda v: abs(v - 1.0))
                         for k in keys},
                      **{f"{k}_errors": [e[k] for e in errors] for k in keys},
                      "worst_of_bar": max(max(o.values()) for o in over), "tol": SCATTER_TOL,
                      "sigmas": SCATTER_SIGMAS, "seconds": time.monotonic() - t0}))
    for c, err, o in zip(cells, errors, over):
        where = f"theta_e {c['theta_e']}, k0 {c['k0']}"
        if c["engine"]["n"] != SCATTER_N:
            fail(f"scatter_dist: {SCATTER_N - c['engine']['n']} photons never accepted "
                 f"at {where}")
        for k in keys:
            if not o[k] <= 1.0:
                fail(f"scatter_dist: {k} {c[k]} not within 1 +- max({SCATTER_TOL}, "
                     f"{SCATTER_SIGMAS} x {err[k]}) at {where}")


def replay_check(root):
    """Phase 14: the deep-tau replay harness on the card, its launches
    counted (:func:`path_launches` over its two engine runs; no plain hot
    step), its captured birth state and its replays checked."""
    import io

    from grmonty_tpu_torch.tools import replay_deep_tau
    from grmonty_tpu_torch.transport import hot_kernels

    args = replay_deep_tau.parse_args(
        ["--bench-profile", "--photons", str(REPLAY_PHOTONS), "--mass-unit", "4e20",
         "--json", os.path.join(root, ".cache", "chip_smoke_replay.json")])
    cfg, _ = replay_deep_tau.config(args)
    t0 = time.monotonic()
    with contextlib.redirect_stdout(io.StringIO()), counting_plain_steps() as plain_steps:
        hot_kernels.reset_launches()
        out = replay_deep_tau.run(args)
        counts = dict(hot_kernels.launches)
    runs = out["runs"]
    total = {k: sum(r[k] for r in runs.values())
             for k in ("hot_iters", "full_phases", "light_phases")}
    line = {"phase": "replay", "photons": out["photons"], "mass_unit": out["mass_unit"],
            **{k: out.get(k) for k in (
                "engine_max_tau", "engine_max_tau_nominal_steps", "replay_max_tau",
                "tau_ratio_engine_over_replay", "mt_birth_x", "mt_birth_k", "mt_birth_w",
                "mt_birth_nsc0", "mt_birth_null_residual", "mt_birth_n_e", "verdict", "engine_s",
                "engine_nominal_s")},
            "replays": out["replays"], "runs": runs, "launches": counts,
            "plain_steps": plain_steps[0], "seconds": time.monotonic() - t0}
    print(json.dumps(line))
    bad = launch_failures(cfg, total, counts)
    if bad or plain_steps[0]:
        fail(f"replay: {bad or ''} {plain_steps[0]} plain hot steps")
    if "nominal" not in runs:
        fail("replay: the shipped profile grows its steps, but no nominal-step run ran")
    x, k = out["mt_birth_x"], out["mt_birth_k"]
    if not (out["mt_birth_w"] > 0.0 and all(map(math.isfinite, x + k)) and k[0] > 0.0
            and out["mt_birth_n_e"] > 0.0):
        fail(f"replay: mt_* is not a birth state: x {x} k {k} w {out['mt_birth_w']}, "
             f"n_e {out['mt_birth_n_e']}")
    reps = out["replays"]
    if len(reps) != 3 or not all(math.isfinite(r["replay_max_tau"]) for r in reps):
        fail(f"replay: the replays did not run: {reps}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--photon-n", type=float, default=1e5, help="shipped path")
    ap.add_argument("--ref-photon-n", type=float, default=5e4, help="reference path")
    ap.add_argument("--ref-stall-steps", type=int, default=REF_STALL_STEPS,
                    help="the reference path's per-photon step cap")
    ap.add_argument("--resume-photon-n", type=float, default=RESUME_PHOTON_N,
                    help="the resume and command-line phases")
    ap.add_argument("--probe-kernels-only", action="store_true",
                    help="phases 1, 2 and 7a alone, then the card line and the kernels "
                         "line; a copy of this script beside another commit's package "
                         "times that commit's probe kernels the same way")
    ap.add_argument("--sharded-only", action="store_true",
                    help="phases 1, 2 and 11 alone, then the card line")
    ap.add_argument("--ab-hot-step", metavar="DIR", default=None,
                    help="phases 1 and 2, then this checkout's hot step (float32 and "
                         "float64) against the one of the checkout at DIR, in turns; then "
                         "the card line")
    ap.add_argument("--f64-only", action="store_true",
                    help="phases 1, 2 and 12 alone (with the float32 run of phase 12b's "
                         "setup), then the card line and the kernels line")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from grmonty_tpu_torch.transport import hot_kernels, oracle_native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    paths, build_s, log = hot_kernels.build()
    print(f"kernel build: {build_s:.1f} s -> "
          + ", ".join(os.path.relpath(p, root) for p in paths))
    if args.probe_kernels_only:
        recs = probe_kernel_checks()
        print(card)
        print(json.dumps({"kernels": recs}))
        return
    t0 = time.monotonic()
    oracle_native.load()
    print(f"host tracker build: {time.monotonic() - t0:.1f} s -> "
          + os.path.relpath(oracle_native.library_path(), root))
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    usage = ptxas_usage(log)
    sass = {}
    for path in paths:
        sass.update(sass_counts(path))
    for fn, (lds, n_ins) in sass.items():
        print(f"  sass: {fn}: {lds} LDS in {n_ins} instructions")
    if args.sharded_only:
        sharded_check(root, args.resume_photon_n)
        print(card)
        return
    if args.ab_hot_step:
        sims = [make_simulation(root, args.photon_n, dtype=dt)
                for dt in (torch.float32, torch.float64)]
        ab_hot_step(root, sims, args.ab_hot_step, usage, args.ref_stall_steps)
        print(card)
        return
    if args.f64_only:
        recs = f64_checks(root, args, usage, sass)
        print(card)
        print(json.dumps({"kernels": recs}))
        return

    t0 = time.monotonic()
    sim = make_simulation(root, args.photon_n)
    torch.cuda.synchronize()
    print(f"torus + tables: {time.monotonic() - t0:.1f} s")

    kernels = {rec["name"]: rec for rec in kernel_checks(sim, usage, sass,
                                                          args.ref_stall_steps)}

    _, counts = drive(sim, "shipped")
    kernels["hot_step"]["launches"] = counts["hot_step"]
    del sim

    ref_sim = make_simulation(root, args.ref_photon_n, reference=True,
                              stall_steps=args.ref_stall_steps)
    _, counts = drive(ref_sim, "reference")
    for name in ("hot_step_ref", "row_gather"):
        kernels[name]["launches"] = counts[name]
    del ref_sim

    kernels.update((rec["name"], rec) for rec in probe_kernel_checks())
    probes, counts = run_probes()
    for name in ROWSUMS + ("row_gather_rowloop",):
        if counts[name] < 1:
            fail(f"probes: {name} was never launched ({counts})")
        kernels[name]["launches"] = counts[name]
    for name in ROWSUMS:
        kernels[name]["probe_torch_ms"] = probes["probe_vmem_gather"]["torch_ms"]

    ref, phases32 = resume_check(root, args.resume_photon_n)
    cli_check(root, args.resume_photon_n)
    accuracy_check(root)
    sharded_check(root, args.resume_photon_n, ref)
    kernels.update((rec["name"], rec)
                   for rec in f64_checks(root, args, usage, sass, (ref[1], phases32)))
    scatter_dist_check()
    replay_check(root)

    print(card)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
