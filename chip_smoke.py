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
   counters exactly equal; each also in its drawing instance
   (``hot_step_draw``, ``hot_step_ref_draw``: the uniforms drawn inside the
   kernel from the lane's Philox stream, under a seeded key at one step of
   a block) against the plain version on ``draws.hot_uniforms`` under the
   same key and step, within the same tolerance with the census exactly,
   phase A's own fields (``hot_kernels.PHASE_A_FIELDS``) equal on every
   lane, and every field bit for bit the explicit instance's on those
   uniforms (``hot_draw_check``); the drawing instance's runs
   (``hot_run_checks``, phase 4b: one launch of S = 4, 32 and 64 steps in
   place at 65,536, 16,384, 4,096, 1,024 and 512 lanes, bit for bit S
   launches of one step, census included; its device time a launch and a
   step beside one step's launch and the run's bound, ``run check
   <entry>@<n>x<S>`` lines, kept in the record's ``runs``); the row gather
   on the raw corner table at seeded indices, bitwise equal to
   ``table[idx]``.  Each with the time per call of kernel
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
   and timed the same way, in both dtypes, at the tail cascade's widths
   and the accuracy gate's, N = 4,096, 1,024 and 512 (``kernel check
   hot_step@4096: ...``); each hot-step record of the kernels line lists
   every width's instance (``instances``: its group, threads, blocks an
   SM, registers and spills, device time and bound).  The event kernel
   (``scatter_event``, the scatter event of every full phase) on synthetic
   event lanes
   (``hot_kernels.synthetic_events``: seeded positions and null wave
   vectors through the engine's own fluid, guard, inactive, halved and
   forced lanes) at the event phase's widths, N = 16,384, 4,096, 1,024 and 512,
   against the plain ``scattering.scatter_event_c`` drawing from
   ``draws.PhiloxDraws`` under the kernel's key
   (``hot_kernels.compare_event``): masks and round counts equal on every
   active lane and floats on the lanes made and sampled bit for bit (a
   lane that differs is printed and fails the check); each record gives
   the lanes a warp of the instance the width runs (``lanes``, and
   ``group`` = 32 / lanes); its ``plain_ms`` is the plain version drawing
   from a ``torch.Generator``, as the event phase ran before the kernel,
   its ``bound_ms`` counts the rounds its lanes ran (``event_ops``); the
   chain kernel (``scatter_chain``) at the scatter-chain probe's 40,000
   lanes over its (theta_e, k0) grid, held as the event was before
   (masks and round counts equal but where an acceptance test sat within
   a few ulps of its threshold, at most one lane in 10,000; floats within
   rtol 1e-4 of the lane's scale); the generator's raw words
   (``philox_words``) bitwise against the plain version and against
   ``numpy.random.Philox``.  Refill's sources, load and track start
   (``fresh_init``, ``fresh_init_ref`` through ``refill_fresh``: each
   slot's source, the ring's count, the backlog position and n_created,
   refill's row moves and all of ``engine.init_fresh_plain``, in place)
   on synthetic pools and refill slots
   (``hot_kernels.synthetic_refill``: phase 4's lane states, slots from a
   partly filled ring and a backlog that runs out, rows with a NaN or a
   zero weight, padding slots; the birth state untraced, as the main path
   runs, then traced, as phase 14 runs) at the (pool, slots) widths of its
   path (``hot_kernels.FRESH_WIDTHS``), on a copy of the pool and of the
   three counts, against ``engine.refill_sources_plain`` and
   ``engine.init_fresh_plain`` (``hot_kernels.compare_fresh``: every
   loaded field, dk/dlambda, interacting and the birth state bit for bit,
   every lane outside the loaded slots unchanged bit for bit, the
   opacities and the bias within the hot step's tolerance, the three
   counts exactly; ``group`` the
   threads a slot); the event phase's fluid (``event_fluid``) on
   synthetic event lanes at the event phase's widths
   (``hot_kernels.EVENT_FLUID_WIDTHS``) against ``engine.event_fluid_plain``, every
   output within the hot step's tolerance.  The whole event phase
   (``event_phase``: the events' rows, fluid, opacities and bias, the
   event, the outcome, the staged secondaries, in place on the pool) and
   the ring's pack (``compact_rows``) at the path's (pool, compacted width)
   (``hot_kernels.EVENT_PHASE_WIDTHS``: the path's 65,536 x 16,384, 4,096 x
   4,096 and 512 x 512, and 65,536 x 8,192, 4,096 x 512, 512 x 256; the
   kernels line's record at the first) on synthetic pools
   (``hot_kernels.synthetic_event_pool``: parked, shadow-register,
   deferred, forced, doomed and unmagnetised lanes, outside the plasma
   too) against an open ring, a ring with room for half the set and a
   wedged one, on a copy of the pool, against
   ``engine.event_phase_plain`` on ``draws.PhiloxDraws`` under the kernel's
   key and ``engine.pack_rows_plain`` (``hot_kernels.compare_event_phase``:
   every pool field, the staged rows, the counters and the ring bit for
   bit, the refreshed opacities and bias at the event fluid's tolerance;
   ``bound_ms`` counts the event fluid's work and the rounds the events
   ran; ``parts_device_ms`` times the three launches it replaced, the row
   gather, the event fluid and the event alone, on the same events); the
   compaction (``compact``, float32 only: it takes a mask) at
   ``COMPACT_WIDTHS`` on seeded masks of every density of
   ``COMPACT_DENSITIES``, bit for bit ``engine.compact_idx`` (the sort),
   each timed beside the sort (``sort_ms``), ``torch.nonzero``
   (``nonzero_ms``) and ``torch.nonzero_static`` (``library_ms``), and of
   the clear lanes (refill's inverted mask) at the first width.  The
   phases' record (``record_phase``: the poison sweep, the record into the
   spectrum, the frees with their census, the full phase's EMA fold and
   the bias's terms, in place, one launch a call) at the path's (pool,
   width) (``hot_kernels.RECORD_WIDTHS``) on synthetic pools
   (``hot_kernels.synthetic_record``), every stage at once as a light
   phase runs it, the sweep alone, the full phase's record, frees and
   fold, and the last records' record alone at the first width, traced
   too, against ``engine.record_phase_plain`` and
   ``engine.bias_terms_plain`` (``hot_kernels.compare_record``: every
   flag, count, the ratchet, the capture, the fold and the three terms bit
   for bit, the spectrum and w_stall within their sums' slack, the scratch
   at rest after), and at every width the terms in every mode under the
   shipped EMA, the reference's cumulative average and the frozen bias
   (none written).  Each kernel is timed on
   copies of what it updates, a fresh one a call, so that every timed call
   does the same work (warm: the read-only fields stay in L2).  Each
   of these records gives its registers and spills.  Every
   run of phases 5-12 and 14 must launch exactly what its path runs
   (``path_launches``: the drawing hot step of its dtype and semantics once
   per full and light phase, a run of the block's hot steps each, its
   launches' steps (``<entry>.steps``, ``hot_kernels.run_steps``) the hot
   iterations, the event phase and the ring's pack of its dtype once
   per full phase, the compaction at least twice a full phase and once a
   light one, the record exactly once a call of each engine's phases and
   closing flushes (one a run; ``hot_kernels.record_launches``, one a
   call), the sweep once in each block slot of each replay (a block's
   gated first launch), the track start of its dtype and semantics once
   per full and light phase, the exit test at each engine run's entry and
   at the end of each block run, no other entry point: the row
   gather, the event fluid and the event kernel stay off the path), no
   plain hot step or run, load, track start, event fluid, event phase,
   pack, record, refill sources or sort-based compaction, no
   ``torch.sort`` at all (``plain_calls["torch.sort"]``, 0), and no
   ``torch.rand`` inside a block (``counting_plain_steps``: it raises
   there, and the path lines count its calls as
   ``plain_calls["torch.rand_in_block"]``, 0).  The
   kernels line's explicit hot-step records carry ``launches`` null: the
   engine's blocks run the drawing instances.  Phases 5-14 run the engine as it
   ships: each engine's block (the full phase, the hot steps, each light
   phase and its hot steps) captured once into a CUDA graph, a replay
   running ``engine.GRAPH_BODIES`` blocks, each its sweep gated on the
   exit word's go setting the condition of a conditional node that holds
   the rest of the block, which ends with the exit test, the host one
   replay ahead of the exit word it reads; the launches
   credited by the blocks run and the replays; each
   path's line gives its blocks, bodies, replays, skipped replays, engine
   runs, ms per body and ``capture_s`` (``graph_summary``), and phases 5,
   6, 10, 11, 12b, 14 and 15 fail unless the bodies equal the full
   phases, the replays hold them and at most one replay a run ran none
   (``launch_failures``), and one closing flush a run.  Phase 4h: the exit
   test (``exit_test``) at 65,536, 4,096, 1,024 and 512 lanes on seeded
   masks of every density and alignment at each edge of the test, bit for
   bit ``engine.exit_test_plain``, both values of go at every width
   (``exit_test@<n>`` lines); the gated sweep (``gated_sweep_checks``: nothing changed with go clear,
   the ungated sweep's bits with go set, and in a graph the IF node's
   condition set from go; ``gated sweep`` line, kept in the record's
   ``gated_sweep``); and what a replay costs the card alone
   (``replay_cost_check``: a graph of one empty IF node, of one IF node
   whose body is not run, and of one one-element kernel; ``replay cost``
   line, kept in ``exit_test``'s ``replay_cost``);
5. the shipped profile end to end at M = 4e19, seed 123, float32, pool
   65,536, the JAX driver's whole schedule: the pilot (8,192 photons on the
   host tracker; its seconds and counters printed), the waves (the first
   chunk ramped), the tail cascade (each stage's width, iterations and
   device window printed); every run of hot steps of every engine must be
   one launch of ``hot_step_draw``, every full phase's events one launch of
   ``event_phase`` and their secondaries' pack one of ``compact_rows`` (the
   row gather, ``event_fluid`` and ``scatter_event`` none), every
   compaction one of ``compact``, ``fresh_init`` once per full and light
   phase, the cascade must end with the pool empty, the spectrum must be finite with a photon
   count equal to ``n_recorded`` (the pilot's records debited), no
   secondary may be dropped, and the luminosity must lie within 10% of the
   JAX engine's 12694.3 on the same torus and seed;
6. reference semantics end to end on the same cell (``--ref-photon-n``
   photons, ``profiles.reference_config`` with its step cap cut to
   ``--ref-stall-steps``, the same schedule): every run of hot steps must
   be one launch of ``hot_step_ref_draw``, the event phase, the pack and the
   compaction run as in phase 5 (the track start ``fresh_init_ref``
   fetches its raw rows itself, once in each full and light phase), with
   the same checks of the schedule, the spectrum and the luminosity;
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
   ``Simulation``.  The resumed
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
   must lie within 1 +- 0.10, every run of hot steps of its engines must
   be one launch of ``hot_step_draw`` and the event phase one launch a full
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
   ``hot_step_draw`` launch a run, one event phase per full phase);
   ``python -m grmonty_tpu_torch --devices N`` with one rank more than the
   machine has cards must exit non-zero with "need N devices".  The
   set-up seconds of each ``Simulation`` made here (the dump read and the
   per-dump tables on the card) are printed; the numbers go on one line
   (``{"phase": "sharded", ...}``);
12. float64 on the card: (a) phase 4's checks in float64 (``hot_step_f64``,
   ``hot_step_ref_f64`` and their drawing instances at N = 65,536, 4,096,
   1,024 and 512, ``row_gather_f64``
   bitwise, ``scatter_event_f64`` at 16,384, 1,024 and 512 within rtol
   1e-11, ``scatter_chain_f64``, ``fresh_init_f64``, ``fresh_init_ref_f64``
   and ``event_fluid_f64`` within rtol 1e-11, ``event_phase_f64`` and
   ``compact_rows_f64`` as phase 4's), on the tables of a float64
   ``Simulation``
   of the cell; (b)
   that ``Simulation`` end to end, the shipped profile at
   ``--resume-photon-n`` photons with phase 8's waves and cascade step cap,
   under phase 5's checks (``"path": "shipped_f64"``),
   and one line (``{"phase": "f64_vs_f32", ...}``) with its window, rate
   and counts beside phase 8's float32 run; (c) the accuracy gate at
   reference semantics in float64 (``F64_GATE_ARGS``): its hard gates, the
   luminosity ratio within 3 of the tool's sigmas, one ``hot_step_ref_f64_draw``
   launch a run; (d) ``python -m grmonty_tpu_torch --dtype
   float64 --reference`` on the 64x32 torus at ``--photon_n`` 200
   (``F64_CLI_PHOTON_N``), as phase 9;
13. the scatter-chain distribution probe
   (``grmonty_tpu_torch.tools.probe_scatter_dist``) on the card at its full
   ``PROBE_N`` of 40,000 photons a cell over its 3 x 3 grid of (theta_e,
   k0): the engine's deferring samplers in float64, each phase one launch
   of the chain kernel ``scatter_chain_f64`` (the launch counts set to 0
   just before; it must have launched), against the native tracker's
   scalar ones, one line a cell (``scatter cell: {...}``) and one
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
   (``{"phase": "replay", ...}``);
15. the graph against its plain version (run after phase 6): each path in
   float32 and float64 (``GRAPH_RUNS``), a wave of ``GRAPH_PHOTON_N``
   photons and the whole cascade at the path's setup (pool 65,536; the
   pilot cut to ``GRAPH_WARMUP`` photons, the step caps to
   ``RESUME_TAIL_STALL``), run twice on the same seed: graphed, and with
   ``graphed=False`` (the block issued op by op).  The state handed to the
   cascade and the final state must agree bit for bit (pool, ring,
   counters), the spectrum to rtol 1e-6 (float atomics sum it), the launch
   and phase counts exactly; the graphed run must replay one graph a block
   and report a capture.  One line a path (``graph run: {...}``: both
   runs' device windows, rates, ms per body and per hot iteration, the
   replays, ``capture_s``), then ``{"phase": "graph", ...}`` with the
   card's name and power limit.  Neither run may call a plain version or
   ``torch.rand`` inside a block (the eager run issues every block through
   ``Engine._body``).

With ``--probe-kernels-only`` the script runs phases 1, 2 and 7a and
prints the card line and the kernels line (no result line); a copy of it
placed in another commit's checkout times that commit's probe kernels
the same way, which is how two versions are compared in one call.  With
``--sharded-only`` it runs phases 1, 2 and 11 and prints the card line
(no kernels line, no result line); with ``--ab-hot-step DIR`` phases 1
and 2, then this checkout's hot step against the one of the checkout at
DIR in turns (``ab_hot_step``: both dtypes, variants and instances at
``AB_WIDTHS``, every output and census bit for bit the other's, the
drawing instance also as this checkout's run of S steps against the
other's run, or S of its launches (``ab_hot_run``), the SASS of the kernels of
``fresh_init.cu`` and ``scatter_event.cu`` identical to the other's), then
the card line; with
``--ab-phase-kernels DIR`` phases 1 and 2, then this checkout's event
kernel, refill's sources, load and track start and the record against
those of the checkout at DIR in turns (``ab_phase_kernels``: each at its
path's widths in both dtypes, a parent's track start that took its
sources as tensors after those sources as torch ops, a parent's record
from before the bias's terms launched with its own pointers and scratch;
every output bit for bit the parent's,
the record's flags, counts, ratchet and capture), then the card line; with ``--ab-wide DIR`` phases
1 and 2, then this checkout's event phase and compaction against those of
the checkout at DIR in turns (``ab_wide``: the event phase at its widths
and the path's event counts in both dtypes, at each lanes a warp; the
compaction at every width and density beside
``torch.nonzero_static``; every output bit for bit the other's), then the
card line; with ``--f64-only``
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
# the tail cascade's narrower pools and the accuracy gate's pool of 1,024
# lanes (phases 10 and 12c)
TAIL_CHECKS = (4096, 1024, 512)
# --ab-hot-step's widths: the pool, the cascade's and the gate's.
AB_WIDTHS = (N_CHECK, *TAIL_CHECKS)
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
# The event kernel's checks: the event phase's compacted widths (ev_k at the
# pool of 65,536, and the cascade's and the gate's), and the chain kernel's
# lanes, the scatter-chain probe's photons a cell.
EVENT_WIDTHS = (16384, 4096, 1024, 512)
CHAIN_N = 40000
# The event kernels' work, counted by hand from csrc/scatter_event.cu, as
# float operations (every add, multiply, compare-select, division, square
# root and transcendental as one) and 32-bit integer instructions: a Philox
# block is 260 (per round two 64-bit low products, 3 each, two high
# products, 6 each, two three-way 64-bit XORs, 2 each, the key's two 64-bit
# adds, 2 each), counted at the float32 rate (the card's integer pipes run
# at half of it, so the bound stays a least time).  Every lane: 690 (the
# field trial vector, the tetrad's four normalisations and six projections,
# the frames and the masks); a lane that samples: 335 and two Philox blocks
# (the mixture's weights, the two directions, the two boosts, the
# Klein-Nishina set-up); an electron round: 133 and three blocks; a round
# of the second loop: 11 (Thomson's; a Klein-Nishina round is 21) and one
# block.  The chain kernel does no tetrad.
EVENT_OPS = {"lane": 690, "sampled": 335, "electron_round": 133, "second_round": 11}
PHILOX_BLOCK_INT_OPS = 260
EVENT_BLOCKS = {"sampled": 2, "electron_round": 3, "second_round": 1}
# Their operations, counted by hand from csrc/physics.cuh as OPS_PER_LANE
# is: a fresh lane 3,510 (shipped: the connection 255, the geodesic
# right-hand side 96, the cell and the blend 100, the kinematics 26, the
# hotcross 2,860 (its sum 2,542), K2, synch and B_nu 160, the bias and the
# selects 11), 3,600 under reference semantics (the raw blend and its metric
# pair and four-vectors instead of the derived blend); an event lane 3,240
# (the raw blend, metric pair and four-vectors, kinematics, hotcross, K2,
# synch, B_nu, bias, the halved theta_e).  A lane that only keeps its
# values does none.
FRESH_OPS = {False: 3510, True: 3600}
EVENT_FLUID_OPS = 3240
# The compaction's checks: each pool width of the path and the k its
# compactions take there (transport/profiles.py:25-26,45; engine.py): at
# 65,536 lanes the event set (Engine.process_scatters -> engine.event_set)
# at ev_k = 16,384, the light phases' refill at light_k = 12,288
# (Engine.light_phase, shipped profile), a full phase's refill
# (Engine.refill_slots, inverted: the free lanes) at refill_k =
# 32,768 (shipped; 16,384 under reference semantics), and 8,192, the
# engine's default n // 8, which no profile runs; at the cascade's 4,096
# and 512 lanes the whole pool (min(pool, ev_k)) and 512 and 256.  The
# kernels line's record is the first width's at density 0.3.  On seeded
# masks of these densities.
COMPACT_WIDTHS = {65536: (16384, 12288, 32768, 8192), 4096: (4096, 512), 512: (512, 256)}
COMPACT_DENSITIES = (0.0, 0.02, 0.3, 1.0)
# The ring that the event phase's kernels line records run against (the
# other two are checked and printed).
EVENT_PHASE_RING = "room"
PROBE_BLK = 8192  # probe_pallas_gather's default blk (PROBE_BLK) for dsB
ROWSUMS = tuple(f"gather_rowsum_{s}" for s in ("coop", "persistent", "rowloop", "smem"))
OPS_PER_LANE = {"hot_step": 3800, "hot_step_ref": 3840, "row_gather": 0,
                "hot_step_f64": 3800, "hot_step_ref_f64": 3840, "row_gather_f64": 0,
                **{name: W_PROBE - 1 for name in ROWSUMS}, "row_gather_rowloop": 0}
# the drawing instances: the step's float operations (and one Philox block
# a lane, counted where they are checked)
OPS_PER_LANE.update({f"{name}_draw": OPS_PER_LANE[name]
                     for name in ("hot_step", "hot_step_ref", "hot_step_f64",
                                  "hot_step_ref_f64")})
# the records of the phases' record
RECORD_NAMES = ("record_phase", "record_phase_f64")
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
    **{f"{name}_draw": (f"against engine.hot_step_plain on draws.hot_uniforms under the same key "
                        f"and step: as {name}; phase A's own fields equal on every lane; every "
                        f"field bit for bit {name}'s on those uniforms")
       for name in ("hot_step", "hot_step_ref", "hot_step_f64", "hot_step_ref_f64")},
    **{name: ("against the plain version on draws.PhiloxDraws under the same key: masks and "
              "round counts equal on every active lane, floats on the lanes made and sampled "
              "bit for bit")
       for name in ("scatter_event", "scatter_event_f64")},
    **{name: ("against the plain version on draws.PhiloxDraws under the same key: masks and "
              "round counts equal on every lane but where an acceptance test sat "
              "within 16 ulps of its threshold, at most one lane in 10,000; floats on the "
              f"lanes accepted within rtol {rtol} of the lane's scale")
       for name, rtol in (("scatter_chain", "1e-4"), ("scatter_chain_f64", "1e-11"))},
    "philox_words": "bitwise equal to the plain version and to numpy.random.Philox",
    **{name: ("against engine.refill_sources_plain and engine.init_fresh_plain, on a copy of "
              "the pool, updated in place: every loaded field, dk/dlambda, interacting and the "
              "birth state bitwise equal on the loaded lanes, every other lane's fields bitwise "
              f"unchanged; alpha_scatti, alpha_absi and bi within rtol {rtol} atol {atol} on the "
              "started lanes; the ring's count, backlog_pos and n_created exactly equal, the "
              "ticket back at 0")
       for name, rtol, atol in (("fresh_init", "1e-4", "1e-6"), ("fresh_init_ref", "1e-4", "1e-6"),
                                ("fresh_init_f64", "1e-11", "1e-30"),
                                ("fresh_init_ref_f64", "1e-11", "1e-30"))},
    **{name: f"every output within rtol {rtol} atol {atol} on every lane (NaN where the plain "
             "version's is NaN)"
       for name, rtol, atol in (("event_fluid", "1e-4", "1e-6"),
                                ("event_fluid_f64", "1e-11", "1e-30"))},
    **{name: ("against the plain version on draws.PhiloxDraws under the same key, on a copy of "
              "the pool, in every ring (open, room for half the set, wedged): every pool field, "
              "the make flags, the staged rows that make one, the counters and the ring after "
              f"the pack bit for bit; alpha_scatti, alpha_absi and bi within rtol {rtol} atol "
              f"{atol} on every lane")
       for name, rtol, atol in (("event_phase", "1e-4", "1e-6"),
                                ("event_phase_f64", "1e-11", "1e-30"))},
    "compact": "valid, gi and sidx bitwise equal to engine.compact_idx (the sort)",
    **{name: ("on copies of the pool, the spectrum and the counters, updated in place: every "
              "pool field and every counter but w_stall (the chosen lanes' counts, "
              "max_tau_scatt, the birth capture) bitwise equal to engine.record_phase_plain; "
              "each spectrum entry and w_stall within (m + 1) eps |plain|, m the entry's adds "
              "(the atomics add in another order)") for name in RECORD_NAMES},
    **{name: ("the ring's rows, count and n_sec_drop bitwise equal to engine.pack_rows_plain "
              "(the cumsum pack)") for name in ("compact_rows", "compact_rows_f64")},
    "exit_test": ("the word and go bitwise equal to engine.exit_test_plain at every density, "
                  "alignment of the mask and edge of the test"),
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
# The event kernels replace no TPU kernel: the JAX event phase is XLA.
EVENT_SOURCE = ("scatter_event.cu", "no TPU kernel: XLA process_scatters, "
                "grmonty_tpu/transport/engine.py:2036; grmonty_tpu/ops/scattering.py:125")
SOURCES.update({name: EVENT_SOURCE for name in ("scatter_event", "scatter_chain",
                                                "philox_words")})
# Nor do refill and the track start and the event fluid: the JAX engine's
# are XLA.
SOURCES.update({name: ("fresh_init.cu", "no TPU kernel: XLA refill and init_fresh, "
                       "grmonty_tpu/transport/engine.py:2204, "
                       "grmonty_tpu/transport/engine.py:2320")
                for name in ("fresh_init", "fresh_init_ref")})
SOURCES["event_fluid"] = ("event_fluid.cu", "no TPU kernel: XLA process_scatters, "
                          "grmonty_tpu/transport/engine.py:2036")
# Nor do the whole event phase and the compaction: the JAX engine's are XLA
# (compact_idx a sort, the ring's pack a cumsum and a scatter).
SOURCES["event_phase"] = ("scatter_event.cu", "no TPU kernel: XLA process_scatters, "
                          "grmonty_tpu/transport/engine.py:2036")
SOURCES["compact"] = ("compact.cu", "no TPU kernel: XLA compact_idx (a sort), "
                      "grmonty_tpu/transport/engine.py:1956")
SOURCES["compact_rows"] = ("compact.cu", "no TPU kernel: XLA process_scatters' pack (a cumsum "
                           "and a scatter), grmonty_tpu/transport/engine.py:2036")
# Nor does the record: the JAX engine's is XLA.
SOURCES["record_phase"] = ("record.cu", "no TPU kernel: XLA spectrum_add, _poison_sweep and "
                           "_record_free_refill, grmonty_tpu/transport/engine.py:1819, "
                           "grmonty_tpu/transport/engine.py:2395, "
                           "grmonty_tpu/transport/engine.py:2410")
# Nor does the run's exit test: the JAX engine's is the cond of its
# lax.while_loop, which XLA evaluates on the device.
SOURCES["exit_test"] = ("exit_test.cu", "no TPU kernel: XLA's lax.while_loop cond of run, "
                        "grmonty_tpu/transport/engine.py:2531")
# The float64 instantiations replace what their float32 kernels replace, and
# each hot step's drawing instance what the hot step replaces.
SOURCES.update({f"{name}_f64": SOURCES[name]
                for name in ("hot_step", "hot_step_ref", "row_gather", "scatter_event",
                             "scatter_chain", "fresh_init", "fresh_init_ref", "event_fluid",
                             "event_phase", "compact_rows", "record_phase")})
SOURCES.update({f"{name}_draw": SOURCES[name]
                for name in ("hot_step", "hot_step_ref", "hot_step_f64", "hot_step_ref_f64")})
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


def cuda_ms(fn, reps=REPS, queued=False, or_none=False):
    """Mean milliseconds per call of ``fn`` by CUDA events, after a warm-up;
    the host's launch pace is part of the time.  ``queued``: the calls are
    enqueued while the stream runs a GPU sleep, so the events time the
    device's work alone; the sleep is lengthened until it outlasts the
    enqueueing (``or_none``: None where it never does, as for a call that
    reads the device on the host; else the check fails).  ``fn`` must
    launch few kernels: the device queues about a thousand launches, and
    the host blocks beyond that."""
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
    if or_none:
        return None
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
                slack=None, n=N_CHECK, extra=None, nan_equal=False):
    """Hold ``got`` against ``ref`` under the kernel's tolerance (plus
    ``slack`` per lane where given; ``nan_equal`` as ``hot_kernels.compare``
    takes it), time plain, kernel, kernel, plain (one
    pair of each per call, averaged), the kernel's device time and the
    library call, and return the record, updated by ``extra``; ``ops`` is
    the call's work, ``OPS_PER_LANE`` over ``n`` lanes unless given, in
    float64 for a float64 instantiation (``*_f64``), else float32."""
    from grmonty_tpu_torch.transport import hot_kernels

    err, rel, mask, fails = hot_kernels.compare(ref, got, **hot_kernels.KERNEL_TOLERANCE[name],
                                                slack=slack, nan_equal=nan_equal)
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
           "library_device_ms": (None if library is None
                                 else cuda_ms(library, queued=True, or_none=True)),
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
    """(reference, type, group, threads, draw) of a mangled hot_step_kernel
    instantiation: the type "float" for the float-only kernels before the
    float64 ones; the group (threads a lane) 1 and the threads a block None
    for those before the group instances; ``draw`` whether the instance
    draws its uniforms (False for those before the drawing instances)."""
    m = re.search(r"hot_step_kernelILb([01])E(?:([fd])(?:Li(\d+)E)?(?:Li(\d+)E)?(?:Lb([01])E)?E)?",
                  fn)
    if m is None:
        return None
    return (m.group(1) == "1", {"f": "float", "d": "double"}.get(m.group(2), "float"),
            int(m.group(3) or 1), m.group(4) and int(m.group(4)), m.group(5) == "1")


def ptxas_label(v):
    """The ``hot step ptxas:`` lines' name of a hot-step instance."""
    return "{}/{}/G{}/T{}/{}".format("reference" if v[0] else "shipped", v[1], v[2], v[3],
                                     "draw" if v[4] else "explicit")


def bit_diff(a, b):
    """(N,) mask of the elements of ``a`` and ``b`` whose bits differ."""
    import torch

    if a.dtype.is_floating_point:
        iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return a.view(iv) != b.view(iv)
    return a != b


def anon(text):
    """``text`` with each translation unit's anonymous namespace, whose
    mangled name hashes the source's path, named alike."""
    return re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "_anon_", text)


def ab_hot_step(root, sims, other, usage, ref_stall_steps, turns=2):
    """``--ab-hot-step``: this checkout's hot step against the one of the
    checkout at ``other`` (its ``csrc/hot_step.cu`` built with this build's
    flags; its C interface is the same, so this wrapper launches it on the
    same arguments), each variant and dtype at AB_WIDTHS in both instances
    (explicit, and drawing under a seeded key at the block's step 5), on
    phase 4's lanes (``sims``: a float32 and a float64 ``Simulation`` of the
    cell): each side's worst errors against the plain version and its
    census; every pool field and census counter of this side against the
    other's on the same inputs, bit for bit (the fields and lanes that
    differ printed, with the worst relative difference); the device time in
    turns (this, other, other, this, ``turns`` times); each side's ptxas
    registers and spills (and a ``hot step ptxas:`` line with every
    instance's beside the other's: a growth fails), this side's group,
    threads and blocks an SM; and
    whether each instance's SASS is identical to the other's (reported: a
    run's loop moves the hot step's).  The drawing instance also as a run
    of S steps against the other's run, or S of its launches where it runs
    no run (:func:`ab_hot_run`).
    Then the SASS of every kernel of the other checkout's ``fresh_init.cu``
    and ``scatter_event.cu`` (the track start, the event, the chain, the
    event phase), built the same way, against this build's.  Prints one
    line per variant, instance and width; fails if a census differs from
    the plain version's, after all lines if an output or a census of a step
    or a run differs from the other side's or another kernel's SASS
    differs."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from grmonty_tpu_torch.ops import draws
    from grmonty_tpu_torch.transport import engine, hot_kernels, profiles

    with ThreadPoolExecutor(3) as ex:
        built = dict(zip(AB_SASS_STEMS, ex.map(lambda stem: build_other(root, other, stem),
                                               AB_SASS_STEMS)))
    lib, usage_other, lib_path = built["hot_step"]
    other_usage = {hot_step_variant(f): v for f, v in usage_other.items() if hot_step_variant(f)}
    this_usage = {hot_step_variant(f): v for f, v in usage.items() if hot_step_variant(f)}
    # every instance's registers and spills beside the other's (a growth
    # in either fails the comparison)
    names = {ptxas_label(k): k for k in set(this_usage) | set(other_usage)}
    print("hot step ptxas: " + json.dumps({
        label: {"this": this_usage.get(k), "other": other_usage.get(k)}
        for label, k in sorted(names.items())}))
    grew = sorted(label for label, k in names.items()
                  if k in this_usage and k in other_usage and any(
                      this_usage[k].get(f, 0) > other_usage[k].get(f, 0)
                      for f in ("registers", "spill_stores", "spill_loads")))
    mine_all = {f: v for path in hot_kernels._Build.paths for f, v in sass_listing(path).items()}
    mine_sass = {hot_step_variant(f): v for f, v in mine_all.items() if hot_step_variant(f)}
    other_sass = {hot_step_variant(f): v for f, v in sass_listing(lib_path).items()
                  if hot_step_variant(f)}
    problems = [f"ptxas: registers or spills grew in {grew}"] if grew else []
    for sim in sims:
        mc, tabs, dev, dt = sim.mc, sim.tables, sim.device, sim.cfg.dtype
        typ = "double" if dt == torch.float64 else "float"
        for reference in (False, True):
            for draw in (False, True):
                name = hot_kernels.entry_point("hot_step", dt, reference, draw=draw)
                theirs = getattr(lib, f"{name}_launch")
                theirs.argtypes = hot_kernels._Build.fns[name].argtypes
                theirs.restype = ctypes.c_int
                fns = {"this": hot_kernels._Build.fns[name], "other": theirs}
                for n in AB_WIDTHS:
                    cfg = (profiles.reference_config(pool=n, dtype=dt,
                                                     stall_steps=ref_stall_steps)
                           if reference else sim.cfg._replace(n_pool=n))
                    lanes = hot_kernels.synthetic_lanes(mc, n, 2024, cfg.stall_steps,
                                                        reference, events=True)
                    pool, counters, u_roul, u_x1, bias = hot_kernels.synthetic_step(
                        lanes, dt, dev)
                    key = torch.tensor([0x407D4A00 + n, 0x5EED5], dtype=torch.int64,
                                       device=dev)
                    if draw:
                        u_roul, u_x1 = draws.hot_uniforms(key, 5, n, dt)

                    def step(fn, c=None):
                        if c is None:
                            c = counters._replace(**{k: getattr(counters, k).clone()
                                                     for k in hot_kernels.CENSUS})
                        if fn is engine.hot_step_plain or not draw:
                            return fn(pool, c, u_roul, u_x1, bias, mc, tabs, cfg)
                        return hot_kernels.hot_step_drawn(pool, c, key, 5, bias, mc, tabs,
                                                          cfg)

                    ref_f, ref_c = hot_kernels.step_outputs(*step(engine.hot_step_plain),
                                                            reference)
                    slack = hot_kernels.weight_slack(pool, ref_f,
                                                     hot_kernels.KERNEL_TOLERANCE[name]["rtol"])
                    shape = hot_kernels.hot_step_shape(name, n)
                    rec = {"name": name, "n": n, **shape,
                           "device_ms": {"this": [], "other": []}}
                    got = {}
                    launch = hot_kernels.hot_step_drawn if draw else hot_kernels.hot_step
                    try:
                        for side, fn in fns.items():
                            hot_kernels._Build.fns[name] = fn
                            got[side] = hot_kernels.step_outputs(*step(launch), reference)
                            torch.cuda.synchronize()
                            err, rel, mask, fails = hot_kernels.compare(
                                ref_f, got[side][0], **hot_kernels.KERNEL_TOLERANCE[name],
                                slack=slack)
                            rec[side] = {"max_abs_err": err, "max_rel_err": rel,
                                         "mask_mismatch": mask, "fails": fails,
                                         "census_equal": got[side][1] == ref_c}
                        # timed as phase 4 times it: the census added to one set
                        # of counters, no copies between the launches
                        kc = counters._replace(**{k: getattr(counters, k).clone()
                                                  for k in hot_kernels.CENSUS})
                        for _ in range(turns):
                            for side in ("this", "other", "other", "this"):
                                hot_kernels._Build.fns[name] = fns[side]
                                rec["device_ms"][side].append(
                                    cuda_ms(lambda: step(launch, kc), queued=True))
                    finally:
                        hot_kernels._Build.fns[name] = fns["this"]
                    mine_f, theirs_f = (hot_kernels._flat(got[s][0]) for s in ("this", "other"))
                    differ = {}
                    for f in mine_f:
                        d = bit_diff(mine_f[f], theirs_f[f])
                        if bool(d.any()):
                            a, b = mine_f[f][d].double(), theirs_f[f][d].double()
                            worst = float(((a - b).abs() / b.abs()).nan_to_num(
                                nan=float("inf")).max())
                            differ[f] = {"lanes": int(d.sum()),
                                         "first": torch.nonzero(d)[:8, 0].tolist(),
                                         "worst_rel": worst}
                    rec["bitwise_vs_other"] = not differ
                    rec["differ"] = differ
                    rec["census_vs_other"] = got["this"][1] == got["other"][1]
                    key_i = (reference, typ, shape["group"], shape["threads"], draw)
                    # the same instance in the other checkout, or its one
                    # instance of the variant, type and drawing where it builds a
                    # single one
                    theirs_key = key_i if key_i in other_sass else next(
                        (k for k in other_sass if k[:2] == key_i[:2] and k[4] == draw), None)
                    rec["ptxas"] = {"this": this_usage.get(key_i),
                                    "other": other_usage.get(theirs_key)}
                    theirs_sass, mine = other_sass.get(theirs_key), mine_sass.get(key_i)
                    rec["sass_identical"] = theirs_sass is not None and mine == theirs_sass
                    rec["sass_instructions"] = {"this": len(mine or []),
                                                "other": len(theirs_sass or [])}
                    print(f"ab {name}@{n}: {json.dumps(rec)}")
                    if not (rec["this"]["census_equal"] and rec["other"]["census_equal"]):
                        fail(f"ab {name}@{n}: a census differs from the plain version's")
                    if differ or not rec["census_vs_other"]:
                        problems.append(f"{name}@{n}: fields {sorted(differ)}, census "
                                        f"{'equal' if rec['census_vs_other'] else 'differs'}")
                    if draw:
                        problems += ab_hot_run(
                            name, fns, pool, counters, key, bias, mc, tabs, cfg, turns,
                            getattr(lib, f"{name}_nscal")() >= hot_kernels._HOT_NSCAL + 2)
    mine_anon = {anon(f): [anon(ins) for ins in v] for f, v in mine_all.items()}
    for stem in AB_SASS_STEMS[1:]:
        same = {anon(f): mine_anon.get(anon(f)) == [anon(ins) for ins in v]
                for f, v in sass_listing(built[stem][2]).items()}
        print(f"ab sass {stem}: "
              + json.dumps({"functions": len(same), "identical": sum(same.values())}))
        if not same or not all(same.values()):
            problems.append(f"{stem}: SASS of {sorted(f for f, ok in same.items() if not ok)}")
    if problems:
        fail("ab: " + "; ".join(problems))


# --ab-hot-step: the sources built from the other checkout: the hot step's,
# then those whose kernels' SASS must not move (the track start, the event,
# the chain and the event phase include the shared csrc/physics.cuh)
AB_SASS_STEMS = ("hot_step", "fresh_init", "scatter_event")
# --ab-hot-step's runs: this checkout's run of S steps against S of the
# other's drawing launches (a run of 4 in a shipped wave body, 64 in a
# cascade body)
AB_RUN_STEPS = (4, 64)


def ab_hot_run(name, fns, pool, counters, key, bias, mc, tabs, cfg, turns, other_runs):
    """``--ab-hot-step``'s runs of the drawing entry point ``name``: this
    side's run of S steps (``hot_kernels.hot_run``, one launch in place)
    against the other side's run of S steps where its entry point runs
    them (``other_runs``), else against S launches of it (each
    ``hot_kernels.hot_step_drawn``, into new tensors; an entry point from
    before the run reads its step and ignores the steps) from the block's
    step 5, at each S of AB_RUN_STEPS: every pool field and census counter
    bit for bit, the device time of the runs (or of the S launches) in
    turns (this, other, other, this; ``turns`` times).  Prints a line
    each; returns the problems."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    n, reference = pool.w.shape[0], cfg.reference

    def copy():
        return engine.clone_pool(pool), counters._replace(
            **{c: getattr(counters, c).clone() for c in hot_kernels.CENSUS})

    def chained(p, c, steps):
        for j in range(steps):
            p, c = hot_kernels.hot_step_drawn(p, c, key, 5 + j, bias, mc, tabs, cfg)
        return p, c

    def other(p, c, steps):
        if other_runs:
            return hot_kernels.hot_run(p, c, key, 5, steps, bias, mc, tabs, cfg)
        return chained(p, c, steps)

    problems = []
    for steps in AB_RUN_STEPS:
        try:
            hot_kernels._Build.fns[name] = fns["other"]
            theirs = other(*copy(), steps)
            hot_kernels._Build.fns[name] = fns["this"]
            mine = hot_kernels.hot_run(*copy(), key, 5, steps, bias, mc, tabs, cfg)
            torch.cuda.synchronize()
            (mine_f, mine_c), (theirs_f, theirs_c) = (
                hot_kernels.step_outputs(*side, reference) for side in (mine, theirs))
            flat_m, flat_t = hot_kernels._flat(mine_f), hot_kernels._flat(theirs_f)
            differ = sorted(f for f in flat_m if bool(bit_diff(flat_m[f], flat_t[f]).any()))
            work, chain = copy(), copy()
            sides = {"this": lambda: hot_kernels.hot_run(*work, key, 5, steps, bias, mc, tabs,
                                                         cfg),
                     "other": lambda: other(*chain, steps)}
            device_ms = {"this": [], "other": []}
            for _ in range(turns):
                for side in ("this", "other", "other", "this"):
                    hot_kernels._Build.fns[name] = fns[side]
                    device_ms[side].append(cuda_ms(sides[side], reps=RUN_REPS, queued=True))
        finally:
            hot_kernels._Build.fns[name] = fns["this"]
        rec = {"name": f"{name}.run", "n": n, "steps": steps, "other_runs": other_runs,
               "device_us_launch": {k: [1e3 * v for v in vs] for k, vs in device_ms.items()},
               "device_us_step": {k: 1e3 * sum(vs) / len(vs) / steps
                                  for k, vs in device_ms.items()},
               "bitwise_vs_other": not differ, "census_vs_other": mine_c == theirs_c,
               "differ": differ}
        print(f"ab run {name}@{n}x{steps}: {json.dumps(rec)}")
        if differ or mine_c != theirs_c:
            problems.append(f"{name}@{n}: a run of {steps} steps differs from the other's: "
                            f"fields {differ}, census "
                            f"{'equal' if mine_c == theirs_c else 'differs'}")
    return problems


# --ab-phase-kernels: the event's lanes a warp and the track start's
# threads a slot that each side is timed at besides the width's own
AB_EVENT_LANES = (32, 8, 1)
AB_REPS = 10  # the parent's sources and start are some 20 launches a call


def build_other(root, other, stem):
    """Build the checkout ``other``'s ``csrc/<stem>.cu`` with this build's
    flags (and its own headers) into build/grmonty_tpu_torch/; returns the
    loaded library, {kernel function: ptxas registers and spills} and the
    library's path."""
    import ctypes

    from grmonty_tpu_torch.transport import hot_kernels

    src = os.path.join(other, "grmonty_tpu_torch", "csrc", f"{stem}.cu")
    lib_path = os.path.join(root, "build", "grmonty_tpu_torch", f"ab_other_{stem}.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = subprocess.run([nvcc, *hot_kernels.NVCC_FLAGS, "-I", os.path.dirname(src), "-o",
                          lib_path, src], capture_output=True, text=True)
    if out.returncode != 0:
        fail(f"ab: nvcc failed for {src}:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(lib_path), ptxas_usage(out.stdout + out.stderr), lib_path


def turns_of(sides, turns, before=None, host_paced=()):
    """{side: device ms a call, one value a turn} of the A/B ``sides`` ({name:
    function}, with "this" and "other"), in turns: this, other, the other
    sides, other, this; ``turns`` times.  ``before``: a function of the side's
    name run before each timing (outside it: a side that updates its inputs
    in place starts each timing from the same state); the sides in
    ``host_paced`` (a call that reads the device on the host) are timed
    back to back, the host's pace included."""
    ms = {k: [] for k in sides}
    order = ["this", "other"] + [k for k in sides if k not in ("this", "other")]
    for _ in range(turns):
        for k in order + ["other", "this"]:
            if before is not None:
                before(k)
            ms[k].append(cuda_ms(sides[k], reps=AB_REPS, queued=k not in host_paced))
    return ms


# --ab-wide: the event phase's event counts beside the room ring's k / 2
# (the path's full phases at pool 65,536, from profile_slice.py --trace); the
# pack's slot counts (the path's compacted widths) with the rows they make
# (the wave's events a phase and all slots, the synthetic record's 6,489, the
# cascade's one event and half its slots)
AB_PHASE_EVENTS = {65536: (11000, 13000, 16384)}
AB_ROWS = {16384: (6489, 11000, 13000, 16384), 4096: (1, 2048), 512: (1, 256)}


def ab_wide(root, sims, other, usage, turns=2):
    """``--ab-wide``: this checkout's event phase and compaction against
    those of the checkout at ``other`` (its ``csrc/scatter_event.cu`` and
    ``csrc/compact.cu`` built with this build's flags), by device time a
    call in turns (this, other, this's other shapes, other, this; ``turns``
    times).  The event phase in float32 and float64 (``sims``) at
    ``hot_kernels.EVENT_PHASE_WIDTHS`` on the room ring, and at
    ``AB_PHASE_EVENTS``' counts, each side in place on its own copy of the
    pool (the same states call by call: every side gives the same bits), this
    side also at each of its dtype's ``hot_kernels.EVENT_PHASE_LANES``
    instances; every output bit for bit the
    other's on a fresh copy, each timing starting from the pool as made.  The compaction at
    ``COMPACT_WIDTHS`` and ``COMPACT_DENSITIES``, bit for bit the other's,
    beside ``torch.nonzero_static`` in the same turns.  The ring's pack at
    ``AB_ROWS`` in both dtypes against a ring with room for every row and
    one with room for half (:func:`ab_rows`).  Prints one line per kernel
    and width; fails where an output differs."""
    import ctypes

    import numpy as np
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    ev_lib, ev_usage, _ = build_other(root, other, "scatter_event")
    cp_lib, cp_usage, _ = build_other(root, other, "compact")

    def swapped(lib, name, fn):
        """``fn`` run with the other checkout's entry point ``name``."""
        ours = hot_kernels._Build.fns[name]
        theirs = getattr(lib, f"{name}_launch")
        theirs.argtypes, theirs.restype = ours.argtypes, ctypes.c_int

        def call(*a, **kw):
            hot_kernels._Build.fns[name] = theirs
            try:
                return fn(*a, **kw)
            finally:
                hot_kernels._Build.fns[name] = ours
        return call

    for sim in sims:
        mc, tabs, dev, dt = sim.mc, sim.tables, sim.device, sim.cfg.dtype
        typ = "d" if dt == torch.float64 else "f"
        name = hot_kernels.entry_point("event_phase", dt)
        cases = [(n, k, None) for n, k in hot_kernels.EVENT_PHASE_WIDTHS]
        cases += [(n, k, e) for n, k in hot_kernels.EVENT_PHASE_WIDTHS
                  for e in AB_PHASE_EVENTS.get(n, ()) if k == max(
                      kk for nn, kk in hot_kernels.EVENT_PHASE_WIDTHS if nn == n)]
        for n, k, events in cases:
            pool, sec, counters, den = hot_kernels.synthetic_event_pool(
                sim.engine, n, k, 2040 + k, "room", events=events)
            sel, room, wedged = engine.event_set(pool, sec, k)
            key = torch.tensor([0x5EED0000 + k, 0xE7E27], dtype=torch.int64, device=dev)

            works = {}

            def side(label, fn, **kw):
                work = engine.clone_pool(pool)
                wc = engine.Counters(*(t.clone() for t in counters))
                works[label] = (work, wc)

                def run():
                    return fn(work, wc, sel, room, wedged, den, mc, tabs, key=key, **kw)
                return run

            def restore(label):
                work, wc = works[label]
                for dst, src in zip(hot_kernels._flat(work._asdict()).values(),
                                    hot_kernels._flat(pool._asdict()).values()):
                    if dst is not None:
                        dst.copy_(src)
                for dst, src in zip(wc, counters):
                    dst.copy_(src)

            ours = hot_kernels.event_phase
            specs = {"this": (ours, {}), "other": (swapped(ev_lib, name, ours), {}),
                     **{f"lanes{L}": (ours, {"lanes": L})
                        for L in hot_kernels.EVENT_PHASE_LANES[dt]}}
            outs = {label: side(label, fn, **kw)() for label, (fn, kw) in specs.items()}
            sides = {label: side(label, fn, **kw) for label, (fn, kw) in specs.items()}
            torch.cuda.synchronize()
            want = outs["other"]
            differ = {}
            for label, got in outs.items():
                a, b = (hot_kernels._flat({**o[0]._asdict(), **o[1]._asdict(),
                                           "rows": o[2].rows[o[2].make], "make": o[2].make})
                        for o in (want, got))
                differ[label] = sorted(f for f, v in a.items()
                                       if v.shape != b[f].shape
                                       or not bool(hot_kernels._same_bits(v, b[f]).all()))
            on = sel[0] & ((torch.arange(k, device=dev) < room) | wedged)
            rec = {"name": name, "n": n, "k": k, "events": int(on.sum()),
                   **hot_kernels.event_shape(name, k),
                   "fields_differing": differ,
                   "device_ms": turns_of(sides, turns, before=restore),
                   "ptxas": {s_: {f: v for f, v in use.items()
                                  if f"event_phase_kernelI{typ}" in f}
                             for s_, use in (("this", usage), ("other", ev_usage))}}
            print(f"ab {name}@{n}x{k}e{int(on.sum())}: {json.dumps(rec)}")
            if any(differ.values()):
                fail(f"ab {name}@{n}x{k}: outputs differ from the other checkout's: {differ}")

    dev = sims[0].device
    for n, ks in COMPACT_WIDTHS.items():
        rng = np.random.default_rng(n)
        for density in COMPACT_DENSITIES:
            mask = torch.as_tensor(rng.random(n) < density, device=dev)
            for k in ks:
                def this(m=mask, kk=k):
                    return hot_kernels.compact(m, kk)

                sides = {"this": this, "other": swapped(cp_lib, "compact", this),
                         "nonzero_static": lambda m=mask, kk=k, nn=n: torch.nonzero_static(
                             m, size=kk, fill_value=nn)}
                got, want = sides["this"](), sides["other"]()
                torch.cuda.synchronize()
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                rec = {"name": "compact", "n": n, "k": k, "density": density,
                       "set": int(mask.sum()), "same_bits": same,
                       "device_ms": turns_of(sides, turns),
                       "ptxas": {s_: {f: v for f, v in use.items() if "compact" in f
                                      and "rows" not in f}
                                 for s_, use in (("this", usage), ("other", cp_usage))}}
                print(f"ab compact@{n}k{k}d{density}: {json.dumps(rec)}")
                if not same:
                    fail(f"ab compact@{n}k{k}d{density}: differs from the other checkout's")
    for sim in sims:
        ab_rows(sim.cfg.dtype, dev, cp_lib, cp_usage, usage, swapped, turns)


def ab_rows(dt, dev, cp_lib, cp_usage, usage, swapped, turns):
    """The ring's pack in ``dt`` against the other checkout's (``cp_lib``) at
    ``AB_ROWS``, on a ring with room for every flagged row and on one with
    room for half of them: every ring row, the count and n_sec_drop bit for
    bit the other's and the plain pack's; then timed in turns (this, other,
    ``stage.rows[stage.make]`` host paced, other, this), each timing on a
    ring that holds its calls' rows (the count restored before each
    timing).  Prints one line a case; fails where an output differs."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    name = hot_kernels.entry_point("compact_rows", dt)
    ours = hot_kernels.compact_rows
    ticket = hot_kernels.rows_ticket(dev)
    for k, mades in AB_ROWS.items():
        for made in mades:
            for room in sorted({made + 3, max(0, made // 2)}):
                stage, sec, counters = hot_kernels.synthetic_rows(k, made, room, dt, dev, 2050)
                rsec, rc = engine.pack_rows_plain(stage, sec, counters)
                outs = {}
                for label, fn in (("this", ours), ("other", swapped(cp_lib, name, ours))):
                    wsec = engine.SecBuf(*(t.clone() for t in sec))
                    wc = engine.Counters(*(t.clone() for t in counters))
                    outs[label] = fn(stage, wsec, wc, ticket)
                torch.cuda.synchronize()
                differ = {label: [f for f, a, b in (("rows", o[0].rows, rsec.rows),
                                                   ("count", o[0].count, rsec.count),
                                                   ("n_sec_drop", o[1].n_sec_drop,
                                                    rc.n_sec_drop))
                                  if not bool(hot_kernels._same_bits(a, b).all())]
                          for label, o in outs.items()}
                big = engine.SecBuf(torch.empty((256 * k + 2 * k, engine.ROW_WIDTH), dtype=dt,
                                                device=dev),
                                    torch.zeros((), dtype=torch.int64, device=dev))
                tc = engine.Counters(*(t.clone() for t in counters))

                def call(fn):
                    return lambda: fn(stage, big, tc, ticket)

                sides = {"this": call(ours), "other": call(swapped(cp_lib, name, ours)),
                         "rows[make]": lambda: stage.rows[stage.make]}
                rec = {"name": name, "k": k, "made": made, "room": room,
                       **hot_kernels.rows_shape(name, k), "fields_differing": differ,
                       "device_ms": turns_of(sides, turns,
                                             before=lambda _: big.count.fill_(2 * k - room),
                                             host_paced=("rows[make]",)),
                       "ptxas": {s_: {f: v for f, v in use.items() if "compact_rows" in f}
                                 for s_, use in (("this", usage), ("other", cp_usage))}}
                print(f"ab {name}@{k}m{made}r{room}: {json.dumps(rec)}")
                if any(differ.values()):
                    fail(f"ab {name}@{k}m{made}r{room}: differs from the plain pack: {differ}")


def ab_phase_kernels(root, sims, other, usage, turns=2):
    """``--ab-phase-kernels``: this checkout's event kernel, load and
    track start and record (:func:`ab_record`) against those of the
    checkout at ``other`` (its ``csrc/scatter_event.cu``,
    ``csrc/fresh_init.cu`` and ``csrc/record.cu`` built with this build's
    flags), in float32 and float64 (``sims``), by device time a
    call in turns (this, other, this's other shapes, other, this; ``turns``
    times).  The event at EVENT_WIDTHS on phase 4's synthetic events, this
    side at the width's own lanes a warp and at each of AB_EVENT_LANES,
    every output bit for bit the other's.  Refill's sources, load and start
    at each semantics' FRESH_WIDTHS on phase 4's synthetic pools and slots
    (untraced), this side one launch in place (``refill_fresh``, on copies
    of the three counts, one a call), the other side one launch in place
    on its own copy where its start has this one's interface, else (a
    start from before it worked out the sources) those sources as the
    torch ops they were (``engine.refill_sources_plain``) and then its
    kernel, every field bit for bit the other's.  Prints one
    line per kernel and width; fails where an output differs."""
    import ctypes

    import torch

    from grmonty_tpu_torch.tools import clock_phase_kernels
    from grmonty_tpu_torch.transport import engine, hot_kernels

    ev_lib, ev_usage, _ = build_other(root, other, "scatter_event")
    fr_lib, fr_usage, _ = build_other(root, other, "fresh_init")

    def fn_of(lib, name):
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = hot_kernels._Build.fns[name].argtypes
        fn.restype = ctypes.c_int
        return fn

    for sim in sims:
        mc, tabs, dev, dt = sim.mc, sim.tables, sim.device, sim.cfg.dtype
        typ = "d" if dt == torch.float64 else "f"
        name = hot_kernels.entry_point("scatter_event", dt)
        theirs = fn_of(ev_lib, name)
        ours = hot_kernels._Build.fns[name]
        for n in EVENT_WIDTHS:
            _, k, fl, g7, active, force, _ = hot_kernels.synthetic_events(sim.engine, n, 2026)
            key = torch.tensor([0x5EED0000 + n, 0xC0FFEE], dtype=torch.int64, device=dev)

            def event(lanes=None, fn=ours):
                hot_kernels._Build.fns[name] = fn
                try:
                    return hot_kernels.scatter_event(k, fl, g7, mc.b_unit, active, force,
                                                     key=key, lanes=lanes)
                finally:
                    hot_kernels._Build.fns[name] = ours

            want = event(fn=theirs)
            sides = {"this": event, "other": lambda: event(fn=theirs),
                     **{f"lanes{L}": (lambda L=L: event(L)) for L in AB_EVENT_LANES}}
            differ = {}
            for side, fn in sides.items():
                got = fn()
                torch.cuda.synchronize()
                bad = torch.zeros(n, dtype=torch.bool, device=dev)
                for f, a in hot_kernels._flat(want._asdict()).items():
                    bad |= ~hot_kernels._same_bits(a, hot_kernels._flat(got._asdict())[f])
                differ[side] = int(bad.sum())
            rec = {"name": name, "n": n, **hot_kernels.event_shape(name, n),
                   "rounds": [int(want.rounds_el.sum()), int(want.rounds_sc.sum()),
                              int(want.rounds_el.max()), int(want.rounds_sc.max())],
                   "lanes_differing": differ, "device_ms": turns_of(sides, turns),
                   "ptxas": {side: {f: v for f, v in use.items()
                                    if f"scatter_event_kernelI{typ}" in f}
                             for side, use in (("this", usage), ("other", ev_usage))}}
            print(f"ab {name}@{n}: {json.dumps(rec)}")
            if any(differ.values()):
                fail(f"ab {name}@{n}: outputs differ from the other checkout's: {differ}")

        ticket = hot_kernels.fresh_ticket(dev)
        for reference in (False, True):
            name = hot_kernels.entry_point("fresh_init", dt, reference)
            theirs = fn_of(fr_lib, name)
            # the other's start has this one's interface, or is the start
            # before it worked out refill's sources (the sources mode)
            abi = (getattr(fr_lib, f"{name}_nptrs")(), getattr(fr_lib, f"{name}_nscal")())
            if abi not in (hot_kernels._ABI[name], clock_phase_kernels.sources_mode_abi()):
                fail(f"ab {name}: the other checkout's start takes {abi} (pointers, scalars), "
                     "neither this one's nor the sources mode's")
            same = abi == hot_kernels._ABI[name]
            for n, k in hot_kernels.FRESH_WIDTHS[reference]:
                pool, slots, counters, den, cfg = hot_kernels.synthetic_refill(
                    mc, n, k, 2031 + k, dt, dev, reference=reference, trace_birth=False)
                work, o_work = engine.clone_pool(pool), engine.clone_pool(pool)

                def scalars():
                    return (slots._replace(sec=engine.SecBuf(slots.sec.rows,
                                                             slots.sec.count.clone()),
                                           backlog_pos=slots.backlog_pos.clone()),
                            counters._replace(n_created=counters.n_created.clone()))

                mine, yours = Copies(scalars), Copies(scalars)

                def other_side():
                    if not same:
                        return clock_phase_kernels.launch_sources_mode(
                            theirs, o_work, slots, counters, den, mc, tabs, cfg)
                    ours_fn = hot_kernels._Build.fns[name]
                    hot_kernels._Build.fns[name] = theirs
                    try:
                        return hot_kernels.refill_fresh(o_work, *yours(), den, mc, tabs, cfg,
                                                        ticket)[0]
                    finally:
                        hot_kernels._Build.fns[name] = ours_fn

                def this_side():
                    return hot_kernels.refill_fresh(work, *mine(), den, mc, tabs, cfg, ticket)[0]

                want = other_side()
                sides = {"this": this_side, "other": other_side}
                differ = {}
                for side, fn in sides.items():
                    got = fn()
                    torch.cuda.synchronize()
                    flat_w, flat_g = (hot_kernels._flat(p._asdict()) for p in (want, got))
                    differ[side] = {f: int((~hot_kernels._same_bits(a, flat_g[f])).sum())
                                    for f, a in flat_w.items()
                                    if not bool(hot_kernels._same_bits(a, flat_g[f]).all())}
                load = engine.refill_sources_plain(slots, counters)[3]
                loaded, started = hot_kernels.fresh_lanes(pool, load)
                rec = {"name": name, "n": n, "k": k, **hot_kernels.fresh_shape(name, k),
                       "sources_mode": not same,
                       "lanes_loaded": int(loaded.sum()), "lanes_fresh": int(started.sum()),
                       "fields_differing": differ, "device_ms": turns_of(sides, turns),
                       "ptxas": {side: {f: v for f, v in use.items()
                                        if f"fresh_init_kernelILb{int(reference)}E{typ}" in f}
                                 for side, use in (("this", usage), ("other", fr_usage))}}
                print(f"ab {name}@{n}x{k}: {json.dumps(rec)}")
                if any(differ.values()):
                    fail(f"ab {name}@{n}x{k}: outputs differ from the other checkout's: "
                         f"{differ}")
    ab_record(root, sims, other, usage, turns)


def ab_record(root, sims, other, usage, turns=2):
    """``--ab-phase-kernels``' record: this checkout's against the record of
    the checkout at ``other`` (its ``csrc/record.cu`` built with this
    build's flags), in float32 and float64 (``sims``), at
    ``hot_kernels.RECORD_WIDTHS`` (every mode of ``RECORD_MODES`` at the
    first width, a light phase's call at the others) on synthetic pools,
    by device time a call in turns (this, other, other, this; ``turns``
    times), each call on a fresh copy of the pool, the spectrum and the
    counters (:class:`Copies`).  This side runs as the engine does (the
    bias's terms written, the full phase's EMA fold); the other one its
    own record, through this wrapper where it takes this interface, else
    launched with its own pointers, ticket and scratch (a record from
    before the terms: the counters it knew, two launches above one tile).
    Every flag, count, the ratchet and the capture bit for bit the
    other's; prints one line per width and mode; fails where they
    differ."""
    import ctypes

    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    lib, o_usage, _ = build_other(root, other, "record")
    lib.record_phase_scratch.argtypes = [ctypes.c_int]
    lib.record_phase_scratch.restype = ctypes.c_int
    for sim in sims:
        mc, dev, dt = sim.mc, sim.device, sim.cfg.dtype
        typ = "d" if dt == torch.float64 else "f"
        name = hot_kernels.entry_point("record_phase", dt)
        ours = hot_kernels._Build.fns[name]
        theirs = getattr(lib, f"{name}_launch")
        theirs.argtypes, theirs.restype = ours.argtypes, ctypes.c_int
        abi = (getattr(lib, f"{name}_nptrs")(), getattr(lib, f"{name}_nscal")())
        same = abi == hot_kernels._ABI[name]
        old_counters = hot_kernels._RECORD_COUNTERS[:11]  # the counters before the terms
        for j, (n, k) in enumerate(hot_kernels.RECORD_WIDTHS):
            ticket, o_ticket = hot_kernels.record_ticket(dev, n), (
                hot_kernels.record_ticket(dev, n) if same
                else torch.zeros(1, dtype=torch.int32, device=dev))
            o_scratch = None if same else torch.zeros(lib.record_phase_scratch(n),
                                                      dtype=torch.uint8, device=dev)
            for label in RECORD_MODES if j == 0 else ("light",):
                sweep, record, free = RECORD_MODES[label]
                mode = dict(sweep=sweep, record=record, free=free)
                fold = label == "full"
                pool, spec, counters, cfg = hot_kernels.synthetic_record(
                    mc, n, k, 4545 + n + k, dt, dev, trace_birth=False)
                bias = hot_kernels.record_bias(dt, dev)

                def fresh():
                    return hot_kernels.clone_record(pool, spec, counters)

                def this(work):
                    return hot_kernels.record_phase(*work, k, mc, cfg, ticket, bias=bias,
                                                    fold=fold, **mode)

                def that(work):
                    if same:
                        hot_kernels._Build.fns[name] = theirs
                        try:
                            return hot_kernels.record_phase(*work, k, mc, cfg, o_ticket,
                                                            bias=bias, fold=fold, **mode)
                        finally:
                            hot_kernels._Build.fns[name] = ours
                    p, sp, c = work
                    ptrs = [*p.x, *p.k, p.w, p.e, p.x1i, p.x2i, p.tau_abs, p.tau_scatt,
                            p.n_e_0, p.theta_e_0, p.b_0, p.e_0, p.n_scatt, p.nsc0, p.n_step,
                            p.alive, p.occupied, p.record_pending, p.at_event, p.ev_pending,
                            *[None] * 9, sp, *[getattr(c, f) for f in old_counters],
                            o_ticket, o_scratch]
                    bits = (sweep * hot_kernels.RECORD_SWEEP + record * hot_kernels.RECORD_RECORD
                            + free * hot_kernels.RECORD_FREE)
                    scal = hot_kernels._record_scalars(mc, k if record else 1, bits,
                                                       cfg.stall_steps, dev, dt)[:abi[1]]
                    arr = (ctypes.c_void_p * len(ptrs))(
                        *[None if t is None else t.data_ptr() for t in ptrs])
                    rc = theirs(arr, (ctypes.c_double * len(scal))(*map(float, scal)), n,
                                ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
                    if rc != 0:
                        fail(f"ab {name}: the other checkout's record failed: CUDA error {rc}")
                    return work

                outs = {"this": this(fresh()), "other": that(fresh())}
                torch.cuda.synchronize()
                flat = {side: hot_kernels._flat({**o[0]._asdict(),
                                                 **{f: getattr(o[2], f) for f in old_counters
                                                    if f != "w_stall"}})
                        for side, o in outs.items()}
                differ = sorted(f for f, a in flat["other"].items()
                                if not bool(hot_kernels._same_bits(a, flat["this"][f]).all()))
                sides = {"this": (lambda c=Copies(fresh): this(c())),
                         "other": (lambda c=Copies(fresh): that(c()))}
                rec = {"name": name, "n": n, "k": k, "mode": label, "other_interface": same,
                       "pending": int(pool.record_pending.sum()),
                       "recorded": int(outs["other"][2].n_recorded - counters.n_recorded),
                       "fields_differing": differ, "device_ms": turns_of(sides, turns),
                       "ptxas": {side: {f: v for f, v in use.items()
                                        if "record_" in f and f"I{typ}" in f}
                                 for side, use in (("this", usage), ("other", o_usage))}}
                print(f"ab {name}.{label}@{n}x{k}: {json.dumps(rec)}")
                if differ:
                    fail(f"ab {name}.{label}@{n}x{k}: differs from the other checkout's: "
                         f"{differ}")


# what the kernels line keeps of each width's hot-step instance
HOT_INSTANCE_KEYS = ("group", "threads", "blocks_per_sm", "ptxas", "device_ms", "bound_ms")


def hot_step_checks(sim, usage, sass, ref_stall_steps, n=N_CHECK):
    """Phase 4a (and 12a): the hot step of each semantics, in ``sim``'s
    dtype, against its plain version at ``n`` lanes of synthetic state
    drawn at the path's step cap (the shipped ``sim.cfg``'s,
    ``ref_stall_steps`` under reference semantics), its census counters
    exactly; then its drawing instance (:func:`hot_draw_check`) on the same
    state.  ``usage``/``sass``: the build's ptxas and SASS counts by kernel
    function.  Returns the records of both instances."""
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
        rec = time_kernel(name, ref_f, got_f, plain, kern, moved, slack=slack, n=n,
                          extra=hot_instance(name, n, reference, dt, usage, sass))
        rec["census"] = got_c
        print(f"  {name}@{n}: census {got_c}; group {rec['group']}, {rec['threads']}-thread "
              f"blocks, {rec['blocks_per_sm']} an SM; ptxas {rec['ptxas']}; {rec['lds']} LDS "
              f"in {rec['sass_instructions']} instructions")
        # the explicit instance runs outside the engine's blocks only
        rec["launches"] = None
        out.append(rec)
        out.append(hot_draw_check(sim, cfg, pool, counters, bias, usage, sass,
                                  moved - nbytes(u_roul, u_x1), rec["device_ms"]))
    return out


def hot_instance(name, n, reference, dt, usage, sass, draw=False):
    """The instance a launch of ``name`` at ``n`` lanes runs
    (hot_step_kernel<reference, type, group, threads, draw>): its shape
    (``hot_kernels.hot_step_shape``), its ptxas registers and spills, its
    shared-memory loads and instructions in the SASS."""
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    shape = hot_kernels.hot_step_shape(name, n)
    inst = (reference, "double" if dt == torch.float64 else "float", shape["group"],
            shape["threads"], draw)
    lds, n_ins = next((v for f, v in sass.items() if hot_step_variant(f) == inst), (None, None))
    return {**shape, "ptxas": next((v for f, v in usage.items() if hot_step_variant(f) == inst),
                                   None), "lds": lds, "sass_instructions": n_ins}


def hot_draw_check(sim, cfg, pool, counters, bias, usage, sass, moved, explicit_device_ms):
    """The hot step's drawing instance (``hot_kernels.hot_step_drawn``) at
    ``cfg``'s semantics and width on the pool ``pool``, under a seeded key
    at the block's step 5: against its plain version (``draws.hot_uniforms``
    under the same key and step, then ``engine.hot_step_plain``) within the
    kernel's tolerance with the census exactly; phase A's own fields
    (``hot_kernels.PHASE_A_FIELDS``) equal on every lane; and every field
    bit for bit the explicit instance's on those uniforms.  ``moved``: the
    explicit launch's bytes without its two uniform arrays;
    ``explicit_device_ms``: its device time, printed beside this one's.
    Returns the record (``<entry>_draw``)."""
    import torch

    from grmonty_tpu_torch.ops import draws
    from grmonty_tpu_torch.transport import engine, hot_kernels

    mc, tabs, dev, dt = sim.mc, sim.tables, sim.device, cfg.dtype
    reference, n, step_i = cfg.reference, cfg.n_pool, 5
    name = hot_kernels.entry_point("hot_step", dt, reference, draw=True)
    key = torch.tensor([0x407D4A00 + n, 0x5EED5], dtype=torch.int64, device=dev)

    def fresh():
        return counters._replace(**{c: getattr(counters, c).clone() for c in hot_kernels.CENSUS})

    def plain():
        u_roul, u_x1 = draws.hot_uniforms(key, step_i, n, dt)
        return engine.hot_step_plain(pool, counters, u_roul, u_x1, bias, mc, tabs, cfg)

    u_roul, u_x1 = draws.hot_uniforms(key, step_i, n, dt)
    ref_f, ref_c = hot_kernels.step_outputs(*plain(), reference)
    got_f, got_c = hot_kernels.step_outputs(
        *hot_kernels.hot_step_drawn(pool, fresh(), key, step_i, bias, mc, tabs, cfg), reference)
    exp_f, _ = hot_kernels.step_outputs(
        *hot_kernels.hot_step(pool, fresh(), u_roul, u_x1, bias, mc, tabs, cfg), reference)
    torch.cuda.synchronize()
    if got_c != ref_c:
        fail(f"{name}@{n}: census {got_c} != the plain version's {ref_c}")
    a_fields = hot_kernels.PHASE_A_FIELDS[reference]
    a_differ = {f: int((ref_f[f] != got_f[f]).sum()) for f in a_fields}
    if any(a_differ.values()):
        fail(f"{name}@{n}: phase A's own fields differ from the plain version's: {a_differ}")
    flat_got, flat_exp = hot_kernels._flat(got_f), hot_kernels._flat(exp_f)
    not_bitwise = sorted(f for f in flat_got
                         if not bool(hot_kernels._same_bits(flat_got[f], flat_exp[f]).all()))
    if not_bitwise:
        fail(f"{name}@{n}: not bit for bit the explicit instance's on the same uniforms: "
             f"{not_bitwise}")
    kc = fresh()

    def kern():
        return hot_kernels.hot_step_drawn(pool, kc, key, step_i, bias, mc, tabs, cfg)

    slack = hot_kernels.weight_slack(pool, ref_f, hot_kernels.KERNEL_TOLERANCE[name]["rtol"])
    # the operations: the step's, and one Philox block a lane at the
    # float32 rate
    ops = event_ops_equiv(OPS_PER_LANE[name] * n, PHILOX_BLOCK_INT_OPS * n, kernel_dtype(name))
    rec = time_kernel(name, ref_f, got_f, plain, kern, moved + nbytes(key), slack=slack, n=n,
                      ops=ops, extra={**hot_instance(name, n, reference, dt, usage, sass, True),
                                      "step": step_i, "phase_a_fields": list(a_fields),
                                      "bitwise_vs_explicit": True})
    rec["census"] = got_c
    print(f"  {name}@{n}: device {rec['device_ms'] * 1e3:.2f} us a launch against the explicit "
          f"instance's {explicit_device_ms * 1e3:.2f}; ptxas {rec['ptxas']}; group "
          f"{rec['group']}, {rec['blocks_per_sm']} blocks an SM")
    return rec


# Phase 4b's runs (and 12a's): every instance width of the drawing hot step
# and the steps a run takes on the path (a shipped wave body's four runs of
# 4, a reference wave body's run of 32, a cascade body's run of 64).
RUN_WIDTHS = (N_CHECK, 16384, *TAIL_CHECKS)
RUN_STEPS = (4, 32, 64)
RUN_REPS = 4  # timed runs of the chained steps a call: few launches queued


def step_cells(pool, mc):
    """The bilinear cells of the pool's positions, as the hot step finds
    the cell whose corner row it fetches (its pushed position, the pool's
    after the step but on a lane that rolled back): the rows a step
    reads, for a bound."""
    import torch

    ii = torch.floor((pool.x[1] - mc.x_start[1]) / mc.dx[1] - 0.5).clamp(0, mc.n1 - 2)
    jj = torch.floor((pool.x[2] - mc.x_start[2]) / mc.dx[2] - 0.5).clamp(0, mc.n2 - 2)
    return torch.unique((ii * mc.n2 + jj).long())


def hot_run_checks(sim, usage, sass, ref_stall_steps):
    """Phase 4b (and 12a): a run of the drawing hot step of each semantics
    in ``sim``'s dtype (``hot_kernels.hot_run``: one launch of S steps, in
    place) against S launches of one step each (``hot_kernels.hot_step_drawn``,
    into new tensors) on phase 4's synthetic lanes under one key from the
    block's step 5: every pool field and census counter bit for bit, at
    every width of RUN_WIDTHS and S of RUN_STEPS (the run's tensors its
    own, one launch of S steps counted).  Each timed on the card: the run's
    device time a launch and a step, one step's launch, and the run's bound
    (each lane's fields read and written once, the corner rows its S steps
    touch, its operations and Philox blocks S times).  Returns {entry point:
    {"<n>x<S>": record}}; fails on a differing bit."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels, profiles

    mc, tabs, dev, dt = sim.mc, sim.tables, sim.device, sim.cfg.dtype
    out = {}
    for reference in (False, True):
        name = hot_kernels.entry_point("hot_step", dt, reference, draw=True)
        table = tabs.corner_rows if reference else tabs.hot_tab
        for n in RUN_WIDTHS:
            cfg = (profiles.reference_config(pool=n, dtype=dt, stall_steps=ref_stall_steps)
                   if reference else sim.cfg._replace(n_pool=n))
            lanes = hot_kernels.synthetic_lanes(mc, n, 2024, cfg.stall_steps, reference,
                                                events=True)
            pool, counters, _, _, bias = hot_kernels.synthetic_step(lanes, dt, dev)
            key = torch.tensor([0x407D4A00 + n, 0x5EED5], dtype=torch.int64, device=dev)

            def copy():
                return engine.clone_pool(pool), counters._replace(
                    **{c: getattr(counters, c).clone() for c in hot_kernels.CENSUS})

            for steps in RUN_STEPS:
                want_p, want_c = copy()
                cells = []  # the corner rows the steps fetch: each step's cells
                for j in range(steps):
                    want_p, want_c = hot_kernels.hot_step_drawn(want_p, want_c, key, 5 + j,
                                                                bias, mc, tabs, cfg)
                    cells.append(step_cells(want_p, mc))
                cells = torch.unique(torch.cat(cells))
                got_p, got_c = copy()
                held = engine.pool_tensors(got_p)
                n0, s0 = hot_kernels.launches[name], hot_kernels.run_steps[name]
                back = hot_kernels.hot_run(got_p, got_c, key, 5, steps, bias, mc, tabs, cfg)
                torch.cuda.synchronize()
                in_place = (back[0] is got_p and all(
                    a is b for a, b in zip(engine.pool_tensors(back[0]), held, strict=True))
                    and hot_kernels.launches[name] == n0 + 1
                    and hot_kernels.run_steps[name] == s0 + steps)
                got_f, got_cen = hot_kernels.step_outputs(got_p, got_c, reference)
                want_f, want_cen = hot_kernels.step_outputs(want_p, want_c, reference)
                flat_got, flat_want = hot_kernels._flat(got_f), hot_kernels._flat(want_f)
                differ = sorted(f for f in flat_got if not bool(
                    hot_kernels._same_bits(flat_got[f], flat_want[f]).all()))
                work = copy()
                run_ms = cuda_ms(lambda: hot_kernels.hot_run(*work, key, 5, steps, bias, mc,
                                                             tabs, cfg),
                                 reps=RUN_REPS, queued=True)
                one = copy()
                step_ms = cuda_ms(lambda: hot_kernels.hot_step_drawn(*one, key, 5, bias, mc,
                                                                     tabs, cfg), queued=True)
                lane_bytes = nbytes(hot_kernels._pool_cols(pool), pool.occupied,
                                    [] if reference else hot_kernels._ev_cols(pool))
                moved = (2 * lane_bytes + 2 * nbytes([getattr(counters, c)
                                                      for c in hot_kernels.CENSUS])
                         + nbytes(key, bias, tabs.hc_coeffs)
                         + cells.numel() * table.shape[1] * table.element_size())
                ops = event_ops_equiv(OPS_PER_LANE[name] * n * steps,
                                      PHILOX_BLOCK_INT_OPS * n * steps, kernel_dtype(name))
                bound_ms, bound_by = bound(moved, ops, kernel_dtype(name))
                rec = {"name": f"{name}.run", "n": n, "steps": steps,
                       **hot_instance(name, n, reference, dt, usage, sass, True),
                       "device_us_launch": 1e3 * run_ms, "device_us_step": 1e3 * run_ms / steps,
                       "one_step_device_us": 1e3 * step_ms, "bound_us": 1e3 * bound_ms,
                       "bound_by": bound_by, "bytes": moved, "cells": cells.numel(),
                       "bitwise_vs_steps": not differ and got_cen == want_cen,
                       "in_place": in_place}
                print(f"run check {name}@{n}x{steps}: {json.dumps(rec)}")
                if differ or got_cen != want_cen or not in_place:
                    fail(f"{name}@{n}: a run of {steps} steps is not {steps} launches of one "
                         f"step: fields {differ}, census {got_cen} against {want_cen}, in "
                         f"place {in_place}")
                out.setdefault(name, {})[f"{n}x{steps}"] = {
                    k: rec[k] for k in ("device_us_launch", "device_us_step",
                                        "one_step_device_us", "bound_us", "bound_by",
                                        "group", "threads", "ptxas")}
    return out


def kernel_checks(sim, usage, sass, ref_stall_steps):
    """Phase 4 (and 12a): every kernel of the path in ``sim``'s dtype vs its
    plain version at N_CHECK lanes (the records returned), the hot step
    at the cascade's and the gate's widths (printed, and kept in each
    hot-step record's ``instances``), and the drawing hot step's runs
    (:func:`hot_run_checks`, kept in its record's ``runs``)."""
    import numpy as np
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    out = hot_step_checks(sim, usage, sass, ref_stall_steps)
    tails = [rec for n in TAIL_CHECKS
             for rec in hot_step_checks(sim, usage, sass, ref_stall_steps, n=n)]
    runs = hot_run_checks(sim, usage, sass, ref_stall_steps)
    for rec in out:
        rec["instances"] = {r["n"]: {k: r[k] for k in HOT_INSTANCE_KEYS}
                            for r in [rec] + tails if r["name"] == rec["name"]}
        if rec["name"] in runs:
            rec["runs"] = runs[rec["name"]]
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
    out += event_checks(sim, usage) + fresh_checks(sim, usage) + event_fluid_checks(sim, usage)
    out += event_phase_checks(sim, usage)
    if sim.cfg.dtype == torch.float32:  # the compaction and the exit test: one dtype
        out += compact_checks(sim.device) + exit_test_checks(sim.device)
        out[-1]["replay_cost"] = replay_cost_check(sim.device)
    gated = gated_sweep_checks(sim)
    out += record_checks(sim, usage)
    for rec in out:
        if rec["name"] == hot_kernels.entry_point("record_phase", sim.cfg.dtype):
            rec["gated_sweep"] = gated
    return out


def fresh_moved_bytes(pool, load, ref, table, tabs, den, mc, trace):
    """The bytes refill's sources, load and start on ``pool`` must move,
    each once (``load``: the sources, ``engine.refill_sources_plain``):
    every slot's lane and valid flag; the ring's count, the backlog
    position and n_created, read and written; a loaded slot's row and the
    32 fields it writes; a started lane's 8 start fields (17 traced) and
    the corner rows its cell touches (``ref``: the plain result); the
    surface and the denominator."""
    import torch

    from grmonty_tpu_torch.ops import fluid
    from grmonty_tpu_torch.transport import hot_kernels

    t = pool.w.element_size()
    loaded, started = hot_kernels.fresh_lanes(pool, load)
    n_loaded, n_started = int(loaded.sum()), int(started.sum())
    cells = torch.unique(fluid.cell_index_c(ref.x[1][started], ref.x[2][started], mc))
    return (load.sidx.shape[0] * (8 + 1) + 3 * 2 * 8 + n_loaded * (16 * t + 23 * t + 4 * 4 + 5)
            + n_started * ((7 + (9 if trace else 0)) * t + 1)
            + cells.numel() * table.shape[1] * table.element_size()
            + nbytes(tabs.hc_coeffs, den))


def event_fluid_checks(sim, usage):
    """Phase 4e (and 12a): the event fluid in ``sim``'s dtype against
    ``engine.event_fluid_plain`` at ``hot_kernels.EVENT_FLUID_WIDTHS`` on synthetic event
    lanes (``hot_kernels.synthetic_event_fluid``), every output within the
    kernel's tolerance.  Returns the record at the first width; prints the
    others."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    mc, tabs, dt = sim.mc, sim.tables, sim.cfg.dtype
    name = hot_kernels.entry_point("event_fluid", dt)
    inst = f"event_fluid_kernelI{'d' if dt == torch.float64 else 'f'}E"
    ptx = next((v for f, v in usage.items() if inst in f), None)
    out = []
    for j, n in enumerate(hot_kernels.EVENT_FLUID_WIDTHS):
        args = hot_kernels.synthetic_event_fluid(sim.engine, n, 2032 + n)
        plain = lambda: engine.event_fluid_plain(*args, mc, tabs)  # noqa: E731
        kern = lambda: hot_kernels.event_fluid(*args, mc, tabs)  # noqa: E731
        ref = hot_kernels.event_fluid_outputs(plain())
        got = hot_kernels.event_fluid_outputs(kern())
        torch.cuda.synchronize()
        bitwise = sorted(f for f in ref if bool(hot_kernels._same_bits(ref[f], got[f]).all()))
        moved = nbytes(args, tabs.hc_coeffs, ref)
        # the synthetic guard lanes' NaN wave vectors give NaN on both sides
        rec = time_kernel(name, ref, got, plain, kern, moved, ops=EVENT_FLUID_OPS * n, n=n,
                          nan_equal=True,
                          extra={"ptxas": ptx, "library_ms": None, "library_device_ms": None,
                                 "bitwise_fields": len(bitwise), "fields": len(ref)})
        print(f"  {name}@{n}: {len(bitwise)} of {len(ref)} outputs bitwise "
              f"(not: {sorted(set(ref) - set(bitwise))}); ptxas {ptx}")
        if j == 0:
            out.append(rec)
    return out


def event_phase_moved_bytes(pool, sel, on, res, stage, mc, extra):
    """The bytes an event phase must move, each once: every slot's valid
    flag, lane and make flag; an event's position and wave vector (x1, x2,
    k), weight, defer count and shadow flag read and its defer count
    written, a run event's at_event or ev_pending flag; the raw corner rows
    of the events' cells; a surviving parent's three opacities and bias, a
    doomed parent's weight and two flags; a secondary's six inputs and its
    16-wide row; ``extra`` (the surface, the key, the scalars)."""
    import torch

    from grmonty_tpu_torch.ops import fluid

    t = pool.w.element_size()
    _, gi, _ = sel
    lanes = gi[on]
    reg = pool.ev_pending[lanes]
    x1 = torch.where(reg, pool.ev_x[1][lanes], pool.x[1][lanes])
    x2 = torch.where(reg, pool.ev_x[2][lanes], pool.x[2][lanes])
    cells = torch.unique(fluid.cell_index_c(x1, x2, mc)).numel()
    ran = on & (res.sampled | res.parent_die)
    n_on, n_ran = int(on.sum()), int(ran.sum())
    reg_all = torch.zeros_like(on)
    reg_all[on] = reg
    n_surv = int((ran & ~res.parent_die & ~reg_all).sum())
    n_die = int((ran & res.parent_die & ~reg_all).sum())
    n_make = int(stage.make.sum())
    k = on.shape[0]
    return (k * 10 + n_on * (7 * t + 9) + n_ran + cells * 32 * t + n_surv * 3 * t
            + n_die * (t + 2) + n_make * (22 * t + 4) + nbytes(*extra))


@contextlib.contextmanager
def captured_events():
    """Keep each result of ``scattering.scatter_event_c`` made inside (the
    plain event phase's event: its rounds count the bound's work)."""
    from grmonty_tpu_torch.ops import scattering

    plain, kept = scattering.scatter_event_c, []

    def keep(*a, **kw):
        kept.append(plain(*a, **kw))
        return kept[-1]

    scattering.scatter_event_c = keep
    try:
        yield kept
    finally:
        scattering.scatter_event_c = plain


def event_parts(pool, sel, on, den, mc, tabs, key):
    """The three launches the event phase replaced (the row gather, the
    event fluid, the event alone), on its events' inputs as the parent's
    torch ops gathered them: a function that launches them, for their
    device time beside the event phase's on the same events."""
    import torch

    from grmonty_tpu_torch.ops import fluid
    from grmonty_tpu_torch.transport import engine, hot_kernels

    _, gi, _ = sel
    reg = pool.ev_pending[gi] & on
    x = engine.where4(reg, tuple(c[gi] for c in pool.ev_x), tuple(c[gi] for c in pool.x))
    k = engine.where4(reg, tuple(c[gi] for c in pool.ev_k), tuple(c[gi] for c in pool.k))
    w, tries = pool.w[gi], pool.ev_tries[gi]
    force = on & (tries >= engine.EV_FORCE)
    idx = fluid.cell_index_c(x[1], x[2], mc).to(torch.int32)

    def parts():
        ev = hot_kernels.event_fluid(hot_kernels.row_gather(tabs.corner_rows, idx), x[1], x[2],
                                     k, w, tries, den, mc, tabs)
        return hot_kernels.scatter_event(k, ev.fl._replace(theta_e=ev.theta_s), ev.g7, mc.b_unit,
                                         active=on, force=force, key=key)

    return parts


def event_phase_checks(sim, usage):
    """Phase 4f (and 12a): the whole event phase in ``sim``'s dtype against
    ``engine.event_phase_plain`` on ``draws.PhiloxDraws`` under the same key,
    then the ring's pack (``compact_rows``) against
    ``engine.pack_rows_plain``, at ``hot_kernels.EVENT_PHASE_WIDTHS`` on
    synthetic pools (``hot_kernels.synthetic_event_pool``) against every
    ring (``hot_kernels.EVENT_RINGS``), held by
    ``hot_kernels.compare_event_phase`` (the pool, the staged rows, the
    counters and the ring bit for bit, the refreshed opacities and bias at
    the event fluid's tolerance).  The kernel updates a copy of the pool.
    Returns the event phase's and the pack's records at the first width and
    ``EVENT_PHASE_RING``; prints the others."""
    import torch

    from grmonty_tpu_torch.ops import draws
    from grmonty_tpu_torch.transport import engine, hot_kernels

    eng, mc, tabs, dev, dt = sim.engine, sim.mc, sim.tables, sim.device, sim.cfg.dtype
    dtn = kernel_dtype(hot_kernels.entry_point("event_phase", dt))
    name = hot_kernels.entry_point("event_phase", dt)
    rows_name = hot_kernels.entry_point("compact_rows", dt)
    typ = "d" if dt == torch.float64 else "f"
    ticket = hot_kernels.rows_ticket(dev)
    out = []
    for j, (n, k) in enumerate(hot_kernels.EVENT_PHASE_WIDTHS):
        shape = hot_kernels.event_shape(name, k)
        inst = f"event_phase_kernelI{typ}Li{shape['lanes']}EE"
        ptx = usage.get(next((f for f in usage if inst in f), None))
        for ring in hot_kernels.EVENT_RINGS:
            pool, sec, counters, den = hot_kernels.synthetic_event_pool(eng, n, k, 2040 + k, ring)
            sel, room, wedged = engine.event_set(pool, sec, k)
            key = torch.tensor([0x5EED0000 + k, 0xE7E27], dtype=torch.int64, device=dev)
            with captured_events() as kept:
                rp, rc, rs = engine.event_phase_plain(pool, counters, sel, room, wedged, den, mc,
                                                      tabs, draws.PhiloxDraws(key))
            res = kept[0]
            rsec, rc = engine.pack_rows_plain(rs, sec, rc)
            work = engine.clone_pool(pool)
            wsec = engine.SecBuf(*(t.clone() for t in sec))
            wc = engine.Counters(*(t.clone() for t in counters))
            gp, gc, gs = hot_kernels.event_phase(work, wc, sel, room, wedged, den, mc, tabs,
                                                 key=key)
            gsec, gc = hot_kernels.compact_rows(gs, wsec, gc, ticket)
            torch.cuda.synchronize()
            rec, fails = hot_kernels.compare_event_phase(name, (rp, rc, rs, rsec),
                                                         (gp, gc, gs, gsec))
            if gp is not work or gsec.rows is not wsec.rows:
                fails.append("the kernels' pool or ring is not the one they were given")
            on = sel[0] & ((torch.arange(k, device=dev) < room) | wedged)
            label = f"{name}@{n}x{k}:{ring}"
            print(f"  {label}: {int(on.sum())} events of {k} slots, {rec['made']} secondaries, "
                  f"ring {int(sec.count)} -> {int(gsec.count)} of {sec.rows.shape[0]}, "
                  f"dropped {int(gc.n_sec_drop - counters.n_sec_drop)}, bitwise among "
                  f"{list(hot_kernels.EVENT_PHASE_TOL)}: {rec['bitwise_tol_fields']}; "
                  f"lanes a warp {shape['lanes']}; ptxas {ptx}")
            if fails:
                fail(f"{label} disagrees with its plain version: " + "; ".join(fails))
            if ring != EVENT_PHASE_RING:
                continue
            gen = torch.Generator(device=dev)
            gen.manual_seed(k)
            plain = lambda: engine.event_phase_plain(  # noqa: E731
                pool, counters, sel, room, wedged, den, mc, tabs, gen)
            kern = lambda: hot_kernels.event_phase(  # noqa: E731
                work, wc, sel, room, wedged, den, mc, tabs, key=key)
            extra_b = (tabs.hc_coeffs, den, key, room, wedged)
            moved = event_phase_moved_bytes(pool, sel, on, res, rs, mc, extra_b)
            flops, int_ops = event_ops(res.rounds_el[on], res.rounds_sc[on], int(on.sum()))
            ops = EVENT_FLUID_OPS * int(on.sum()) + event_ops_equiv(flops, int_ops, dtn)
            parts = event_parts(pool, sel, on, den, mc, tabs, key)
            extra = {**rec, "ptxas": ptx, "library_ms": None, "library_device_ms": None,
                     "k": k, "ring": ring, "events": int(on.sum()), **shape,
                     "parts_ms": cuda_ms(parts), "parts_device_ms": cuda_ms(parts, queued=True)}
            if j:
                extra["name"] = f"{name}@{n}x{k}"
            full = time_kernel(name, {}, {}, plain, kern, moved, ops=ops, n=n, extra=extra)
            # the pack, timed on a ring that holds every timed call's rows
            tsec = engine.SecBuf(torch.empty((256 * k, engine.ROW_WIDTH), dtype=dt, device=dev),
                                 torch.zeros((), dtype=torch.int64, device=dev))
            tc = engine.Counters(*(t.clone() for t in counters))
            made = int(rs.make.sum())
            # the library call: stage.rows[stage.make], the flagged rows in
            # order (no ring, no cap, no count; it reads the count on the host)
            rows_rec = time_kernel(
                rows_name, {}, {}, lambda: engine.pack_rows_plain(rs, sec, counters),
                lambda: hot_kernels.compact_rows(gs, tsec, tc, ticket),
                k + 2 * made * engine.ROW_WIDTH * pool.w.element_size() + 24,
                library=lambda: gs.rows[gs.make], ops=k, n=n,
                extra={"k": k, "made": made, **hot_kernels.rows_shape(rows_name, k),
                       "max_abs_err": 0.0, "max_rel_err": 0.0, "mask_mismatch": 0.0,
                       **({"name": f"{rows_name}@{n}x{k}"} if j else {})})
            if j == 0:
                out += [full, rows_rec]
    return out


def compact_checks(dev):
    """Phase 4g: the compaction (mask mode) against ``engine.compact_idx``
    (the sort) at each pool width of the path and the k its compactions
    take there (``COMPACT_WIDTHS``), on seeded masks of
    ``COMPACT_DENSITIES``, bit for bit.  Times it at every width and
    density beside the sort (``sort_ms``), ``torch.nonzero``
    (``nonzero_ms``, which reads the count on the host) and, as
    ``library_ms``, the one call that computes the same padded indices,
    ``torch.nonzero_static``.  Returns the record at 65,536 lanes, the
    first k and the density 0.3; prints the others."""
    import numpy as np
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    out = []
    for n, ks in COMPACT_WIDTHS.items():
        rng = np.random.default_rng(n)
        for density in COMPACT_DENSITIES:
            mask = torch.as_tensor(rng.random(n) < density, device=dev)
            for j, k in enumerate(ks):
                got, want = hot_kernels.compact(mask, k), engine.compact_idx(mask, k)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"compact@{n}: k {k} at density {density} is not bitwise the sort")

                def library(m=mask, kk=k, nn=n):
                    return torch.nonzero_static(m, size=kk, fill_value=nn)

                try:
                    library()
                except (RuntimeError, NotImplementedError) as e:  # not on this build's card
                    print(f"  compact@{n}: no torch.nonzero_static on the card ({e})")
                    library = None
                first = (n, j, density) == (N_CHECK, 0, 0.3)
                extra = {"k": k, "density": density, "set": int(mask.sum()),
                         "blocks": -(-n // hot_kernels.COMPACT_TILE),
                         "sort_ms": cuda_ms(lambda m=mask, kk=k: engine.compact_idx(m, kk)),
                         "sort_device_ms": cuda_ms(lambda m=mask, kk=k: engine.compact_idx(m, kk),
                                                   queued=True),
                         "nonzero_ms": cuda_ms(lambda m=mask: torch.nonzero(m)),
                         "max_abs_err": 0.0, "max_rel_err": 0.0, "mask_mismatch": 0.0}
                if not first:
                    extra["name"] = f"compact@{n}k{k}d{density}"
                rec = time_kernel("compact", {}, {},
                                  lambda m=mask, kk=k: engine.compact_idx(m, kk),
                                  lambda m=mask, kk=k: hot_kernels.compact(m, kk),
                                  n + 17 * k, library=library, ops=n, n=n, extra=extra)
                if first:
                    out.append(rec)
    return out


# Phase 4h: the exit test's widths (the wave's pool and the cascade's),
# the mask's densities and its byte offsets from a 16-byte boundary
EXIT_WIDTHS = (N_CHECK, *TAIL_CHECKS)
EXIT_DENSITIES = (0.0, 0.003, 0.5, 1.0)
EXIT_SHIFTS = (0, 1, 7, 15)


def exit_edges(count, n_super):
    """(tail_exit, backlog_pos, n_valid, sec_count, bodies, max_outer) at
    the exit test's edges for a mask of ``count`` set lanes at ``n_super``
    iterations a block: every term false (go clear); each term true alone
    under the cap (5 * n_super < 6 * n_super: go set); every term true at
    the cap (6 * n_super) and past it (go clear)."""
    from grmonty_tpu_torch.transport import engine

    cap = 6 * n_super
    return ((count, 3, 3, 0, 0, engine.MAX_OUTER), (count - 1, 3, 3, 0, 5, cap),
            (count, 2, 3, 0, 5, cap), (count, 3, 3, 1, 5, cap), (count - 1, 0, 9, 4, 6, cap),
            (count, 0, 9, 4, 7, cap))


def exit_test_checks(dev):
    """Phase 4h: the exit test (``exit_test``) against
    ``engine.exit_test_plain`` at ``EXIT_WIDTHS`` on seeded masks of
    ``EXIT_DENSITIES`` at each offset of ``EXIT_SHIFTS`` and each edge of
    :func:`exit_edges`, the word and go bit for bit, both values of go
    coming out at every width; timed at each width on a mask of density 0.5
    with go set (``bound_ms``: the mask's bytes and the words, one operation
    a lane).  Returns the record at 65,536 lanes; prints the others
    (``exit_test@<n>``)."""
    import numpy as np
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    n_super = 16
    out = []
    for n in EXIT_WIDTHS:
        rng = np.random.default_rng(n + 1)
        timed, gos = None, set()
        for density in EXIT_DENSITIES:
            for shift in EXIT_SHIFTS:
                base = torch.as_tensor(rng.random(n + 16) < density, device=dev)
                occ = base[shift:shift + n]
                for edge in exit_edges(int(occ.sum()), n_super):
                    te, pos, nv, sec, bodies, cap = edge
                    ins = [torch.tensor(v, dtype=torch.int64, device=dev)
                           for v in (pos, sec, nv, te)]
                    res = []
                    for fn in (engine.exit_test_plain, hot_kernels.exit_test):
                        word = torch.full((engine.EXIT_WORD,), -5, dtype=torch.int64,
                                          device=dev)
                        word[3] = bodies
                        go = torch.zeros((), dtype=torch.bool, device=dev)
                        fn(occ, *ins, word, go, n_super, cap)
                        res.append({"word": word, "go": go})
                    torch.cuda.synchronize()
                    if not all(torch.equal(res[0][k], res[1][k]) for k in ("word", "go")):
                        fail(f"exit_test@{n}: density {density} offset {shift} edge {edge}: "
                             f"{res[1]['word'].tolist()} against {res[0]['word'].tolist()}")
                    gos.add(bool(res[0]["go"]))
                    if density == 0.5 and shift == 0 and timed is None and bool(res[0]["go"]):
                        timed = (occ, ins, bodies, cap, res)
        if gos != {False, True}:
            fail(f"exit_test@{n}: the edges gave go {sorted(gos)} alone")
        occ, ins, bodies, cap, (ref, got) = timed
        word = torch.zeros(engine.EXIT_WORD, dtype=torch.int64, device=dev)
        go = torch.zeros((), dtype=torch.bool, device=dev)
        extra = {"max_abs_err": 0.0, "max_rel_err": 0.0, "mask_mismatch": 0.0,
                 "blocks": 1, "threads": 1024}
        if n != N_CHECK:
            extra["name"] = f"exit_test@{n}"
        rec = time_kernel(
            "exit_test", ref, got,
            lambda: engine.exit_test_plain(occ, *ins, word, go, n_super, cap),
            lambda: hot_kernels.exit_test(occ, *ins, word, go, n_super, cap),
            nbytes(occ, ins, word, go) + nbytes(word, go), ops=n, n=n, extra=extra)
        if n == N_CHECK:
            out.append(rec)
    return out


GATED_WIDTHS = ((N_CHECK, 16384), (4096, 512), (1024, 1024), (512, 512))


def gated_sweep_checks(sim):
    """Phase 4h (and 12a): the block's first launch, the sweep gated on the
    exit word's go (``record_phase`` with ``go`` and a conditional
    handle), in ``sim``'s dtype and both semantics at ``GATED_WIDTHS`` on
    ``hot_kernels.synthetic_record`` pools: with go clear no byte of the
    pool, spectrum, counters or bias terms changes; with go set it is the
    ungated sweep bit for bit; captured ahead of an IF node on its handle
    (one add to a count), each replay sets the node's condition from go
    (with go clear the node does not run, the handle left at 0).  Timed at
    65,536 lanes with go clear and set (device us a launch).  Prints one
    ``gated sweep`` line; fails on a differing bit."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    mc, dev, dt = sim.mc, sim.device, sim.cfg.dtype
    flat = {}
    for reference in (False, True):
        for n, k in GATED_WIDTHS:
            pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, n, k, 5 * n + k, dt,
                                                                     dev, reference=reference)
            ticket = hot_kernels.record_ticket(dev, n)

            def tensors(rec, terms):
                return engine.pool_tensors(rec[0]) + [rec[1], *rec[2], *terms]

            def sweep(rec, terms, **gate):
                hot_kernels.record_phase(*rec, k, mc, cfg, ticket, sweep=True, record=False,
                                         free=False, bias=terms, **gate)

            first = hot_kernels.clone_record(pool, spec, counters)
            want = hot_kernels.clone_record(pool, spec, counters)
            want_terms = hot_kernels.record_bias(dt, dev)
            sweep(want, want_terms)
            for go in (False, True):
                got, terms = hot_kernels.clone_record(pool, spec, counters), \
                    hot_kernels.record_bias(dt, dev)
                sweep(got, terms, go=torch.tensor(go, device=dev))
                ref = (tensors(want, want_terms) if go
                       else tensors(first, hot_kernels.record_bias(dt, dev)))
                if not all(bool(hot_kernels._same_bits(a, b).all())
                           for a, b in zip(tensors(got, terms), ref, strict=True)):
                    fail(f"gated sweep {dt} {'reference' if reference else 'shipped'}@{n}: "
                         f"go {go}: not {'the sweep' if go else 'untouched'}")
            work, terms = hot_kernels.clone_record(pool, spec, counters), \
                hot_kernels.record_bias(dt, dev)
            g = torch.zeros((), dtype=torch.bool, device=dev)
            count = torch.zeros((), dtype=torch.int64, device=dev)
            capture, stream = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
            mem, graph = torch.cuda.MemPool(), torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=capture):
                handle = hot_kernels.exit_handle(dev)
                sweep(work, terms, go=g, handle=handle)
                hot_kernels.exit_guard(handle, lambda: count.add_(1), stream, mem)
            for go in (False, True):
                for dst, src in zip(tensors(work, terms),
                                    tensors(first, hot_kernels.record_bias(dt, dev))):
                    dst.copy_(src)
                g.fill_(go)
                count.zero_()
                graph.replay()
                torch.cuda.synchronize()
                ref = (tensors(want, want_terms) if go
                       else tensors(first, hot_kernels.record_bias(dt, dev)))
                if int(count) != int(go) or not all(
                        bool(hot_kernels._same_bits(a, b).all())
                        for a, b in zip(tensors(work, terms), ref, strict=True)) or not (
                        hot_kernels.record_at_rest(ticket, n)):
                    fail(f"gated sweep {dt} {'reference' if reference else 'shipped'}@{n}: "
                         f"replayed at go {go}: count {int(count)}")
            if n == N_CHECK:
                for go in (False, True):
                    g.fill_(go)
                    flat[f"{'reference' if reference else 'shipped'}_go{int(go)}_device_us"] = (
                        1e3 * cuda_ms(lambda: sweep(work, terms, go=g), queued=True))
            del graph
    rec = {"dtype": str(dt).removeprefix("torch."), "widths": [n for n, _ in GATED_WIDTHS],
           "bitwise": True, **flat}
    print(f"gated sweep: {json.dumps(rec)}")
    return rec


REPLAY_COST_REPS = 200


def replay_cost_check(dev):
    """Phase 4h: what a replay costs the card alone, device us a replay of
    a graph replayed ``REPLAY_COST_REPS`` times back to back (queued behind
    a GPU sleep): a graph of one IF node with an empty body, whose
    condition no launch sets; the same node with one add to a count in its
    body; and a graph of one kernel of one element (an add to a 0-d
    tensor).  Prints one ``replay cost`` line and returns its record."""
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    count = torch.zeros((), dtype=torch.int64, device=dev)
    capture, stream, mem = torch.cuda.Stream(dev), torch.cuda.Stream(dev), torch.cuda.MemPool()
    graphs = {name: torch.cuda.CUDAGraph() for name in ("if_empty", "if_add", "add")}
    rec = {}
    try:  # the runtime may refuse a conditional node with an empty body
        with torch.cuda.graph(graphs["if_empty"], stream=capture):
            hot_kernels.exit_guard(hot_kernels.exit_handle(dev), lambda: None, stream, mem)
    except RuntimeError as err:
        rec["if_empty_refused"] = str(err)[:200]
        del graphs["if_empty"]
    with torch.cuda.graph(graphs["if_add"], stream=capture):
        hot_kernels.exit_guard(hot_kernels.exit_handle(dev), lambda: count.add_(1), stream, mem)
    with torch.cuda.graph(graphs["add"], stream=capture):
        count.add_(1)
    for _ in range(2):
        for name, graph in graphs.items():
            rec.setdefault(f"{name}_device_us", []).append(
                1e3 * cuda_ms(graph.replay, reps=REPLAY_COST_REPS, queued=True))
    torch.cuda.synchronize()
    count.zero_()
    graphs["if_add"].replay()
    torch.cuda.synchronize()
    if int(count) != 0:
        fail(f"replay cost: an IF node whose condition no launch set ran its body ({count})")
    print(f"replay cost: {json.dumps(rec)}")
    return rec


class Copies:
    """A kernel's inputs that it updates in place, ``COPIES`` fresh copies
    made before the timing (``make``), handed out one a call, so that every
    timed call of the kernel does the same work."""

    def __init__(self, make):
        self.copies, self.at = [make() for _ in range(COPIES)], 0

    def __call__(self):
        self.at = (self.at + 1) % len(self.copies)
        return self.copies[self.at]


# the copies a timed kernel takes: more than time_kernel's calls of it
# (two host-paced timings and a queued one, each a warm-up and up to four
# rounds of REPS calls)
COPIES = 4 + 6 * REPS


def record_moved_bytes(pool, spec, counters, ref, width, sweep, record, free, trace):
    """The bytes a record on ``pool`` must move, each once (``ref``: the
    plain result from ``spec`` and ``counters``): every lane's four flags
    it reads; under ``sweep`` the occupied lanes' x, k and w; under
    ``record`` the pending lanes' w and e, the recorded lanes' ten other
    fields and two counts (traced, the captured lane's birth state), the
    spectrum rows they add to, read and written; under ``free`` the freed
    lanes' steps and the stalled lanes' weight; each flag that changes,
    written."""
    import torch

    from grmonty_tpu_torch.transport import engine

    t, n = pool.w.element_size(), pool.w.shape[0]
    p0 = engine.poison_sweep_plain(pool) if sweep else pool
    p1 = ref[0]
    out = 4 * n + (int(pool.occupied.sum()) * 9 * t if sweep else 0)
    if record:
        eligible = p0.record_pending & ~p0.ev_pending & ~torch.isnan(p0.w) & ~torch.isnan(p0.e)
        bins = int((ref[1] != spec).any(dim=1).sum())
        out += (int(p0.record_pending.sum()) * 2 * t
                + min(width, int(eligible.sum())) * (10 * t + 8) + bins * 32 * t
                + (9 * t if trace else 0))
    if free:
        out += (int((p0.occupied & ~p1.occupied).sum()) * 4
                + int(ref[2].n_stall - counters.n_stall) * t)
    for f in ("alive", "occupied", "record_pending", "at_event", "ev_pending"):
        out += int((getattr(pool, f) != getattr(p1, f)).sum())
    return out


# The path's record calls (PERF.md, row 12: the census of profile_slice.py
# --trace): (pool, width, pending lanes a call) at the shipped wave, on the
# reference path's wave and in the 512-lane stage.
RECORD_PATH_COUNTS = ((65536, 12288, 4000), (65536, 16384, 11100), (512, 512, 2))


def record_path_bounds(mc, dev, dt):
    """The record's bound and time at the path's own counts
    (``RECORD_PATH_COUNTS``): a light phase's call on a synthetic pool whose
    pending lanes are cut to the count (the first ones in lane order), its
    bytes by :func:`record_moved_bytes` at the card's memory rate, and the
    kernel's device ms a call (two queued timings, each call on a fresh
    copy, the bias's terms written).  Returns one record a count."""
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    out = []
    for n, k, pending in RECORD_PATH_COUNTS:
        pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, n, k, 4646 + n, dt, dev,
                                                                 trace_birth=False)
        rp = pool.record_pending
        keep = torch.cumsum(rp.to(torch.int64), 0) <= pending
        pool = pool._replace(record_pending=rp & keep)
        ref = hot_kernels.record_plain(pool, spec, counters, k, mc, cfg)[0]
        moved = record_moved_bytes(pool, spec, counters, ref, k, True, True, True, False)
        bound_ms, bound_by = bound(moved, 0, kernel_dtype(
            hot_kernels.entry_point("record_phase", dt)))
        copies = Copies(lambda: hot_kernels.clone_record(pool, spec, counters))
        ticket, bias = hot_kernels.record_ticket(dev, n), hot_kernels.record_bias(dt, dev)

        def call():
            hot_kernels.record_phase(*copies(), k, mc, cfg, ticket, bias=bias)
        out.append({"n": n, "k": k, "pending": int(pool.record_pending.sum()),
                    "recorded": int(ref[2].n_recorded - counters.n_recorded), "bytes": moved,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "device_ms": [cuda_ms(call, queued=True) for _ in range(2)]})
    return out


RECORD_MODES = {"light": (True, True, True), "sweep": (True, False, False),
                "full": (False, True, True), "flush": (False, True, False)}
# the bias's semantics the record's terms are held in: the shipped EMA, the
# reference's cumulative average, the frozen bias (no terms written)
RECORD_SEMANTICS = ("shipped", "reference", "frozen")


def record_terms_checks(mc, dev, dt, n, k, seed):
    """The record's bias terms at (n, k): every mode of ``RECORD_MODES`` in
    each of ``RECORD_SEMANTICS`` (the full phase's with the EMA fold but
    under reference semantics), one call on copies of a synthetic pool,
    against ``hot_kernels.record_plain`` by ``compare_record`` with the
    terms bit for bit; under the frozen bias no term passed and the
    buffers left as they were.  Returns the failures."""
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    fails = []
    ticket = hot_kernels.record_ticket(dev, n)
    for sem in RECORD_SEMANTICS:
        pool, spec, counters, cfg = hot_kernels.synthetic_record(
            mc, n, k, seed, dt, dev, reference=sem == "reference")
        for label, (sweep, record, free) in RECORD_MODES.items():
            fold = label == "full" and sem != "reference"
            mode = dict(sweep=sweep, record=record, free=free, fold=fold)
            ref, terms = hot_kernels.record_plain(pool, spec, counters, k, mc, cfg, **mode)
            bias = hot_kernels.record_bias(dt, dev)
            got = hot_kernels.record_phase(*hot_kernels.clone_record(pool, spec, counters), k,
                                           mc, cfg, ticket,
                                           bias=None if sem == "frozen" else bias, **mode)
            torch.cuda.synchronize()
            _, bad = hot_kernels.compare_record(
                pool, spec, counters, ref, got,
                terms=None if sem == "frozen" else (terms, bias))
            if sem == "frozen" and not all(bool(torch.isnan(t)) for t in bias):
                bad.append("a term written under the frozen bias")
            if not hot_kernels.record_at_rest(ticket, n):
                bad.append("the scratch not at rest")
            fails += [f"{sem} {label}@{n}x{k}: {b}" for b in bad]
    return fails


def record_checks(sim, usage):
    """Phase 4h (and 12a): the record of ``sim``'s dtype against
    ``engine.record_phase_plain`` and ``engine.bias_terms_plain``
    (``hot_kernels.record_plain``) at ``hot_kernels.RECORD_WIDTHS`` on
    synthetic pools (``hot_kernels.synthetic_record``), every stage at once
    (a light phase's call), then at the first width the sweep alone, the
    full phase's record, frees and EMA fold, and the last records' record
    alone, and every stage traced (``record_phase+trace``), each on copies
    of what it updates (:class:`Copies`), held by
    ``hot_kernels.compare_record`` with the bias's terms bit for bit and the
    scratch at rest after; then at every width the terms in every mode and
    semantics (:func:`record_terms_checks`).  Returns the light phase's
    record at the first width; prints the others."""
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    mc, dev, dt = sim.mc, sim.device, sim.cfg.dtype
    name = hot_kernels.entry_point("record_phase", dt)
    ptx = {f: v for f, v in usage.items() if "record_" in f
           and ("Id" if dt == torch.float64 else "If") in f}
    out = []
    for j, (n, k) in enumerate(hot_kernels.RECORD_WIDTHS):
        ticket = hot_kernels.record_ticket(dev, n)
        runs = [(label, False) for label in RECORD_MODES] + [("light", True)] if j == 0 else [
            ("light", False)]
        for label, trace in runs:
            sweep, record, free = RECORD_MODES[label]
            pool, spec, counters, cfg = hot_kernels.synthetic_record(
                mc, n, k, 4242 + n + k, dt, dev, trace_birth=trace)
            mode = dict(sweep=sweep, record=record, free=free, fold=label == "full")
            bias = hot_kernels.record_bias(dt, dev)

            def plain():
                return hot_kernels.record_plain(pool, spec, counters, k, mc, cfg, **mode)

            copies = Copies(lambda: hot_kernels.clone_record(pool, spec, counters))

            def kern():
                return hot_kernels.record_phase(*copies(), k, mc, cfg, ticket, bias=bias,
                                                **mode)

            ref, terms = plain()
            got = hot_kernels.record_phase(*hot_kernels.clone_record(pool, spec, counters),
                                           k, mc, cfg, ticket, bias=bias, **mode)
            torch.cuda.synchronize()
            rec, fails = hot_kernels.compare_record(pool, spec, counters, ref, got,
                                                    terms=(terms, bias))
            if not hot_kernels.record_at_rest(ticket, n):
                fails.append("the scratch is not at rest after the call")
            moved = record_moved_bytes(pool, spec, counters, ref, k, sweep, record, free,
                                       trace)
            label_n = f"{name}{'' if label == 'light' else '.' + label}" + (
                "+trace" if trace else "")
            extra = {**rec, "k": k, "mode": label, "trace_birth": trace, "ptxas": ptx,
                     "launches_a_call": hot_kernels.record_launches(
                         sweep * hot_kernels.RECORD_SWEEP + record * hot_kernels.RECORD_RECORD
                         + free * hot_kernels.RECORD_FREE),
                     "library_ms": None, "library_device_ms": None}
            if (j, label, trace) != (0, "light", False):
                extra["name"] = f"{label_n}@{n}x{k}"
            full = time_kernel(name, {}, {}, plain, kern, moved, ops=0, n=n, extra=extra)
            print(f"  {label_n}@{n}x{k}: {rec['pending']} pending, {rec['recorded']} "
                  f"recorded in bins, {rec['freed']} freed, {rec['stalled']} stalled, "
                  f"captured {rec['captured']}; spectrum err {rec['max_rel_err']:.3g} "
                  f"(bitwise {rec['spec_bitwise']})")
            if fails:
                fail(f"{label_n}@{n}x{k} disagrees with its plain version: "
                     + "; ".join(fails))
            if (j, label, trace) == (0, "light", False):
                out.append(full)
        fails = record_terms_checks(mc, dev, dt, n, k, 4343 + n + k)
        print(f"  {name} bias terms@{n}x{k}: {len(RECORD_SEMANTICS)} semantics x "
              f"{len(RECORD_MODES)} modes, {len(fails)} failing")
        if fails:
            fail(f"{name}: the bias's terms disagree with the plain terms: " + "; ".join(fails))
    for rec in record_path_bounds(mc, dev, dt):
        print(f"  {name} bound at the path's counts: {json.dumps(rec)}")
    return out


def fresh_checks(sim, usage):
    """Phase 4d (and 12a): refill's sources, load and track start of each
    semantics in ``sim``'s dtype (``hot_kernels.refill_fresh``) against
    ``engine.refill_sources_plain`` and ``engine.init_fresh_plain`` at its
    path's ``hot_kernels.FRESH_WIDTHS`` on synthetic pools and refill slots
    (``hot_kernels.synthetic_refill``), held by
    ``hot_kernels.compare_fresh`` (every loaded field, dk/dlambda,
    interacting and the birth state bitwise, the lanes outside the loaded
    slots bitwise as they were, the opacities and the bias at the hot
    step's tolerance) and the ring's count, the backlog position and
    n_created exactly: at each width with the birth state untraced, as
    phases 5, 6, 10 and 12 run it, then traced, as phase 14 runs it
    (``name+trace``).  The kernel updates a copy of the pool in place and
    copies of the three counts, one a call (:class:`Copies`).  Returns
    each semantics' untraced record at its first width; prints the
    others."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    mc, tabs, dev, dt = sim.mc, sim.tables, sim.device, sim.cfg.dtype
    ticket = hot_kernels.fresh_ticket(dev)
    out = []
    for reference in (False, True):
        name = hot_kernels.entry_point("fresh_init", dt, reference)
        table = tabs.corner_rows if reference else tabs.hot_tab
        for j, (n, k) in enumerate(hot_kernels.FRESH_WIDTHS[reference]):
            group = hot_kernels.fresh_shape(name, k)["group"]
            inst = (f"fresh_init_kernelILb{int(reference)}E{'d' if dt == torch.float64 else 'f'}"
                    f"Li{group}E")
            ptx = next((v for f, v in usage.items() if inst in f), None)
            for trace in (False, True):
                pool, slots, counters, den, cfg = hot_kernels.synthetic_refill(
                    mc, n, k, 2031 + k, dt, dev, reference=reference, trace_birth=trace)
                work = engine.clone_pool(pool)

                def plain():
                    sec, pos, c, load = engine.refill_sources_plain(slots, counters)
                    return engine.init_fresh_plain(pool, load, den, mc, tabs, cfg), sec, pos, c

                def scalars():
                    return (slots._replace(sec=engine.SecBuf(slots.sec.rows,
                                                             slots.sec.count.clone()),
                                           backlog_pos=slots.backlog_pos.clone()),
                            counters._replace(n_created=counters.n_created.clone()))

                copies = Copies(scalars)

                def kern():
                    sl, c = copies()
                    return hot_kernels.refill_fresh(work, sl, c, den, mc, tabs, cfg, ticket)

                ref = plain()
                sl, c = scalars()
                mine = engine.clone_pool(pool)
                got = hot_kernels.refill_fresh(mine, sl, c, den, mc, tabs, cfg, ticket)
                torch.cuda.synchronize()
                load = engine.refill_sources_plain(slots, counters)[3]
                rec, fails = hot_kernels.compare_fresh(name, pool, load, ref[0], got[0])
                if got[0] is not mine:
                    fails.append("the kernel's pool is not the one it was given")
                counts = [int(v) for v in (got[1].count, got[2], got[3].n_created)]
                want = [int(v) for v in (ref[1].count, ref[2], ref[3].n_created)]
                if counts != want:
                    fails.append(f"count, backlog_pos, n_created {counts} against {want}")
                if bool(ticket.any()):
                    fails.append(f"the ticket is {ticket.tolist()}, not zeros")
                moved = fresh_moved_bytes(pool, load, ref[0], table, tabs, den, mc, trace)
                label = f"{name}{'+trace' if trace else ''}"
                extra = {**rec, "k": k, "counts": counts, "trace_birth": trace, "ptxas": ptx,
                         "group": group, "library_ms": None, "library_device_ms": None,
                         "name": label if j == 0 else f"{label}@{n}x{k}"}
                full = time_kernel(name, {}, {}, plain, kern, moved,
                                   ops=FRESH_OPS[reference] * rec["lanes_fresh"], n=n,
                                   extra=extra)
                print(f"  {label}@{n}x{k}: {rec['lanes_loaded']} loaded lanes, "
                      f"{rec['lanes_fresh']} started ({rec['lanes_plasma']} in plasma) of {k} "
                      f"slots on {n}; counts {counts}; group {group}; bi bitwise "
                      f"{rec['bi_bitwise']}; ptxas {ptx}")
                if fails:
                    fail(f"{label}@{n}x{k} disagrees with its plain version: " + "; ".join(fails))
                if j == 0 and not trace:
                    out.append(full)
    return out


def event_ops(rounds_el, rounds_sc, n, chain=False):
    """(float operations, 32-bit integer instructions) of an event kernel's
    launch on ``n`` lanes whose loops ran ``rounds_el`` and ``rounds_sc``
    rounds (EVENT_OPS; a lane with 0 electron rounds sampled nothing)."""
    sampled = int((rounds_el > 0).sum())
    r_el, r_sc = int(rounds_el.sum()), int(rounds_sc.sum())
    counts = {"lane": 0 if chain else n, "sampled": sampled, "electron_round": r_el,
              "second_round": r_sc}
    flops = sum(EVENT_OPS[k] * v for k, v in counts.items())
    int_ops = PHILOX_BLOCK_INT_OPS * sum(EVENT_BLOCKS.get(k, 0) * v for k, v in counts.items())
    return flops, int_ops


def event_ops_equiv(flops, int_ops, dtype):
    """The operations at ``dtype``'s rate that take as long as ``flops``
    float operations at that rate and ``int_ops`` integer instructions at
    the float32 rate: what :func:`bound` takes for an event kernel."""
    return flops + int_ops * OPS_PER_S[dtype] / FP32_OPS_PER_S


def event_checks(sim, usage):
    """Phase 4c (and 12a): the event kernel of ``sim``'s dtype against its
    plain version at EVENT_WIDTHS on synthetic event lanes, the chain
    kernel at CHAIN_N lanes over the scatter-chain probe's grid, and (in
    float32) the generator's raw words.  Returns the records at the event
    phase's full width and the chain's and philox_words' records; prints
    the others."""
    import torch

    from grmonty_tpu_torch.ops import draws, scattering
    from grmonty_tpu_torch.tools import probe_scatter_dist
    from grmonty_tpu_torch.transport import hot_kernels

    eng, mc, dev = sim.engine, sim.mc, sim.device
    dtn = "float64" if sim.cfg.dtype == torch.float64 else "float32"
    out = []

    def gen_of(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def check(name, n, res_plain, res_kern, margin, active, plain, kern, moved, ops, extra):
        rec, fails, rows = hot_kernels.compare_event(name, res_plain, res_kern, margin, active)
        for row in rows:
            print(f"  {name}@{n}: a lane near a threshold differs: {json.dumps(row)}")
        flops, int_ops = ops
        typ = "d" if dtn == "float64" else "f"
        inst = (f"scatter_chain_kernelI{typ}E" if "chain" in name else
                f"scatter_event_kernelI{typ}Li{extra['lanes']}E")
        fn = next((f for f in usage if inst in f), None)
        rec.update(extra, flops=flops, int_ops=int_ops, ptxas=usage.get(fn),
                   rounds=[int(res_kern.rounds_el.sum()), int(res_kern.rounds_sc.sum())])
        full = time_kernel(name, {}, {}, plain, kern, moved, n=n, extra=rec,
                           ops=event_ops_equiv(flops, int_ops, dtn))
        print(f"  {name}@{n}: {flops} float operations, {int_ops} integer instructions; "
              f"ptxas {rec['ptxas']}")
        if fails:
            fail(f"{name}@{n} disagrees with its plain version: " + "; ".join(fails))
        return full

    name = hot_kernels.entry_point("scatter_event", sim.cfg.dtype)
    for n in EVENT_WIDTHS:
        _, k, fl, g7, active, force, _ = hot_kernels.synthetic_events(eng, n, 2026)
        key = torch.tensor([0x5EED0000 + n, 0xC0FFEE], dtype=torch.int64, device=dev)
        src = draws.PhiloxDraws(key, margins=True)
        ref = scattering.scatter_event_c(src, k, fl, g7, mc.b_unit, active=active, force=force)
        got = hot_kernels.scatter_event(k, fl, g7, mc.b_unit, active, force, key=key)
        torch.cuda.synchronize()
        gen = gen_of(n)
        plain = lambda: scattering.scatter_event_c(  # noqa: E731
            gen, k, fl, g7, mc.b_unit, active=active, force=force)
        kern = lambda: hot_kernels.scatter_event(  # noqa: E731
            k, fl, g7, mc.b_unit, active, force, key=key)
        moved = nbytes(k, fl.u_con, fl.b_con, fl.b, fl.theta_e, g7, active, force, key,
                       got)
        guard = {"parent_die": int((got.parent_die & active).sum()),
                 "inactive": int((~active).sum()), "forced": int(force.sum()),
                 "deferred": int((active & ~got.sampled).sum())}
        rec = check(name, n, ref, got, src.margin, active, plain, kern, moved,
                    event_ops(got.rounds_el, got.rounds_sc, n),
                    {"guards": guard, "library_ms": None, "library_device_ms": None,
                     **hot_kernels.event_shape(name, n)})
        if rec["lanes_differing"] or rec["max_abs_err"] != 0.0:
            fail(f"{name}@{n} is not bit for bit the plain event on PhiloxDraws: "
                 f"{rec['lanes_differing']} lanes differ, max_abs_err {rec['max_abs_err']}")
        if n == EVENT_WIDTHS[0]:
            out.append(rec)

    # the chain kernel at the probe's photons, over its grid of cells
    name = hot_kernels.entry_point("scatter_chain", sim.cfg.dtype)
    cells = [(t, k0) for t in probe_scatter_dist.THETAS for k0 in probe_scatter_dist.K0S]
    cell = torch.arange(CHAIN_N, device=dev) % len(cells)
    th = torch.tensor([c[0] for c in cells], dtype=sim.cfg.dtype, device=dev)[cell]
    k0 = torch.tensor([c[1] for c in cells], dtype=sim.cfg.dtype, device=dev)[cell]
    k_tet = (k0, k0.clone(), torch.zeros_like(k0), torch.zeros_like(k0))
    key = torch.tensor([0x5EED, 0xC4A1], dtype=torch.int64, device=dev)
    src = draws.PhiloxDraws(key, margins=True)
    ref = scattering.scatter_chain_c(src, k_tet, th)
    got = hot_kernels.scatter_chain(k_tet, th, key=key)
    torch.cuda.synchronize()
    gen = gen_of(7)
    moved = nbytes(k_tet, th, key, got) + CHAIN_N  # + force
    out.append(check(name, CHAIN_N, ref, got, src.margin, None,
                     lambda: scattering.scatter_chain_c(gen, k_tet, th),
                     lambda: hot_kernels.scatter_chain(k_tet, th, key=key), moved,
                     event_ops(got.rounds_el, got.rounds_sc, CHAIN_N, chain=True),
                     {"cells": len(cells), "library_ms": None, "library_device_ms": None,
                      # phase 13 launches the float64 chain; no phase the float32 one
                      "launches": None, "lanes": 32, "group": 1}))

    if dtn == "float32":
        out.append(philox_check(dev))
    return out


def philox_check(dev):
    """The generator's raw words at seeded counters, bitwise against the
    plain version and against numpy.random.Philox (its first four words at
    counter c are the words at c + 1)."""
    import numpy as np
    import torch

    from grmonty_tpu_torch.ops import draws
    from grmonty_tpu_torch.transport import hot_kernels

    n = 65536
    rng = np.random.default_rng(2027)
    ctr_np = rng.integers(0, 2**63 - 1, (n, 4), dtype=np.int64)
    ctr_np[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [2**62, 3, 4, 5], [7, 2**40, 0, 1]]
    key_np = np.array([0x0123456789ABCDEF, 0x7EDCBA9876543210], dtype=np.int64)
    ctr, key = torch.as_tensor(ctr_np, device=dev), torch.as_tensor(key_np, device=dev)
    got = hot_kernels.philox_words(ctr, key)
    plain = draws.philox_words(ctr, key)  # the plain version, on the card
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        fail("philox_words is not bitwise equal to its plain version")
    for i in range(64):
        c = sum(int(w) << (64 * j) for j, w in enumerate(ctr_np[i].view(np.uint64))) - 1
        bg = np.random.Philox(key=key_np.view(np.uint64), counter=np.array(
            [(c >> (64 * j)) & (2**64 - 1) for j in range(4)], dtype=np.uint64))
        if not np.array_equal(bg.random_raw(4), got[i].cpu().numpy().view(np.uint64)):
            fail(f"philox_words differs from numpy.random.Philox at counter {ctr_np[i]}")
    # 260 integer instructions a block at the float32 rate; 64 bytes a counter
    rec = time_kernel("philox_words", {}, {}, lambda: draws.philox_words(ctr, key),
                      lambda: hot_kernels.philox_words(ctr, key), nbytes(ctr, key, got),
                      ops=PHILOX_BLOCK_INT_OPS * n, n=n,
                      extra={"library_ms": None, "library_device_ms": None,
                             "launches": None, "numpy_counters": 64})
    return rec


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
    ``stats`` (hot_iters, full_phases, light_phases, engine_phases) must
    show (:func:`path_counts`): the fused hot step of its dtype and
    semantics, its drawing instance (every hot iteration runs inside a
    block, each of a block's runs of hot steps one launch), once in each
    full and light phase of every engine, its launches running ``hot_iters``
    steps (``<entry>.steps``); the event phase and the ring's pack of its
    dtype once in each full phase; the track start of its dtype and
    semantics once in each full and light phase (under reference semantics
    it fetches its raw rows itself); the exit test at each engine run's
    entry and at the end of each block run (the bodies); the record of its dtype, one launch a call
    (``hot_kernels.record_launches``): the sweep alone in each block
    (eager) or in each of a graph replay's ``engine.GRAPH_BODIES`` blocks
    (graphed: the block's gated first launch, which runs whether or not
    the block does), the record with the frees in each full phase, the
    three at once in each light phase, the record alone in each closing
    flush (one a run); the
    compaction at least twice a full phase (the events, the
    refill) and once a light one (the ``COMPACT_MORE`` of
    :func:`launch_failures`: the cascade's gathers and merges compact too);
    every other entry point (the row gather, the event fluid and the event
    kernel among them, off the path since the event phase is one kernel)
    never."""
    from grmonty_tpu_torch.transport import engine, hot_kernels

    dt, ref, full = cfg.dtype, cfg.reference, stats["full_phases"]
    sweep, rec, free = (hot_kernels.RECORD_SWEEP, hot_kernels.RECORD_RECORD,
                        hot_kernels.RECORD_FREE)

    def launched(mode):
        one = hot_kernels.record_launches(mode)
        if one != 1:
            fail(f"the record launches {one} kernels a call in mode {mode}, not 1")
        return one

    # the sweeps: one in each block slot of a replay (graphed), else a block
    graphed = stats["replays"] > 0
    sweeps = engine.GRAPH_BODIES * stats["replays"] if graphed else full
    records = sweeps * launched(sweep) + sum(
        f * launched(rec | free) + li * launched(sweep | rec | free) + fl * launched(rec)
        for _, f, li, fl in stats["engine_phases"])
    draw = hot_kernels.entry_point("hot_step", dt, ref, draw=True)
    want = {draw: full + stats["light_phases"],
            hot_kernels.entry_point("event_phase", dt): full,
            hot_kernels.entry_point("compact_rows", dt): full,
            "compact": 2 * full + stats["light_phases"],
            hot_kernels.entry_point("record_phase", dt): records,
            hot_kernels.entry_point("fresh_init", dt, ref): full + stats["light_phases"]}
    # the exit test at each run's entry and at the end of each block run
    want["exit_test"] = stats["engine_runs"] + stats["bodies"]
    out = {name: want.get(name, 0) for name in hot_kernels.launches}
    out.update({f"{name}{STEPS}": stats["hot_iters"] if name == draw else 0
                for name in hot_kernels.run_steps})
    return out


# the key of a drawing hot step's run steps in path_counts
STEPS = ".steps"


def path_counts():
    """The counts a path's run is held to (:func:`path_launches`): the
    kernels' launches and, under ``<entry>.steps``, the hot steps each
    drawing hot step's launches ran (``hot_kernels.run_steps``)."""
    from grmonty_tpu_torch.transport import hot_kernels

    return {**hot_kernels.launches,
            **{f"{name}{STEPS}": v for name, v in hot_kernels.run_steps.items()}}


# the entry points whose path_launches count is a least count
COMPACT_MORE = ("compact",)
# the kernels that the event phase's one kernel took off the path (float32
# names; their float64 instantiations too)
OFF_PATH = ("row_gather", "event_fluid", "scatter_event")


def launch_failures(cfg, stats, counts):
    """What is wrong with a run's launch ``counts`` against
    :func:`path_launches` (empty when they match, ``COMPACT_MORE`` at or
    above its count, and a hot step ran), or with its blocks: on the card
    every block runs under a conditional node of its engine's graph, so
    the blocks run (``stats["bodies"]``) equal the full phases, the replays
    hold them (``engine.GRAPH_BODIES`` a replay), and at most one replay a
    run (``skipped_replays``, against ``engine_runs``) ran none."""
    from grmonty_tpu_torch.transport import engine

    want = path_launches(cfg, stats)
    exact = all(counts[k] == v if k not in COMPACT_MORE else counts[k] >= v
                for k, v in want.items()) and set(counts) == set(want)
    bad = "" if exact and stats["hot_iters"] > 0 else (
        f"launches {counts} against {want} ({stats['hot_iters']} hot iterations, "
        f"{stats['full_phases']} full and {stats['light_phases']} light phases)")
    k, replays, skipped = engine.GRAPH_BODIES, stats["replays"], stats["skipped_replays"]
    if (stats["bodies"] != stats["full_phases"] or not 0 < replays
            or stats["bodies"] > k * (replays - skipped) or skipped > stats["engine_runs"]):
        bad += (f" {stats['bodies']} blocks for {stats['full_phases']} full phases in "
                f"{replays} graph replays of {k} ({skipped} with none) over "
                f"{stats['engine_runs']} engine runs")
    return bad


# The plain versions that a run on the card must not call: the hot step's
# and its run's, the load's and the track start's, the event fluid's, the event phase's,
# the ring's pack, the compaction (the sort), the record's and refill's
# sources.
PLAIN_FNS = ("hot_step_plain", "hot_run_plain", "init_fresh_plain", "refill_load_plain",
             "event_fluid_plain", "event_phase_plain", "pack_rows_plain", "compact_idx",
             "record_phase_plain", "refill_sources_plain")
# and what a block on the card must not call: it draws its hot steps'
# uniforms inside their kernel
RAND_IN_BLOCK = "torch.rand_in_block"
# nor any part of the run: the compactions scan in their kernel
SORT = "torch.sort"


@contextlib.contextmanager
def counting_plain_steps():
    """Count the calls of each plain version of ``PLAIN_FNS`` made inside
    ({name: calls}), of ``torch.sort`` (``SORT``), and of ``torch.rand``
    inside an engine's block (``Engine._body``, at its capture and in every
    eager block; ``RAND_IN_BLOCK``), which raises: a run on the card must
    make none."""
    import torch

    from grmonty_tpu_torch.transport import engine

    saved = {name: getattr(engine, name) for name in PLAIN_FNS}
    body = engine.Engine._body
    sort = torch.sort
    calls = dict.fromkeys(PLAIN_FNS + (RAND_IN_BLOCK, SORT), 0)

    def counted_sort(*a, **kw):
        calls[SORT] += 1
        return sort(*a, **kw)

    def counting(name):
        def counted(*a, **kw):
            calls[name] += 1
            return saved[name](*a, **kw)
        return counted

    def refuse(*a, **kw):
        calls[RAND_IN_BLOCK] += 1
        raise RuntimeError("torch.rand inside a block on the card")

    def guarded_body(self):
        rand = torch.rand
        torch.rand = refuse
        try:
            body(self)
        finally:
            torch.rand = rand

    for name in PLAIN_FNS:
        setattr(engine, name, counting(name))
    engine.Engine._body = guarded_body
    torch.sort = counted_sort
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(engine, name, fn)
        engine.Engine._body = body
        torch.sort = sort


def graph_summary(stats):
    """The run's blocks as its graphs ran them: {blocks (one full phase
    each), bodies (the blocks the exit tests let run), replays,
    skipped_replays (those that ran no block), engine_runs, graph_bodies
    (``engine.GRAPH_BODIES``, blocks a replay), flushes (one record call a
    run, read nothing on the host), ms_per_body (device window over
    blocks), capture_s}."""
    from grmonty_tpu_torch.transport import engine

    blocks = stats["full_phases"]
    flushes = sum(e[3] for e in stats["engine_phases"])
    return {"blocks": blocks, "bodies": stats["bodies"], "replays": stats["replays"],
            "skipped_replays": stats["skipped_replays"], "engine_runs": stats["engine_runs"],
            "graph_bodies": engine.GRAPH_BODIES, "flushes": flushes,
            "ms_per_body": 1e3 * stats["device_s"] / max(1, blocks),
            "capture_s": stats["capture_s"]}


def drive(sim, label):
    """Run ``sim`` with every launch count set to 0 just before, check its
    schedule, its spectrum, its luminosity, its launches
    (:func:`path_launches`; no plain version called) and that every block
    was one replay of its engine's graph, print its result line (with
    :func:`graph_summary`); returns (stats, counts)."""
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    root = os.path.dirname(os.path.abspath(__file__))
    with counting_plain_steps() as plain_steps:
        hot_kernels.reset_launches()
        spec, stats = sim.run()
        counts = path_counts()
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
        "plain_steps": plain_steps["hot_step_plain"], "plain_calls": plain_steps,
    }
    result["graph"] = graph_summary(stats)
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
    if bad or any(plain_steps.values()):
        fail(f"{label}: {bad or ''} plain calls {plain_steps}")
    if result["graph"]["flushes"] != stats["engine_runs"]:
        fail(f"{label}: {result['graph']['flushes']} closing flushes in "
             f"{stats['engine_runs']} engine runs")
    return stats, counts


class InjectedFailure(Exception):
    """The failure phase 8 injects into a run after its second wave."""


def resume_check(root, photon_n):
    """Phase 8: an uninterrupted run, a run that fails after its second wave
    with a checkpoint, and its resumption in a fresh ``Simulation``.
    Returns (spectrum, stats) of the uninterrupted run."""
    import numpy as np

    ck = os.path.join(root, ".cache", "chip_smoke_resume.npz")
    if os.path.exists(ck):
        os.remove(ck)

    def sim():
        return make_simulation(root, photon_n, emit_chunk=RESUME_CHUNK,
                               tail_stall_steps=RESUME_TAIL_STALL)

    t0 = time.monotonic()
    spec_ref, st_ref = sim().run()
    ref = (spec_ref, st_ref)
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
              "elapsed_s": [st_ref["elapsed_s"], st_res["elapsed_s"], crashed_s],
              "graph": graph_summary(st_ref)}
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
    return ref


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
        counts = path_counts()
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
            "replays": run["replays"], "bodies": run["bodies"],
            "skipped_replays": run["skipped_replays"], "engine_runs": run["engine_runs"],
            "tail_stages": run["tail_stages"], "launches": counts,
            "plain_steps": plain_steps["hot_step_plain"], "plain_calls": plain_steps,
            "seconds": time.monotonic() - t0}
    print(json.dumps(line))
    fails = validate_accuracy.gate_failures(out)
    if fails:
        fail(f"{label} gate: " + "; ".join(fails))
    tol = GATE_LUM_TOL if sigmas is None else sigmas * out["lum_ratio_rel_sigma"]
    if not abs(out["lum_ratio"] - 1.0) <= tol:
        fail(f"{label} gate: lum_ratio {out['lum_ratio']} not within 1 +- {tol}")
    bad = launch_failures(cfg, run, counts)
    if bad or any(plain_steps.values()):
        fail(f"{label} gate: {bad or ''} plain calls {plain_steps}")
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
        counts = path_counts()
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
            "full_phases", "light_phases", "replays", "bodies", "skipped_replays", "waves",
            "n_stall_killed", "n_secondary_dropped")
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
    end (:func:`drive`) beside ``ref32`` (the stats of phase 8's float32
    run of the same setup; run here when None); (c) the accuracy gate at reference semantics in float64
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
        _, ref32 = sim32.run()
        del sim32
    t0 = time.monotonic()
    stats, counts = drive(sim, "shipped_f64")
    for name in ("hot_step_f64_draw", "fresh_init_f64", "event_phase_f64", "compact_rows_f64",
                 "record_phase_f64"):
        recs[name]["launches"] = counts[name]
    recs["hot_step_f64_draw"]["run_steps"] = counts["hot_step_f64_draw" + STEPS]
    for name in OFF_PATH:
        recs[f"{name}_f64"]["launches"] = None
    st32 = ref32
    keys = ("device_s", "photon_rate_device", "hot_iters", "full_phases", "light_phases",
            "n_recorded", "n_created")
    print(json.dumps({"phase": "f64_vs_f32", "photon_n": args.resume_photon_n,
                      **{k: [st32[k], stats[k]] for k in keys},
                      "tail_stages": [[[st["pool"], st["iters"], st["device_s"]]
                                       for st in s["tail_stages"]] for s in (st32, stats)],
                      "graph": [graph_summary(s) for s in (st32, stats)],
                      "kernel_checks_s": t_kernels,
                      "run_s": time.monotonic() - t0}))
    del sim
    counts = accuracy_check(root, F64_GATE_ARGS, "accuracy_f64", sigmas=F64_GATE_SIGMAS)
    for name in ("hot_step_ref_f64_draw", "fresh_init_ref_f64"):
        recs[name]["launches"] = counts[name]
    recs["hot_step_ref_f64_draw"]["run_steps"] = counts["hot_step_ref_f64_draw" + STEPS]
    cli_check(root, F64_CLI_PHOTON_N, extra=F64_CLI_ARGS,
              dump=validate_accuracy._torus(64, 32), label="cli_f64")
    return list(recs.values())


GRAPH_PHOTON_N = 2e4  # phase 15's photons (one wave)
GRAPH_WARMUP = 2048  # and its pilot
GRAPH_RUNS = (("shipped", False, "float32"), ("reference", True, "float32"),
              ("shipped_f64", False, "float64"), ("reference_f64", True, "float64"))


def graph_check(root, card):
    """Phase 15: each path, float32 and float64, run twice on the same seed:
    every engine's block replayed from its CUDA graph, and issued op by op
    (``graphed=False``, the plain version of the graph).  A wave of
    ``GRAPH_PHOTON_N`` photons and the whole cascade at the path's setup
    (pool 65,536; the pilot and the step caps cut to ``GRAPH_WARMUP`` and
    ``RESUME_TAIL_STALL``).  The state handed to the cascade and the final
    state must agree bit for bit (pool, ring, counters), the spectrum to
    rtol 1e-6 (float atomics sum it), the launch and phase counts exactly
    but the loop's own (the exit test and the conditional nodes' guards,
    each run held to its :func:`path_launches`), and the graphed run must
    run every block under a replay's conditional node
    (:func:`launch_failures`).  One line with each run's device window, ms
    per body, blocks, replays and skipped replays and ``capture_s`` and the
    card's name and power limit."""
    import numpy as np
    import torch

    from grmonty_tpu_torch.transport import driver, engine, hot_kernels

    def bits(t):
        if t.is_floating_point():
            return t.view(torch.int64 if t.element_size() == 8 else torch.int32)
        return t

    t0 = time.monotonic()
    out = []
    for label, reference, dt in GRAPH_RUNS:
        runs = {}
        for graphed in (True, False):
            sim = make_simulation(root, GRAPH_PHOTON_N, reference=reference,
                                  stall_steps=RESUME_TAIL_STALL, dtype=getattr(torch, dt),
                                  warmup=GRAPH_WARMUP, tail_stall_steps=RESUME_TAIL_STALL,
                                  graphed=graphed)
            handed, drain = [], sim._drain_tail

            def keep_and_drain(state, _drain=drain, _handed=handed):
                _handed.append(engine.clone_state(state))
                return _drain(state)

            sim._drain_tail = keep_and_drain
            with counting_plain_steps() as plain_calls:
                hot_kernels.reset_launches()
                spec, stats = sim.run()
            if any(plain_calls.values()):
                fail(f"graph {label}: plain calls {plain_calls} (graphed {graphed})")
            runs[graphed] = (spec, stats, handed[0], sim.state, path_counts())
            cfg = sim.cfg
            del sim
        (spec_g, st_g, hand_g, end_g, launches_g), (spec_e, st_e, hand_e, end_e, launches_e) = (
            runs[True], runs[False])
        differ = [f"{when}.{name}"
                  for when, got, want in (("handed", hand_g, hand_e), ("final", end_g, end_e))
                  for name, g, w in zip(driver._flat_state(want), engine.state_tensors(got),
                                        engine.state_tensors(want), strict=True)
                  if name != "spec" and not torch.equal(bits(g), bits(w))]
        with np.errstate(invalid="ignore", divide="ignore"):
            rel = np.abs(spec_g - spec_e) / np.abs(spec_e)
        max_rel = float(np.nanmax(np.where(spec_e == spec_g, 0.0, rel)))
        keys = ("hot_iters", "full_phases", "light_phases", "n_recorded", "n_created")
        rec = {"path": label, "photon_n": GRAPH_PHOTON_N,
               **{k: [st_g[k], st_e[k]] for k in keys + ("device_s", "photon_rate_device")},
               "ms_per_body": [graph_summary(s)["ms_per_body"] for s in (st_g, st_e)],
               "ms_per_hot_iter": [1e3 * s["device_s"] / max(1, s["hot_iters"])
                                   for s in (st_g, st_e)],
               "replays": [st_g["replays"], st_e["replays"]],
               "bodies": [st_g["bodies"], st_e["bodies"]],
               "skipped_replays": [st_g["skipped_replays"], st_e["skipped_replays"]],
               "engine_runs": [st_g["engine_runs"], st_e["engine_runs"]],
               "capture_s": st_g["capture_s"], "max_rel_spec_diff": max_rel,
               "state_differs": differ}
        out.append(rec)
        print(f"graph run: {json.dumps(rec)}")
        if differ:
            fail(f"graph {label}: the graphed run's state differs from the eager one's: "
                 f"{differ[:8]}")
        if not np.allclose(spec_g, spec_e, rtol=1e-6, atol=0.0):
            fail(f"graph {label}: the spectra differ by {max_rel} relative")
        # every launch but the loop's own: the sweep, once a block (eager)
        # or in each of a replay's blocks (path_launches holds both runs to
        # theirs)
        loop = (hot_kernels.entry_point("record_phase", cfg.dtype),)
        moved = [k for k in keys + ("bodies", "engine_runs") if st_g[k] != st_e[k]]
        if moved or any(launches_g[k] != launches_e[k] for k in launches_g if k not in loop):
            fail(f"graph {label}: counts differ: {moved}, launches {launches_g} against "
                 f"{launches_e}")
        bad = launch_failures(cfg, st_g, launches_g)
        if bad:
            fail(f"graph {label}: {bad}")
        want_e = path_launches(cfg, st_e)
        if any(launches_e[k] != want_e[k] for k in loop):
            fail(f"graph {label}: the eager run's loop launched "
                 f"{[launches_e[k] for k in loop]}, not {[want_e[k] for k in loop]}")
        if not (st_g["bodies"] == st_g["full_phases"] > 0 and st_e["replays"] == 0
                and st_g["capture_s"] > 0.0):
            fail(f"graph {label}: {st_g['bodies']} blocks in replays {rec['replays']} for "
                 f"{st_g['full_phases']} full phases, capture_s {st_g['capture_s']}")
    print(json.dumps({"phase": "graph", "card": card, "runs": out,
                      "seconds": time.monotonic() - t0}))


def scatter_dist_check():
    """Phase 13: the scatter-chain probe on the card at SCATTER_N photons a
    cell, its chain the kernel ``scatter_chain_f64`` (launch counts set to 0
    just before; it must have launched); every cell's mean and q99 ratios
    within 1 +- SCATTER_TOL, or within SCATTER_SIGMAS of their Monte Carlo
    errors where wider.  Returns the launch counts."""
    import torch

    from grmonty_tpu_torch.tools import probe_scatter_dist
    from grmonty_tpu_torch.transport import hot_kernels

    t0 = time.monotonic()
    hot_kernels.reset_launches()
    cells, errors = probe_scatter_dist.measure(
        SCATTER_N, torch.device("cuda"), out=lambda line: print(f"scatter cell: {line}"))
    counts = path_counts()
    keys = ("mean_ratio", "q99_ratio")
    # each ratio's distance from 1 in units of its bar
    over = [{k: abs(c[k] - 1.0) / max(SCATTER_TOL, SCATTER_SIGMAS * err[k]) for k in keys}
            for c, err in zip(cells, errors)]
    print(json.dumps({"phase": "scatter_dist", "n": SCATTER_N, "cells": len(cells),
                      **{f"worst_{k}": max((c[k] for c in cells), key=lambda v: abs(v - 1.0))
                         for k in keys},
                      **{f"{k}_errors": [e[k] for e in errors] for k in keys},
                      "worst_of_bar": max(max(o.values()) for o in over), "tol": SCATTER_TOL,
                      "sigmas": SCATTER_SIGMAS, "launches": counts,
                      "seconds": time.monotonic() - t0}))
    if counts["scatter_chain_f64"] < 1:
        fail(f"scatter_dist: the chain never launched scatter_chain_f64 ({counts})")
    for c, err, o in zip(cells, errors, over):
        where = f"theta_e {c['theta_e']}, k0 {c['k0']}"
        if c["engine"]["n"] != SCATTER_N:
            fail(f"scatter_dist: {SCATTER_N - c['engine']['n']} photons never accepted "
                 f"at {where}")
        for k in keys:
            if not o[k] <= 1.0:
                fail(f"scatter_dist: {k} {c[k]} not within 1 +- max({SCATTER_TOL}, "
                     f"{SCATTER_SIGMAS} x {err[k]}) at {where}")
    return counts


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
        counts = path_counts()
    runs = out["runs"]
    total = {k: sum(r[k] for r in runs.values())
             for k in ("hot_iters", "full_phases", "light_phases", "replays", "bodies",
                       "skipped_replays", "engine_runs")}
    total["engine_phases"] = [e for r in runs.values() for e in r["engine_phases"]]
    line = {"phase": "replay", "photons": out["photons"], "mass_unit": out["mass_unit"],
            **{k: out.get(k) for k in (
                "engine_max_tau", "engine_max_tau_nominal_steps", "replay_max_tau",
                "tau_ratio_engine_over_replay", "mt_birth_x", "mt_birth_k", "mt_birth_w",
                "mt_birth_nsc0", "mt_birth_null_residual", "mt_birth_n_e", "verdict", "engine_s",
                "engine_nominal_s")},
            "replays": out["replays"], "runs": runs, "launches": counts,
            "plain_steps": plain_steps["hot_step_plain"], "plain_calls": plain_steps,
            "seconds": time.monotonic() - t0}
    print(json.dumps(line))
    bad = launch_failures(cfg, total, counts)
    if bad or any(plain_steps.values()):
        fail(f"replay: {bad or ''} plain calls {plain_steps}")
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
    ap.add_argument("--ab-phase-kernels", metavar="DIR", default=None,
                    help="phases 1 and 2, then this checkout's event kernel, load and "
                         "track start and record (float32 and float64) against those of "
                         "the checkout at DIR, in turns; then the card line")
    ap.add_argument("--ab-wide", metavar="DIR", default=None,
                    help="phases 1 and 2, then this checkout's event phase (float32 and "
                         "float64) and compaction against those of the checkout at DIR, in "
                         "turns; then the card line")
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
    print("hot step ptxas: " + json.dumps({
        ptxas_label(v): u for f, u in usage.items() for v in [hot_step_variant(f)] if v}))
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
    if args.ab_phase_kernels:
        sims = [make_simulation(root, args.photon_n, dtype=dt)
                for dt in (torch.float32, torch.float64)]
        ab_phase_kernels(root, sims, args.ab_phase_kernels, usage)
        print(card)
        return
    if args.ab_wide:
        sims = [make_simulation(root, args.photon_n, dtype=dt)
                for dt in (torch.float32, torch.float64)]
        ab_wide(root, sims, args.ab_wide, usage)
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
    for name in ("hot_step_draw", "fresh_init", "event_phase", "compact_rows", "compact",
                 "record_phase", "exit_test"):
        kernels[name]["launches"] = counts[name]
    kernels["hot_step_draw"]["run_steps"] = counts["hot_step_draw" + STEPS]
    # off the path since the event phase is one kernel (the counts, 0, are
    # on the path lines): checks of the fused kernel's parts
    for name in OFF_PATH:
        kernels[name]["launches"] = None
    del sim

    ref_sim = make_simulation(root, args.ref_photon_n, reference=True,
                              stall_steps=args.ref_stall_steps)
    _, counts = drive(ref_sim, "reference")
    for name in ("hot_step_ref_draw", "fresh_init_ref"):
        kernels[name]["launches"] = counts[name]
    kernels["hot_step_ref_draw"]["run_steps"] = counts["hot_step_ref_draw" + STEPS]
    del ref_sim
    graph_check(root, card)

    kernels.update((rec["name"], rec) for rec in probe_kernel_checks())
    probes, counts = run_probes()
    for name in ROWSUMS + ("row_gather_rowloop",):
        if counts[name] < 1:
            fail(f"probes: {name} was never launched ({counts})")
        kernels[name]["launches"] = counts[name]
    for name in ROWSUMS:
        kernels[name]["probe_torch_ms"] = probes["probe_vmem_gather"]["torch_ms"]

    ref = resume_check(root, args.resume_photon_n)
    cli_check(root, args.resume_photon_n)
    accuracy_check(root)
    sharded_check(root, args.resume_photon_n, ref)
    kernels.update((rec["name"], rec)
                   for rec in f64_checks(root, args, usage, sass, ref[1]))
    kernels["scatter_chain_f64"]["launches"] = scatter_dist_check()["scatter_chain_f64"]
    replay_check(root)

    print(card)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
