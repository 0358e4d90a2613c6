"""The hand-written CUDA kernels of the transport engine, and their dispatch.

``csrc/hot_step.cu`` holds the hot step for Hopper (sm_90a) as one kernel,
``hot_step_kernel``, in two compile-time variants: ``hot_step`` (the
shipped profile: derived 44-wide corner rows, the error-proportional step
control, the detached-event capture) and ``hot_step_ref`` (reference
semantics: the ladder, raw 32-wide rows through the metric pair), each in
float32 and in float64 (``hot_step_f64``, ``hot_step_ref_f64``); each entry
point picks its instance from the lane count (:func:`hot_step_shape`: in
both dtypes a group of threads a lane in the narrow pools, one thread a lane
at the pool's width).  It
replaces the TPU kernels ``grmonty_tpu/transport/hotstep_pallas.py:104``
(``kernel_a``, body ``engine.hot_phase_a``) and ``hotstep_pallas.py:152``
(``kernel_b``, body ``engine.hot_phase_b``) and the corner-row gather
between them, and computes ``engine.hot_step_plain``: phase A, the row,
phase B, the ``dl_shrink`` clamp, the capture and the lane-slot census.
Each entry point has a drawing instance, ``<entry>_draw``
(:func:`hot_step_drawn`), which draws the step's two uniforms itself from
the lane's Philox stream under a key and the step's index in the block
(``draws.hot_uniforms`` is the plain version of those draws) and runs
several steps of each lane in one launch, in place (:func:`hot_run`;
``engine.hot_run_plain``, the JAX engine's ``lax.fori_loop`` over
``hot_step``): the engine's block on the card runs each of its runs of hot
steps as one launch.

``csrc/row_gather.cu`` replaces ``grmonty_tpu/ops/gather.py:63``
(``_gather_kernel``): ``out[n, :] = table[idx[n], :]``, the raw corner-row
gather of the event phase, in float32 (``row_gather``) and float64
(``row_gather_f64``).

``csrc/gather_probe.cu`` replaces the eight Pallas kernels of the gather
probes under ``tools/``: :func:`gather_rowsum` (``table[idx].sum(1)`` by
four strategies) and :func:`row_gather_rowloop` (the row copy), float32
only, as the JAX probes' tables are; the probes that drive them are
``grmonty_tpu_torch/tools/``.

``csrc/scatter_event.cu`` holds the event phase's scatter event as one
kernel, a warp's threads sharing its lanes' rejection rounds
(:func:`scatter_event`: ``scatter_event`` /
``scatter_event_f64``): the tetrad, the electron, Klein-Nishina and
Thomson rejection loops with the lane's own Philox stream, the boosts and
the secondary's wave vector, which ``ops.scattering.scatter_event_c``
computes as batched torch ops; :func:`scatter_chain` (``scatter_chain`` /
``scatter_chain_f64``) runs its samplers alone for the scatter-chain
probe, and :func:`philox_words` writes the generator's raw words.  No TPU
kernel does this: the JAX package's event phase is XLA
(``grmonty_tpu/transport/engine.py:2036``).

The same file holds the whole event phase between its compaction and the
ring as one kernel, in place on the pool (:func:`event_phase`:
``event_phase`` / ``event_phase_f64``; ``engine.event_phase_plain``): the
events' raw corner rows, fluid, opacities and bias, the event, the
outcome, the secondaries' rows staged; ``csrc/compact.cu`` the pool's
order-preserving compaction (:func:`compact`: ``compact``, one block's
scan; ``engine.compact_idx``, the sort) and the ring's pack of the staged
rows (:func:`compact_rows`: ``compact_rows`` / ``compact_rows_f64``;
``engine.pack_rows_plain``).  The event alone, the event fluid and the
row gather stay as checks of the event phase's parts, off the engine's
path.

``csrc/fresh_init.cu`` holds refill's sources, row moves and the track
start of the lanes they fill, in place on the pool, with the ring's count,
the backlog position and n_created (:func:`refill_fresh`: ``fresh_init`` /
``fresh_init_ref`` and their ``_f64`` instantiations;
``engine.refill_sources_plain`` then ``engine.init_fresh_plain``), and
``csrc/event_fluid.cu`` the event phase's fluid, opacities and bias
(:func:`event_fluid`: ``event_fluid`` / ``event_fluid_f64``;
``engine.event_fluid_plain``), each one launch where the plain versions
are hundreds of torch operations; the JAX package runs both as XLA
(``grmonty_tpu/transport/engine.py:2320`` and ``:2036``).  They and the hot
step share the device physics of ``csrc/physics.cuh``.

``csrc/record.cu`` holds the phases' upkeep of the pool: the poison
sweep, the record of the escaped lanes into the spectrum and the counters,
and the frees with their census, in place (:func:`record_phase`:
``record_phase`` / ``record_phase_f64``; ``engine.record_phase_plain``),
where the JAX engine runs XLA (``grmonty_tpu/transport/engine.py:1819``,
``:2395``, ``:2410``).

``csrc/exit_test.cu`` holds the engine run's exit test (:func:`exit_test`;
``engine.exit_test_plain``), the JAX engine's ``lax.while_loop`` ``cond``
(XLA, ``grmonty_tpu/transport/engine.py:2531``): one block counts the
occupied lanes and writes the exit word and ``go`` (the engine takes it
at a run's entry and at the end of every block); and the conditional IF node that guards each block of a graph replay
(:func:`exit_guard`, on a handle of :func:`exit_handle`), built through
the CUDA runtime on the graph PyTorch is capturing, whose condition the
block's first launch, its sweep (:func:`record_phase` gated on ``go``),
sets.

The headers of the ``.cu`` files say what bounds each kernel on the card.

:func:`hot_step`, :func:`row_gather`, :func:`gather_rowsum`,
:func:`row_gather_rowloop`, :func:`compact` and :func:`record_phase` take
their plain versions' arguments.  On CPU
tensors they call the plain versions (``engine.hot_step_plain`` /
indexing); on CUDA tensors they launch the kernel of the tensors' dtype
(:func:`entry_point`), or raise.  ``launches``
counts kernel launches only, ``run_steps`` the hot steps the drawing
instances' launches ran; a launch captured into a CUDA graph passes
the wrapper once, at the capture, and its replays not at all: the probes'
chained links count their captures, and the engine's graph takes what its
capture adds (:func:`launches_during`) off the counts and credits it once
per replay (:func:`credit`), so that its counts read what an eager run's do.

Build: ``nvcc`` compiles each ``csrc/*.cu`` into its own shared library
with a plain C interface under ``build/grmonty_tpu_torch/`` (keyed by a
hash of the source, the shared headers ``csrc/*.cuh`` and the flags, all sources at once in parallel, at
first use) and ``ctypes`` loads them.
"""

import ctypes
import glob
import hashlib
import math
import os
import shutil
import subprocess
import time
import typing

import numpy as np
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.ops import draws, fluid, geometry, scattering
from grmonty_tpu_torch.transport import engine
from grmonty_tpu_torch.utils import tables as tables_mod

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "grmonty_tpu_torch")
# No --use_fast_math (it folds the isfinite tests of the commit gate and the
# step controller); -fmad=false keeps each multiply and add rounded on its
# own, as the plain versions' separate tensor ops round them.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches on CUDA tensors, per kernel (the plain path counts nothing).
launches = {"hot_step": 0, "hot_step_ref": 0, "row_gather": 0, "hot_step_f64": 0,
            "hot_step_ref_f64": 0, "row_gather_f64": 0, "hot_step_draw": 0,
            "hot_step_ref_draw": 0, "hot_step_f64_draw": 0, "hot_step_ref_f64_draw": 0,
            "gather_rowsum_coop": 0,
            "gather_rowsum_persistent": 0, "gather_rowsum_rowloop": 0,
            "gather_rowsum_smem": 0, "row_gather_rowloop": 0, "scatter_event": 0,
            "scatter_event_f64": 0, "scatter_chain": 0, "scatter_chain_f64": 0,
            "philox_words": 0, "fresh_init": 0, "fresh_init_ref": 0, "fresh_init_f64": 0,
            "fresh_init_ref_f64": 0, "event_fluid": 0, "event_fluid_f64": 0,
            "event_phase": 0, "event_phase_f64": 0, "compact": 0, "compact_rows": 0,
            "compact_rows_f64": 0, "record_phase": 0, "record_phase_f64": 0, "exit_test": 0}
# The dtypes the hot step and the row gather have kernels for, and the
# suffix of their entry points: the float32 kernels keep their names.
DTYPE_SUFFIX = {torch.float32: "", torch.float64: "_f64"}
# The strategies of gather_rowsum, each its own entry point gather_rowsum_<s>.
ROWSUM_STRATEGIES = ("coop", "persistent", "rowloop", "smem")
# The widest row of row_gather_rowloop: one row must fit one of the row
# copy's 8 KB shared-memory stages (COPY_STAGE_BYTES of csrc/gather_probe.cu);
# a tile holds ROW_COPY_MAX_W // W rows.
ROW_COPY_MAX_W = 2048
# The floats of one warp's shared-memory stage in gather_rowsum "smem" (4 *
# SMEM_STAGE_F4 of csrc/gather_probe.cu): the widest row it takes.  A stage
# holds at most SMEM_STAGE_ROWS rows, one index a lane.
SMEM_STAGE_FLOATS = 512
SMEM_STAGE_ROWS = 32


def reset_launches():
    """Set ``launches`` and ``run_steps`` to 0."""
    for counts in _COUNTS.values():
        for name in counts:
            counts[name] = 0


def launches_during(fn):
    """Run ``fn`` and return what it added to ``launches`` and
    ``run_steps`` ({("launches" or "run_steps", name): n}), leaving the
    counts as they were."""
    before = {what: dict(c) for what, c in _COUNTS.items()}
    try:
        fn()
    finally:
        added = {(what, k): v - before[what][k] for what, c in _COUNTS.items()
                 for k, v in c.items() if v != before[what][k]}
        for what, c in _COUNTS.items():
            c.update(before[what])
    return added


def credit(added):
    """Add ``added`` (:func:`launches_during`) to ``launches`` and
    ``run_steps``: the launches and steps of the replays of a captured
    graph."""
    for (what, k), v in added.items():
        _COUNTS[what][k] += v


def entry_point(kernel, dtype, reference=False, draw=False):
    """The entry point that runs ``kernel`` ("hot_step", "row_gather",
    "scatter_event", "scatter_chain", "fresh_init", "event_fluid",
    "event_phase", "compact_rows", "record_phase" or "compact") on tensors
    of ``dtype``: the
    reference variant of the hot step and of the track start under
    ``reference``, the float64 instantiation for float64 (the compaction of
    a mask has one entry point, "compact", for every dtype), and under
    ``draw`` the hot step's drawing instance (``_draw``).  Raises a
    ValueError for a dtype that has no kernel."""
    if kernel not in ("hot_step", "row_gather", "scatter_event", "scatter_chain",
                      "fresh_init", "event_fluid", "event_phase", "compact_rows",
                      "record_phase", "compact"):
        raise ValueError(f"no entry point for kernel {kernel!r}")
    if draw and kernel != "hot_step":
        raise ValueError(f"{kernel}: only the hot step has a drawing instance")
    if dtype not in DTYPE_SUFFIX:
        raise ValueError(f"{kernel}: no kernel for {dtype} (only "
                         f"{', '.join(str(d) for d in DTYPE_SUFFIX)})")
    if kernel == "compact":
        return kernel
    base = kernel + "_ref" if kernel in ("hot_step", "fresh_init") and reference else kernel
    return base + DTYPE_SUFFIX[dtype] + ("_draw" if draw else "")


# Scalar orders of the C structs AScal and BScal.
_A_SCAL = ("a h_slope r_0 x_start1 x_start2 x_stop2 dx1 dx2 n1 n2 x1_min d_tau_k "
           "fp_iters weight_min shrink_floor grow_cap grow_tau_cap step_ctrl "
           "inv_dx1 inv_dx2 inv_e_tol inv_e_drift_tol").split()
_B_SCAL_HEAD = ("x_start1 x_start2 x_stop1 x_stop2 dx1 dx2 n1 n2 b_unit d_tau_k "
                "weight_min stall_steps tau_cap hc_xlo hc_xhi hc_ylo "
                "hc_yhi k2_lo k2_hi inv_dx1 inv_dx2 inv_b_unit inv_hpl inv_mecc "
                "inv_hc_xdiff inv_hc_ydiff inv_k2_diff inv_cl inv_24 inv_2pimecl "
                "inv_weight_min inv_tp_over_te").split()
_K2_N = 25
# The fused hot step (the C structs HotPtrs and HotScal): the pre-step pool,
# the uniforms (a drawing instance: the key in u_roul's place, null in
# u_x1's), the bias scale, the corner table, the hotcross surface, the
# census counters, the post-step pool; then, for the shipped profile only,
# the detached-event registers in and out and ``occupied`` out.  Its
# scalars are phase A's, phase B's, then the primitives' units of the raw
# rows (a drawing instance: then the step's index in the block).
_POOL_IN = ("x0 x1 x2 x3 k0 k1 k2 k3 d0 d1 d2 d3 e_0_s dl_shrink pend_dl pend_push "
            "at_event alive w record_pending alpha_scatti alpha_absi bi tau_abs "
            "tau_scatt interacting sec_w n_step occupied").split()
CENSUS = ("ls_iters ls_slots ls_occupied ls_moving ls_committed ls_parked "
           "n_hc_clamp").split()
_EV = "ev_x0 ev_x1 ev_x2 ev_x3 ev_k0 ev_k1 ev_k2 ev_k3 ev_w ev_pending".split()
_HOT_REF_PTRS = (_POOL_IN + ["u_roul", "u_x1", "bias_scale", "table", "hc"] + CENSUS
                 + ["o" + f for f in _POOL_IN[:-1]])
_HOT_PTRS = _HOT_REF_PTRS + _EV + ["o" + f for f in _EV] + ["ooccupied"]
_HOT_NSCAL = len(_A_SCAL) + len(_B_SCAL_HEAD) + _K2_N + 2
# The load and track start (the C struct FreshPtrs): the pool's fields the
# load writes, those the start writes, the birth state (null when the trace
# is off), all updated in place; refill's slots (engine.RefillSlots): the
# compaction's valid flags and lanes, the ring's and the backlog's rows;
# the bias's denominator, the corner table, the hotcross surface; the
# ring's count, the backlog position, its valid rows (null where they come
# as a scalar), n_created, the ticket.  Its scalars: the hot step's, then
# the slots, the backlog's valid rows (where its pointer is null), the
# ring's and the backlog's rows.
_FRESH_LOAD = ("x0 x1 x2 x3 k0 k1 k2 k3 w e l n_e_0 theta_e_0 b_0 e_0 e_0_s x1i x2i tau_abs "
               "tau_scatt pend_dl dl_shrink sec_w n_scatt nsc0 n_step ev_tries occupied alive "
               "pend_push at_event record_pending").split()
_FRESH_START = "d0 d1 d2 d3 alpha_scatti alpha_absi bi interacting".split()
_BIRTH = "bx0 bx1 bx2 bx3 bk0 bk1 bk2 bk3 bw".split()
_FRESH_PTRS = (_FRESH_LOAD + _FRESH_START + _BIRTH
               + "valid sidx sec_rows backlog_rows bias_den table hc sec_count backlog_pos "
                 "n_valid n_created ticket".split())
_FRESH_NSCAL = _HOT_NSCAL + 4
# The event phase's fluid (FluidPtrs): the raw rows, the lanes' inputs, the
# bias's denominator, the surface, then its 30 outputs (EventFluid's
# fields flattened); its scalars the hot step's, then EV_HALVE.
_FLUID_IN = "rows x1 x2 k0 k1 k2 k3 w tries bias_den hc".split()
_FLUID_OUT = 30
# The whole event phase (PhasePtrs of csrc/scatter_event.cu): the pool's
# fields it reads at the events' lanes, those it updates there in place, the
# compacted set, the ring's room and wedged flag, the key, the bias's
# denominator, the raw corner table and the surface, the staged rows and
# their flags, the two counters.  Its scalars: the hot step's, then
# EV_HALVE, EV_FORCE and the lanes a warp (below 1: by the width).
_PHASE_READ = ("x0 x1 x2 x3 k0 k1 k2 k3 ev_x0 ev_x1 ev_x2 ev_x3 ev_k0 ev_k1 ev_k2 ev_k3 ev_w "
               "sec_w n_e_0 theta_e_0 e_0 n_scatt").split()
_PHASE_WRITE = "w alpha_scatti alpha_absi bi ev_tries alive occupied at_event ev_pending".split()
_PHASE_PTRS = (_PHASE_READ + _PHASE_WRITE
               + "valid sidx room wedged key bias_den table hc rows make n_ev_soft n_ev_forced"
               .split())
# The record (RecordPtrs of csrc/record.cu): the pool's fields it reads,
# the flags it updates in place, the birth state (null when the trace is
# off), the spectrum and the counters it adds to and folds, the bias's
# terms it writes (null without), the engine's scratch, and the gated
# sweep's go and conditional handle (null and 0 without).  Its scalars
# (RecordScal): the width, the mode's bits, the step cap, the bins'
# counts, the bins' constants as the plain version's torch operations take
# them on the card, the bias's norm and the EMA's weight.
_RECORD_READ = ("x0 x1 x2 x3 k0 k1 k2 k3 w e x1i x2i tau_abs tau_scatt n_e_0 theta_e_0 b_0 e_0 "
                "n_scatt nsc0 n_step").split()
_RECORD_FLAGS = "alive occupied record_pending at_event ev_pending".split()
_RECORD_COUNTERS = ("n_recorded n_scatt_rec max_tau_scatt n_retired n_steps_retired n_stall "
                    "w_stall mt_bx mt_bk mt_bw mt_nsc0 avg_ema ema_scatt_mark "
                    "ema_rec_mark").split()
_RECORD_PTRS = (_RECORD_READ + _RECORD_FLAGS + _BIRTH + ["spec"] + _RECORD_COUNTERS
                + list(engine.BiasTerms._fields) + ["scratch", "go", "handle"])
_RECORD_SCAL = "k mode stall_steps n_th n_e mid x_stop2 inv_dx2 l_e_0 inv_d_l_e bias_norm ema".split()
# the record's stages (the mode's bits): the sweep, the record, the frees,
# the EMA fold, the bias's terms written, the cumulative average in them
RECORD_SWEEP, RECORD_RECORD, RECORD_FREE = 1, 2, 4
RECORD_FOLD, RECORD_TERMS, RECORD_CUMUL = 8, 16, 32
# the lanes a block of the record above one block (csrc/record.cu TILE)
RECORD_TILE = 512
# (pointers, scalars) each entry point takes
# (a drawing hot step: then its run's first step and its steps)
_ABI = {**{f"hot_step{r}{x}{d}": (len(_HOT_REF_PTRS if r else _HOT_PTRS),
                                   _HOT_NSCAL + (2 if d else 0))
           for r in ("", "_ref") for x in DTYPE_SUFFIX.values() for d in ("", "_draw")},
        "row_gather": (3, 1),
        "row_gather_f64": (3, 1),
        # the row sums take W; "smem" also the rows of a stage (smem_stage_rows)
        **{f"gather_rowsum_{s}": (3, 2 if s == "smem" else 1) for s in ROWSUM_STRATEGIES},
        "row_gather_rowloop": (3, 1),
        # the event: k, u_con, b_con, b, theta_e, g7, active, force, key; the
        # masks, k_sec, e_sec, l_sec, the rounds; the scalars 1 / b_unit and
        # the lanes a warp (0: by the width)
        **{f"scatter_event{x}": (35, 2) for x in DTYPE_SUFFIX.values()},
        # the chain: k_tet, theta_e, force, key; p_el, k_tet_p, ok_el, ok_kn,
        # the rounds
        **{f"scatter_chain{x}": (19, 0) for x in DTYPE_SUFFIX.values()},
        "philox_words": (3, 0),
        **{f"fresh_init{r}{x}": (len(_FRESH_PTRS), _FRESH_NSCAL)
           for r in ("", "_ref") for x in DTYPE_SUFFIX.values()},
        **{f"event_fluid{x}": (len(_FLUID_IN) + _FLUID_OUT, _HOT_NSCAL + 1)
           for x in DTYPE_SUFFIX.values()},
        **{f"event_phase{x}": (len(_PHASE_PTRS), _HOT_NSCAL + 3) for x in DTYPE_SUFFIX.values()},
        # the mask, valid, gi, sidx; the scalars k and whether inverted.
        # Rows mode: the flags, the staged rows, the ring, its count,
        # n_sec_drop, the ticket; the scalar the ring's capacity
        "compact": (4, 2),
        **{f"compact_rows{x}": (6, 1) for x in DTYPE_SUFFIX.values()},
        **{f"record_phase{x}": (len(_RECORD_PTRS), len(_RECORD_SCAL))
           for x in DTYPE_SUFFIX.values()},
        # the exit test: occupied, backlog_pos, sec_count, n_valid,
        # tail_exit, the word, go; the scalars n_super and max_outer
        "exit_test": (7, 2)}


# The hot step's entry points, and their drawing instances; the track
# start's and the event's.
HOT_STEPS = ("hot_step", "hot_step_ref", "hot_step_f64", "hot_step_ref_f64")
FRESH_INITS = ("fresh_init", "fresh_init_ref", "fresh_init_f64", "fresh_init_ref_f64")
SCATTER_EVENTS = ("scatter_event", "scatter_event_f64")
EVENT_PHASES = ("event_phase", "event_phase_f64")
COMPACT_ROWS = ("compact_rows", "compact_rows_f64")
RECORD_PHASES = ("record_phase", "record_phase_f64")
HOT_DRAWS = tuple(f"{h}_draw" for h in HOT_STEPS)
# Hot steps run by each drawing entry point's launches on CUDA tensors (a
# run of hot_run its steps, hot_step_drawn one): the engine's hot
# iterations on the card, counted on the host beside ``launches``.
run_steps = dict.fromkeys(HOT_DRAWS, 0)
_COUNTS = {"launches": launches, "run_steps": run_steps}
# The most steps a run takes (the census sums a block's ballots in 32 bits).
MAX_RUN_STEPS = 1 << 20
# The libraries' int -> int functions: the row counts of csrc/gather_probe.cu's
# tilings (w -> rows), the launch shape of each hot-step entry point at n
# lanes (csrc/hot_step.cu: the threads a lane, the threads a block, the
# blocks an SM of the instance it runs), the track start's threads a slot
# at K slots, the event's lanes a warp at n lanes, the pack's threads a
# block at K slots, the record's scratch bytes at n lanes and the kernels
# a record launches in a mode.
HOT_SHAPE = ("group", "threads", "blocks_per_sm")
_INT_FNS = ("gather_rowsum_persistent_pass_rows", "gather_rowsum_rowloop_wave_rows",
            *(f"{h}_{what}" for h in HOT_STEPS + HOT_DRAWS for what in HOT_SHAPE),
            *(f"{f}_group" for f in FRESH_INITS),
            *(f"{e}_lanes" for e in SCATTER_EVENTS + EVENT_PHASES),
            *(f"{c}_threads" for c in COMPACT_ROWS), "record_phase_scratch",
            "record_phase_launches")


# The conditional nodes' builders of csrc/exit_test.cu (exit_handle,
# exit_guard): their arguments.
_GUARD_FNS = {"exit_guard_handle": [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)],
              "exit_guard_begin": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong],
              "exit_guard_end": [ctypes.c_void_p]}


class _Build:
    """The loaded libraries, their entry points and how they were built
    (one per process)."""

    fns = None  # kernel name -> ctypes function
    int_fns = {}  # _INT_FNS name -> ctypes function
    guard_fns = {}  # _GUARD_FNS name -> ctypes function
    paths = []
    seconds = 0.0
    log = ""


def built():
    """Whether this process has loaded the kernels."""
    return _Build.fns is not None


def build():
    """Compile each ``csrc/*.cu`` whose hashed library is missing (one
    ``nvcc`` per source, all started together), load them, check each
    entry point's pointer and scalar counts against the wrapper's, and
    return (library paths, build seconds, nvcc/ptxas output)."""
    if _Build.fns is not None:
        return _Build.paths, _Build.seconds, _Build.log
    t0 = time.monotonic()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    paths, jobs = [], []
    headers = b""
    for hdr in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(hdr, "rb") as f:
            headers += f.read()
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        h.update(headers)
        with open(src, "rb") as f:
            h.update(f.read())
        stem = os.path.splitext(os.path.basename(src))[0]
        path = os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
        paths.append(path)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            jobs.append((path, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    log = [(path, tmp, proc.returncode, out) for path, tmp, proc in jobs
           for out in [proc.communicate()[0]]]
    for path, tmp, rc, out in log:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) for {path}:\n{out}")
        os.replace(tmp, path)
    fns, int_fns, guard_fns = {}, {}, {}
    for path in paths:
        lib = ctypes.CDLL(path)
        for name, (n_ptrs, n_scal) in _ABI.items():
            fn = getattr(lib, f"{name}_launch", None)
            if fn is None:
                continue
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_double),
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            got = tuple(getattr(lib, f"{name}_{what}")() for what in ("nptrs", "nscal"))
            if got != (n_ptrs, n_scal):
                raise RuntimeError(f"{name}: library takes {got} pointers/scalars, "
                                   f"the wrapper passes {(n_ptrs, n_scal)}")
            fns[name] = fn
        for sym in _INT_FNS:
            if hasattr(lib, sym):
                fn = getattr(lib, sym)
                fn.argtypes = [ctypes.c_int]
                fn.restype = ctypes.c_int
                int_fns[sym] = fn
        for sym, argtypes in _GUARD_FNS.items():
            if hasattr(lib, sym):
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                guard_fns[sym] = fn
    missing = (sorted(set(_ABI) - set(fns)) + [sym for sym in _INT_FNS if sym not in int_fns]
               + [sym for sym in _GUARD_FNS if sym not in guard_fns])
    if missing:
        raise RuntimeError(f"no entry point for {missing} in {paths}")
    _Build.fns, _Build.int_fns, _Build.paths = fns, int_fns, paths
    _Build.guard_fns = guard_fns
    _Build.seconds, _Build.log = time.monotonic() - t0, "".join(out for *_, out in log)
    return _Build.paths, _Build.seconds, _Build.log


def _check_lanes(what, tensors, dtypes, n, dev, names=None):
    """Each tensor a contiguous (n,) tensor of its dtype on dev; ``names``
    (one per tensor) name the field that fails."""
    for j, (t, dt) in enumerate(zip(tensors, dtypes, strict=True)):
        if (t.device != dev or t.dtype != dt or t.dim() != 1 or t.shape[0] != n
                or not t.is_contiguous()):
            field = "" if names is None else f" {names[j]}"
            raise ValueError(f"{what}{field}: expected a contiguous ({n},) {dt} tensor on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} stride {t.stride()} "
                             f"on {t.device}")


def _launch(name, ptr_tensors, scal, n, device, kernels=1):
    """Launch entry point ``name`` on ``n`` lanes: the tensors' device
    pointers (None passes a null pointer, an int its bits), the scalars (a ctypes array or a
    list of numbers), the current stream of ``device``; ``kernels``: the
    kernels the entry point launches, which its count adds."""
    build()
    if n == 0:
        return  # no lanes: nothing to launch
    ptrs = (ctypes.c_void_p * len(ptr_tensors))(
        *[t if t is None or isinstance(t, int) else t.data_ptr() for t in ptr_tensors])
    sc = scal if isinstance(scal, ctypes.Array) else (ctypes.c_double * len(scal))(
        *[float(v) for v in scal])
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = _Build.fns[name](ptrs, sc, n, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += kernels


_RECIP = {}


def _recip(c, device, dtype=torch.float32):
    """The multiplier PyTorch uses for ``tensor / c`` on a ``dtype`` tensor
    on ``device``: on the card it divides a tensor by a Python scalar as a
    multiply by the scalar's reciprocal in the tensor's type.  Read from
    PyTorch itself, once per value and dtype, so the kernels round each
    such division exactly as the plain versions."""
    key = (float(c), str(device), dtype)
    if key not in _RECIP:
        one = torch.ones((), dtype=dtype, device=device)
        _RECIP[key] = float((one / float(c)).item())
    return _RECIP[key]


def _cuda_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"the kernels take CPU or CUDA tensors, got {t.device}")
    return t.device


_SCAL_HELD = {}  # (ids of mc and tables, cfg, device, dtype) -> (mc, tables, ctypes scalars)


def _check_hc(hc, dt, dev):
    """The (41, 31) hotcross surface: contiguous, of ``dt``, on ``dev``."""
    if (hc.dtype != dt or tuple(hc.shape) != (41, 31) or not hc.is_contiguous()
            or hc.device != dev):
        raise ValueError(f"hotcross coefficients: expected {dt} (41, 31) on {dev}, got "
                         f"{hc.dtype} {tuple(hc.shape)} on {hc.device}")


def hot_step(pool, counters, u_roul, u_x1, bias_scale, mc, tables, cfg):
    """One hot iteration: on CPU tensors the plain version
    (``engine.hot_step_plain``), on CUDA tensors one launch of the fused
    kernel of ``csrc/hot_step.cu`` that :func:`entry_point` names for
    ``cfg.reference`` and the pool's dtype (``hot_step`` /
    ``hot_step_ref`` in float32, ``hot_step_f64`` / ``hot_step_ref_f64``
    in float64), or raise.  ``pool``: the pre-step ``engine.Pool``;
    ``u_roul``/``u_x1``: (N,) uniforms; ``bias_scale``: a 0-d tensor;
    ``tables``: the ``engine.EngineTables``, all floats in the pool's
    dtype.  Returns the post-step (pool, counters).  On the card the census
    counters are added to in place (integer atomics) and returned; the
    pool's fields are new tensors, views of three allocations.  No host
    sync."""
    if pool.w.device.type == "cpu":
        return engine.hot_step_plain(pool, counters, u_roul, u_x1, bias_scale, mc, tables, cfg)
    dev, dt, n = _cuda_device(pool.w), pool.w.dtype, pool.w.shape[0]
    _check_lanes("hot_step", [u_roul, u_x1], [dt, dt], n, dev, names=["u_roul", "u_x1"])
    return _hot_launch(entry_point("hot_step", dt, cfg.reference), pool, counters,
                       [u_roul, u_x1], bias_scale, mc, tables, cfg,
                       _hot_scalars(mc, tables, cfg, dev, dt))


def hot_step_drawn(pool, counters, key, step, bias_scale, mc, tables, cfg):
    """One hot iteration whose two uniforms come from the lane's own Philox
    stream: (u_roul, u_x1) = ``draws.hot_uniforms(key, step, N, dtype)``,
    slots 0 and 1 of the block at the counter (lane, ``draws.HOT``,
    ``step``, 0) under ``key`` (int64 (2,), :func:`draw_key`).  On CPU
    tensors the plain version on those uniforms (``engine.hot_step_plain``),
    on CUDA tensors one launch of the drawing instance of the fused kernel
    (:func:`entry_point` with ``draw=True``: ``hot_step_draw`` ...
    ``hot_step_ref_f64_draw``), a run of one step into new tensors, which
    draws them itself, or raise.  ``step``: the iteration's index in its
    block, an int in [0, 2^53).  Otherwise as :func:`hot_step`; no host
    sync on the card."""
    _check_step(step, 1)
    dt, n = pool.w.dtype, pool.w.shape[0]
    if pool.w.device.type == "cpu":
        u_roul, u_x1 = draws.hot_uniforms(key, step, n, dt, device=pool.w.device)
        return engine.hot_step_plain(pool, counters, u_roul, u_x1, bias_scale, mc, tables, cfg)
    return _drawn_launch(pool, counters, key, step, 1, bias_scale, mc, tables, cfg,
                         in_place=False)


def hot_run(pool, counters, key, step0, steps, bias_scale, mc, tables, cfg):
    """``steps`` hot iterations of the block's iterations ``step0`` ...
    ``step0 + steps - 1``, in place (the JAX engine's ``lax.fori_loop``
    over ``hot_step``, whose carry XLA updates in place): step j as
    :func:`hot_step_drawn` at ``step0 + j``.  On CPU tensors the plain
    version (``engine.hot_run_plain``); on CUDA tensors one launch of the
    drawing instance of the fused kernel (:func:`entry_point` with
    ``draw=True``), whose lanes load their state once, hold it across the
    steps and store it once into the pool's own tensors, or raise.  The
    census counters are added to in place.  ``steps``: an int in [1,
    ``MAX_RUN_STEPS``]; ``step0 + steps`` at most 2^53.  Returns the
    (pool, counters) it was given; no host sync on the card."""
    _check_step(step0, steps)
    if pool.w.device.type == "cpu":
        return engine.hot_run_plain(pool, counters, key, step0, steps, bias_scale, mc, tables,
                                    cfg)
    return _drawn_launch(pool, counters, key, step0, steps, bias_scale, mc, tables, cfg,
                         in_place=True)


def _check_step(step0, steps):
    if not (isinstance(step0, int) and isinstance(steps, int) and step0 >= 0
            and 1 <= steps <= MAX_RUN_STEPS and step0 + steps <= 2**53):
        raise ValueError(f"hot step: step must be an int in [0, 2^53) and steps in [1, "
                         f"{MAX_RUN_STEPS}], got step {step0!r}, steps {steps!r}")


def _drawn_launch(pool, counters, key, step0, steps, bias_scale, mc, tables, cfg, in_place):
    """A launch of the drawing instance: ``steps`` steps from the block's
    iteration ``step0``, into the pool's own tensors under ``in_place``;
    counts the launch and its steps."""
    dev, dt = _cuda_device(pool.w), pool.w.dtype
    name = entry_point("hot_step", dt, cfg.reference, draw=True)
    out = _hot_launch(name, pool, counters, [_event_key(None, key, dev), None], bias_scale, mc,
                      tables, cfg, [*_hot_scalars(mc, tables, cfg, dev, dt), step0, steps],
                      in_place=in_place)
    run_steps[name] += steps
    return out


def _hot_launch(name, pool, counters, uniforms, bias_scale, mc, tables, cfg, scal,
                in_place=False):
    """Launch the hot step's entry point ``name`` on the pool (its inputs
    checked), ``uniforms`` in the pointer slots of u_roul and u_x1 and the
    scalars ``scal``; returns the post-step (pool, counters): under
    ``in_place`` the pool given (its fields, which the launch writes, must
    not share memory), else new tensors, views of three allocations."""
    dev, n = pool.w.device, pool.w.shape[0]
    if n == 0:
        raise ValueError("hot_step: empty pool")
    ref = cfg.reference
    dt, b8, i32 = pool.w.dtype, torch.bool, torch.int32
    if in_place:
        q = pool
    else:
        nf, nb = (22, 5) if ref else (31, 7)
        fo = torch.empty((nf, n), dtype=dt, device=dev).unbind(0)
        bo = torch.empty((nb, n), dtype=b8, device=dev).unbind(0)
        new = dict(x=fo[0:4], k=fo[4:8], dkdlam=fo[8:12], e_0_s=fo[12], dl_shrink=fo[13],
                   pend_dl=fo[14], pend_push=bo[0], at_event=bo[1], alive=bo[2], w=fo[15],
                   record_pending=bo[3], alpha_scatti=fo[16], alpha_absi=fo[17], bi=fo[18],
                   tau_abs=fo[19], tau_scatt=fo[20], interacting=bo[4], sec_w=fo[21],
                   n_step=torch.empty(n, dtype=i32, device=dev))
        if not ref:
            new.update(ev_x=fo[22:26], ev_k=fo[26:30], ev_w=fo[30], ev_pending=bo[5],
                       occupied=bo[6])
        q = pool._replace(**new)
    ins = _pool_cols(pool) + [pool.occupied] + ([] if ref else _ev_cols(pool))
    want = ([t.dtype for t in _pool_cols(q)] + [b8]
            + ([] if ref else [t.dtype for t in _ev_cols(q)]))
    _check_lanes("hot_step", ins, want, n, dev, names=_POOL_IN + ([] if ref else _EV))
    if in_place and len({t.data_ptr() for t in ins}) != len(ins):
        raise ValueError("hot_run: the pool's fields share memory; a run writes each in place")
    table = tables.corner_rows if ref else tables.hot_tab
    _check_rows(table, 32 if ref else 44, dev, "corner table", dt)
    if table.shape[0] < mc.n1 * mc.n2:
        raise ValueError(f"corner table: {table.shape[0]} rows for {mc.n1}x{mc.n2} cells")
    hc = tables.hc_coeffs
    _check_hc(hc, dt, dev)
    if bias_scale.dtype != dt or bias_scale.numel() != 1 or bias_scale.device != dev:
        raise ValueError(f"bias_scale: expected a {dt} scalar tensor on {dev}, got "
                         f"{bias_scale.dtype} on {bias_scale.device}")
    census = [getattr(counters, c) for c in CENSUS]
    if any(c.dtype != torch.int64 or c.dim() != 0 or c.device != dev for c in census):
        raise ValueError(f"hot_step: census counters must be int64 scalars on {dev}")
    ptrs = (_pool_cols(pool) + [pool.occupied, *uniforms, bias_scale, table, hc] + census
            + _pool_cols(q))
    if not ref:
        ptrs += _ev_cols(pool) + _ev_cols(q) + [q.occupied]
    _launch(name, ptrs, scal, n, dev)
    return q, counters


def _pool_cols(p):
    """The pool's columns in the order of ``_POOL_IN``, but ``occupied``."""
    return [*p.x, *p.k, *p.dkdlam, p.e_0_s, p.dl_shrink, p.pend_dl, p.pend_push, p.at_event,
            p.alive, p.w, p.record_pending, p.alpha_scatti, p.alpha_absi, p.bi, p.tau_abs,
            p.tau_scatt, p.interacting, p.sec_w, p.n_step]


def _ev_cols(p):
    return [*p.ev_x, *p.ev_k, p.ev_w, p.ev_pending]


def _hot_scalars(mc, tables, cfg, dev, dtype=torch.float32):
    """The fused kernel's scalars as a ctypes array, built once per (mc,
    tables, cfg, device, dtype): the reciprocals (``_recip``) are those of
    ``dtype``."""
    key = (id(mc), id(tables), cfg, str(dev), dtype)
    held = _SCAL_HELD.get(key)
    if held is None or held[0] is not mc or held[1] is not tables:
        scal = (_a_scalars(mc, cfg.grow_cap, dev, dtype)
                + _b_scalars(mc, cfg.stall_steps, tables.k2_coeffs, dev, dtype)
                + [mc.n_e_unit, mc.theta_e_unit])
        if len(_SCAL_HELD) >= 8:
            _SCAL_HELD.clear()
        held = _SCAL_HELD[key] = (mc, tables, (ctypes.c_double * len(scal))(
            *[float(v) for v in scal]))
    return held[2]


def _a_scalars(mc, grow_cap, dev, dtype=torch.float32):
    """Phase A's scalars (``_A_SCAL`` order), the reciprocals of ``dtype``."""
    scal = [mc.a, mc.h_slope, mc.r_0, mc.x_start[1], mc.x_start[2], mc.x_stop[2],
            mc.dx[1], mc.dx[2], mc.n1, mc.n2, mc.x1_min, mc.d_tau_k, engine.FP_ITERS,
            engine.WEIGHT_MIN, engine.SHRINK_FLOOR, grow_cap, engine.GROW_TAU_CAP,
            engine.STEP_CTRL]
    return scal + [_recip(c, dev, dtype) for c in (mc.dx[1], mc.dx[2], consts.E_TOL,
                                                   consts.E_DRIFT_TOL)]


def row_gather(table, idx):
    """``table[idx]``: rows of a (Z, W) table at (N,) int32 indices in
    [0, Z) (not checked: the TPU kernel's PROMISE_IN_BOUNDS).  The plain
    version on CPU tensors, the kernel of ``csrc/row_gather.cu`` on CUDA
    tensors (``row_gather`` in float32, ``row_gather_f64`` in float64;
    contiguous, W a whole number of 16-byte units); no host sync."""
    if table.device.type == "cpu":
        return table[idx.long()]
    name = entry_point("row_gather", table.dtype)
    dev, n, w = _gather_args(table, idx, "row gather", table.dtype)
    out = torch.empty((n, w), dtype=table.dtype, device=dev)
    _launch(name, [table, idx, out], [w], n, dev)
    return out


def draw_key(gen, device):
    """Two key words for the event kernels' and the drawing hot step's
    Philox, drawn from ``gen`` on ``device`` as an int64 tensor that stays
    there (nothing is read on the host; the generator's state advances as
    any draw's)."""
    return torch.randint(0, 2**63 - 1, (2,), generator=gen, dtype=torch.int64, device=device)


def scatter_event(k, fl, g7, b_unit, active=None, force=None, gen=None, key=None,
                  lanes=None):
    """The scatter event of ``ops.scattering.scatter_event_c``: on CPU
    tensors that plain version, drawing from ``gen`` (a ``torch.Generator``)
    or, given ``key`` (two int64 words), from ``draws.PhiloxDraws(key)``; on
    CUDA tensors one launch of ``scatter_event`` (float32) or
    ``scatter_event_f64`` (:func:`entry_point`) under ``key``, or under two
    words drawn from ``gen`` (:func:`draw_key`), or raise.  ``k``, ``g7``
    and ``fl``'s ``u_con``, ``b_con``, ``b``, ``theta_e``: (N,) tensors of
    one dtype; ``active``/``force``: (N,) bool (all active, none forced
    when None).  Returns a ``ScatterResultC`` with the rounds each lane's
    loops ran (0 on guarded lanes).  On the card a guarded lane (inactive,
    doomed parent, invalid frame) skips its samplers: its ``k_sec``,
    ``e_sec`` and ``l_sec`` are 0, and on an inactive lane ``made`` only
    says whether the frame was valid; ``lanes``: the lanes a warp (32, 8
    or 1; None: :func:`event_shape` picks by the width).  No host sync."""
    if (gen is None) == (key is None):
        raise ValueError("scatter_event: give exactly one of gen and key")
    if k[0].device.type == "cpu":
        src = gen if key is None else draws.PhiloxDraws(key)
        return scattering.scatter_event_c(src, k, fl, g7, b_unit, active=active, force=force)
    dev, dt, n = _cuda_device(k[0]), k[0].dtype, k[0].shape[0]
    name = entry_point("scatter_event", dt)
    b8 = torch.bool
    active = torch.ones(n, dtype=b8, device=dev) if active is None else active
    force = torch.zeros(n, dtype=b8, device=dev) if force is None else force
    ins = [t.contiguous() for t in (*k, *fl.u_con, *fl.b_con, fl.b, fl.theta_e, *g7)]
    _check_lanes(name, ins + [active, force], [dt] * len(ins) + [b8, b8], n, dev,
                 names=[f"k{i}" for i in range(4)] + [f"u_con{i}" for i in range(4)]
                 + [f"b_con{i}" for i in range(4)] + ["b", "theta_e"]
                 + [f"g7[{i}]" for i in range(7)] + ["active", "force"])
    key = _event_key(gen, key, dev)
    bo = torch.empty((3, n), dtype=b8, device=dev)
    fo = torch.empty((6, n), dtype=dt, device=dev)
    io = torch.empty((2, n), dtype=torch.int32, device=dev)
    _launch(name, ins + [active, force, key, *bo, *fo, *io],
            [_recip(b_unit, dev, dt), lanes or 0], n, dev)
    return scattering.ScatterResultC(bo[0], bo[1], tuple(fo[:4]), fo[4], fo[5], bo[2], io[0],
                                     io[1])


def scatter_chain(k_tet, theta_e, force=None, gen=None, key=None):
    """The electron draw and the scattered photon of tetrad-frame wave
    vectors ``k_tet`` (4-tuple of (N,)) off electrons at ``theta_e`` (N,)
    (``ops.scattering.scatter_chain_c``, the scatter-chain probe's chain):
    the plain version on CPU tensors (drawing from ``gen`` or
    ``PhiloxDraws(key)``), on CUDA tensors one launch of ``scatter_chain``
    / ``scatter_chain_f64`` under ``key`` or two words drawn from ``gen``,
    or raise.  Returns a ``ChainResult``; no host sync."""
    if (gen is None) == (key is None):
        raise ValueError("scatter_chain: give exactly one of gen and key")
    if theta_e.device.type == "cpu":
        src = gen if key is None else draws.PhiloxDraws(key)
        return scattering.scatter_chain_c(src, k_tet, theta_e, force=force)
    dev, dt, n = _cuda_device(theta_e), theta_e.dtype, theta_e.shape[0]
    name = entry_point("scatter_chain", dt)
    force = torch.zeros(n, dtype=torch.bool, device=dev) if force is None else force
    ins = [t.contiguous() for t in (*k_tet, theta_e)]
    _check_lanes(name, ins + [force], [dt] * 5 + [torch.bool], n, dev,
                 names=[f"k_tet{i}" for i in range(4)] + ["theta_e", "force"])
    key = _event_key(gen, key, dev)
    fo = torch.empty((8, n), dtype=dt, device=dev)
    bo = torch.empty((2, n), dtype=torch.bool, device=dev)
    io = torch.empty((2, n), dtype=torch.int32, device=dev)
    _launch(name, ins + [force, key, *fo, *bo, *io], [], n, dev)
    return scattering.ChainResult(tuple(fo[:4]), tuple(fo[4:]), bo[0], bo[1], io[0], io[1])


def _event_key(gen, key, dev):
    """The event kernels' key on ``dev``: ``key`` checked, or drawn from ``gen``."""
    if key is None:
        return draw_key(gen, dev)
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or key.device != dev:
        raise ValueError(f"key: expected an int64 (2,) tensor on {dev}, got {key.dtype} "
                         f"{tuple(key.shape)} on {key.device}")
    return key.contiguous()


def philox_words(ctr, key):
    """The raw words of the event kernels' Philox4x64-10 for an (N, 4)
    int64 tensor of counters under ``key`` (int64 (2,)), as an (N, 4) int64
    tensor holding the unsigned words' bits: the plain version
    (``draws.philox_words``) on CPU tensors, the kernel on CUDA tensors;
    no host sync."""
    if ctr.dim() != 2 or ctr.shape[1] != 4 or ctr.dtype != torch.int64:
        raise ValueError(f"philox_words: expected (N, 4) int64 counters, got {ctr.dtype} "
                         f"{tuple(ctr.shape)}")
    if ctr.device.type == "cpu":
        return draws.philox_words(ctr, key)
    dev = _cuda_device(ctr)
    key = _event_key(None, key, dev)
    out = torch.empty_like(ctr)
    _launch("philox_words", [ctr.contiguous(), key, out], [], ctr.shape[0], dev)
    return out


def _den_on(bias_den, dev, dt):
    """The bias's 0-d denominator as the kernels read it: one value of the
    pool's dtype on ``dev`` (a float64 denominator, the frozen-bias mode's,
    rounds into float32 as the plain division's type promotion rounds it)."""
    if bias_den.numel() != 1 or bias_den.device != dev:
        raise ValueError(f"bias_den: expected a scalar tensor on {dev}, got "
                         f"{tuple(bias_den.shape)} on {bias_den.device}")
    return bias_den.reshape(()).to(dt).contiguous()


def fresh_ticket(device):
    """The refill's ticket for :func:`refill_fresh`: three int32 words at
    zero (the ticket, the slots taken from the ring and from the backlog),
    which every launch takes and leaves at zero.  The engine allocates it
    outside any CUDA graph's capture."""
    return torch.zeros(3, dtype=torch.int32, device=device)


def fresh_fields(pool):
    """The pool's fields that the load and the track start write, in the
    order of their pointers (``_FRESH_LOAD``, ``_FRESH_START``)."""
    return [*pool.x, *pool.k, pool.w, pool.e, pool.l, pool.n_e_0, pool.theta_e_0, pool.b_0,
            pool.e_0, pool.e_0_s, pool.x1i, pool.x2i, pool.tau_abs, pool.tau_scatt,
            pool.pend_dl, pool.dl_shrink, pool.sec_w, pool.n_scatt, pool.nsc0, pool.n_step,
            pool.ev_tries, pool.occupied, pool.alive, pool.pend_push, pool.at_event,
            pool.record_pending, *pool.dkdlam, pool.alpha_scatti, pool.alpha_absi, pool.bi,
            pool.interacting]


def refill_fresh(pool, slots, counters, bias_den, mc, tables, cfg, ticket):
    """Refill's slots (``engine.RefillSlots``: the compaction of the free
    lanes, the ring, the backlog, its position and valid rows): each slot's
    source, the ring's count, the backlog position and n_created past what
    the slots take (``engine.refill_sources_plain``), then the load and
    track start of the lanes they fill (``engine.init_fresh_plain``: the
    rows' fields, then dk/dlambda, the opacities, the bias and
    ``interacting`` of the valid ones; the birth state under
    ``cfg.trace_birth``).  ``bias_den``: the 0-d bias_norm * max_tau * (avg
    + 2).  On CPU tensors those plain versions (new tensors); on CUDA
    tensors one launch of the kernel of ``csrc/fresh_init.cu`` that
    :func:`entry_point` names for ``cfg.reference`` and the pool's dtype
    (``fresh_init`` / ``fresh_init_ref``, ``_f64`` in float64; the threads
    a slot by the width, :func:`fresh_shape`): each slot works out its
    source from the values before the launch, and the last block to take
    ``ticket`` (a :func:`fresh_ticket`) updates ``slots.sec.count``,
    ``slots.backlog_pos`` and ``counters.n_created`` in place; the pool is
    updated in place; or raise.  Returns (pool, sec, backlog_pos,
    counters).  No host sync."""
    if pool.w.device.type == "cpu":
        sec, pos, counters, load = engine.refill_sources_plain(slots, counters)
        return engine.init_fresh_plain(pool, load, bias_den, mc, tables, cfg), sec, pos, counters
    dev, dt, n = _cuda_device(pool.w), pool.w.dtype, pool.w.shape[0]
    name = entry_point("fresh_init", dt, cfg.reference)
    k = slots.valid.shape[0]
    _check_lanes(f"{name} slots", [slots.valid, slots.sidx], [torch.bool, torch.int64], k, dev,
                 names=["valid", "sidx"])
    for what, t in (("ring count", slots.sec.count), ("backlog_pos", slots.backlog_pos),
                    ("n_created", counters.n_created)):
        _check_scalar(f"{name} {what}", t, torch.int64, dev)
    n_valid = slots.n_valid
    held = isinstance(n_valid, torch.Tensor)
    if held:
        _check_scalar(f"{name} n_valid", n_valid, torch.int64, dev)
    if ticket.dtype != torch.int32 or ticket.shape != (3,) or ticket.device != dev:
        raise ValueError(f"{name}: expected the refill's ticket (fresh_ticket) on {dev}, got "
                         f"{ticket.dtype} {tuple(ticket.shape)} on {ticket.device}")
    i32, b8 = torch.int32, torch.bool
    fields = fresh_fields(pool)
    birth = [*pool.bx, *pool.bk, pool.bw] if cfg.trace_birth else []
    types = [dt] * 23 + [i32] * 4 + [b8] * 5 + [dt] * 7 + [b8] + [dt] * len(birth)
    _check_lanes(name, fields + birth, types, n, dev,
                 names=_FRESH_LOAD + _FRESH_START + _BIRTH[:len(birth)])
    if len({t.data_ptr() for t in fields + birth}) != len(fields + birth):
        raise ValueError(f"{name}: two of the pool's fields share memory (updated in place)")
    sec_rows, backlog_rows = slots.sec.rows, slots.backlog_rows
    _check_rows(sec_rows, engine.ROW_WIDTH, dev, "ring rows", dt)
    _check_rows(backlog_rows, engine.ROW_WIDTH, dev, "backlog rows", dt)
    table = tables.corner_rows if cfg.reference else tables.hot_tab
    _check_rows(table, 32 if cfg.reference else 44, dev, "corner table", dt)
    if table.shape[0] < mc.n1 * mc.n2:
        raise ValueError(f"corner table: {table.shape[0]} rows for {mc.n1}x{mc.n2} cells")
    _check_hc(tables.hc_coeffs, dt, dev)
    ptrs = (fields + (birth or [None] * 9)
            + [slots.valid, slots.sidx, sec_rows, backlog_rows, _den_on(bias_den, dev, dt),
               table, tables.hc_coeffs, slots.sec.count, slots.backlog_pos,
               n_valid if held else None, counters.n_created, ticket])
    scal = (list(_hot_scalars(mc, tables, cfg, dev, dt))
            + [k, 0 if held else int(n_valid), sec_rows.shape[0], backlog_rows.shape[0]])
    _launch(name, ptrs, scal, n, dev)
    return pool, slots.sec, slots.backlog_pos, counters


def fresh_shape(name, k):
    """The threads a slot (``group``) of the track start's entry point
    ``name`` (``FRESH_INITS``) at ``k`` slots."""
    return {"group": _int_fn(f"{name}_group", k)}


# The event phase's lanes a warp (a pair of warps holds them) by its dtype
# and compacted width K (csrc/scatter_event.cu phase_lanes, the same table;
# the sweep of PERF.md): (the widest K of a band, the lanes a warp) in
# ascending bands, the last unbounded (None).
EVENT_PHASE_SHAPES = {torch.float32: ((1024, 1), (8192, 4), (None, 16)),
                      torch.float64: ((1024, 1), (4096, 4), (8192, 8), (None, 32))}
# the instances of csrc/scatter_event.cu (phase_instance): the table's
EVENT_PHASE_LANES = {dt: tuple(sorted({lanes for _, lanes in bands}, reverse=True))
                     for dt, bands in EVENT_PHASE_SHAPES.items()}


def event_phase_shape(k, dtype=torch.float32):
    """The event phase's shape at ``k`` slots in ``dtype`` from
    ``EVENT_PHASE_SHAPES`` (no build): its lanes a warp and threads a lane
    (``group``), as :func:`event_shape` reads them from the kernel."""
    for top, lanes in EVENT_PHASE_SHAPES[dtype]:
        if top is None or k <= top:
            return {"lanes": lanes, "group": 32 // lanes}
    raise AssertionError("EVENT_PHASE_SHAPES has no unbounded band")


def event_shape(name, n):
    """The lanes a warp of the event kernel's or the event phase's entry
    point ``name`` (``SCATTER_EVENTS``, ``EVENT_PHASES``) at ``n`` lanes,
    and the threads a lane that gives at the first pass (``group``)."""
    lanes = _int_fn(f"{name}_lanes", n)
    return {"lanes": lanes, "group": 32 // lanes}


def event_fluid(rows, x1, x2, k, w, tries, bias_den, mc, tables):
    """The event phase's fluid, opacities and bias at its compacted lanes
    (``engine.EventFluid``): on CPU tensors the plain version
    (``engine.event_fluid_plain``), on CUDA tensors one launch of
    ``event_fluid`` (float32) or ``event_fluid_f64`` of
    ``csrc/event_fluid.cu``, or raise.  ``rows``: the (N, 32) raw corner
    rows at (x1, x2); ``k`` a 4-tuple of (N,); ``tries`` (N,) int32;
    ``bias_den`` the 0-d bias_norm * max_tau * (avg + 2).  No host sync."""
    if rows.device.type == "cpu":
        return engine.event_fluid_plain(rows, x1, x2, k, w, tries, bias_den, mc, tables)
    dev, dt, n = _cuda_device(rows), rows.dtype, rows.shape[0]
    name = entry_point("event_fluid", dt)
    ins = [t.contiguous() for t in (x1, x2, *k, w)]
    _check_lanes(name, ins + [tries], [dt] * 7 + [torch.int32], n, dev,
                 names=_FLUID_IN[1:9])
    _check_rows(rows, 32, dev, "event rows", dt)
    if rows.shape[0] != n:
        raise ValueError(f"event rows: {rows.shape[0]} rows for {n} lanes")
    _check_hc(tables.hc_coeffs, dt, dev)
    out = torch.empty((_FLUID_OUT, n), dtype=dt, device=dev).unbind(0)
    # the hot step's scalars (phase A's step knobs, which this kernel does
    # not read, at their defaults), then EV_HALVE
    scal = list(_hot_scalars(mc, tables, engine.EngineConfig(), dev, dt)) + [engine.EV_HALVE]
    _launch(name, [rows] + ins + [tries, _den_on(bias_den, dev, dt), tables.hc_coeffs]
            + list(out), scal, n, dev)
    fl = fluid.FluidC(out[7], out[8], out[9], tuple(out[10:14]), tuple(out[14:18]),
                      tuple(out[18:22]), tuple(out[22:26]))
    return engine.EventFluid(tuple(out[0:7]), fl, out[26], out[27], out[28], out[29])


def compact(mask, k, invert=False):
    """The first ``k`` lanes where ``mask`` (N,) bool is set (clear, under
    ``invert``), ascending, padded: (valid, gi, sidx), each (k,), as
    ``engine.compact_idx`` gives them (gi clamped to N - 1 and sidx N on the
    pad).  On CPU tensors that plain version (the sort, of ``~mask`` under
    ``invert``), on CUDA tensors one launch of ``compact``
    (``csrc/compact.cu``: the mask's tiles over blocks), or raise.  0 <= k
    <= N on either device.  No host sync."""
    n = mask.shape[0]
    if not (isinstance(k, int) and 0 <= k <= n):
        raise ValueError(f"compact: k must be an int in [0, {n}], got {k!r}")
    if mask.device.type == "cpu":
        return engine.compact_idx(~mask if invert else mask, k)
    dev = _cuda_device(mask)
    _check_lanes("compact", [mask], [torch.bool], n, dev, names=["mask"])
    valid = torch.empty(k, dtype=torch.bool, device=dev)
    gi, sidx = torch.empty((2, k), dtype=torch.int64, device=dev).unbind(0)
    _launch("compact", [mask, valid, gi, sidx], [k, int(invert)], n, dev)
    return valid, gi, sidx


# The mask mode's tile (csrc/compact.cu TILE): a block's bytes of the mask,
# 16 a thread of 256 (one block of 1,024 threads of 4 at N up to a tile).
COMPACT_TILE = 4096


def _check_scalar(what, t, dt, dev):
    if t.dtype != dt or t.dim() != 0 or t.device != dev:
        raise ValueError(f"{what}: expected a {dt} 0-d tensor on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def event_phase(pool, counters, sel, room, wedged, bias_den, mc, tables, gen=None, key=None,
                lanes=None):
    """The event phase between the compaction and the ring
    (``engine.event_phase_plain``): the compacted set ``sel`` = (valid, gi,
    sidx) of the lanes holding an event, cut to the ring's ``room`` unless
    ``wedged`` (0-d int64 and bool), runs its events: their raw corner rows,
    fluid, opacities and bias, the scatter event, the outcome on the pool,
    the secondaries' rows staged (``engine.EventStage``) and n_ev_soft and
    n_ev_forced counted.  On CPU tensors the plain version, drawing from
    ``gen`` or, given ``key``, from ``draws.PhiloxDraws(key)``, which
    returns a new pool and counters; on CUDA tensors one launch of
    ``event_phase`` (float32) or ``event_phase_f64`` of
    ``csrc/scatter_event.cu`` under ``key`` or two words drawn from ``gen``
    (:func:`draw_key`), which updates the pool's w, alpha_scatti,
    alpha_absi, bi, ev_tries, alive, occupied, at_event and ev_pending and
    the two counters in place and returns them, or raise.  ``bias_den``:
    the 0-d bias_norm * max_tau * (avg + 2); ``lanes``: the lanes a warp,
    one of ``EVENT_PHASE_LANES[dtype]`` (None: :func:`event_shape` picks by
    the width).
    Returns (pool, counters, stage).  No host sync."""
    if (gen is None) == (key is None):
        raise ValueError("event_phase: give exactly one of gen and key")
    if pool.w.device.type == "cpu":
        src = gen if key is None else draws.PhiloxDraws(key)
        return engine.event_phase_plain(pool, counters, sel, room, wedged, bias_den, mc, tables,
                                        src)
    dev, dt, n = _cuda_device(pool.w), pool.w.dtype, pool.w.shape[0]
    name = entry_point("event_phase", dt)
    valid, _, sidx = sel
    k = valid.shape[0]
    i32, b8 = torch.int32, torch.bool
    read = [*pool.x, *pool.k, *pool.ev_x, *pool.ev_k, pool.ev_w, pool.sec_w, pool.n_e_0,
            pool.theta_e_0, pool.e_0, pool.n_scatt]
    write = [pool.w, pool.alpha_scatti, pool.alpha_absi, pool.bi, pool.ev_tries, pool.alive,
             pool.occupied, pool.at_event, pool.ev_pending]
    _check_lanes(name, read + write, [dt] * 21 + [i32] + [dt] * 4 + [i32] + [b8] * 4, n, dev,
                 names=_PHASE_READ + _PHASE_WRITE)
    held = [t.data_ptr() for t in write]
    if len(set(held)) != len(held) or set(held) & {t.data_ptr() for t in read}:
        raise ValueError(f"{name}: a field it updates in place shares memory with another")
    _check_lanes(f"{name} set", [valid, sidx], [b8, torch.int64], k, dev, names=["valid", "sidx"])
    _check_scalar(f"{name} room", room, torch.int64, dev)
    _check_scalar(f"{name} wedged", wedged, b8, dev)
    for c in ("n_ev_soft", "n_ev_forced"):
        _check_scalar(f"{name} {c}", getattr(counters, c), torch.int64, dev)
    table = tables.corner_rows
    _check_rows(table, 32, dev, "corner table", dt)
    if table.shape[0] < mc.n1 * mc.n2:
        raise ValueError(f"corner table: {table.shape[0]} rows for {mc.n1}x{mc.n2} cells")
    _check_hc(tables.hc_coeffs, dt, dev)
    stage = engine.EventStage(torch.empty((k, engine.ROW_WIDTH), dtype=dt, device=dev),
                              torch.empty(k, dtype=b8, device=dev))
    ptrs = (read + write + [valid, sidx, room.contiguous(), wedged.contiguous(),
                            _event_key(gen, key, dev), _den_on(bias_den, dev, dt), table,
                            tables.hc_coeffs, stage.rows, stage.make, counters.n_ev_soft,
                            counters.n_ev_forced])
    # the hot step's scalars (phase A's step knobs, which this kernel does not
    # read, at their defaults), then EV_HALVE, EV_FORCE and the lanes a warp
    scal = list(_hot_scalars(mc, tables, engine.EngineConfig(), dev, dt)) + [
        engine.EV_HALVE, engine.EV_FORCE, lanes or 0]
    _launch(name, ptrs, scal, k, dev)
    return pool, counters, stage


def rows_ticket(device):
    """A ring's ticket for :func:`compact_rows` (``csrc/compact.cu`` rows
    mode): one int32 word at zero, which every pack into the ring takes and
    leaves at zero.  The ring's owner allocates it beside the ring's count,
    outside any CUDA graph's capture (a word made there is zeroed only
    when the graph replays)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def rows_shape(name, k):
    """The threads a block (and slots a tile) of the pack's entry point
    ``name`` (``COMPACT_ROWS``) at ``k`` slots, and its blocks."""
    threads = _int_fn(f"{name}_threads", k)
    return {"threads": threads, "blocks": -(-k // threads)}


def compact_rows(stage, sec, counters, ticket=None):
    """Pack the event phase's staged secondaries into the ring in slot
    order (``engine.pack_rows_plain``): the r-th row of ``stage`` (an
    ``engine.EventStage``) that makes one goes to ``sec.rows[sec.count +
    r]`` while that is below the ring's capacity; the count takes the rows
    kept, ``counters.n_sec_drop`` the rows dropped.  On CPU tensors the
    plain version (a cumsum and a scatter; new tensors), on CUDA tensors
    one launch of ``compact_rows`` / ``compact_rows_f64``
    (``csrc/compact.cu``: tiles of the slots over blocks, the last block to
    finish updating the count through the ring's ``ticket``, a
    :func:`rows_ticket`, so packs into one ring run one at a time, as on
    one stream), which updates ``sec.rows``, ``sec.count`` and
    ``counters.n_sec_drop`` in place and returns them, or raise.  Returns
    (sec, counters).  No host sync."""
    if sec.rows.device.type == "cpu":
        return engine.pack_rows_plain(stage, sec, counters)
    dev, dt = _cuda_device(sec.rows), sec.rows.dtype
    name = entry_point("compact_rows", dt)
    k = stage.make.shape[0]
    _check_lanes(name, [stage.make], [torch.bool], k, dev, names=["make"])
    _check_rows(stage.rows, engine.ROW_WIDTH, dev, "staged rows", dt)
    _check_rows(sec.rows, engine.ROW_WIDTH, dev, "ring rows", dt)
    if stage.rows.shape[0] != k:
        raise ValueError(f"{name}: {stage.rows.shape[0]} staged rows for {k} flags")
    _check_scalar(f"{name} count", sec.count, torch.int64, dev)
    _check_scalar(f"{name} n_sec_drop", counters.n_sec_drop, torch.int64, dev)
    if ticket is None or ticket.dtype != torch.int32 or ticket.shape != (1,) \
            or ticket.device != dev:
        raise ValueError(f"{name}: expected the ring's ticket (rows_ticket) on {dev}, got "
                         f"{None if ticket is None else (ticket.dtype, tuple(ticket.shape))}")
    _launch(name, [stage.make, stage.rows, sec.rows, sec.count, counters.n_sec_drop, ticket],
            [sec.rows.shape[0]], k, dev)
    return sec, counters


def record_ticket(device, n):
    """The record's scratch for :func:`record_phase` on ``n`` lanes: bytes
    at zero (on the card ``csrc/record.cu``'s record_phase_scratch: the
    ticket, the tile counter and the tiles' status words, which every call
    leaves at zero, and the blocks' counters; one byte elsewhere, where the
    plain version runs).  The engine allocates it outside any CUDA graph's
    capture."""
    dev = torch.device(device)
    size = _int_fn("record_phase_scratch", n) if dev.type == "cuda" else 1
    return torch.zeros(size, dtype=torch.uint8, device=dev)


def _record_scalars(mc, width, mode, stall_steps, dev, dt):
    """The record's scalars (``_RECORD_SCAL``): the bins' divisions by a
    Python scalar are multiplies by PyTorch's reciprocal (:func:`_recip`)."""
    dx2 = (mc.x_stop[2] - mc.x_start[2]) / (2.0 * consts.N_TH_BINS)
    mid = 0.5 * (mc.x_start[2] + mc.x_stop[2])
    return [width, mode, stall_steps, consts.N_TH_BINS, consts.N_E_BINS, mid, mc.x_stop[2],
            _recip(dx2, dev, dt), consts.spectrum.L_E_0, _recip(consts.spectrum.D_L_E, dev, dt),
            mc.bias_norm, engine.BIAS_EMA]


def record_phase(pool, spec, counters, width, mc, cfg, ticket=None, sweep=True, record=True,
                 free=True, fold=False, bias=None, go=None, handle=None):
    """The phases' upkeep of the pool (``engine.record_phase_plain``, then
    ``engine.bias_terms_plain``): under ``sweep`` the poison sweep, under
    ``record`` the record of up to ``width`` escaped lanes into ``spec``
    and the counters, under ``free`` the frees and their census, under
    ``fold`` (with ``record``) the full phase's EMA fold; into ``bias`` (an
    ``engine.BiasTerms`` of 0-d tensors of the pool's dtype, or None: the
    frozen bias's constants, which nothing writes) the bias's terms from
    the counters it leaves, under ``cfg.reference`` with the cumulative
    average.  On CPU tensors the plain versions (new tensors; the terms
    copied into ``bias``); on CUDA tensors one launch of ``record_phase`` /
    ``record_phase_f64`` of ``csrc/record.cu`` (``launches`` counts it,
    :func:`record_launches`), which updates the pool's flags (alive,
    occupied, record_pending, at_event, ev_pending), ``spec``, the counters
    and ``bias`` in place through ``ticket`` (a :func:`record_ticket` for
    the pool's lanes) and returns them, or raise.  Returns (pool, spec,
    counters).  No host sync.

    The sweep alone may be gated (a block's first launch): given ``go``
    (the exit word's bool scalar), it changes nothing, the bias's terms
    included, where ``go`` is clear (the plain version keeps every tensor
    it would write where ``go`` is clear, ``engine.gated_sweep_plain``);
    given ``handle`` (:func:`exit_handle`, inside a capture on the card)
    it also sets that conditional node's condition from ``go``."""
    if not (sweep or record or free):
        raise ValueError("record_phase: no stage to run")
    if (go is not None or handle is not None) and (record or free or not sweep):
        raise ValueError("record_phase: only the sweep alone takes go and a handle")
    if handle is not None and go is None:
        raise ValueError("record_phase: a conditional handle is set from go")
    if fold and not record:
        raise ValueError("record_phase: the EMA fold comes with the record")
    n = pool.w.shape[0]
    if record and not (isinstance(width, int) and 0 < width <= n):
        raise ValueError(f"record_phase: width must be an int in [1, {n}], got {width!r}")
    dt = pool.w.dtype
    if pool.w.device.type == "cpu":
        if handle is not None:
            raise ValueError("record_phase: a conditional handle exists only on the card")
        if go is not None:
            return engine.gated_sweep_plain(pool, spec, counters, go, mc, cfg, bias)
        pool, spec, counters = engine.record_phase_plain(pool, spec, counters, width, mc, cfg,
                                                         sweep=sweep, record=record, free=free)
        if fold or bias is not None:
            counters, terms = engine.bias_terms_plain(counters, mc.bias_norm, dt,
                                                      cfg.reference, fold=fold)
            for dst, src in zip(bias or (), terms):
                dst.copy_(src)
        return pool, spec, counters
    dev = _cuda_device(pool.w)
    name = entry_point("record_phase", dt)
    i32, b8 = torch.int32, torch.bool
    read = [*pool.x, *pool.k, pool.w, pool.e, pool.x1i, pool.x2i, pool.tau_abs, pool.tau_scatt,
            pool.n_e_0, pool.theta_e_0, pool.b_0, pool.e_0, pool.n_scatt, pool.nsc0,
            pool.n_step]
    flags = [pool.alive, pool.occupied, pool.record_pending, pool.at_event, pool.ev_pending]
    birth = [*pool.bx, *pool.bk, pool.bw] if cfg.trace_birth else []
    _check_lanes(name, read + flags + birth, [dt] * 18 + [i32] * 3 + [b8] * 5 + [dt] * len(birth),
                 n, dev, names=_RECORD_READ + _RECORD_FLAGS + _BIRTH[:len(birth)])
    held = [t.data_ptr() for t in flags]
    if len(set(held)) != len(held):
        raise ValueError(f"{name}: two of the flags it updates in place share memory")
    if (spec.dtype != dt or tuple(spec.shape) != (engine.N_BINS + 1, engine.N_SPEC_CHAN)
            or not spec.is_contiguous() or spec.device != dev or spec.data_ptr() % 16):
        raise ValueError(f"{name}: expected a contiguous 16-byte aligned {dt} spectrum "
                         f"({engine.N_BINS + 1}, {engine.N_SPEC_CHAN}) on {dev}, got "
                         f"{spec.dtype} {tuple(spec.shape)} on {spec.device}")
    cs = [getattr(counters, c) for c in _RECORD_COUNTERS]
    terms = list(bias) if bias is not None else [None] * len(engine.BiasTerms._fields)
    floats = ("max_tau_scatt", "w_stall", "mt_bx", "mt_bk", "mt_bw", "avg_ema")
    for c, t in [*zip(_RECORD_COUNTERS, cs), *zip(engine.BiasTerms._fields, terms)]:
        if t is None:
            continue
        want = (4,) if c in ("mt_bx", "mt_bk") else ()
        typ = dt if c in floats + engine.BiasTerms._fields else torch.int64
        if t.dtype != typ or tuple(t.shape) != want or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} {c}: expected a {typ} {want} tensor on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    held = [t.data_ptr() for t in terms if t is not None]
    if len(set(held)) != len(held):
        raise ValueError(f"{name}: two of the bias's terms share memory")
    if (ticket is None or ticket.dtype != torch.uint8 or ticket.dim() != 1
            or ticket.device != dev or ticket.numel() < _int_fn("record_phase_scratch", n)):
        raise ValueError(f"{name}: expected the record's scratch (record_ticket) for {n} lanes "
                         f"on {dev}, got "
                         f"{None if ticket is None else (ticket.dtype, tuple(ticket.shape))}")
    if go is not None:
        _check_scalar(f"{name} go", go, torch.bool, dev)
    mode = (sweep * RECORD_SWEEP + record * RECORD_RECORD + free * RECORD_FREE
            + fold * RECORD_FOLD + (bias is not None) * RECORD_TERMS
            + cfg.reference * RECORD_CUMUL)
    _launch(name, read + flags + (birth or [None] * 9) + [spec] + cs + terms
            + [ticket, go, 0 if handle is None else int(handle)],
            _record_scalars(mc, width if record else 1, mode, cfg.stall_steps, dev, dt),
            n, dev, kernels=record_launches(mode))
    return pool, spec, counters


def record_at_rest(scratch, n):
    """Whether a record's scratch for ``n`` lanes (:func:`record_ticket`)
    is at rest: the ticket, the tile counter and every tile's status word
    (tiles of ``RECORD_TILE`` lanes) at zero."""
    return not bool(scratch[:8 + 8 * -(-n // RECORD_TILE)].any())


def record_launches(mode):
    """The kernels a :func:`record_phase` call launches in ``mode``
    (``RECORD_SWEEP``, ``RECORD_RECORD``, ``RECORD_FREE`` added): one for
    every mode (``csrc/record.cu``'s record_phase_launches)."""
    return _int_fn("record_phase_launches", mode)


def exit_test(occupied, backlog_pos, sec_count, n_valid, tail_exit, word, go, n_super,
              max_outer):
    """The run's exit test (``engine.exit_test_plain``): whether the next
    block runs, ``go`` = (occupied lanes > ``tail_exit`` or ``backlog_pos``
    < ``n_valid`` or ``sec_count`` > 0) and ``word[3] * n_super <
    max_outer``, written into ``word`` = [occ, pos, sec, bodies + go, go]
    (int64 (``engine.EXIT_WORD``,)) and ``go`` (a bool scalar, which the
    blocks' gated sweeps read), in place.  ``occupied``: the (N,) bool
    mask; the other four int64 scalars.  On CPU tensors the plain version,
    on CUDA tensors one launch of ``exit_test`` (``csrc/exit_test.cu``), or
    raise.  Returns (word, go).  No host sync."""
    if occupied.device.type == "cpu":
        return engine.exit_test_plain(occupied, backlog_pos, sec_count, n_valid, tail_exit,
                                      word, go, n_super, max_outer)
    dev, n = _cuda_device(occupied), occupied.shape[0]
    _check_lanes("exit_test", [occupied], [torch.bool], n, dev, names=["occupied"])
    for what, t in (("backlog_pos", backlog_pos), ("sec_count", sec_count),
                    ("n_valid", n_valid), ("tail_exit", tail_exit)):
        _check_scalar(f"exit_test {what}", t, torch.int64, dev)
    _check_scalar("exit_test go", go, torch.bool, dev)
    if (word.dtype != torch.int64 or tuple(word.shape) != (engine.EXIT_WORD,)
            or not word.is_contiguous() or word.device != dev):
        raise ValueError(f"exit_test: expected a contiguous ({engine.EXIT_WORD},) int64 word "
                         f"on {dev}, got {word.dtype} {tuple(word.shape)} on {word.device}")
    if not (isinstance(n_super, int) and isinstance(max_outer, int) and n_super >= 1
            and 0 <= max_outer < 2**53):
        raise ValueError(f"exit_test: n_super {n_super!r} and max_outer {max_outer!r}")
    _launch("exit_test", [occupied, backlog_pos, sec_count, n_valid, tail_exit, word, go],
            [n_super, max_outer], n, dev)
    return word, go


def exit_handle(device):
    """A conditional handle (its condition 0 at each launch unless a kernel
    sets it) on the CUDA graph that ``device``'s current stream is
    capturing: made before the launch that sets it is captured (the
    gated sweep, :func:`record_phase`'s ``handle``), and given to the node
    that it guards (:func:`exit_guard`).  Raises where the stream is not
    capturing."""
    build()
    out = ctypes.c_ulonglong(0)
    rc = _Build.guard_fns["exit_guard_handle"](torch.cuda.current_stream(device).cuda_stream,
                                               ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"exit_handle: no conditional handle ("
                           f"{'the stream is not capturing' if rc < 0 else f'CUDA error {rc}'})")
    return out.value


def exit_guard(handle, fn, body_stream, pool):
    """Capture ``fn()`` under a conditional IF node on ``handle``
    (:func:`exit_handle`) into the CUDA graph that the current stream is
    capturing, after what it captured so far: a replay runs what ``fn``
    launched only where the handle's condition is set when the node is
    reached, by a launch captured before the node (the block's gated
    sweep, :func:`record_phase`'s ``handle``).  ``fn`` runs with
    ``body_stream`` (a ``torch.cuda.Stream`` other than the current one,
    not capturing) as the current stream, capturing into the node's body,
    and its allocations come from ``pool`` (a ``torch.cuda.MemPool`` that
    the graph's owner keeps as long as the graph).  The plain version is
    Python's ``if``: a graph exists only on the card.  Raises where the
    current stream is not capturing or the CUDA runtime refuses the
    node."""
    build()
    dev = body_stream.device
    stream = torch.cuda.current_stream(dev)
    if stream.cuda_stream == body_stream.cuda_stream:
        raise ValueError("exit_guard: the body's stream is the stream capturing the graph")
    rc = _Build.guard_fns["exit_guard_begin"](stream.cuda_stream, body_stream.cuda_stream,
                                              int(handle))
    if rc != 0:
        raise RuntimeError(f"exit_guard: the conditional node was refused ("
                           f"{'the stream is not capturing' if rc < 0 else f'CUDA error {rc}'})")
    try:
        with torch.cuda.stream(body_stream), torch.cuda.use_mem_pool(pool, dev):
            fn()
    finally:
        rc = _Build.guard_fns["exit_guard_end"](body_stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"exit_guard: the capture of the node's body failed: CUDA error {rc}")


def plain_rowsum(table, idx):
    """The plain version of :func:`gather_rowsum`: ``table[idx].sum(1)``."""
    return table[idx.long()].sum(dim=1)


def gather_rowsum(table, idx, strategy="coop", blk=256):
    """``table[idx].sum(1)``: row sums of a (Z, W) table at (N,) int32
    indices in [0, Z) (not checked, as in the TPU kernels).  The plain
    version on CPU tensors; on CUDA tensors the kernel of
    ``csrc/gather_probe.cu`` that ``strategy`` names (one of
    ``ROWSUM_STRATEGIES``; float32, contiguous, 16-byte aligned, W a
    multiple of 4).  ``blk``, the JAX probe's grid block, is read by
    ``"smem"`` alone: it caps the rows of one shared-memory stage
    (:func:`smem_stage_rows`, which checks it and W on either device).
    The sums run in another order than the plain version's
    (``rowsum_slack`` bounds the difference); no host sync."""
    if strategy not in ROWSUM_STRATEGIES:
        raise ValueError(f"gather_rowsum: strategy {strategy!r} not in {ROWSUM_STRATEGIES}")
    scal = [table.shape[-1]]
    if strategy == "smem":
        scal.append(smem_stage_rows(table.shape[-1], blk))
    if table.device.type == "cpu":
        return plain_rowsum(table, idx)
    dev, n, _ = _gather_args(table, idx, f"gather_rowsum {strategy}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    _launch(f"gather_rowsum_{strategy}", [table, idx, out], scal, n, dev)
    return out


def smem_stage_rows(w, blk):
    """The rows T of one shared-memory stage of ``gather_rowsum(...,
    "smem", blk)`` for rows of ``w`` floats: ``blk`` capped at what a warp's
    stage holds (``SMEM_STAGE_FLOATS``, ``SMEM_STAGE_ROWS``).  Each warp
    sums tiles of T consecutive rows; the grid is one wave whatever ``blk``
    is.  Raises a ValueError for a ``blk`` that is not a positive int or a
    row wider than a stage."""
    if not (isinstance(blk, int) and blk > 0):
        raise ValueError(f"gather_rowsum smem: blk must be a positive int, got {blk!r}")
    if not 0 < w <= SMEM_STAGE_FLOATS:
        raise ValueError(f"gather_rowsum smem: W = {w} is not in 1..{SMEM_STAGE_FLOATS}, "
                         "the floats of one shared-memory stage")
    return min(blk, SMEM_STAGE_ROWS, SMEM_STAGE_FLOATS // w)


def persistent_pass_rows(w):
    """The rows one pass of ``gather_rowsum(..., "persistent")`` covers at
    row width ``w`` on the current CUDA device: its one-wave grid's threads
    over the lanes a row takes.  The kernel walks N rows in ceil(N / this)
    passes (when N is smaller, its grid is)."""
    return _int_fn("gather_rowsum_persistent_pass_rows", w)


def rowloop_step_rows(w):
    """The rows P of one step of ``gather_rowsum(..., "rowloop")`` at row
    width ``w``: 32 / G, G the lanes a row (the largest power of two at most
    32 and at most w / 4)."""
    g = 1
    while g < 32 and 2 * g <= w // 4:
        g *= 2
    return 32 // g


def rowloop_wave_rows(w):
    """The rows ``gather_rowsum(..., "rowloop")`` covers at row width ``w``
    on the current CUDA device when each warp of its one-wave grid walks one
    step (:func:`rowloop_step_rows` rows): N up to this takes one step a
    warp, beyond it each warp walks ceil(steps / warps)."""
    return _int_fn("gather_rowsum_rowloop_wave_rows", w)


def hot_step_shape(name, n):
    """The instance a launch of the hot step's entry point ``name``
    (``HOT_STEPS`` or ``HOT_DRAWS``) on ``n`` lanes runs, {``HOT_SHAPE``:
    int}: its threads a lane (``group``: in float32 8 up to 4,096 lanes, the
    cascade's and the gate's pools, 2 up to 16,384, 1 beyond; in float64 8
    up to 2,048, 1 beyond), its threads a block (float32: 128 in a group,
    256 beyond; float64: 128, 64 up to 32,768, 256 beyond) and the blocks an
    SM holds on the current CUDA device."""
    return {what: _int_fn(f"{name}_{what}", n) for what in HOT_SHAPE}


def hot_step_shape_edges(name, widest=65536):
    """The widths n in [1, ``widest``) after which a launch of ``name``
    runs another instance (group, threads a block): each the last width of
    an interval of one shape, found by bisection (the shapes run in
    intervals of n); the card tests hold each side of each."""
    def shape(n):
        s = hot_step_shape(name, n)
        return s["group"], s["threads"]

    edges, lo = [], 1
    while shape(lo) != shape(widest):
        first, hi = shape(lo), widest  # shape(lo) == first != shape(hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if shape(mid) == first else (lo, mid)
        edges.append(lo)
        lo = hi
    return edges



def _int_fn(sym, *v):
    """One of the libraries' int functions (``_INT_FNS``) at ``v``; a value
    at or below 0 is minus a CUDA error."""
    build()
    out = _Build.int_fns[sym](*(int(a) for a in v))
    if out <= 0:
        raise RuntimeError(f"{sym}{v}: CUDA error {-out}")
    return out


def row_gather_rowloop(table, idx):
    """``table[idx]`` as :func:`row_gather`, by the row-copy kernel of
    ``csrc/gather_probe.cu`` on CUDA tensors (tiles of rows gathered into
    shared memory and written out by bulk copies), the plain version on
    CPU tensors.  W is at most ``ROW_COPY_MAX_W`` on either device."""
    if table.dim() == 2 and table.shape[1] > ROW_COPY_MAX_W:
        raise ValueError(f"row_gather_rowloop: W = {table.shape[1]} exceeds "
                         f"{ROW_COPY_MAX_W}, the floats of one shared-memory stage")
    if table.device.type == "cpu":
        return table[idx.long()]
    dev, n, w = _gather_args(table, idx, "row_gather_rowloop")
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    _launch("row_gather_rowloop", [table, idx, out], [w], n, dev)
    return out


def _gather_args(table, idx, what, dtype=torch.float32):
    """(device, N, W) of a gather's CUDA ``dtype`` table (Z, W), its rows a
    whole number of 16-byte units, and int32 indices (N,)."""
    dev = _cuda_device(table)
    per_unit = 16 // dtype.itemsize
    if table.dim() != 2 or table.shape[1] % per_unit:
        raise ValueError(f"{what}: expected a (Z, W) table with W % {per_unit} == 0, got "
                         f"{tuple(table.shape)}")
    n = idx.shape[0]
    _check_rows(table, table.shape[1], dev, f"{what} table", dtype)
    _check_lanes(f"{what} indices", [idx], [torch.int32], n, dev)
    return dev, n, table.shape[1]


def _check_rows(t, width, dev, what, dtype=torch.float32):
    """A contiguous, 16-byte aligned ``dtype`` (Z, width) tensor on dev."""
    if (t.dtype != dtype or t.dim() != 2 or t.shape[1] != width
            or not t.is_contiguous() or t.device != dev or t.data_ptr() % 16):
        raise ValueError(f"{what}: expected a contiguous, 16-byte aligned {dtype} "
                         f"(Z, {width}) tensor on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _b_scalars(mc, stall_steps, k2_coeffs, dev, dtype=torch.float32):
    """Phase B's scalars (``_B_SCAL_HEAD`` order, then the K2 series), the
    reciprocals of ``dtype``."""
    if len(k2_coeffs) != _K2_N:
        raise ValueError(f"k2 coefficients: expected {_K2_N}, got {len(k2_coeffs)}")
    scal = [mc.x_start[1], mc.x_start[2], mc.x_stop[1], mc.x_stop[2], mc.dx[1],
            mc.dx[2], mc.n1, mc.n2, mc.b_unit, mc.d_tau_k, engine.WEIGHT_MIN, stall_steps,
            engine.GROW_TAU_CAP, tables_mod.HC_XLO, tables_mod.HC_XHI,
            tables_mod.HC_YLO, tables_mod.HC_YHI, tables_mod.K2_LO, tables_mod.K2_HI]
    scal += [_recip(c, dev, dtype) for c in (
        mc.dx[1], mc.dx[2], mc.b_unit, consts.HPL, consts.ME * consts.CL * consts.CL,
        tables_mod.HC_XHI - tables_mod.HC_XLO, tables_mod.HC_YHI - tables_mod.HC_YLO,
        tables_mod.K2_HI - tables_mod.K2_LO, consts.CL, 24.0,
        2.0 * math.pi * consts.ME * consts.CL, engine.WEIGHT_MIN, consts.TP_OVER_TE)]
    return scal + list(np.asarray(k2_coeffs, np.float64))


# ---------------------------------------------------------------------------
# checks: synthetic lane states and the comparison contract
# ---------------------------------------------------------------------------

def synthetic_lanes(mc, n, seed, stall_steps, reference=False, events=False):
    """Random per-lane hot-step inputs, float64 numpy, from ``seed``.

    Positions span the grid, the vacuum beyond it, the horizon and the
    escape radius; momenta get a consistent dk/dlambda and conserved
    energy, so most pushes commit.  Step factors, pend pushes, parked
    lanes, small weights with forced roulette wins, zero-opacity lanes
    (grown entry roll), large opacities (tau_over, absorption), scatter
    draws and step counts at the cap reach every branch of both phases.
    ``reference`` adds the lanes that the reference variants need to reach
    every branch, drawn from a second stream so that all other lanes stay
    as they are: lanes at the polar edges (where the cell index clamps and
    the raw rows' metric pair is extreme), lanes flying backwards in time
    (negative fluid-frame frequency), and lanes whose conserved energy is
    off by 1e-3, so that their push fails unless at the shrink floor, some
    of them just above it.  ``events`` adds what the whole step reads
    beyond the two phases, from a third stream: ``occupied`` (every alive
    lane and half of the others), the detached-event registers ``ev_x``,
    ``ev_k``, ``ev_w`` and ``ev_pending``, and (for the shipped profile,
    whose step captures events) lanes flying backwards in time, so that
    some arrivals are doomed parents.  Returns a dict of (n,)
    arrays (4-vectors as 4-tuples) and the scalar ``bias_scale``."""
    weight_min = engine.WEIGHT_MIN
    rng = np.random.default_rng(seed)
    u = rng.random
    kind = u(n)
    x1 = rng.uniform(mc.x_start[1] + 0.02, mc.x_stop[1] + 0.6, n)
    x1 = np.where(kind < 0.05, rng.uniform(mc.x_start[1] - 0.02, mc.x1_min + 0.01, n), x1)
    x1 = np.where((kind >= 0.05) & (kind < 0.1),
                  rng.uniform(consts.X1_MAX - 0.02, consts.X1_MAX + 0.05, n), x1)
    x2 = rng.uniform(0.02, 0.98, n)
    x = (rng.uniform(0.0, 100.0, n), x1, x2, rng.uniform(0.0, 2.0 * np.pi, n))
    r = np.exp(x1)
    e = 10.0 ** rng.uniform(-9.0, -3.0, n)
    c = rng.uniform(-1.0, 1.0, (3, n))
    k = (e * (1.0 + 0.5 * u(n)), e * c[0] / r, e * c[1] / (np.pi * r), e * c[2] / r)
    extra = np.random.default_rng([seed, 1]).random((3, n)) if reference else np.ones((3, n))
    edge = (0.1 + 1.4 * extra[1]) * mc.dx[2]
    x2 = np.where(extra[0] < 0.02, mc.x_start[2] + edge,
                  np.where(extra[0] < 0.04, mc.x_stop[2] - edge, x2))
    x = (x[0], x1, x2, x[3])
    ev = np.random.default_rng([seed, 2]).random((5, n)) if events else np.ones((5, n))
    back = (ev[0] < 0.05) & (not reference)  # only the shipped profile captures events
    k = (np.where(((extra[0] >= 0.04) & (extra[0] < 0.06)) | back, -k[0], k[0]),) + k[1:]
    drift = (extra[0] >= 0.06) & (extra[0] < 0.09)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    conn = geometry.connection_c(t(x1), t(x2), mc.a, mc.h_slope)
    dk = tuple(v.numpy() for v in geometry.geodesic_rhs_c(conn, *map(t, k)))
    g00, g01, g03 = (v.numpy() for v in geometry.gcov_row0_c(
        t(x1), t(x2), mc.a, mc.h_slope, mc.r_0))
    e_0_s = -(k[0] * g00 + k[1] * g01 + k[3] * g03)
    e_0_s = np.where(drift, e_0_s * (1.0 + 1e-3), e_0_s)

    floor = 2.0 ** (-consts.MAX_HALVING_DEPTH)
    dl_shrink = np.where(u(n) < 0.05, floor, 2.0 ** rng.uniform(-7.0, 3.0, n))
    dl_shrink = np.where(drift & (extra[2] < 0.5), floor * (1.0 + extra[1]), dl_shrink)
    pend_push = u(n) < 0.2
    dl_nom = geometry.step_size_c(t(x1), t(x2), t(k[1]), t(k[2]), t(k[3]),
                                  mc.x_stop[2]).numpy()
    pend_dl = np.where(pend_push, dl_nom * rng.uniform(0.1, 1.5, n), 0.0)
    vacuum = u(n) < 0.15
    alpha_scatti = np.where(vacuum, 0.0, 10.0 ** rng.uniform(-12.0, 2.0, n))
    alpha_absi = np.where(vacuum, 0.0, 10.0 ** rng.uniform(-12.0, 4.0, n))
    u_roul = np.where(u(n) < 0.02, 0.5e-4 * u(n), u(n))
    u_x1 = np.where(u(n) < 0.1, 1.0 - 1e-6 * u(n), u(n))
    n_step = np.where(u(n) < 0.05, stall_steps, rng.integers(0, stall_steps, n))
    out = dict(
        x=x, k=k, dkdlam=dk, e_0_s=e_0_s, dl_shrink=dl_shrink,
        pend_dl=pend_dl, pend_push=pend_push, at_event=u(n) < 0.1,
        alive=u(n) < 0.93, w=weight_min * 10.0 ** rng.uniform(-1.0, 6.0, n),
        record_pending=u(n) < 0.05, u_roul=u_roul,
        alpha_scatti=alpha_scatti, alpha_absi=alpha_absi,
        bi=10.0 ** rng.uniform(0.0, 6.0, n), tau_abs=u(n), tau_scatt=u(n),
        interacting=u(n) < 0.5, sec_w=weight_min * 10.0 ** rng.uniform(0.0, 4.0, n),
        n_step=n_step.astype(np.int32), u_x1=u_x1,
        bias_scale=100.0 / (mc.bias_norm * mc.max_tau_scatt0 * 2.0),
    )
    if events:
        out.update(occupied=out["alive"] | (ev[1] < 0.5), ev_pending=ev[2] < 0.4,
                   ev_x=tuple(np.where(ev[3] < 0.5, x[m], 0.5 * x[m]) for m in range(4)),
                   ev_k=tuple(np.where(ev[4] < 0.5, k[m], -k[m]) for m in range(4)),
                   ev_w=out["sec_w"] * (0.5 + ev[4]))
    return out


# The pool fields a hot step writes; the shipped profile's capture also the
# detached-event registers and occupied.
STEP_FIELDS = tuple(("x k dkdlam e_0_s dl_shrink pend_dl pend_push at_event w alive "
                     "record_pending tau_abs tau_scatt alpha_scatti alpha_absi bi "
                     "interacting sec_w n_step").split())
EVENT_FIELDS = ("ev_x", "ev_k", "ev_w", "ev_pending", "occupied")
# The fields of a hot step's output that phase A alone writes (kernel A's,
# which the card holds to the plain version on every lane): under reference
# semantics phase B and the epilogue pass at_event and dl_shrink through,
# in the shipped profile the clamp and the capture may change them.
PHASE_A_FIELDS = {False: ("record_pending",),
                  True: ("record_pending", "at_event", "dl_shrink")}


def synthetic_step(lanes, dtype, device):
    """(pool, counters, u_roul, u_x1, bias_scale) of one hot step, as torch
    on ``device``, from ``synthetic_lanes(..., events=True)``: the pool's
    fields that the lanes do not give are zero, and the census counters
    start at small nonzero values, so that a step adds to them."""
    def t(v):
        if isinstance(v, tuple):
            return tuple(t(c) for c in v)
        a = torch.as_tensor(np.asarray(v), device=device)
        return a if a.dtype in (torch.bool, torch.int32) else a.to(dtype)

    s = {k: t(v) for k, v in lanes.items() if k != "bias_scale"}
    n = s["w"].shape[0]
    pool = engine.empty_pool(n, dtype, device)._replace(
        **{k: v for k, v in s.items() if k in engine.Pool._fields})
    start = dict(ls_iters=5, ls_slots=5 * n, ls_occupied=3, ls_moving=2, ls_committed=1,
                 ls_parked=0, n_hc_clamp=7)
    counters = engine.init_counters(1.0, dtype, device)._replace(**{
        name: torch.tensor(v, dtype=torch.int64, device=device) for name, v in start.items()})
    bias = torch.tensor(lanes["bias_scale"], dtype=dtype, device=device)
    return pool, counters, s["u_roul"], s["u_x1"], bias


def step_outputs(pool, counters, reference):
    """({field: tensor} of what a hot step writes, {census counter: int})."""
    fields = STEP_FIELDS + (() if reference else EVENT_FIELDS)
    return ({f: getattr(pool, f) for f in fields},
            {c: int(getattr(counters, c)) for c in CENSUS})


def _flat(out):
    """{name: tensor}, 4-tuples split into name0..name3."""
    flat = {}
    for name, v in out.items():
        if isinstance(v, tuple):
            flat.update({f"{name}{i}": c for i, c in enumerate(v)})
        else:
            flat[name] = v
    return flat


# What each kernel is held to against its plain version on the same inputs,
# on every lane.  The hot step's phase A mirrors its plain version
# operation by operation (-fmad=false, the reciprocals of _recip), and the
# gather is a copy.  But the hot step's hotcross Chebyshev sum cannot round
# exactly as the plain version's float32 matrix product and sum, so both
# variants of the hot step are held to the Pallas-vs-XLA parity contract of
# tests/test_pallas_hot.py, and their census counters (integer counts of
# masks) to equality.  A weight decays by exp(-d_tau), which turns an error
# of rtol * d_tau in d_tau into a relative error of rtol * d_tau in w: w is
# held to rtol * (1 + d_tau), the slack of weight_slack.  The gather-probe row sums
# add a row's W terms in another order than the plain version, and rows of
# normal numbers can sum to nearly zero, so no relative tolerance fits
# them: each index may differ by rowsum_slack, W * 2^-23 * sum_j |row_j|
# (twice the worst-case error of either order), passed as compare's slack.
# The float64 hot step is held 10^7 tighter than the float32 one: rtol 1e-11
# is 100 times the worst relative difference its float64 instantiations
# showed against the plain float64 version on the card (1.1e-13 on w,
# 1e-13 on alpha_scatti: the hotcross sum's order against the float64
# matrix product; phase A equal bit for bit), atol 1e-30 (the physics' EPS:
# no field differed where the plain value is zero), every mask equal.
KERNEL_TOLERANCE = {
    "hot_step": dict(rtol=1e-4, atol=1e-6, mask_frac=1e-3),
    "hot_step_ref": dict(rtol=1e-4, atol=1e-6, mask_frac=1e-3),
    "row_gather": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
    "hot_step_f64": dict(rtol=1e-11, atol=1e-30, mask_frac=0.0),
    "hot_step_ref_f64": dict(rtol=1e-11, atol=1e-30, mask_frac=0.0),
    "row_gather_f64": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
    **{f"gather_rowsum_{s}": dict(rtol=0.0, atol=0.0, mask_frac=0.0)
       for s in ROWSUM_STRATEGIES},
    "row_gather_rowloop": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
}
# The drawing instances are held as the instances that take their uniforms,
# against the plain version on draws.hot_uniforms under the same key and step.
KERNEL_TOLERANCE.update({f"{h}_draw": KERNEL_TOLERANCE[h] for h in HOT_STEPS})


def step_d_tau(pool, ref):
    """The optical depth a hot step added per lane (float64, at least 0):
    the step ``ref`` (fields as ``step_outputs`` gives them) against the
    pre-step ``pool``."""
    d_tau = ((ref["tau_abs"].double() - pool.tau_abs.double())
             + (ref["tau_scatt"].double() - pool.tau_scatt.double()))
    return torch.clamp(d_tau, min=0.0)


def weight_slack(pool, ref, rtol):
    """The weight's slack in a hot step's comparison, per lane (float64):
    ``rtol * d_tau * |w|`` with ``d_tau`` from :func:`step_d_tau` of the
    plain step ``ref``.  For ``compare``'s ``slack``."""
    return {"w": rtol * step_d_tau(pool, ref) * ref["w"].double().abs()}


def rowsum_slack(table, idx):
    """What a row sum of ``table[idx]`` may differ by between two summation
    orders, per index (float64): W * 2^-23 * sum_j |table[idx, j]|."""
    return table.shape[1] * 2.0 ** -23 * plain_rowsum(table.abs().double(), idx)


def compare(ref, got, rtol, atol, mask_frac, slack=None, nan_equal=False):
    """Hold a phase's outputs ``got`` against ``ref`` (dicts as the phases
    return them) on every lane: each mask and integer field differs on at
    most ``mask_frac`` of the lanes, and each float field agrees to
    ``rtol``/``atol``, plus ``slack`` where given: a tensor of the lanes,
    or a dict of such tensors by field name (NaN only where ``ref`` is
    NaN).  A NaN fails, on either side, unless ``nan_equal`` lets a lane
    pass where both are NaN (the event fluid's guard lanes).  Returns
    (max_abs_err, max_rel_err, worst mask mismatch fraction, failures);
    the relative error is taken against max(|ref|, atol/rtol), or |ref|
    when rtol is 0."""
    ref, got = _flat(ref), _flat(got)
    worst = max_err = max_rel = 0.0
    fails = []
    for name, a in ref.items():
        b = got[name].to(a.device)
        if not a.dtype.is_floating_point:
            frac = float((a != b).double().mean())
            worst = max(worst, frac)
            if frac > mask_frac:
                fails.append(f"{name}: {frac:.2e} of lanes differ")
            continue
        a64, b64 = a.double(), b.double()
        both_nan = torch.isnan(a64) & torch.isnan(b64)
        diff = torch.nan_to_num(torch.where(both_nan, 0.0, torch.abs(a64 - b64)),
                                nan=math.inf)
        floor = atol / rtol if rtol > 0.0 else 0.0
        rel = torch.where(diff == 0.0, 0.0, diff / torch.clamp(torch.abs(a64), min=floor))
        if diff.numel():
            max_err = max(max_err, float(diff.max()))
            max_rel = max(max_rel, float(torch.nan_to_num(rel, nan=math.inf).max()))
        extra = slack.get(name) if isinstance(slack, dict) else slack
        allowed = atol + rtol * torch.abs(a64)
        if extra is not None:
            allowed = allowed + extra.to(a64.device)
        bad = ~(diff <= allowed)
        if nan_equal:
            bad &= ~both_nan
        if bool(bad.any()):
            i = int(torch.argmax(torch.nan_to_num(diff - allowed, nan=math.inf)))
            fails.append(f"{name}: {int(bad.sum())} lanes beyond rtol {rtol} atol {atol}"
                         + ("" if extra is None else " plus the slack")
                         + f"; worst lane {i}: {float(b64[i])} against {float(a64[i])}")
    return max_err, max_rel, worst, fails


# ---------------------------------------------------------------------------
# the event kernels' checks: synthetic event lanes and the comparison
# ---------------------------------------------------------------------------

# The event kernel is held to its plain version on PhiloxDraws under the
# same key, lane by lane.  Both round each operation alike (csrc/
# scatter_event.cu), so masks and round counts must be equal on every active
# lane; a lane may differ only where one of its acceptance tests sat within
# EVENT_NEAR_ULPS ulps of its threshold (PhiloxDraws' margins), at most one
# lane in EVENT_DIFF_PER lanes.  Floats are compared on the active lanes
# that both sides made and sampled, each within rtol of the lane's own scale
# (event_slack): the secondary's wave vector's components near 0 cancel.
EVENT_NEAR_ULPS = 16
EVENT_DIFF_PER = 10000
KERNEL_TOLERANCE.update({
    "scatter_event": dict(rtol=1e-4, atol=0.0, mask_frac=0.0),
    "scatter_event_f64": dict(rtol=1e-11, atol=0.0, mask_frac=0.0),
    "scatter_chain": dict(rtol=1e-4, atol=0.0, mask_frac=0.0),
    "scatter_chain_f64": dict(rtol=1e-11, atol=0.0, mask_frac=0.0),
    "philox_words": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
})
EVENT_MASKS = ("parent_die", "made", "sampled", "rounds_el", "rounds_sc")
CHAIN_MASKS = ("ok_el", "ok_kn", "rounds_el", "rounds_sc")


class EventLanes(typing.NamedTuple):
    """Synthetic event lanes: what ``Engine.process_scatters`` passes to
    :func:`scatter_event` (``k``, ``fl`` with its theta_e halved at
    ``tries // EV_HALVE``, ``g7``, ``active``, ``force``), and the lanes'
    positions ``x`` and defer counts ``tries``."""
    x: tuple
    k: tuple
    fl: object
    g7: tuple
    active: torch.Tensor
    force: torch.Tensor
    tries: torch.Tensor


def synthetic_events(eng, n, seed):
    """Random event lanes (:class:`EventLanes`), from ``seed``, through the
    engine ``eng``'s own fluid (``eval_fluid_xy``) in its dtype on its
    device.

    Positions span the grid and the vacuum beyond it; wave vectors are null
    and future-directed at energies 1e-10 ... 0.3, so that cold lanes run
    the Thomson loop and hot ones the Klein-Nishina loop, some to its cap.
    Guard lanes: k^0 negative, above 1e5 or NaN and k^1 NaN (doomed
    parents), spacelike wave vectors (some with a negative tetrad energy:
    invalid frames), 10% inactive.  The defer counts put 5% of the lanes at
    a halved theta_e and 5% at a forced draw."""
    mc, dt, dev = eng.mc, eng.dt, eng.device
    rng = np.random.default_rng(seed)
    kind = rng.random(n)
    x1 = rng.uniform(mc.x_start[1] + 0.01, mc.x_stop[1] - 0.01, n)
    x1 = np.where(kind < 0.05, rng.uniform(mc.x_stop[1], mc.x_stop[1] + 0.5, n), x1)
    x2 = rng.uniform(0.01, 0.99, n)
    g7, fl = eng.eval_fluid_xy(torch.as_tensor(x1, dtype=dt, device=dev),
                               torch.as_tensor(x2, dtype=dt, device=dev))
    g00, g01, g03, g11, g13, g22, g33 = (c.double().cpu().numpy() for c in g7)
    c = rng.normal(size=(3, n))
    c /= np.linalg.norm(c, axis=0)
    r = np.exp(x1)
    k1, k2, k3 = c[0] / r, c[1] / (np.pi * r), c[2] / r
    # the future-directed root of g_mn k^m k^n = 0 for k^0
    b = g01 * k1 + g03 * k3
    cc = g11 * k1 * k1 + 2.0 * g13 * k1 * k3 + g22 * k2 * k2 + g33 * k3 * k3
    k0 = (-b - np.sqrt(np.maximum(b * b - g00 * cc, 0.0))) / g00
    e = 10.0 ** rng.uniform(-10.0, -0.5, n)
    k = [e * k0, e * k1, e * k2, e * k3]
    guard = rng.random(n)
    k[0] = np.where(guard < 0.02, -k[0], k[0])
    k[0] = np.where((guard >= 0.02) & (guard < 0.03), 2.0e5, k[0])
    k[0] = np.where((guard >= 0.03) & (guard < 0.035), np.nan, k[0])
    k[1] = np.where((guard >= 0.035) & (guard < 0.04), np.nan, k[1])
    k[0] = np.where((guard >= 0.04) & (guard < 0.06), 1e-3 * k[0], k[0])
    tries = np.where(kind < 0.9, 0, rng.integers(1, 16, n))
    tries = np.where((kind >= 0.9) & (kind < 0.95), rng.integers(16, 32, n), tries)
    tries = np.where(kind >= 0.95, rng.integers(32, 40, n), tries)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    tries = t(tries.astype(np.int32))
    theta = fl.theta_e * torch.exp2(-(tries // engine.EV_HALVE).to(dt))
    active = t(rng.random(n) < 0.9)
    x = (t(np.zeros(n)).to(dt), t(x1).to(dt), t(x2).to(dt), t(np.zeros(n)).to(dt))
    return EventLanes(x, tuple(t(v).to(dt) for v in k), fl._replace(theta_e=theta), g7, active,
                      active & (tries >= engine.EV_FORCE), tries)


def event_slack(ref, names, rtol):
    """Each float field's slack per lane: ``rtol`` times the lane's scale,
    the sum of the magnitudes of ``names``' fields of ``ref`` (float64)."""
    flat = _flat(ref)
    scale = sum(flat[nm].double().abs() for nm in names)
    return rtol * torch.nan_to_num(scale, nan=0.0, posinf=0.0)


def compare_event(name, ref, got, margin, active=None):
    """Hold the event kernel ``name``'s result ``got`` against the plain
    version's ``ref`` (each a ``ScatterResultC`` or a ``ChainResult``),
    with ``margin`` the plain version's per-lane margins
    (``PhiloxDraws(margins=True)``), on the ``active`` lanes (all when
    None).  Returns (record, failures, the differing lanes as dicts): the
    record's ``max_abs_err``, ``max_rel_err``, ``mask_mismatch`` and counts
    of the lanes compared."""
    ref, got = ref._asdict(), got._asdict()
    chain = name.startswith("scatter_chain")
    masks = CHAIN_MASKS if chain else EVENT_MASKS
    tol = KERNEL_TOLERANCE[name]
    dt = _flat(ref)["k_tet_p0" if chain else "e_sec"].dtype
    n = next(iter(_flat(ref).values())).shape[0]
    dev = margin.device
    active = torch.ones(n, dtype=torch.bool, device=dev) if active is None else active
    differ = torch.zeros(n, dtype=torch.bool, device=dev)
    for m in masks:
        differ |= ref[m].to(dev) != got[m].to(dev)
    differ &= active
    near = margin <= EVENT_NEAR_ULPS * torch.finfo(dt).eps
    lanes = torch.nonzero(differ).flatten().tolist()
    rows = [{"lane": i, "margin": float(margin[i]),
             **{m: [_num(ref[m][i]), _num(got[m][i])] for m in masks}} for i in lanes]
    fails = []
    if lanes and not bool(near[differ].all()):
        fails.append(f"{int((differ & ~near).sum())} lanes differ in a mask or a round count "
                     f"with no acceptance test within {EVENT_NEAR_ULPS} ulps")
    if len(lanes) > n // EVENT_DIFF_PER:
        fails.append(f"{len(lanes)} lanes differ in a mask or a round count (at most "
                     f"{n // EVENT_DIFF_PER} at {n} lanes)")
    if chain:
        sel = active & ref["ok_el"] & ref["ok_kn"] & ~differ
        groups = {"p_el": ("p_el0", "p_el1", "p_el2", "p_el3"),
                  "k_tet_p": ("k_tet_p0", "k_tet_p1", "k_tet_p2", "k_tet_p3")}
    else:
        sel = active & ref["made"] & ref["sampled"] & ~differ
        groups = {"k_sec": ("k_sec0", "k_sec1", "k_sec2", "k_sec3"),
                  "e_sec": ("e_sec", "l_sec"), "l_sec": ("e_sec", "l_sec")}
    pick = lambda out: {k: (tuple(c[sel] for c in v) if isinstance(v, tuple) else v[sel])  # noqa: E731
                        for k, v in out.items() if k in groups}
    ref_f, got_f = pick(ref), pick(got)
    slack = {}
    for field, names in groups.items():
        s = event_slack(ref_f, names, tol["rtol"])
        for sub in ((field,) if field in ("e_sec", "l_sec") else names):
            slack[sub] = s
    err, rel, _, ffails = compare(ref_f, got_f, 0.0, 0.0, 0.0, slack=slack)
    rec = {"max_abs_err": err, "max_rel_err": rel, "mask_mismatch": len(lanes) / max(n, 1),
           "lanes_compared": int(sel.sum()), "lanes_active": int(active.sum()),
           "lanes_differing": len(lanes)}
    return rec, fails + ffails, rows


def _num(v):
    v = v.item()
    return bool(v) if isinstance(v, bool) else v


# ---------------------------------------------------------------------------
# the track start's and the event fluid's checks: synthetic inputs and the
# comparison
# ---------------------------------------------------------------------------

# The track start and the event fluid are held to their plain versions on
# every lane at the hot step's tolerance, as their hotcross sum runs in the
# hot step's reference order, not the plain matrix product's; every other
# field of a lane the track start loads (the row's fields, dk/dlambda,
# interacting, the birth state) must be equal bit for bit (the connection
# and the blend round as the plain versions), and every lane outside the
# loaded slots must keep each of its values bit for bit.
KERNEL_TOLERANCE.update({
    **{f"fresh_init{r}": dict(rtol=1e-4, atol=1e-6, mask_frac=0.0) for r in ("", "_ref")},
    **{f"fresh_init{r}_f64": dict(rtol=1e-11, atol=1e-30, mask_frac=0.0)
       for r in ("", "_ref")},
    "event_fluid": dict(rtol=1e-4, atol=1e-6, mask_frac=0.0),
    "event_fluid_f64": dict(rtol=1e-11, atol=1e-30, mask_frac=0.0),
})
# the track start's fields held within the tolerance (every other field of
# a loaded lane bit for bit)
FRESH_TOL = ("alpha_scatti", "alpha_absi", "bi")
# The widths the checks hold them at: the (pool lanes, fresh-set width) of
# each semantics' track starts on its path (by ``reference``: the wave
# engine's full phase (refill_k) and, shipped, its light phase (light_k),
# the cascade's engines and the gates' pool of 1,024), the first the kernels
# line's; the event phase's compacted widths (ev_k at the pool of 65,536,
# the cascade's and the gate's).
FRESH_WIDTHS = {False: ((65536, 32768), (65536, 12288), (4096, 4096), (1024, 1024), (512, 512)),
                True: ((65536, 16384), (4096, 4096), (1024, 1024), (512, 512))}
EVENT_FLUID_WIDTHS = (16384, 4096, 1024, 512)


def synthetic_fresh(mc, n, k, seed, dtype, device, reference=False, trace_birth=True):
    """(pool, load, bias_den, cfg) of one load and track start on ``n``
    lanes: the pool of :func:`synthetic_step`, the fields it leaves at zero
    drawn apart (so that a write into a wrong lane shows), distinct birth
    fields under ``trace_birth``; refill's slots ``load``
    (``engine.FreshLoad``) ``k`` wide: their lanes ascending and free, the
    last sixteenth (at least one slot) padded with ``n``; the first quarter
    of the slots loading from a ring of k // 2 rows (LIFO, partly filled),
    the rest from a backlog that runs out before the last of them; the
    rows' photons those of another synthetic pool (positions on the grid,
    in the vacuum beyond it and at its polar edges, weights that reach both
    ends of the bias clamp), one in twenty with a NaN in x or k and one in
    twenty at zero weight (loaded, not started); ``bias_den`` the initial
    bias_norm * max_tau * 2; ``cfg`` the semantics' config at ``n`` lanes."""
    lanes = synthetic_lanes(mc, n, seed, consts.MAX_N_STEP, reference, events=True)
    pool = synthetic_step(lanes, dtype, device)[0]
    rng, brng = np.random.default_rng([seed, 3]), np.random.default_rng([seed, 5])

    def t(a, dt=dtype):
        return torch.as_tensor(a, device=device).to(dt)

    def col():
        return t(brng.uniform(-2.0, 2.0, n))

    def ints():
        return t(brng.integers(0, 9, n), torch.int32)

    pool = pool._replace(e=col(), l=col(), n_e_0=col(), theta_e_0=col(), b_0=col(), e_0=col(),
                         x1i=col(), x2i=col(), n_scatt=ints(), nsc0=ints(), ev_tries=ints())
    if trace_birth:
        pool = pool._replace(bx=tuple(col() for _ in range(4)), bk=tuple(col() for _ in range(4)),
                             bw=col())
    m = min(n, k - max(1, k // 16))
    sidx = np.full(k, n, dtype=np.int64)
    sidx[:m] = np.sort(rng.choice(n, size=m, replace=False))
    occupied = pool.occupied.cpu().numpy().copy()
    occupied[sidx[:m]] = False
    valid, rank = sidx < n, np.arange(k)
    s_cap, n_sec, pos = max(1, k // 2), k // 4, k // 8
    n_valid = pos + max(0, m - n_sec - max(1, k // 10))
    from_sec = valid & (rank < n_sec)
    bl = pos + np.maximum(rank - n_sec, 0)
    from_bl = valid & (rank >= n_sec) & (bl < n_valid)
    # the rows: the photons of another synthetic pool, packed as the ring's
    r_n = s_cap + k
    r_lanes = synthetic_lanes(mc, r_n, seed + 7, consts.MAX_N_STEP, reference)
    rows = np.stack([*r_lanes["x"], *r_lanes["k"], r_lanes["w"],
                     *rng.uniform(0.1, 2.0, (6, r_n)), rng.integers(0, 5, r_n)], axis=1)
    kind = rng.random(r_n)
    rows[kind < 0.05, rng.integers(0, 8)] = np.nan
    rows[(kind >= 0.05) & (kind < 0.1), engine.ROW_W] = 0.0
    load = engine.FreshLoad(
        t(sidx, torch.int64), t(from_sec | from_bl, torch.bool), t(from_sec, torch.bool),
        t(np.clip(n_sec - 1 - rank, 0, s_cap - 1), torch.int64),
        t(np.clip(bl, 0, k - 1), torch.int64), t(rows[:s_cap]), t(rows[s_cap:]))
    cfg = engine.EngineConfig(n_pool=n, dtype=dtype, reference=reference,
                              trace_birth=trace_birth)
    den = torch.tensor(mc.bias_norm * mc.max_tau_scatt0 * 2.0, dtype=dtype, device=device)
    return pool._replace(occupied=t(occupied, torch.bool)), load, den, cfg


def _same_bits(a, b):
    """Per element: equal, or both NaN."""
    eq = a == b
    return eq | (torch.isnan(a) & torch.isnan(b)) if a.dtype.is_floating_point else eq


def fresh_lanes(pool, load):
    """(loaded, started): (N,) masks of the lanes that refill's slots
    ``load`` fill on ``pool`` and of those whose start runs."""
    n = pool.w.shape[0]
    valid, sidx = engine.refill_load_plain(pool, load)[1]

    def lanes(mask):
        out = torch.zeros(n + 1, dtype=torch.bool, device=sidx.device)
        out[sidx[mask]] = True
        return out[:n]

    return lanes(load.load), lanes(valid)


def compare_fresh(name, pool, load, ref, got):
    """Hold the load and start ``got`` (a pool) against the plain version's
    ``ref`` on the pool before them, ``pool``, and refill's slots
    ``load``: every field of the loaded lanes bit for bit but the
    opacities and the bias of the started lanes, which are held within
    ``KERNEL_TOLERANCE[name]``; every lane outside the loaded slots keeping
    each of the pool's values bit for bit.  Returns (record, failures)."""
    n = pool.w.shape[0]
    loaded, started = fresh_lanes(pool, load)
    before, ref_f, got_f = (_flat(p._asdict()) for p in (pool, ref, got))
    fails, kept_ok = [], True
    for f, a in ref_f.items():
        moved = ~_same_bits(before[f], got_f[f]) & ~loaded
        if bool(moved.any()):
            kept_ok = False
            fails.append(f"{f}: {int(moved.sum())} lanes outside the loaded slots changed")
        exact = loaded & ~started if f in FRESH_TOL else loaded
        differ = ~_same_bits(a, got_f[f]) & exact
        if bool(differ.any()):
            fails.append(f"{f}: {int(differ.sum())} loaded lanes not bit for bit")
    sel = {f: ref_f[f][started] for f in FRESH_TOL}
    err, rel, _, tfails = compare(sel, {f: got_f[f][started] for f in sel},
                                  **KERNEL_TOLERANCE[name])
    mism = float((ref.interacting != got.interacting).double().mean())
    rec = {"max_abs_err": err, "max_rel_err": rel, "mask_mismatch": mism,
           "lanes": n, "slots": int(load.sidx.shape[0]), "lanes_loaded": int(loaded.sum()),
           "lanes_fresh": int(started.sum()),
           "lanes_plasma": int(ref.interacting[started].sum()), "kept_bitwise": kept_ok,
           "bi_bitwise": bool(_same_bits(ref.bi, got.bi).all())}
    return rec, fails + tfails


# The record's widths on the path: (pool lanes, width) of the wave engine's
# full phase (ev_k), light phase (light_k) and closing flush (the pool's
# width) and of the cascade's engines (the width their pools), each also
# cut below its recording lanes.
RECORD_WIDTHS = ((65536, 16384), (65536, 12288), (65536, 65536), (4096, 4096), (4096, 512),
                 (512, 512), (512, 64))
# The step cap of the synthetic record's pools.
RECORD_STALL = 1000


def synthetic_record(mc, n, k, seed, dtype, device, reference=False, trace_birth=True,
                     nan_tau=False):
    """(pool, spec, counters, cfg) of one record on ``n`` lanes at width
    ``k``: nine in ten lanes occupied, a third of those pending a record
    (more than ``k`` at the wave's widths), one in ten holding an event,
    half alive; positions on the grid and beyond its polar edges, energies
    below, across and above the spectrum's bins (a few under the log's
    clamp); one lane in a hundred poisoned (a NaN in x, k or w), one pending
    lane in a hundred with a NaN energy and one unoccupied with a NaN
    weight; steps on both sides of the step cap ``RECORD_STALL``; the
    ratchet at the pending lanes' 99th percentile of tau_scatt (a NaN
    tau_scatt on the first lane that records under ``nan_tau``); a
    spectrum and counters already filled."""
    rng = np.random.default_rng([seed, 11])

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    occupied = rng.random(n) < 0.9
    pending = occupied & (rng.random(n) < 0.35)
    span2 = mc.x_stop[2] - mc.x_start[2]
    x = [rng.uniform(0.0, 100.0, n), rng.uniform(mc.x_start[1], mc.x_stop[1], n),
         rng.uniform(mc.x_start[2] - 0.05 * span2, mc.x_stop[2] + 0.05 * span2, n),
         rng.uniform(0.0, 2.0 * math.pi, n)]
    kv = [rng.normal(0.0, 1.0, n) for _ in range(4)]
    w = rng.uniform(0.5, 2.0, n)
    top = consts.spectrum.L_E_0 + consts.spectrum.D_L_E * consts.N_E_BINS
    e = np.exp(rng.uniform(consts.spectrum.L_E_0 - 2.0, top + 2.0, n))
    e[rng.random(n) < 0.01] = 1e-35
    poison = rng.random(n) < 0.01
    for lane in np.flatnonzero(poison):
        (x + kv + [w])[rng.integers(0, 9)][lane] = np.nan
    e[pending & (rng.random(n) < 0.01)] = np.nan
    unocc = np.flatnonzero(~occupied)
    if unocc.size:
        w[unocc[0]] = np.nan
        pending[unocc[0]] = True
    tsc = rng.exponential(0.5, n)
    alive, at_event, ev_pending = (rng.random(n) < q for q in (0.5, 0.1, 0.1))
    if nan_tau:  # on the first lane that records
        tsc[np.flatnonzero(pending & ~ev_pending & ~poison & np.isfinite(e)
                           & np.isfinite(w))[0]] = np.nan
    pool = engine.empty_pool(n, dtype, device, trace_birth)._replace(
        x=tuple(t(v) for v in x), k=tuple(t(v) for v in kv), w=t(w), e=t(e),
        x1i=t(rng.uniform(0.5, 3.0, n)), x2i=t(rng.uniform(0.0, 1.0, n)),
        tau_abs=t(rng.exponential(0.5, n)), tau_scatt=t(tsc),
        n_e_0=t(rng.uniform(0.1, 2.0, n)), theta_e_0=t(rng.uniform(0.1, 2.0, n)),
        b_0=t(rng.uniform(0.1, 2.0, n)), e_0=t(rng.uniform(0.1, 2.0, n)),
        n_scatt=t(rng.integers(0, 5, n), torch.int32),
        nsc0=t(rng.integers(0, 5, n) * (rng.random(n) < 0.5), torch.int32),
        n_step=t(rng.integers(0, RECORD_STALL + RECORD_STALL // 5, n), torch.int32),
        occupied=t(occupied, torch.bool), alive=t(alive, torch.bool),
        record_pending=t(pending, torch.bool), at_event=t(at_event, torch.bool),
        ev_pending=t(ev_pending, torch.bool))
    if trace_birth:
        pool = pool._replace(bx=tuple(t(rng.uniform(-2.0, 2.0, n)) for _ in range(4)),
                             bk=tuple(t(rng.uniform(-2.0, 2.0, n)) for _ in range(4)),
                             bw=t(rng.uniform(0.5, 2.0, n)))
    finite = tsc[pending & np.isfinite(tsc)]
    counters = engine.init_counters(
        float(np.quantile(finite, 0.99)) if finite.size else 1.0, dtype, device)
    counters = counters._replace(
        n_recorded=t(int(rng.integers(0, 1000)), torch.int64),
        n_scatt_rec=t(int(rng.integers(0, 1000)), torch.int64),
        n_retired=t(int(rng.integers(0, 1000)), torch.int64),
        n_steps_retired=t(int(rng.integers(0, 10**6)), torch.int64),
        n_stall=t(3, torch.int64), w_stall=t(0.5), mt_bx=t(rng.uniform(-1.0, 1.0, 4)),
        mt_bk=t(rng.uniform(-1.0, 1.0, 4)), mt_bw=t(0.25), mt_nsc0=t(7, torch.int64))
    spec = t(rng.uniform(0.0, 1.0, (engine.N_BINS + 1, engine.N_SPEC_CHAN)))
    # the EMA's average and its marks some scatters and records back
    counters = counters._replace(
        avg_ema=t(rng.uniform(0.5, 3.0)),
        ema_scatt_mark=counters.n_scatt_rec - int(rng.integers(0, 200)),
        ema_rec_mark=counters.n_recorded - int(rng.integers(0, 100)))
    cfg = engine.EngineConfig(n_pool=n, dtype=dtype, reference=reference,
                              stall_steps=RECORD_STALL, trace_birth=trace_birth)
    return pool, spec, counters, cfg


def clone_record(pool, spec, counters):
    """Copies of a record's inputs, for a kernel that updates them in place."""
    return (engine.clone_pool(pool), spec.clone(),
            engine.Counters(*(c.clone() for c in counters)))


def record_bias(dtype, device):
    """Bias terms for :func:`record_phase` to write: 0-d tensors of
    ``dtype`` at NaN, so that a term left unwritten shows."""
    return engine.BiasTerms(*(torch.full((), math.nan, dtype=dtype, device=device)
                              for _ in engine.BiasTerms._fields))


def record_plain(pool, spec, counters, width, mc, cfg, fold=False, **mode):
    """The plain version of :func:`record_phase` with its bias terms:
    ((pool, spec, counters), ``engine.BiasTerms``), the counters folded
    under ``fold``."""
    p, s, c = engine.record_phase_plain(pool, spec, counters, width, mc, cfg, **mode)
    c, terms = engine.bias_terms_plain(c, mc.bias_norm, pool.w.dtype, cfg.reference, fold=fold)
    return (p, s, c), terms


def sum_slack(before, after, count):
    """The tolerance of a sum of ``count`` nonnegative terms added into
    ``before`` in another order, elementwise: (count + 1) eps |after|, the
    first-order bound of any order's rounding."""
    eps = torch.finfo(after.dtype).eps
    return (count + 1.0) * eps * torch.abs(after) + torch.finfo(after.dtype).tiny


def compare_record(pool, spec, counters, ref, got, terms=None):
    """Hold a record's outputs ``got`` = (pool, spec, counters) against the
    plain version's ``ref`` on its inputs (``pool``, ``spec``,
    ``counters``): every pool field (the flags, and the rest untouched),
    every counter but w_stall (the chosen lanes' counts, the ratchet, the
    trace's capture, the EMA fold) bit for bit; the spectrum and w_stall,
    sums of nonnegative terms that the kernel adds in another order
    (atomics), within :func:`sum_slack` of their adds (a bin's count of
    adds is its channel 2, a recorded lane's 1.0); ``terms`` = (the plain
    ``engine.BiasTerms``, the written ones), each bit for bit.  Returns
    (record, failures)."""
    fails = []
    for f, a, b in zip(engine.BiasTerms._fields, *(terms or ((), ()))):
        if a.dtype != b.dtype or not bool(_same_bits(a, b).all()):
            fails.append(f"{f}: {b.tolist()} against {a.tolist()}")
    ref_f, got_f = (_flat(p._asdict()) for p in (ref[0], got[0]))
    for f, a in ref_f.items():
        differ = ~_same_bits(a, got_f[f])
        if bool(differ.any()):
            fails.append(f"{f}: {int(differ.sum())} lanes not bit for bit")
    for f in engine.Counters._fields:
        a, b = getattr(ref[2], f), getattr(got[2], f)
        if f == "w_stall":
            adds = (ref[2].n_stall - counters.n_stall).to(a.dtype)
            if bool(torch.abs(a - b) > sum_slack(counters.w_stall, a, adds)):
                fails.append(f"w_stall {float(b)} against {float(a)}")
        elif not bool(_same_bits(a, b).all()):
            fails.append(f"{f}: {b.tolist()} against {a.tolist()}")
    adds = (ref[1][:, 2:3] - spec[:, 2:3]).round()
    err = torch.abs(ref[1] - got[1])
    over = err > sum_slack(spec, ref[1], adds)
    if bool(over.any()):
        fails.append(f"spec: {int(over.sum())} entries beyond their sums' slack")
    rel = err / torch.clamp(torch.abs(ref[1]), min=torch.finfo(ref[1].dtype).tiny)
    rec = {"lanes": pool.w.shape[0],
           "pending": int(pool.record_pending.sum()),
           "recorded": int(ref[2].n_recorded - counters.n_recorded),
           "freed": int(ref[2].n_retired - counters.n_retired),
           "stalled": int(ref[2].n_stall - counters.n_stall),
           "captured": not bool(torch.equal(ref[2].mt_bx, counters.mt_bx)),
           "ratchet_moved": not bool(_same_bits(ref[2].max_tau_scatt,
                                                counters.max_tau_scatt).all()),
           "max_abs_err": float(err.max()), "max_rel_err": float(rel.max()),
           "max_adds": int(adds.max()), "spec_bitwise": bool(torch.equal(ref[1], got[1]))}
    return rec, fails


# The record is held by compare_record (the kernels line's compare finds
# nothing to hold).
KERNEL_TOLERANCE.update({name: dict(rtol=0.0, atol=0.0, mask_frac=0.0)
                         for name in RECORD_PHASES})


def synthetic_refill(mc, n, k, seed, dtype, device, reference=False, trace_birth=True):
    """(pool, slots, counters, bias_den, cfg) of one refill in the slots
    mode: :func:`synthetic_fresh`'s pool, rows and bias, its slots' lanes
    (valid where not padded), its ring's count, backlog position and valid
    rows (the values from which its sources come:
    ``engine.refill_sources_plain`` on these slots gives its ``load``)."""
    pool, load, den, cfg = synthetic_fresh(mc, n, k, seed, dtype, device, reference,
                                           trace_birth)
    m = min(n, k - max(1, k // 16))
    n_sec, pos = k // 4, k // 8
    n_valid = pos + max(0, m - n_sec - max(1, k // 10))

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=device)

    slots = engine.RefillSlots(
        load.sidx < n, load.sidx, engine.SecBuf(load.sec_rows, i64(n_sec)), load.backlog_rows,
        i64(pos), i64(n_valid))
    counters = engine.init_counters(mc.max_tau_scatt0, dtype, device)._replace(
        n_created=i64(11))
    return pool, slots, counters, den, cfg


def synthetic_event_fluid(eng, n, seed):
    """The event fluid's inputs (rows, x1, x2, k, w, tries, bias_den) on
    ``n`` lanes of :func:`synthetic_events` through the engine ``eng`` (its
    dtype, device and corner table; the rows by plain indexing), weights
    that reach both ends of the bias clamp, the initial bias_norm *
    max_tau * 2."""
    ev = synthetic_events(eng, n, seed)
    mc, dt, dev = eng.mc, eng.dt, eng.device
    rows = eng.tables.corner_rows[fluid.cell_index_c(ev.x[1], ev.x[2], mc)]
    rng = np.random.default_rng([seed, 4])
    w = torch.as_tensor(engine.WEIGHT_MIN * 10.0 ** rng.uniform(-1.0, 6.0, n), dtype=dt,
                        device=dev)
    den = torch.tensor(mc.bias_norm * mc.max_tau_scatt0 * 2.0, dtype=dt, device=dev)
    return rows, ev.x[1], ev.x[2], ev.k, w, ev.tries, den


def event_fluid_outputs(ev):
    """{name: (N,) tensor} of an ``engine.EventFluid``."""
    return _flat({"g7": ev.g7, **ev.fl._asdict(), "theta_s": ev.theta_s, "a_sc": ev.a_sc,
                  "a_ab": ev.a_ab, "bias": ev.bias})


# ---------------------------------------------------------------------------
# the event phase's and the compaction's checks: synthetic pools and the
# comparison
# ---------------------------------------------------------------------------

# The event phase is held to its plain version on PhiloxDraws under the same
# key: every field of the pool, the staged rows where a slot makes one, the
# flags and the counters bit for bit, but the refreshed opacities and bias,
# which run the event fluid's hotcross order and are held to its tolerance;
# the ring after the pack bit for bit.  The compaction is exact.
KERNEL_TOLERANCE.update({
    "event_phase": KERNEL_TOLERANCE["event_fluid"],
    "event_phase_f64": KERNEL_TOLERANCE["event_fluid_f64"],
    "compact": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
    "compact_rows": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
    "compact_rows_f64": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
    "exit_test": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
})
# the pool's fields held within the tolerance (every other field bit for bit)
EVENT_PHASE_TOL = ("alpha_scatti", "alpha_absi", "bi")
# The (pool lanes, compacted width) of the event phase: the path's ev_k at
# the pool of 65,536 and at the cascade's 4,096 and 512 (both profiles'
# min(pool, 16,384), transport/profiles.py), first the one the kernels line
# records; then the engine's default width n // 8 at 65,536 and the narrow
# sets (the gate's pool of 1,024 runs 256, as the 512-lane one does).
EVENT_PHASE_WIDTHS = ((65536, 16384), (4096, 4096), (512, 512), (65536, 8192), (4096, 512),
                      (512, 256))
# The rings a synthetic event phase runs against: room for every event;
# room for half the compacted set (the rest wait); full with no lane free
# (every event runs, its secondary drops).
EVENT_RINGS = ("open", "room", "wedged")


def synthetic_event_pool(eng, n, k, seed, ring="room", events=None):
    """(pool, sec, counters, bias_den) of one event phase on ``n`` lanes
    and a compacted width ``k``, from ``seed``, through the engine ``eng``
    (its dtype, device and tables; :func:`synthetic_events`): lanes parked
    at their event, lanes whose shadow registers hold one (the registers'
    position and wave vector another synthetic set's), lanes with both and
    lanes with none; defer counts at a plain draw, at a halved theta_e and
    at a forced one; wave vectors 1,000 times harder on two lanes in five,
    whose electron loop often ends at its cap (the event waits a phase);
    doomed parents, lanes outside the plasma, weights that
    reach both ends of the bias clamp; fields that the phase only keeps
    drawn apart, so that a write into a wrong lane shows.  ``ring`` (one of
    ``EVENT_RINGS``): "open" leaves the ring room for every event, "room"
    for half of ``k`` (the rest wait), "wedged" fills it and every lane (all
    run, their secondaries drop); ``events`` (with "room" only) sets the
    ring's room, and so the events that run, in place of half of ``k``.
    The counters start at small nonzero values."""
    if ring not in EVENT_RINGS:
        raise ValueError(f"synthetic_event_pool: ring {ring!r} not in {EVENT_RINGS}")
    if events is not None and not (ring == "room" and 0 <= events <= 2 * k):
        raise ValueError(f"synthetic_event_pool: events {events!r} needs the room ring and "
                         f"0 <= events <= {2 * k}")
    mc, dt, dev = eng.mc, eng.dt, eng.device
    a, b = synthetic_events(eng, n, seed), synthetic_events(eng, n, seed + 1)
    rng = np.random.default_rng([seed, 6])
    u = rng.random((3, n))

    def t(v, d=dt):
        return torch.as_tensor(v, device=dev).to(d)

    def col(lo, hi):
        return t(rng.uniform(lo, hi, n))

    def weights():
        return t(engine.WEIGHT_MIN * 10.0 ** rng.uniform(-1.0, 6.0, n))

    at_event, pending = u[0] < 0.45, (u[0] >= 0.3) & (u[0] < 0.65)
    occupied = np.ones(n, bool) if ring == "wedged" else (u[1] < 0.9) | at_event | pending
    # hard photons: their electron loop often ends at its cap and the event waits
    boost = t(np.where(rng.random(n) < 0.4, 1000.0, 1.0))
    pool = engine.empty_pool(n, dt, dev)._replace(
        x=(col(0.0, 100.0), a.x[1], a.x[2], col(0.0, 2.0 * np.pi)),
        k=tuple(c * boost for c in a.k),
        ev_x=(col(0.0, 100.0), b.x[1], b.x[2], col(0.0, 2.0 * np.pi)),
        ev_k=tuple(c * boost for c in b.k),
        w=weights(), sec_w=weights(), ev_w=weights(), n_e_0=col(1.0, 2.0),
        theta_e_0=col(1.0, 5.0), e_0=col(1.0, 2.0), alpha_scatti=col(0.5, 1.0),
        alpha_absi=col(0.5, 1.0), bi=col(1.0, 2.0),
        n_scatt=t(rng.integers(0, 6, n), torch.int32), ev_tries=a.tries.clone(),
        at_event=t(at_event, torch.bool), ev_pending=t(pending, torch.bool),
        occupied=t(occupied, torch.bool), alive=t(occupied & (u[2] < 0.95), torch.bool))
    cap = 2 * k
    room = k // 2 if events is None else events
    count = {"open": 3, "room": cap - room, "wedged": cap}[ring]
    sec = engine.SecBuf(rows=t(rng.uniform(-1.0, 1.0, (cap, engine.ROW_WIDTH))),
                        count=torch.tensor(count, dtype=torch.int64, device=dev))
    start = dict(n_ev_soft=5, n_ev_forced=2, n_sec_drop=1)
    counters = engine.init_counters(1.0, dt, dev)._replace(**{
        c: torch.tensor(v, dtype=torch.int64, device=dev) for c, v in start.items()})
    den = torch.tensor(mc.bias_norm * mc.max_tau_scatt0 * 2.0, dtype=dt, device=dev)
    return pool, sec, counters, den



def synthetic_rows(k, made, room, dtype, device, seed):
    """(stage, sec, counters) of one ring's pack (:func:`compact_rows`):
    ``k`` staged rows of ``dtype``, ``made`` of them flagged at seeded
    slots (``made`` a count or a list of slots), a ring of 2 ``k`` + 8 rows
    with room for ``room`` (its count the capacity less ``room``),
    n_sec_drop 3."""
    rng = np.random.default_rng([seed, k, room])
    make = np.zeros(k, bool)
    if isinstance(made, int):
        make[rng.permutation(k)[:made]] = True
    else:
        make[made] = True
    cap = 2 * k + 8

    def rows(m):
        return torch.as_tensor(rng.uniform(-1.0, 1.0, (m, engine.ROW_WIDTH)),
                               device=device).to(dtype)

    stage = engine.EventStage(rows(k), torch.as_tensor(make, device=device))
    sec = engine.SecBuf(rows(cap), torch.tensor(cap - room, dtype=torch.int64, device=device))
    counters = engine.init_counters(1.0, dtype, device)._replace(
        n_sec_drop=torch.tensor(3, dtype=torch.int64, device=device))
    return stage, sec, counters

def compare_event_phase(name, ref, got):
    """Hold the event phase ``got`` against the plain version's ``ref``,
    each (pool, counters, stage, sec) after the phase and the ring's pack:
    every pool field, the flags, the staged rows of the slots that make one,
    the counters and the ring (rows and count) bit for bit, but
    ``EVENT_PHASE_TOL``, held within ``KERNEL_TOLERANCE[name]``.  Returns
    (record, failures)."""
    (rp, rc, rs, rsec), (gp, gc, gs, gsec) = ref, got
    ref_f, got_f = _flat(rp._asdict()), _flat(gp._asdict())
    fails = []
    for f, a in ref_f.items():
        if f in EVENT_PHASE_TOL:
            continue
        differ = ~_same_bits(a, got_f[f].to(a.device))
        if bool(differ.any()):
            fails.append(f"pool.{f}: {int(differ.sum())} lanes not bit for bit")
    make = rs.make
    if not torch.equal(make, gs.make.to(make.device)):
        fails.append(f"make: {int((make != gs.make).sum())} slots differ")
    rows_same = bool(_same_bits(rs.rows[make], gs.rows.to(make.device)[make]).all())
    if not rows_same:
        fails.append("staged rows: not bit for bit")
    for c in engine.Counters._fields:
        if not torch.equal(getattr(rc, c), getattr(gc, c).to(getattr(rc, c).device)):
            fails.append(f"counters.{c}: {getattr(gc, c).tolist()} against "
                         f"{getattr(rc, c).tolist()}")
    if not (torch.equal(rsec.count, gsec.count)
            and bool(_same_bits(rsec.rows, gsec.rows.to(rsec.rows.device)).all())):
        fails.append(f"ring: count {int(gsec.count)} against {int(rsec.count)}, or its rows")
    sel = {f: ref_f[f] for f in EVENT_PHASE_TOL}
    err, rel, _, tfails = compare(sel, {f: got_f[f] for f in sel}, **KERNEL_TOLERANCE[name])
    rec = {"max_abs_err": err, "max_rel_err": rel, "mask_mismatch": 0.0 if not fails else None,
           "slots": int(make.shape[0]), "made": int(make.sum()),
           "bitwise_tol_fields": sorted(f for f in EVENT_PHASE_TOL
                                        if bool(_same_bits(ref_f[f], got_f[f]).all()))}
    return rec, fails + tfails
