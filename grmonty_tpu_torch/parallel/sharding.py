"""Data-parallel photon transport over several devices (``torch.distributed``).

Port of ``grmonty_tpu/parallel/sharding.py``.  :class:`ShardedSimulation`
splits the photon plan over the ``world_size`` ranks of the default process
group (NCCL on the card, rank r on ``cuda:r``; gloo on the CPU): every rank
runs the port's own single-device schedule (``Simulation.run``: the waves
with the first-wave ramp and the tail cascade) on its share, since photons
are independent.  The only collectives are

* one broadcast of the pilot's warm counters: rank 0 tracks the pilot on
  the host and every rank injects its bias feedback state; the end debits
  ``world_size`` times the warm counts (sharding.py:285-298, :409-414);
* the final reduce: the spectrum summed; every counter summed, except
  ``max_tau_scatt`` and ``avg_ema``, which take the max (sharding.py:
  144-177); the device window and the wall clock the max over ranks.

Design deviation (the JAX package's, kept): the bias feedback counters
(``n_recorded``, ``n_scatt_rec``, ``max_tau_scatt``) stay per rank during
flight instead of being synchronized every iteration.  The reference reads
them racily from device globals while its kernels update them
(super_photon.cu:36-46,1649-1662), so per-rank staleness is the same class
of approximation, and the transport needs no collective, so ranks never
wait on each other.

The plan: every rank draws the same per-zone counts from the run seed (the
first draw of its generator), then each rank but 0 reseeds its generator to
a stream of its own (:func:`rank_seed`).  Rank r takes the contiguous share
``share_bounds(total, world_size, r)`` of the emission order, which the
shipped profile's golden-ratio stride spreads over the whole dump; its
waves split ``ceil(emit_chunk / world_size)``-photon chunks as the
single-device run splits ``emit_chunk``.  At world size 1, rank 0 therefore
repeats ``Simulation.run`` bit for bit.

Checkpoints are per rank (``<path>.rank<r>``), with the world size and the
rank in the run setup: a resume at another world size, or with one rank's
file missing, is refused on every rank before any collective.

:func:`run_ranks` starts the ranks as processes (``torch.multiprocessing``
with ``spawn``, one torch thread each, rendezvous through a ``file://``
init method in a temporary directory, so that concurrent runs never race
for a port), and :func:`run_sharded` drives a whole sharded run that way:
``python -m grmonty_tpu_torch --devices N``.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

from grmonty_tpu_torch.transport import driver as driver_mod
from grmonty_tpu_torch.transport import engine as engine_mod

log = logging.getLogger(__name__)

# Counters that take the max over ranks; the others are summed.
MAX_FIELDS = ("max_tau_scatt", "avg_ema")
FLOAT_SUM_FIELDS = ("w_stall",)
INT_FIELDS = tuple(f for f in engine_mod.Counters._fields
                   if f not in MAX_FIELDS + FLOAT_SUM_FIELDS)


def check_devices(world_size, device_type):
    """Raise ``ValueError`` when a run of ``world_size`` ranks on
    ``device_type`` needs more cards than the machine has."""
    if device_type == "cuda":
        have = torch.cuda.device_count()
        if have < world_size:
            raise ValueError(f"need {world_size} devices, have {have}")


def share_bounds(total, world_size, rank):
    """[lo, hi): rank ``rank``'s contiguous share of ``total`` photons in
    emission order (the shares differ by at most one photon)."""
    return total * rank // world_size, total * (rank + 1) // world_size


def rank_seed(seed, rank):
    """The generator seed of rank ``rank`` after the plan (rank 0 keeps its
    stream)."""
    return seed if rank == 0 else (seed + 0x9E3779B9 * rank) % (1 << 63)


def comm_device():
    """The device of the tensors the process group's collectives take:
    the current CUDA device under NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_counters(counters, int_sums=(), float_maxes=()):
    """All-reduce the engine ``Counters`` over the process group: every
    field summed, except ``max_tau_scatt`` and ``avg_ema`` (max), the
    float ``w_stall`` summed in float64.  ``int_sums`` are summed and
    ``float_maxes`` maxed along.  Returns (the reduced Counters on the
    counters' device and dtypes, the sums, the maxes)."""
    dev = comm_device()
    ints = torch.tensor([int(getattr(counters, f)) for f in INT_FIELDS] + list(int_sums),
                        dtype=torch.int64, device=dev)
    maxes = torch.tensor([float(getattr(counters, f)) for f in MAX_FIELDS] + list(float_maxes),
                         dtype=torch.float64, device=dev)
    sums = torch.tensor([float(getattr(counters, f)) for f in FLOAT_SUM_FIELDS],
                        dtype=torch.float64, device=dev)
    dist.all_reduce(ints, op=dist.ReduceOp.SUM)
    dist.all_reduce(maxes, op=dist.ReduceOp.MAX)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    ints, maxes, sums = ints.tolist(), maxes.tolist(), sums.tolist()
    vals = dict(zip(INT_FIELDS, ints))
    vals.update(zip(MAX_FIELDS, maxes))
    vals.update(zip(FLOAT_SUM_FIELDS, sums))
    out = engine_mod.Counters(**{
        f: torch.tensor(vals[f], dtype=getattr(counters, f).dtype,
                        device=getattr(counters, f).device)
        for f in engine_mod.Counters._fields})
    return out, ints[len(INT_FIELDS):], maxes[len(MAX_FIELDS):]


class ShardedSimulation(driver_mod.Simulation):
    """``Simulation`` over the ranks of the initialized default process
    group: rank r runs its share of the plan on ``cuda:r`` (``device``
    "cuda") or on the CPU, and ``run`` returns the reduced spectrum and
    stats on every rank.  ``emit_chunk`` is the chunk of the whole run,
    split evenly over the ranks; ``config`` sizes each rank's pool."""

    def __init__(self, dump_path, *args, device="cuda", emit_chunk=1 << 20, **kwargs):
        if not dist.is_initialized():
            raise RuntimeError("ShardedSimulation needs an initialized torch.distributed "
                               "process group (see run_ranks)")
        self.rank, self.world_size = dist.get_rank(), dist.get_world_size()
        device = torch.device(device)
        if device.type == "cuda":
            check_devices(self.world_size, "cuda")
            device = torch.device("cuda", self.rank)
            torch.cuda.set_device(device)
        self.emit_chunk_total = emit_chunk
        self.reduce_s = None
        super().__init__(dump_path, *args, device=device,
                         emit_chunk=-(-emit_chunk // self.world_size), **kwargs)

    # -- the plan and the share ---------------------------------------------
    def plan(self):
        """The whole run's plan, the same on every rank; then every rank but
        0 moves its generator to its own stream."""
        plan = super().plan()
        if self.rank:
            self.gen.manual_seed(rank_seed(self.seed, self.rank))
        return plan

    def _waves(self, total):
        lo, hi = share_bounds(total, self.world_size, self.rank)
        return [(lo + s, n, te) for s, n, te in super()._waves(hi - lo)]

    # -- the pilot ------------------------------------------------------------
    def _run_pilot(self, state, warm):
        """Rank 0 runs the pilot; its bias feedback state is broadcast and
        injected on every other rank, whose debit is the same."""
        vals = torch.zeros(4, dtype=torch.float64, device=comm_device())
        if self.rank == 0:
            state = super()._run_pilot(state, warm)
            p = self.pilot
            vals = torch.tensor([p["n_recorded"], p["n_scatt_rec"], p["max_tau_scatt"],
                                 p["avg"]], dtype=torch.float64, device=vals.device)
        dist.broadcast(vals, src=0)
        if self.rank:
            n_rec, n_scatt, max_tau, avg = vals.tolist()
            n_rec, n_scatt = int(round(n_rec)), int(round(n_scatt))
            state = state._replace(counters=driver_mod.warm_counters(
                state.counters, n_rec, n_scatt, max_tau, avg))
            self._warm_counts = (n_rec, n_scatt)
        return state

    # -- checkpoints ----------------------------------------------------------
    SETUP_FIELDS = driver_mod.Simulation.SETUP_FIELDS + ("world_size", "rank")

    def _setup(self):
        return super()._setup() + (self.world_size, self.rank)

    def _rank_path(self, path, rank=None):
        return f"{path}.rank{self.rank if rank is None else rank}"

    def _check_resume(self, path):
        """Refuse, on every rank alike, a resume whose per-rank files are
        of another world size or incomplete."""
        files = sorted(glob.glob(glob.escape(path) + ".rank*"))
        if not files:
            return
        worlds = {self.checkpoint_setup(f)[-2] for f in files}
        if worlds != {self.world_size}:
            raise ValueError(f"checkpoint {path} was written by a run of world size "
                             f"{sorted(worlds)}; this run has {self.world_size}: resume "
                             "at the same world size")
        want = {self._rank_path(path, r) for r in range(self.world_size)}
        if set(files) != want:
            raise ValueError(f"checkpoint {path}: rank files {sorted(want - set(files))} "
                             "are missing")

    # -- the run --------------------------------------------------------------
    def run(self, checkpoint_path=None, checkpoint_every=1):
        """This rank's share through ``Simulation.run``, then the reduce;
        returns (the whole run's spectrum, its stats) on every rank."""
        if checkpoint_path:
            self._check_resume(checkpoint_path)
        _, stats = super().run(checkpoint_path=(self._rank_path(checkpoint_path)
                                                if checkpoint_path else None),
                               checkpoint_every=checkpoint_every)
        t_r = time.monotonic()
        dev = comm_device()
        spec = torch.as_tensor(self.spec_acc, dtype=torch.float64, device=dev)
        dist.all_reduce(spec, op=dist.ReduceOp.SUM)
        debit = self._warm_counts or (0, 0)
        c, sums, maxes = reduce_counters(
            self.state.counters,
            int_sums=(*debit, stats["full_phases"], stats["light_phases"], stats["waves"]),
            float_maxes=(stats["elapsed_s"], stats["device_s"] or 0.0))
        self.spec_acc = spec.cpu().numpy()
        self.reduce_s = time.monotonic() - t_r
        elapsed, device_s = maxes
        stats.update(self._counter_stats(c, sums[:2]))
        stats.update(full_phases=sums[2], light_phases=sums[3], waves=sums[4],
                     elapsed_s=elapsed, photon_rate=stats["n_created"] / max(elapsed, 1e-9),
                     device_s=device_s if self.device_s is not None else None,
                     photon_rate_device=(stats["n_created"] / device_s
                                         if self.device_s else None),
                     n_devices=self.world_size, reduce_s=self.reduce_s)
        stats.pop("util_waves", None)  # this rank's alone
        self.spec = driver_mod.unscale_spectrum(self.spec_acc, engine_mod.WEIGHT_SCALE)
        log.info("rank %d/%d: reduce %.3g s", self.rank, self.world_size, self.reduce_s)
        return self.spec, stats


# ---------------------------------------------------------------------------
# starting the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world_size, backend, init_method, out_path, fn, per_rank_args,
               verbosity):
    """One rank: one torch thread, join the group, ``fn(*per_rank_args[rank])``;
    rank 0 pickles the result to ``out_path``."""
    torch.set_num_threads(1)
    if verbosity:
        from grmonty_tpu_torch.utils.logging import setup

        setup(verbosity)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    try:
        result = fn(*per_rank_args[rank])
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, per_rank_args, device_type="cuda", verbosity=None):
    """``fn(*per_rank_args[r])`` on ranks r = 0 .. len(per_rank_args) - 1,
    each a spawned process in one process group (NCCL for ``device_type``
    "cuda", gloo for "cpu"); returns rank 0's result.  ``fn`` must be a
    module-level function of this package.  A rank's exception ends the
    others and is raised here as ``torch.multiprocessing``'s
    ``ProcessRaisedException``."""
    import torch.multiprocessing as mp

    world_size = len(per_rank_args)
    check_devices(world_size, device_type)
    backend = "nccl" if device_type == "cuda" else "gloo"
    tmp = tempfile.mkdtemp(prefix="grmonty_ranks_")
    try:
        out_path = os.path.join(tmp, "result.pkl")
        mp.spawn(_rank_main, nprocs=world_size, join=True,
                 args=(world_size, backend, f"file://{os.path.join(tmp, 'rendezvous')}",
                       out_path, fn, per_rank_args, verbosity))
        with open(out_path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class Interrupted(RuntimeError):
    """The run stopped on purpose after a wave (``fail_after_waves``)."""


def _sharded_job(dump_path, sim_kwargs, device_type, checkpoint_path, spectrum_path,
                 fail_after_waves):
    """One rank of :func:`run_sharded`."""
    sim = ShardedSimulation(dump_path, device=device_type, **sim_kwargs)
    if fail_after_waves is not None:
        orig, done = sim._run_wave, []

        def run_wave(*a, **kw):
            if len(done) == fail_after_waves:
                raise Interrupted(f"stopped after {fail_after_waves} waves")
            done.append(1)
            return orig(*a, **kw)

        sim._run_wave = run_wave
    spec, stats = sim.run(checkpoint_path=checkpoint_path)
    if sim.rank == 0 and spectrum_path:
        sim.report(spectrum_path, spec)
    return spec, stats


def run_sharded(dump_path, world_size, device_type="cuda", checkpoint_path=None,
                spectrum_path=None, verbosity=None, fail_after_waves=None, **sim_kwargs):
    """A whole :class:`ShardedSimulation` run on ``world_size`` spawned
    ranks (``sim_kwargs`` as ``Simulation`` takes them); rank 0 writes the
    spectrum to ``spectrum_path``.  Returns (spectrum, stats).
    ``fail_after_waves`` stops every rank with :class:`Interrupted` when it
    starts the wave after that many, leaving the checkpoint behind (the
    resume tests' interruption)."""
    job = (dump_path, sim_kwargs, device_type, checkpoint_path, spectrum_path,
           fail_after_waves)
    return run_ranks(_sharded_job, [job] * world_size, device_type, verbosity)
