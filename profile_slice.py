#!/usr/bin/env python3
"""Where the port's time goes in the smoke cell, on one CUDA card.

    python3 profile_slice.py            # graph clocks, then phase clocks
    python3 profile_slice.py --trace    # the census, then trace windows
    python3 profile_slice.py --reference [--trace]   # reference semantics
    python3 profile_slice.py [--reference] --graph-only   # graph clocks alone
    python3 profile_slice.py [--reference] --graph-only --graph-bodies 2   # 2 blocks a replay
    python3 profile_slice.py [--reference] --whole-trace  # the whole run's idle share

Runs a cell of ``chip_smoke.py`` (256x256 torus, M = 4e19, seed 123,
float32, pool 65,536: the shipped profile at 1e5 photons, or with
``--reference`` reference semantics at 5e4 photons and ``chip_smoke.py``'s
step cap) through the driver's whole schedule (the host pilot, the waves,
the tail cascade), and measures one of two things.  Run them in separate
processes: once ``torch.profiler`` has traced a window, every later kernel
launch of the process costs more, so a traced run's clocks and device
window are not the run's.

1. **Graph clocks, then phase clocks, over the whole run** (default).  The
   run as it ships, every engine's blocks replayed from its CUDA graph:
   each replay bracketed by two CUDA events on the current stream (the
   stream's time for the replay, ``replay_ms``; the stream's idle time from
   one replay's end to the next one's start in the same run, ``gap_ms``
   and its 99th percentile ``gap_p99_ms``, their sum over the window
   ``gap_share``: the exit word's copy, the host's turn and the launch, or
   before the device loop the exit check's read), the exit check's host
   seconds (``exit_check_ms``: the wait for a replay's exit word, or
   before the device loop the block's read), the warm-ups' and captures'
   seconds (``capture_s``); the same by engine (``engines``: its runs,
   bodies, replays, skipped replays, blocks a replay, capture seconds and
   graph pool bytes: the allocator's segments of the graph's pools).
   ``--graph-bodies K`` runs K blocks a replay.  Then the same cell in
   a second ``Simulation`` with ``graphed=False`` (the block issued op by
   op, as before the graph), whose phases are clocked: every call of the
   engine's phases (``hot_run``, a block's run of hot steps, one launch;
   ``hot_step`` before the run; ``periodic_phase``, ``light_phase`` and, inside them,
   ``process_scatters`` and ``refill_slots``) and of the kernels' wrappers
   inside them (``hot_kernels.event_phase`` and ``compact_rows`` inside
   ``process_scatters``, ``compact`` inside it and ``refill_slots``,
   ``record_phase`` (the sweep, the record and the frees) and
   ``refill_fresh`` (refill's sources, the load and the track start) inside
   the full and light phases) is bracketed by two CUDA events on the
   current stream.
   Nothing is synchronised, so the run is not stretched; the stream time
   between a phase's two events is the time the stream spent on that
   phase's work, waiting for its launches included, so the phases split
   the engine's device window (nested phases are also counted inside their
   parents).  Beside both: the
   pilot's host seconds (it runs before the first wave, on the host
   tracker, outside the device window), and the window of the waves and of
   each cascade stage (width, hot iterations, CUDA-event seconds, ms per
   hot iteration).  ``--graph-only`` stops after the graph clocks (the
   turns of two versions in one call, where the eager run's minutes buy
   nothing: a copy of this script placed in another commit's checkout runs
   that commit's cell the same way).
2. **The census, then the device busy share in trace windows**
   (``--trace``).  The census is the cell's eager run (``graphed=False``,
   before the profiler starts) with each launch of ``compact``, of the
   event phase (``event_phase``, ``event_phase_f64``), of the record
   (``record_phase``, ``_f64``: a call, its one kernel) and of the
   track start (``fresh_init`` ...) timed alone: a GPU
   sleep, a CUDA event, the launch, a CUDA event, so that the first event
   is stamped when the launch is already queued (the pair's own floor,
   sleep and two events with no launch, is measured and reported as
   ``event_pair_us``).  Each launch is kept with its engine (the wave
   engine, or the cascade stage by its pool), its role (the event set; the
   sweep or the record, by the record's mode; the refill: its compaction
   and its track start), its pool width n, its compacted width k and its
   count, computed on the card and read after the run: the mask's set
   lanes for ``compact`` (clear lanes, inverted), for the event phase the
   events that ran (valid and within the ring's room, or all valid where
   the ring is wedged), for the record the pending lanes before it, for
   the track start its valid slots.
   Summaries by (engine, role, n, k) and a histogram of the events per
   full phase by engine go into the JSON, with the hot step's launches
   counted by engine, entry point, width and steps a launch (``hot_steps``,
   not timed);
   each timed launch's line into
   ``chiprun_out/census_<path>.json``.  Then the trace windows, on the
   graphed run.  ``torch.profiler`` traces the replays of 64 hot iterations twice:
   in the waves from hot iteration 64 on (full pool; the ramp's first
   waves), and in the first stage of the tail cascade from its 64th
   iteration, then in the 512-lane stage (``narrow``, unless that stage is
   the first) over ``NARROW_ITERS`` = 512 hot iterations from its 64th, for
   eight of its full phases.  The busy time is the union of the device activity
   intervals (kernels, copies, sets) in the window; the window is timed by
   CUDA events with the profiler on.  The share holds for those iterations
   only, not for the run.  One more window holds a single replay of the
   first wave (``one_body``): the names of its device activities, its
   hot-step launches and its copies (``copies``: the activities named as a
   copy, the block's closing copies among them) counted.

3. **The whole run's idle share** (``--whole-trace``): the graphed run
   under ``torch.profiler`` from its start to its end, the device's busy
   time (the union of its activity intervals) within each engine run over
   those runs' time, the profiler's own cost included.

Prints the card's name and power limit and one JSON object; with
``--trace`` the profiler's table of the device's kernels goes to
``chiprun_out/profile_kernels.txt``.
"""

import argparse
import json
import logging
import os
import sys
import time

import chip_smoke

# the engine's phases clocked (a checkout from before the run has no
# hot_run, and a run on the card no hot_step: a name the engine lacks is
# skipped)
PHASES = ("hot_step", "hot_run", "periodic_phase", "light_phase", "process_scatters",
          "refill_slots")
# the kernels' wrappers clocked as phases (hot_kernels functions, each nested
# in one of PHASES: event_phase and compact_rows in process_scatters, compact
# in it and in refill_slots, record_phase and refill_fresh in the full and
# light phases)
WRAPPERS = ("event_phase", "compact_rows", "compact", "record_phase", "refill_fresh")
PHOTON_N = 100_000
REF_PHOTON_N = 50_000
# device kernels whose time the trace windows report, by names (the mask
# compaction's kernel is compact_tiles_kernel, compact_kernel before; the
# record's one kernel record_phase_kernel, after record_count_kernel before)
# (the hot step's launches: since the run, one a run of a block's hot steps,
# ``hot_run_us`` each run's device time; before it, one a step)
TRACED = {"hot_run_ms": ("hot_step_kernel",), "event_phase_ms": ("event_phase_kernel",),
          "compact_ms": ("compact_kernel", "compact_tiles_kernel"),
          "compact_rows_ms": ("compact_rows_kernel",), "fresh_init_ms": ("fresh_init_kernel",),
          "record_phase_ms": ("record_count_kernel", "record_phase_kernel")}
# the launches the census times one by one, and the GPU sleep queued before
# each (~66 us at 1.98 GHz: longer than the host takes to queue the launch)
CENSUS = ("compact", "event_phase", "event_phase_f64", "record_phase", "record_phase_f64",
          "fresh_init", "fresh_init_ref", "fresh_init_f64", "fresh_init_ref_f64")
CENSUS_SLEEP = 1 << 17
# the census's histogram of events per full phase: the bins' lower edges
EVENT_BINS = (0, 128, 512, 1024, 2048, 4096, 6144, 8192, 12288, 16384)
WAVE_AT = 64  # trace the first wave from this hot iteration
TRACE_ITERS = 64  # hot iterations per trace window
# the 512-lane stage's window ("narrow"): long enough for eight of its full
# phases (a full phase every 64 hot iterations in both profiles)
NARROW_POOL = 512
NARROW_ITERS = 512
ONE_BODY_AT = WAVE_AT + TRACE_ITERS  # trace the replay from this hot iteration alone


def clock_phases(engine_cls, clocks):
    """Bracket each phase method of ``engine_cls`` (PHASES) and each wrapper
    of ``hot_kernels`` (WRAPPERS) with CUDA events; ``clocks`` has a list
    for each name.  Returns {name: what it replaced}, for
    :func:`restore_phases`."""
    import torch

    from grmonty_tpu_torch.transport import hot_kernels

    saved = {}
    for owner, names in ((engine_cls, PHASES), (hot_kernels, WRAPPERS)):
        for name in names:
            if not hasattr(owner, name):
                continue
            fn = saved[name] = getattr(owner, name)

            def timed(*a, _fn=fn, _name=name, **kw):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _fn(*a, **kw)
                e1.record()
                clocks[_name].append((e0, e1))
                return out

            setattr(owner, name, timed)
    return saved


def restore_phases(engine_cls, saved):
    """Undo :func:`clock_phases`."""
    from grmonty_tpu_torch.transport import hot_kernels

    for name, fn in saved.items():
        setattr(engine_cls if name in PHASES else hot_kernels, name, fn)


def busy_ms(prof):
    """Union of the device activity intervals of a finished trace, ms."""
    import torch

    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    busy, end = 0, None
    for s, t in spans:
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    return busy / 1e6, len(spans)


class Windows:
    """Starts and stops ``torch.profiler`` around the replays of an engine's
    hot iterations: ``name`` is "wave" for the wave engine's, "drain" for
    the cascade's, ``it`` the engine's hot iterations before (or after) the
    replay."""

    def __init__(self, iters, narrow_iters=NARROW_ITERS):
        self.iters, self.results = iters, {}
        self.narrow_iters = narrow_iters
        self.live, self.table = None, ""

    def before(self, name, it):
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.live is None and it >= WAVE_AT and name not in self.results:
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            self.live = (name, it, prof, e0)

    def after(self, it):
        import torch

        if self.live is None or it < self.live[1] + (
                self.narrow_iters if self.live[0] == "narrow" else self.iters):
            return
        name, it0, prof, e0 = self.live
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        e1.synchronize()
        prof.stop()
        window = e0.elapsed_time(e1)
        busy, n_dev = busy_ms(prof)
        self.results[name] = {
            "iters": it - it0, "window_ms": window, "busy_ms": busy,
            "busy_share": busy / window, "device_activities": n_dev}
        dev = sorted((e.start_ns(), e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA)
        for key, kernels in TRACED.items():
            us = [d / 1e3 for _, d, n in dev if any(kernel in n for kernel in kernels)]
            self.results[name][key] = sum(us) / 1e3
            # each launch's device time in the window, in order (a body's
            # compactions run in its phases' order: the event set, the
            # record, the refill, then each light phase's record and refill)
            self.results[name][key[:-3] + "_us"] = us
        self.table += (f"== {name} window ==\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=25) + "\n")
        self.live = None


def clock_replays(engine_cls, clocks):
    """Bracket each graph replay of ``engine_cls`` with CUDA events
    (``clocks["replay"]``: (the engine's label, the run's number, event,
    event)), time each exit check on the host (``clocks["exit_check"]``:
    seconds; the wait for a replay's exit word, ``Engine._read``, or in a
    checkout from before the device loop the block's read,
    ``Engine._exit_counts``), and keep each engine's capture (its seconds
    and :func:`graph_pool_bytes`) and, after each run, its bodies, replays
    and skipped replays
    (``clocks["engines"]``).  Returns what they replaced, for
    :func:`restore_replays`."""
    import torch

    check = "_read" if hasattr(engine_cls, "_read") else "_exit_counts"
    saved = {"_replay": engine_cls._replay, check: getattr(engine_cls, check),
             "run": engine_cls.run, "capture": engine_cls.capture}
    runs, labels = [0], {}

    def label(self):
        return labels.setdefault(id(self), "wave" if not labels else f"stage{self.cfg.n_pool}")

    def run(self, *a, **kw):
        runs[0] += 1
        out = saved["run"](self, *a, **kw)
        rec = clocks["engines"].setdefault(label(self), {"runs": 0})
        rec["runs"] += 1
        rec.update(replays=self.replays, bodies=getattr(self, "bodies", self.replays),
                   skipped=getattr(self, "skipped", 0),
                   graph_bodies=getattr(self, "graph_bodies", 1))
        return out

    def capture(self, *a, **kw):
        secs = saved["capture"](self, *a, **kw)
        if secs:
            rec = clocks["engines"].setdefault(label(self), {"runs": 0})
            rec.update(capture_s=secs, graph_pool_bytes=graph_pool_bytes(self))
        return secs

    def replay(self):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        saved["_replay"](self)
        e1.record()
        clocks["replay"].append((label(self), runs[0], e0, e1))

    def exit_check(*a, **kw):
        t0 = time.perf_counter()
        out = saved[check](*a, **kw)
        clocks["exit_check"].append(time.perf_counter() - t0)
        return out

    engine_cls._replay, engine_cls.run, engine_cls.capture = replay, run, capture
    setattr(engine_cls, check, staticmethod(exit_check) if check == "_read" else exit_check)
    return saved


def graph_pool_bytes(eng):
    """The device memory an engine's graph holds: the segments of the
    graph's private pool and, since the device loop, of its blocks' memory
    pool (``Engine._body_pool``), from the caching allocator's snapshot."""
    import torch

    pools = {tuple(eng._graph.pool())}
    body = getattr(eng, "_body_pool", None)
    if body is not None:
        pools.add(tuple(body.id))
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def restore_replays(engine_cls, saved):
    """Undo :func:`clock_replays`."""
    for name, fn in saved.items():
        setattr(engine_cls, name, staticmethod(fn) if name == "_read" else fn)


def _p99(xs):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(0.99 * len(xs)))] if xs else 0.0


def replay_summary(clocks, window_ms):
    """Over the whole run: {replays, replay_ms (mean), replay_share (of the
    window), gap_ms and gap_p99_ms (the idle time of the stream between two
    replays of one engine run: mean and 99th percentile), gap_share (their
    sum over the window), exit_checks, exit_check_ms (mean host ms)}, and
    the same by engine (``engines``: its runs, bodies, replays and skipped
    replays, blocks a replay, capture seconds and graph pool bytes)."""
    pairs = clocks["replay"]

    def stats(sel):
        ms = [e0.elapsed_time(e1) for _, _, e0, e1 in sel]
        gaps = [a[3].elapsed_time(b[2]) for a, b in zip(sel, sel[1:]) if a[:2] == b[:2]]
        return {"replays": len(sel), "replay_ms": sum(ms) / max(1, len(sel)),
                "replay_share": sum(ms) / window_ms, "gap_ms": sum(gaps) / max(1, len(gaps)),
                "gap_p99_ms": _p99(gaps), "gaps": len(gaps), "gap_share": sum(gaps) / window_ms}

    exits = clocks["exit_check"]
    out = stats(pairs)
    out.update(exit_checks=len(exits), exit_check_ms=1e3 * sum(exits) / max(1, len(exits)))
    out["engines"] = {name: {**rec, **stats([p for p in pairs if p[0] == name])}
                      for name, rec in clocks["engines"].items()}
    return out


def census(root, photon_n, reference):
    """The eager run's launches of ``CENSUS``, each timed alone (see the
    module's docstring): returns (summary, the launches' records)."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    recs, engines, at, hot = [], {}, {"engine": None, "role": None}, {}
    launch, run, event_set = hot_kernels._launch, engine.Engine.run, engine.event_set
    refill_slots = engine.Engine.refill_slots
    slot = hot_kernels._PHASE_PTRS.index

    def timed_launch(name, ptr_tensors, scal, n, device, kernels=1):
        if name in hot_kernels.HOT_STEPS + hot_kernels.HOT_DRAWS:
            # a drawing launch's steps (its scalar after the first step's,
            # since the run)
            at_steps = hot_kernels._HOT_NSCAL + 1
            steps = int(scal[at_steps]) if len(scal) > at_steps else 1
            key = (at["engine"], name, n, steps)
            hot[key] = hot.get(key, 0) + 1
        if name not in CENSUS or n == 0:
            return launch(name, ptr_tensors, scal, n, device, kernels=kernels)
        # the count, queued before the launch (the record updates its flags
        # in place)
        role = at["role"]
        if name == "compact":
            mask = ptr_tensors[0]
            pool_n, k = mask.shape[0], int(scal[0])
            count = (~mask if scal[1] else mask).sum()
        elif name.startswith("record_phase"):
            pool_n, k = n, int(scal[0])
            count = ptr_tensors[hot_kernels._RECORD_PTRS.index("record_pending")].sum()
            stages = hot_kernels.RECORD_RECORD | hot_kernels.RECORD_FREE
            role = "record" if int(scal[1]) & stages else "sweep"
        elif name.startswith("fresh_init"):
            valid = ptr_tensors[hot_kernels._FRESH_PTRS.index("valid")]
            pool_n, k, role = n, valid.shape[0], "refill"
            count = valid.sum()
        else:
            valid, room, wedged = (ptr_tensors[slot(f)] for f in ("valid", "room", "wedged"))
            pool_n, k = ptr_tensors[0].shape[0], n
            count = (valid & ((torch.arange(k, device=valid.device) < room) | wedged)).sum()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(CENSUS_SLEEP)
        e0.record()
        launch(name, ptr_tensors, scal, n, device, kernels=kernels)
        e1.record()
        recs.append((at["engine"], role, name, pool_n, k, count, e0, e1))

    def in_role(fn, role):
        def wrapped(*a, **kw):
            at["role"] = role
            try:
                return fn(*a, **kw)
            finally:
                at["role"] = None
        return wrapped

    def labelled_run(self, *a, **kw):
        engines.setdefault(id(self), "wave" if not engines else f"stage{self.cfg.n_pool}")
        at["engine"] = engines[id(self)]
        return run(self, *a, **kw)

    hot_kernels._launch, engine.Engine.run = timed_launch, labelled_run
    engine.event_set = in_role(event_set, "events")
    engine.Engine.refill_slots = in_role(refill_slots, "refill")
    try:
        _, out = run_cell(root, photon_n, reference, graphed=False)
    finally:
        hot_kernels._launch, engine.Engine.run, engine.event_set = launch, run, event_set
        engine.Engine.refill_slots = refill_slots
    torch.cuda.synchronize()
    floor = []
    for _ in range(200):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(CENSUS_SLEEP)
        e0.record()
        e1.record()
        floor.append((e0, e1))
    torch.cuda.synchronize()
    counts = torch.stack([r[5] for r in recs]).tolist() if recs else []
    lines = [{"engine": e, "role": role, "name": name, "n": n, "k": k, "count": c,
              "us": 1e3 * e0.elapsed_time(e1)}
             for (e, role, name, n, k, _, e0, e1), c in zip(recs, counts)]
    groups = {}
    for ln in lines:
        groups.setdefault((ln["engine"], ln["role"], ln["name"], ln["n"], ln["k"]), []).append(ln)
    summary = []
    for (e, role, name, n, k), g in groups.items():
        us, c = sorted(x["us"] for x in g), [x["count"] for x in g]
        summary.append({"engine": e, "role": role, "name": name, "n": n, "k": k,
                        "launches": len(g), "us_mean": sum(us) / len(us),
                        "us_median": us[len(us) // 2], "us_min": us[0], "us_max": us[-1],
                        "count_mean": sum(c) / len(c), "count_min": min(c),
                        "count_max": max(c), "count_at_k": sum(x >= k for x in c)})
    hist = {}
    for ln in lines:
        if ln["name"].startswith("event_phase"):
            h = hist.setdefault(f"{ln['engine']}@{ln['n']}x{ln['k']}", [0] * len(EVENT_BINS))
            h[max(j for j, lo in enumerate(EVENT_BINS) if ln["count"] >= lo)] += 1
    return {"event_pair_us": 1e3 * sum(a.elapsed_time(b) for a, b in floor) / len(floor),
            "hot_iters": out["hot_iters"], "full_phases": out["full_phases"],
            "light_phases": out["light_phases"], "groups": summary,
            "hot_steps": [{"engine": e, "name": name, "n": n, "steps": s, "launches": c}
                          for (e, name, n, s), c in hot.items()],
            "events_per_full_phase": {"bins": list(EVENT_BINS), **hist}}, lines


def whole_trace(root, photon_n, reference):
    """The graphed run of the cell under ``torch.profiler`` from its start
    to its end: the device's busy time (the union of its activity
    intervals) within each engine run (a ``record_function`` range around
    ``Engine.run``, whose end waits for its device work), over those
    ranges' time: the whole run's idle share, the profiler's own cost
    included."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from grmonty_tpu_torch.transport import engine

    run = engine.Engine.run

    def marked(self, *a, **kw):
        with record_function("engine_run"):
            return run(self, *a, **kw)

    engine.Engine.run = marked
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, out = run_cell(root, photon_n, reference, graphed=True)
    finally:
        engine.Engine.run = run
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                    if e.name() == "engine_run" and e.device_type() != cuda)
    # the device's activities, but the range's own annotation, which the
    # profiler also draws on the device from its first launch to its last
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.device_type() == cuda and e.name() != "engine_run")
    busy = 0
    for a, b in ranges:
        end = a
        for s, t in spans:
            s, t = max(s, end), min(t, b)
            if t > s:
                busy += t - s
                end = t
    total = sum(b - a for a, b in ranges)
    return {"runs": len(ranges), "runs_ms": total / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / max(1, total), "device_activities": len(spans),
            "device_window_ms": out["device_window_ms"], "hot_iters": out["hot_iters"],
            "full_phases": out["full_phases"]}


def run_cell(root, photon_n, reference, graphed):
    """One run of the cell; returns (stats, wall seconds, the run's summary)."""
    import torch

    sim = chip_smoke.make_simulation(root, photon_n, reference=reference, graphed=graphed)
    t0 = time.monotonic()
    _, stats = sim.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    window_ms = stats["device_s"] * 1e3
    stages = [{"pool": st["pool"], "iters": st["iters"], "device_ms": st["device_s"] * 1e3,
               "ms_per_hot_iter": st["device_s"] * 1e3 / max(1, st["iters"])}
              for st in stats["tail_stages"]]
    out = {"graphed": sim.engine.graphed, "n_created": stats["n_created"],
           "n_recorded": stats["n_recorded"],
           "hot_iters": stats["hot_iters"], "full_phases": stats["full_phases"],
           "light_phases": stats["light_phases"], "device_window_ms": window_ms,
           "ms_per_hot_iter": window_ms / max(1, stats["hot_iters"]),
           "ms_per_body": window_ms / max(1, stats["full_phases"]),
           "wall_s": wall, "rate_device": stats["photon_rate_device"],
           "capture_s": stats["capture_s"], "replays": stats["replays"],
           "bodies": stats.get("bodies", stats["replays"]),
           "skipped_replays": stats.get("skipped_replays", 0),
           "pilot_host_s": stats["pilot"]["host_s"], "waves": stats["waves"],
           "waves_device_ms": window_ms - sum(st["device_ms"] for st in stages),
           "tail_stages": stages}
    return stats, out


def force_phase_shape(hot_kernels, spec):
    """Run ``hot_kernels.event_phase`` at the shapes of ``spec`` ("K:L,...":
    at K slots L lanes a warp)."""
    shapes = {int(k): int(lanes) for k, lanes in (item.split(":") for item in spec.split(","))}
    phase = hot_kernels.event_phase

    def shaped(pool, counters, sel, *a, **kw):
        return phase(pool, counters, sel, *a, **{"lanes": shapes.get(sel[0].shape[0]), **kw})

    hot_kernels.event_phase = shaped


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true", help="trace windows, not clocks")
    ap.add_argument("--reference", action="store_true", help="the reference-semantics cell")
    ap.add_argument("--graph-only", action="store_true",
                    help="the graph clocks alone, without the eager run's phase clocks")
    ap.add_argument("--phase-shape", default=None, metavar="K:L,...",
                    help="run the event phase at K slots with L lanes a warp (the shape "
                         "sweep; the other widths their own)")
    ap.add_argument("--whole-trace", action="store_true",
                    help="the graphed run under the profiler from start to end: the whole "
                         "run's idle share")
    ap.add_argument("--graph-bodies", type=int, default=None, metavar="K",
                    help="blocks a graph replay (engine.GRAPH_BODIES; a checkout from before "
                         "the device loop has none)")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device; this measurement runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    from grmonty_tpu_torch.transport import engine, hot_kernels

    card = chip_smoke.card_line()
    hot_kernels.build()
    if args.phase_shape:
        force_phase_shape(hot_kernels, args.phase_shape)
    if args.graph_bodies is not None:
        engine.GRAPH_BODIES = args.graph_bodies
    photon_n = REF_PHOTON_N if args.reference else PHOTON_N
    result = {"mode": "whole_trace" if args.whole_trace else "trace" if args.trace else "clocks",
              "path": "reference" if args.reference else "shipped", "photon_n": photon_n,
              "graph_bodies": getattr(engine, "GRAPH_BODIES", None)}

    if args.whole_trace:
        result["whole"] = whole_trace(root, photon_n, args.reference)
    elif args.trace:
        result["census"], lines = census(root, photon_n, args.reference)
        out_dir = os.path.join(root, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"census_{result['path']}.json"), "w") as f:
            json.dump(lines, f)
        win = Windows(TRACE_ITERS)
        replay = engine.Engine._replay
        waves = []  # the wave engine: the first engine that replays

        def traced_replay(self):
            waves[:] = waves or [self]
            name = ("wave" if self is waves[0] else "narrow"
                    if self.cfg.n_pool == NARROW_POOL and "drain" in win.results else "drain")
            it = self.replays * self.n_super
            if (name == "wave" and it >= ONE_BODY_AT and win.live is None
                    and "one_body" not in win.results):
                return one_body(self)
            win.before(name, it)
            replay(self)
            if win.live is not None and win.live[0] == name:
                win.after(it + self.n_super)

        def one_body(self):
            """Trace one replay after a marker kernel (a tracer can miss the
            first launches of its window; the block has fills of its own, so
            the marker is a GPU sleep), and keep the device activities that
            start after the marker, in order."""
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1 << 10)
                torch.cuda.synchronize()
                replay(self)
                torch.cuda.synchronize()
            dev = sorted(((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                          if e.device_type() == torch.autograd.DeviceType.CUDA))
            mark = max((t for t, name in dev if "spin" in name.lower()), default=None)
            names = [name for t, name in dev if mark is None or t > mark]
            win.results["one_body"] = {
                "iteration": self.replays * self.n_super, "marker_seen": mark is not None,
                "device_activities": len(names),
                "hot_launches": sum("hot_step_kernel" in n for n in names),
                "copies": sum("memcpy" in n.lower() or "copy" in n.lower() for n in names),
                "kernels": {n: names.count(n) for n in sorted(set(names))}}

        engine.Engine._replay = traced_replay
        _, result["run"] = run_cell(root, photon_n, args.reference, graphed=True)
        out_dir = os.path.join(root, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        table = "profile_kernels_reference.txt" if args.reference else "profile_kernels.txt"
        with open(os.path.join(out_dir, table), "w") as f:
            f.write(win.table)
        result["trace_windows"] = win.results
    else:
        clocks = {"replay": [], "exit_check": [], "engines": {}}
        saved = clock_replays(engine.Engine, clocks)
        try:
            _, graphed = run_cell(root, photon_n, args.reference, graphed=True)
        finally:
            restore_replays(engine.Engine, saved)
        graphed.update(replay_summary(clocks, graphed["device_window_ms"]))
        result["graphed"] = graphed
        if args.graph_only:
            print(card)
            print(json.dumps(result))
            return

        clocks = {name: [] for name in PHASES + WRAPPERS}
        saved = clock_phases(engine.Engine, clocks)
        try:
            _, eager = run_cell(root, photon_n, args.reference, graphed=False)
        finally:
            restore_phases(engine.Engine, saved)
        window_ms = eager["device_window_ms"]
        phases = {}
        for name, pairs in clocks.items():
            ms = sum(e0.elapsed_time(e1) for e0, e1 in pairs)
            phases[name] = {"calls": len(pairs), "ms": ms,
                            "ms_per_call": ms / max(1, len(pairs)), "share": ms / window_ms}
        top = sum(phases[n]["ms"]
                  for n in ("hot_step", "hot_run", "periodic_phase", "light_phase"))
        eager.update(phases=phases, outside_phases_share=1.0 - top / window_ms)
        result["eager"] = eager
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
