#!/usr/bin/env python3
"""Where the port's time goes in the smoke cell, on one CUDA card.

    python3 profile_slice.py            # phase clocks
    python3 profile_slice.py --trace    # trace windows
    python3 profile_slice.py --reference [--trace]   # reference semantics

Runs a cell of ``chip_smoke.py`` (256x256 torus, M = 4e19, seed 123,
float32, pool 65,536: the shipped profile at 1e5 photons, or with
``--reference`` reference semantics at 5e4 photons and ``chip_smoke.py``'s
step cap) once, through the driver's whole schedule (the host pilot, the
waves, the tail cascade), and measures one of two things.  Run them in
separate processes: once ``torch.profiler`` has traced a window, every
later kernel launch of the process costs more, so a traced run's phase
clocks and device window are not the run's.

1. **Phase clocks over the whole run** (default).  Every call of the engine's phases
   (``hot_step``, ``periodic_phase``, ``light_phase`` and, inside them,
   ``process_scatters`` and ``init_fresh``) and of the kernels' wrappers
   inside them (``hot_kernels.scatter_event`` and ``event_fluid`` inside
   ``process_scatters``, ``fresh_init`` inside ``init_fresh``) is
   bracketed by two CUDA events on the current stream.  Nothing is synchronised, so the run is
   not stretched; the stream time between a phase's two events is the
   time the stream spent on that phase's work, waiting for its launches
   included, so the phases split the engine's device window (nested
   phases are also counted inside their parents).  Beside them: the
   pilot's host seconds (it runs before the first wave, on the host
   tracker, outside the device window), and the window of the waves and of
   each cascade stage (width, hot iterations, CUDA-event seconds).
2. **Device busy share in trace windows** (``--trace``).  ``torch.profiler``
   traces 64 hot iterations twice: in the waves from hot iteration 64 on
   (full pool; the ramp's first waves), and in the first stage of the tail
   cascade 64 iterations after it starts.  The busy time is the union of
   the device activity intervals
   (kernels, copies, sets) in the window; the window is timed by CUDA
   events with the profiler on.  The share holds for those iterations
   only, not for the run.  One more window holds a single hot step of the
   first wave (``one_hot_step``): the names of its device activities.

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

PHASES = ("hot_step", "periodic_phase", "light_phase", "process_scatters", "init_fresh")
# the kernels' wrappers clocked as phases (hot_kernels functions, each nested
# in one of PHASES: scatter_event and event_fluid in process_scatters,
# fresh_init in init_fresh)
WRAPPERS = ("scatter_event", "event_fluid", "fresh_init")
PHOTON_N = 100_000
REF_PHOTON_N = 50_000
# device kernels whose time the trace windows report, by name
TRACED = {"hot_step_ms": "hot_step_kernel", "row_gather_ms": "row_gather_kernel",
          "scatter_event_ms": "scatter_event_kernel", "event_fluid_ms": "event_fluid_kernel",
          "fresh_init_ms": "fresh_init_kernel"}
WAVE_AT = 64  # trace the first wave from this hot iteration
TRACE_ITERS = 64  # hot iterations per trace window
ONE_STEP_AT = WAVE_AT + TRACE_ITERS + 1  # trace this hot iteration alone


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
    """Starts and stops ``torch.profiler`` around hot iterations."""

    def __init__(self, iters):
        self.iters, self.start_at, self.results = iters, {"wave": WAVE_AT}, {}
        self.live, self.last_it, self.table = None, 0, ""

    def before(self, it):
        import torch
        from torch.profiler import ProfilerActivity, profile

        for name, at in self.start_at.items():
            if self.live is None and it == at and name not in self.results:
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                prof.start()
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
                self.live = (name, it, prof, e0)

    def after(self, it):
        import torch

        if self.live is None or it < self.live[1] + self.iters:
            return
        name, _, prof, e0 = self.live
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        e1.synchronize()
        prof.stop()
        window = e0.elapsed_time(e1)
        busy, n_dev = busy_ms(prof)
        self.results[name] = {
            "iters": self.iters, "window_ms": window, "busy_ms": busy,
            "busy_share": busy / window, "device_activities": n_dev}
        for key, kernel in TRACED.items():
            self.results[name][key] = sum(
                e.duration_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA
                and kernel in e.name()) / 1e6
        self.table += (f"== {name} window ==\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=25) + "\n")
        self.live = None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true", help="trace windows, not phase clocks")
    ap.add_argument("--reference", action="store_true", help="the reference-semantics cell")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import torch

    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device; this measurement runs only on the card",
              file=sys.stderr)
        sys.exit(2)
    root = os.path.dirname(os.path.abspath(__file__))
    from grmonty_tpu_torch.transport import driver, engine, hot_kernels

    card = chip_smoke.card_line()
    hot_kernels.build()
    photon_n = REF_PHOTON_N if args.reference else PHOTON_N
    sim = chip_smoke.make_simulation(root, photon_n, reference=args.reference)

    clocks = {name: [] for name in PHASES + WRAPPERS}
    win = Windows(TRACE_ITERS)
    if args.trace:
        hot = engine.Engine.hot_step
        drain = driver.Simulation._drain_tail

        def traced_hot_step(self, state, *a, **kw):
            if (state.it == ONE_STEP_AT and win.live is None
                    and "one_hot_step" not in win.results):
                return one_hot_step(self, state, *a, **kw)
            win.before(state.it)
            state = hot(self, state, *a, **kw)
            win.last_it = state.it
            win.after(state.it)
            return state

        def one_hot_step(self, state, *a, **kw):
            """Trace one hot step after a marker kernel (a tracer can miss
            the first launches of its window), and keep the device
            activities that start after the marker, in order."""
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                torch.full((1,), 7.0, device=self.device)
                torch.cuda.synchronize()
                state = hot(self, state, *a, **kw)
                torch.cuda.synchronize()
            dev = sorted(((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                          if e.device_type() == torch.autograd.DeviceType.CUDA))
            mark = max((t for t, name in dev if "fill" in name.lower()), default=None)
            win.results["one_hot_step"] = {
                "iteration": ONE_STEP_AT, "marker_seen": mark is not None,
                "device_activities": [name for t, name in dev if mark is None or t > mark]}
            win.last_it = state.it
            return state

        def traced_drain_tail(self, state):
            win.start_at["drain"] = WAVE_AT  # a stage counts its iterations from 0
            return drain(self, state)

        engine.Engine.hot_step = traced_hot_step
        driver.Simulation._drain_tail = traced_drain_tail
    else:
        clock_phases(engine.Engine, clocks)

    t0 = time.monotonic()
    _, stats = sim.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    window_ms = stats["device_s"] * 1e3
    stages = [{"pool": st["pool"], "iters": st["iters"], "device_ms": st["device_s"] * 1e3}
              for st in stats["tail_stages"]]
    result = {"mode": "trace" if args.trace else "clocks",
              "path": "reference" if args.reference else "shipped",
              "photon_n": photon_n, "n_created": stats["n_created"],
              "hot_iters": stats["hot_iters"], "device_window_ms": window_ms,
              "wall_s": wall, "rate_device": stats["photon_rate_device"],
              "pilot_host_s": stats["pilot"]["host_s"], "waves": stats["waves"],
              "waves_device_ms": window_ms - sum(st["device_ms"] for st in stages),
              "tail_stages": stages}
    if args.trace:
        out_dir = os.path.join(root, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        table = "profile_kernels_reference.txt" if args.reference else "profile_kernels.txt"
        with open(os.path.join(out_dir, table), "w") as f:
            f.write(win.table)
        result["trace_windows"] = win.results
    else:
        phases = {}
        for name, pairs in clocks.items():
            ms = sum(e0.elapsed_time(e1) for e0, e1 in pairs)
            phases[name] = {"calls": len(pairs), "ms": ms,
                            "ms_per_call": ms / max(1, len(pairs)), "share": ms / window_ms}
        top = sum(phases[n]["ms"] for n in ("hot_step", "periodic_phase", "light_phase"))
        result.update(phases=phases, outside_phases_share=1.0 - top / window_ms)
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
