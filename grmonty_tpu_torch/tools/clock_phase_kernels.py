"""Where a warp's time goes in the event kernel, the event phase and the
track start (card only).

    python3 -m grmonty_tpu_torch.tools.clock_phase_kernels [--dir CHECKOUT]
        [--dtype float32] [--event-widths 16384,512] [--phase-widths ...]
        [--fresh-widths ...] [--kernels event_phase,...]

Writes copies of ``csrc/scatter_event.cu`` and ``csrc/fresh_init.cu`` (or
those of the checkout ``--dir``, e.g. the parent's from ``git archive``)
with ``clock64()`` stamps between the kernels' segments into
``build/grmonty_tpu_torch/``, builds them with the port's nvcc flags and
the headers beside each source, and runs them on the synthetic inputs of
``chip_smoke.py``'s kernel checks on the 256x256 torus: the event kernel
through ``hot_kernels.scatter_event`` on ``hot_kernels.synthetic_events``
(seed 2026), the event phase through ``hot_kernels.event_phase`` on
``hot_kernels.synthetic_event_pool`` (seed 2040 + K, the ring with room for
the width's events: ``NxKeE`` is E events of K slots on N lanes, a fresh
copy of the pool each launch), refill's sources and the track start
through ``hot_kernels.refill_fresh`` on ``hot_kernels.synthetic_refill``
(seed 2031 + K) in both semantics, untraced (a checkout's start that took
its sources as tensors after those sources as torch ops:
``launch_sources_mode``).  Lane 0 of every warp that reaches a stamp adds
the cycles since its previous stamp to that segment's sum and counts
itself; each stamp first waits for a value the segment computed,
so the compiler cannot move the segment's work across it.  The card's
line, then one JSON line per (kernel, width): each segment's mean cycles
over the warps that reached it, and the warps, over 20 launches.  Exits
2 without a card.

Each stamp has anchors in the current sources and in those of the kernels
before them (one thread a lane; the track start that took refill's
sources as tensors; the event phase with a lane's whole chain on each of
its threads): the first
anchor found is used, and a source with none raises.  Where a lane's
threads split its chain, a segment that lane 0 of a warp does not run is
counted by the warps whose lane 0 runs it, and each stamp counts the
cycles since that thread's previous stamp.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess

EVENT_SEGMENTS = ("tetrad+k_tet", "electron rounds", "electron direction+boost",
                  "KN/Thomson rounds", "scattered direction+boost back+stores")
PHASE_SEGMENTS = ("pool loads+corner row", "blend+scalars", "metric pair",
                  "four-vectors+kinematics", "surface wait", "hotcross", "alpha_abs+bias",
                  "tetrad+k_tet", "electron rounds", "electron direction+boost",
                  "KN/Thomson rounds", "scattered direction+boost back+stores")
FRESH_SEGMENTS = ("search/slots", "staging", "copy/load", "connection+dk", "row fetch+blend",
                  "kinematics", "surface wait", "hotcross", "k2+synch+b_nu", "bias+stores")
# (alternative (pattern, replacement)s) of each stamp, in the kernel's order;
# STAMP(k, v) closes segment k
_EVENT_STAMPS = [
    [(r"(  const int i = blockIdx\.x \* blockDim\.x \+ threadIdx\.x;\n  if \(i >= n\) return;\n)"
      r"(  auto in = )", "\\g<1>  CLK_START();\n\\g<2>"),
     (r"(  const int i0 = warp_lane<L>\(t\);\n)", "\\g<1>  CLK_START();\n")],
    [(r"  const bool guard = invalid_frame \|\| parent_die \|\| !active;\n",
      "\\g<0>  STAMP(0, k_tet[0] + k_tet[3] + e_con[3][3] + e_cov[3][3]);\n")],
    [(r"  rounds = r;\n  ok = acc;\n", "\\g<0>  STAMP(1, gamma + beta + mu);\n"),
     (r"  ok_el = acc_el \|\| !go;\n", "\\g<0>  STAMP(1, el[0] + el[1] + el[2]);\n")],
    [(r"  ok = true;\n  int r = 0;\n", "\\g<0>  STAMP(2, ke0 + p[0] + p[3]);\n"),
     (r"  // the second loop: Klein-Nishina", "  STAMP(2, ke[0] + p[0] + kc.k0);\n\\g<0>")],
    [(r"  rounds = r;\n  const T s_th = fm::sqrt\(fm::fabs", "  STAMP(3, c_th + k0p);\n\\g<0>"),
     (r"  // the scattered direction and the boost back", "  STAMP(3, sc[0]);\n\\g<0>")],
    [(r"(  \(\(int32_t \*\)ptrs\.p\[34\]\)\[i\] = rounds_sc;\n)\}",
      "\\g<1>  STAMP(4, 0.0);\n  CLK_WARP();\n}")],
]
_PHASE_STAMPS = [
    [(r"(  const int s0 = (?:warp_lane|phase_lane)<L>\(t\);\n)",
      "\\g<1>  CLK_START();\n")],
    [(r"  const bool inside = in_grid\(x1, x2, CB\);\n",
      "  STAMP(0, row[0] + row[RAW_W - 1] + kk[0] + kk[3] + w + x1 + x2);\n\\g<0>")],
    [(r"    raw_scalars\(pr, inside, CB, n_e, te\);\n", "\\g<0>    STAMP(1, n_e + te);\n")],
    [(r"( +)metric_pair\(x1, x2, CB, g, gc\);\n",
      "\\g<0>\\g<1>STAMP(2, g[0] + g[6] + gc[0] + gc[5]);\n")],
    [(r"( +)const T e_g = T\(HPL_D\) \* nu_safe \* CB\.inv_mecc;\n",
      "\\g<0>\\g<1>STAMP(3, e_g + sin_th + u_con[0] + b_con[3] + b_mag);\n")],
    [(r"( +)barrier_wait\(&hc_bar\);\n", "\\g<0>\\g<1>STAMP(4, 0.0);\n")],
    [(r"( +)const T a_sc = [^\n]*\n", "\\g<0>\\g<1>STAMP(5, a_sc);\n")],
    [(r"( +)const T bias = bias_clamp[^\n]*\n", "\\g<0>\\g<1>STAMP(6, a_ab + bias);\n")],
    [(r"  const bool guard = invalid_frame \|\| parent_die \|\| !on;\n",
      "\\g<0>  STAMP(7, k_tet[0] + k_tet[3] + e_con[3][3] + e_cov[3][3]);\n")],
    [(r"  ok_el = acc_el \|\| !go;\n", "\\g<0>  STAMP(8, el[0] + el[1] + el[2]);\n")],
    [(r"  // the second loop: Klein-Nishina", "  STAMP(9, ke[0] + p[0] + kc.k0);\n\\g<0>")],
    [(r"  // the scattered direction and the boost back", "  STAMP(10, sc[0]);\n\\g<0>")],
    [(r"(    r\[15\] = [^\n]*;\n  \}\n)\}",
      "\\g<1>  STAMP(11, 0.0);\n  CLK_WARP();\n}")],
]
_FRESH_STAMPS = [
    [(r"(  const int s0 = blockIdx\.x \* \(FRESH_THREADS / G\) \+ threadIdx\.x / G;\n)",
      "\\g<1>  CLK_START();\n")],
    [(r"  const bool load = lane < n && P\.load\[s\];\n", "\\g<0>  STAMP(0, (double)lane);\n"),
     # since the kernel works out the sources: the slot's source known (its
     # ticket taken)
     (r"  if \(!__syncthreads_or\(load\)\) return;\n", "  STAMP(0, (double)lane);\n\\g<0>")],
    [(r"  cp_async_arrive\(&hc_bar\);\n", "\\g<0>  STAMP(1, 0.0);\n")],
    [(r"  // the start\n", "  STAMP(2, row[0] + row[15]);\n\\g<0>")],
    [(r"    geodesic_rhs\(conn, kk, dk\);\n  \}\n", "\\g<0>  STAMP(3, dk[0] + dk[3]);\n")],
    [(r"  // the opacities \(Engine\.eval_alphas\) and the bias",
      "  STAMP(4, n_e + te + b_mag + u_cov[0] + b_cov[3]);\n\\g<0>")],
    [(r"  const T e_g = T\(HPL_D\) \* nu_safe \* CB\.inv_mecc;\n",
      "\\g<0>  STAMP(5, e_g + sin_th);\n")],
    [(r"(  barrier_wait\(&hc_bar\);\n)(  const int first)", "\\g<1>  STAMP(6, 0.0);\n\\g<2>")],
    [(r"  const T a_sc = [^\n]*\n", "\\g<0>  STAMP(7, a_sc);\n")],
    [(r"  const T a_ab = [^\n]*\n", "\\g<0>  STAMP(8, a_ab);\n")],
    [(r"(    P\.bw\[i\] = w;\n  \}\n)\}", "\\g<1>  STAMP(9, 0.0);\n  CLK_WARP();\n}")],
]
_HEAD = """
__device__ unsigned long long g_clk[16], g_cnt[16];
__shared__ long long clk_prev[1024];
#define CLK_START() (clk_prev[threadIdx.x] = clock64())
#define STAMP(k, v) do { asm volatile("" :: "d"((double)(v)) : "memory"); \\
  long long t_ = clock64(); \\
  if ((threadIdx.x & 31) == 0) { \\
    atomicAdd(&g_clk[k], (unsigned long long)(t_ - clk_prev[threadIdx.x])); \\
    atomicAdd(&g_cnt[k], 1ull); } \\
  clk_prev[threadIdx.x] = clock64(); } while (0)
#define CLK_WARP() do { if ((threadIdx.x & 31) == 0) atomicAdd(&g_clk[15], 1ull); } while (0)
"""
_TAIL = """
extern "C" int clk_read(unsigned long long *out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out + 16, g_cnt, sizeof(g_cnt));
  return (int)e;
}
extern "C" int clk_reset() {
  unsigned long long z[16] = {0};
  cudaError_t e = cudaMemcpyToSymbol(g_clk, z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_cnt, z, sizeof(z));
  return (int)e;
}
"""
STAMPS = {"scatter_event": _EVENT_STAMPS, "event_phase": _PHASE_STAMPS,
          "fresh_init": _FRESH_STAMPS}
SEGMENTS = {"scatter_event": EVENT_SEGMENTS, "event_phase": PHASE_SEGMENTS,
            "fresh_init": FRESH_SEGMENTS}
# the source file of each kernel
SOURCES = {"scatter_event": "scatter_event.cu", "event_phase": "scatter_event.cu",
           "fresh_init": "fresh_init.cu"}


def stamped(src, kernel):
    """The source ``src`` of ``kernel`` (one of ``STAMPS``) with the clock
    stamps in."""
    src = src.replace('#include "physics.cuh"\n', '#include "physics.cuh"\n' + _HEAD, 1)
    for alternatives in STAMPS[kernel]:
        for pattern, repl in alternatives:
            src, n = re.subn(pattern, repl, src, count=1)
            if n == 1:
                break
        else:
            raise ValueError(f"clock_phase_kernels: no anchor {alternatives[0][0]!r} in the "
                             f"{kernel} source")
    return src + _TAIL


def _build(src_path, kernel, nvcc_flags, build_dir):
    """Build the stamped copy of ``src_path``; returns the loaded library."""
    with open(src_path) as f:
        src = stamped(f.read(), kernel)
    os.makedirs(build_dir, exist_ok=True)
    cu = os.path.join(build_dir, f"clock_{kernel}.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    out = subprocess.run(["nvcc", *nvcc_flags, "-I", os.path.dirname(os.path.abspath(src_path)),
                          "-o", so, cu], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
    return ctypes.CDLL(so)


def _clocked(lib, segments, launch):
    """Run ``launch`` once, then 20 times between a reset and a read of
    the counters: {segment: mean cycles over the warps that reached it},
    with the warps."""
    import torch

    buf = (ctypes.c_ulonglong * 32)()
    launch()
    torch.cuda.synchronize()
    lib.clk_reset()
    for _ in range(20):
        launch()
    torch.cuda.synchronize()
    lib.clk_read(buf)
    cycles = {s: (buf[k] / buf[16 + k] if buf[16 + k] else None)
              for k, s in enumerate(segments)}
    return {"cycles": cycles, "warps": {s: buf[16 + k] // 20 for k, s in enumerate(segments)},
            "warps_stored": buf[15] // 20}


def sources_mode_abi():
    """(pointers, scalars) of a track start built before it worked out
    refill's sources, which took them as tensors (an ``engine.FreshLoad``):
    the pool's fields, the birth state, the slots' lane, load flag, source
    and indices, the ring's and the backlog's rows, the bias's denominator,
    the corner table and the surface; the hot step's scalars, the slots and
    the threads a slot (0: by the width)."""
    from grmonty_tpu_torch.transport import hot_kernels

    fields = hot_kernels._FRESH_LOAD + hot_kernels._FRESH_START + hot_kernels._BIRTH
    return len(fields) + 10, hot_kernels._HOT_NSCAL + 2


def launch_sources_mode(fn, pool, slots, counters, den, mc, tabs, cfg):
    """The track start as it was before it worked out refill's sources
    (:func:`sources_mode_abi`), on refill's ``slots``: the sources as torch
    ops (``engine.refill_sources_plain``), then one launch of that kernel's
    entry point ``fn`` (a ctypes function) in place on ``pool``, the birth
    state off.  Returns the pool."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    load = engine.refill_sources_plain(slots, counters)[3]
    n, dt, dev = pool.w.shape[0], pool.w.dtype, pool.w.device
    table = tabs.corner_rows if cfg.reference else tabs.hot_tab
    tensors = (hot_kernels.fresh_fields(pool) + [None] * 9
               + [*load[:5], load.sec_rows, load.backlog_rows,
                  hot_kernels._den_on(den, dev, dt), table, tabs.hc_coeffs])
    ptrs = (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr()
                                             for t in tensors])
    scal = list(hot_kernels._hot_scalars(mc, tabs, cfg, dev, dt)) + [load.sidx.shape[0], 0]
    sc = (ctypes.c_double * len(scal))(*[float(v) for v in scal])
    rc = fn(ptrs, sc, n, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"the track start's launch failed: CUDA error {rc}")
    return pool


# the event phase's (pool lanes)x(slots)[e(events)]: the wave's width at the
# path's 8,192-16,384 events a phase, the cascade's widths at half their
# slots, and the 512-lane stage's one event a phase
PHASE_WIDTHS = ("65536x16384e8192,65536x16384e12288,65536x16384e16384,4096x4096,512x512,"
                "512x512e1")


def phase_width(spec):
    """(n, k, events or None) of a ``--phase-widths`` entry ``NxK[eE]``."""
    nk, _, e = spec.partition("e")
    n, k = (int(v) for v in nk.split("x"))
    return n, k, int(e) if e else None


def clock_event_phase(lib, sim, widths, csrc, **shape):
    """Print one line per width of ``widths`` (``phase_width`` entries):
    the stamped event phase of ``lib`` on the path's synthetic pool, at the
    ``lanes`` of ``shape`` where given."""
    import torch

    from grmonty_tpu_torch.transport import engine, hot_kernels

    mc, tabs, dev, dt = sim.mc, sim.tables, sim.device, sim.cfg.dtype
    name = hot_kernels.entry_point("event_phase", dt)
    ours = hot_kernels._Build.fns[name]
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes, fn.restype = ours.argtypes, ctypes.c_int
    for n, k, events in widths:
        pool, sec, counters, den = hot_kernels.synthetic_event_pool(
            sim.engine, n, k, 2040 + k, "room", events=events)
        sel, room, wedged = engine.event_set(pool, sec, k)
        key = torch.tensor([0x5EED0000 + k, 0xE7E27], dtype=torch.int64, device=dev)
        on = sel[0] & ((torch.arange(k, device=dev) < room) | wedged)

        def launch():
            work = engine.clone_pool(pool)
            wc = engine.Counters(*(t.clone() for t in counters))
            hot_kernels._Build.fns[name] = fn
            try:
                hot_kernels.event_phase(work, wc, sel, room, wedged, den, mc, tabs, key=key,
                                        **shape)
            finally:
                hot_kernels._Build.fns[name] = ours
        rec = _clocked(lib, PHASE_SEGMENTS, launch)
        lanes = shape.get("lanes") or getattr(lib, f"{name}_lanes")(k)  # the source's own
        print(json.dumps({"name": name, "n": n, "k": k, "events": int(on.sum()), "lanes": lanes,
                          "source": csrc, **rec}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=None, help="the checkout whose kernels to stamp")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--kernels", default="scatter_event,event_phase,fresh_init",
                    help="the kernels to clock, of " + ",".join(STAMPS))
    ap.add_argument("--event-widths", default="16384,512")
    ap.add_argument("--phase-widths", default=PHASE_WIDTHS)
    ap.add_argument("--lanes", type=int, default=None,
                    help="the event phase's lanes a warp (default: by the width)")
    ap.add_argument("--fresh-widths", default="65536x32768,65536x16384,65536x12288,4096x4096,"
                                              "512x512")
    args = ap.parse_args(argv)
    import torch

    from grmonty_tpu_torch.tools import card, require_cuda, validate_accuracy
    from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

    require_cuda("clock_phase_kernels")
    print(card(), flush=True)
    hot_kernels.build()
    csrc = (os.path.join(args.dir, "grmonty_tpu_torch", "csrc") if args.dir
            else hot_kernels.CSRC_DIR)
    dt = getattr(torch, args.dtype)
    sim = driver.Simulation(validate_accuracy._torus(256, 256), photon_n=20000,
                            mass_unit=4.0e19, seed=123, device="cuda",
                            config=profiles.bench_config(pool=65536, dtype=dt))
    mc, tabs, dev = sim.mc, sim.tables, sim.device
    build_dir = hot_kernels.BUILD_DIR

    kernels = args.kernels.split(",")
    if "event_phase" in kernels:
        lib = _build(os.path.join(csrc, SOURCES["event_phase"]), "event_phase",
                     hot_kernels.NVCC_FLAGS, build_dir)
        shape = {"lanes": args.lanes} if args.lanes else {}
        clock_event_phase(lib, sim, [phase_width(w) for w in args.phase_widths.split(",")],
                          csrc, **shape)
    if "scatter_event" not in kernels:
        widths = []
    else:
        lib = _build(os.path.join(csrc, SOURCES["scatter_event"]), "scatter_event",
                     hot_kernels.NVCC_FLAGS, build_dir)
        widths = [int(w) for w in args.event_widths.split(",")]
        name = hot_kernels.entry_point("scatter_event", dt)
        ours = hot_kernels._Build.fns[name]
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes, fn.restype = ours.argtypes, ctypes.c_int
    for n in widths:
        _, k, fl, g7, active, force, _ = hot_kernels.synthetic_events(sim.engine, n, 2026)
        key = torch.tensor([0x5EED0000 + n, 0xC0FFEE], dtype=torch.int64, device=dev)
        try:
            hot_kernels._Build.fns[name] = fn
            rec = _clocked(lib, EVENT_SEGMENTS, lambda: hot_kernels.scatter_event(
                k, fl, g7, mc.b_unit, active, force, key=key))
        finally:
            hot_kernels._Build.fns[name] = ours
        print(json.dumps({"name": name, "n": n, "source": csrc, **rec}), flush=True)

    if "fresh_init" not in kernels:
        return
    lib = _build(os.path.join(csrc, SOURCES["fresh_init"]), "fresh_init",
                 hot_kernels.NVCC_FLAGS, build_dir)
    ticket = hot_kernels.fresh_ticket(dev)
    for reference in (False, True):
        name = hot_kernels.entry_point("fresh_init", dt, reference)
        ours = hot_kernels._Build.fns[name]
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes, fn.restype = ours.argtypes, ctypes.c_int
        abi = (getattr(lib, f"{name}_nptrs")(), getattr(lib, f"{name}_nscal")())
        if abi not in (hot_kernels._ABI[name], sources_mode_abi()):
            raise ValueError(f"clock_phase_kernels: {name} of {csrc} takes {abi} (pointers, "
                             "scalars), neither this checkout's nor the sources mode's")
        old = abi != hot_kernels._ABI[name]
        for width in args.fresh_widths.split(","):
            n, k = (int(v) for v in width.split("x"))
            pool, slots, counters, den, cfg = hot_kernels.synthetic_refill(
                mc, n, k, 2031 + k, dt, dev, reference=reference, trace_birth=False)
            work = engine.clone_pool(pool)
            if old:
                launch = lambda: launch_sources_mode(  # noqa: E731
                    fn, work, slots, counters, den, mc, tabs, cfg)
            else:
                def launch():
                    # the counts the launch takes its sources from, as made
                    sl = slots._replace(sec=engine.SecBuf(slots.sec.rows,
                                                          slots.sec.count.clone()),
                                        backlog_pos=slots.backlog_pos.clone())
                    c = counters._replace(n_created=counters.n_created.clone())
                    hot_kernels._Build.fns[name] = fn
                    try:
                        hot_kernels.refill_fresh(work, sl, c, den, mc, tabs, cfg, ticket)
                    finally:
                        hot_kernels._Build.fns[name] = ours
            rec = _clocked(lib, FRESH_SEGMENTS, launch)
            print(json.dumps({"name": name, "n": n, "k": k, "source": csrc, "sources_mode": old,
                              **rec}), flush=True)


if __name__ == "__main__":
    main()
