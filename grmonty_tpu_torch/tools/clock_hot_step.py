"""Where a warp's time goes in the fused hot step (card only).

    python3 -m grmonty_tpu_torch.tools.clock_hot_step [--source PATH]
        [--dtype float64] [--widths 512,65536]

Writes a copy of ``csrc/hot_step.cu`` (or ``--source``, e.g. another
checkout's) with ``clock64()`` stamps between the kernel's segments into
``build/grmonty_tpu_torch/``, builds it with the port's nvcc flags and runs
each variant of ``--dtype`` through ``hot_kernels.hot_step`` at each width,
on the synthetic lanes of ``chip_smoke.py``'s kernel checks (seed 2024) on
the 256x256 torus.  Lane 0 of every warp adds the cycles of each segment
to a device counter; each stamp first waits for a value the segment
computed, so the compiler cannot move the segment's work across it.  The
card's line, then one JSON line per (variant, width): the mean cycles a
warp of each segment and in all, over 20 launches; the instance the width
runs in the source (its ``<entry>_group``, ``_threads`` and
``_blocks_per_sm``); and the device microseconds a launch of the source
built unstamped, explicit and drawing (``device_us``: launches queued
behind a GPU sleep, so that the host's launch cost is hidden; a width of 1
gives a lane's chain with the launch).  Exits 2 without a card.

The stamps' anchors are lines both the float64 redesign and the kernel
before it hold, at any indentation: a launch of several steps (a run,
since the loop over the steps) adds each step's cycles to the segments
inside the loop.  A source without one of them raises.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess

SEGMENTS = ("staging", "loads", "connection", "rounds+control+cell", "row fetch",
            "blend+kinematics", "hotcross", "k2+synch+b_nu", "rest of phase B", "stores",
            "census", "surface wait")
_WAIT = 11  # the wait for the staged surface (float32: since the cp.async staging)
# (pattern, replacement) of each stamp, in the order of the kernel
_STAMPS = [
    (r"  if \(threadIdx\.x < 5\) census\[threadIdx\.x\] = 0u;\n",
     "  long long t_prev = clock64();\n\\g<0>"),
    (r"  // ---- phase A \(engine\.hot_phase_a\) ----\n", "  STAMP(0, 0.0);\n\\g<0>"),
    (r"  const bool moving = alive && !at_event;\n",
     "  STAMP(1, x[0] + x[3] + k[0] + k[3] + dk[0] + dk[3] + dl_shrink + pend_dl + "
     "alpha_scatti + bi + (pend_push ? 1.0 : 0.0) + (alive ? 1.0 : 0.0));\n\\g<0>"),
    (r"  connection\(x_new\[1\], x_new\[2\], CA, conn[^\n]*\n",
     "\\g<0>  STAMP(2, conn[0] + conn[39] + conn[26] + conn[14]);\n"),
    (r"  // ---- the corner row at z",
     "  STAMP(3, (double)z + dl_shrink_n + x[0] + k[0] + dk[0] + e0sn + w_a + pend_rem);\n"
     "\\g<0>"),
    (r"  fetch_row<W[^(]*\([^\n]*\n", "\\g<0>  STAMP(4, row[0] + row[W - 1]);\n"),
    (r"  const T e_g = T\(HPL_D\) \* nu_safe \* CB\.inv_mecc;\n",
     "\\g<0>  STAMP(5, e_g + te + n_e + sin_th + b_mag);\n"),
    (r"  const T a_scf = [^\n]*\n", "\\g<0>  STAMP(6, a_scf);\n"),
    (r"  const T a_abf = [^\n]*\n", "\\g<0>  STAMP(7, a_abf);\n"),
    (r"  // ---- the epilogue",
     "  STAMP(8, w_b + decay + (roll ? 1.0 : 0.0) + (alive_b ? 1.0 : 0.0));\n\\g<0>"),
    (r"  // ---- the census", "  STAMP(9, 0.0);\n\\g<0>"),
    (r"(    atomicAdd\(P\.ls_slots, [^\n]*\);\n  \}\n)\}",
     "\\g<1>  STAMP(10, 0.0);\n  if ((threadIdx.x & 31) == 0) atomicAdd(&g_clk[15], 1ull);\n}"),
]
_HEAD = """
__device__ unsigned long long g_clk[16];
#define STAMP(k, v) do { asm volatile("" :: "d"((double)(v)) : "memory"); \\
  long long t_ = clock64(); \\
  if ((threadIdx.x & 31) == 0) atomicAdd(&g_clk[k], (unsigned long long)(t_ - t_prev)); \\
  t_prev = clock64(); } while (0)
"""
_TAIL = """
extern "C" int clk_read(unsigned long long *out) {
  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
}
extern "C" int clk_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(g_clk));
}
"""


def stamped(src):
    """The kernel source ``src`` with the clock stamps in."""
    src = src.replace("typedef unsigned char u8;\n", "typedef unsigned char u8;\n" + _HEAD, 1)
    for pattern, repl in _STAMPS:
        src, n = re.subn(pattern, repl, src, count=1)
        if n != 1:
            raise ValueError(f"clock_hot_step: no anchor {pattern!r} in the source")
    src = re.sub(r"( *)(barrier_wait\(hc_bar\);\n)", f"\\g<1>\\g<2>\\g<1>STAMP({_WAIT}, 0.0);\n",
                 src, count=1)
    return src + _TAIL


def device_us(fn, reps=50):
    """Device microseconds a call of ``fn`` (a few launches), its calls
    queued behind a GPU sleep that outlasts their enqueueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 26
    for _ in range(4):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        covered = not t0.query()
        t1.synchronize()
        if covered:
            return 1e3 * t0.elapsed_time(t1) / reps
        cycles *= 4
    raise RuntimeError("clock_hot_step: the GPU sleep never outlasted the launches")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=None, help="the hot_step.cu to stamp (default ours)")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float64")
    ap.add_argument("--widths", default="512,65536")
    args = ap.parse_args(argv)
    import torch

    from grmonty_tpu_torch.tools import card, require_cuda, validate_accuracy
    from grmonty_tpu_torch.transport import driver, hot_kernels, profiles

    require_cuda("clock_hot_step")
    print(card(), flush=True)
    hot_kernels.build()
    src_path = args.source or os.path.join(hot_kernels.CSRC_DIR, "hot_step.cu")
    with open(src_path) as f:
        src = stamped(f.read())
    os.makedirs(hot_kernels.BUILD_DIR, exist_ok=True)
    cu = os.path.join(hot_kernels.BUILD_DIR, "clock_hot_step.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    # the stamped copy includes the shared headers beside its source; the
    # source itself is built too, unstamped, for its device times and shapes
    plain_so = cu[:-3] + "_plain.so"
    procs = [subprocess.Popen(["nvcc", *hot_kernels.NVCC_FLAGS, "-I",
                               os.path.dirname(os.path.abspath(src_path)), "-o", o, c],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for o, c in ((so, cu), (plain_so, src_path))]
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
    lib, plain = ctypes.CDLL(so), ctypes.CDLL(plain_so)
    buf = (ctypes.c_ulonglong * 16)()
    dt = getattr(torch, args.dtype)
    sim = driver.Simulation(validate_accuracy._torus(256, 256), photon_n=20000,
                            mass_unit=4.0e19, seed=123, device="cuda",
                            config=profiles.bench_config(pool=65536, dtype=dt))
    mc, tabs, dev = sim.mc, sim.tables, sim.device
    for reference in (False, True):
        name = hot_kernels.entry_point("hot_step", dt, reference)
        ours = hot_kernels._Build.fns[name]
        stamped_fn = getattr(lib, f"{name}_launch")
        stamped_fn.argtypes, stamped_fn.restype = ours.argtypes, ctypes.c_int
        sides = {}  # the source's own unstamped entry points, explicit and drawing
        for inst in (name, f"{name}_draw"):
            sides[inst] = getattr(plain, f"{inst}_launch")
            sides[inst].argtypes = hot_kernels._Build.fns[inst].argtypes
            sides[inst].restype = ctypes.c_int
        for n in (int(w) for w in args.widths.split(",")):
            # the reference path's cut step cap, as chip_smoke.py's checks draw them
            cfg = (profiles.reference_config(pool=n, dtype=dt, stall_steps=50000)
                   if reference else sim.cfg._replace(n_pool=n))
            lanes = hot_kernels.synthetic_lanes(mc, n, 2024, cfg.stall_steps, reference,
                                                events=True)
            pool, counters, u_roul, u_x1, bias = hot_kernels.synthetic_step(lanes, dt, dev)
            rec = {"name": name, "n": n, "source": os.path.relpath(src_path)}
            try:
                hot_kernels._Build.fns[name] = stamped_fn
                hot_kernels.hot_step(pool, counters, u_roul, u_x1, bias, mc, tabs, cfg)
                torch.cuda.synchronize()
                lib.clk_reset()
                for _ in range(20):
                    hot_kernels.hot_step(pool, counters, u_roul, u_x1, bias, mc, tabs, cfg)
                torch.cuda.synchronize()
                lib.clk_read(buf)
            finally:
                hot_kernels._Build.fns[name] = ours
            warps = buf[15]
            rec["cycles"] = {s: buf[k] / warps for k, s in enumerate(SEGMENTS)}
            rec["total_cycles"] = sum(rec["cycles"].values())
            for what in hot_kernels.HOT_SHAPE:
                fn = getattr(plain, f"{name}_{what}")
                fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
                rec[what] = fn(n)
            key = torch.tensor([0x407D4A00 + n, 0x5EED5], dtype=torch.int64, device=dev)
            saved = {inst: hot_kernels._Build.fns[inst] for inst in sides}
            try:
                hot_kernels._Build.fns.update(sides)
                rec["device_us"] = {
                    "explicit": device_us(lambda: hot_kernels.hot_step(
                        pool, counters, u_roul, u_x1, bias, mc, tabs, cfg)),
                    "draw": device_us(lambda: hot_kernels.hot_step_drawn(
                        pool, counters, key, 5, bias, mc, tabs, cfg))}
            finally:
                hot_kernels._Build.fns.update(saved)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
