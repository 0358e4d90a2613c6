"""The float32 hot step's launch shapes, timed on the card (card only).

    python3 -m grmonty_tpu_torch.tools.sweep_hot_shape [--source PATH]
        [--widths 512,1024,...] [--groups 1,2,4,8]

Builds, for each group G of ``--groups``, a source that includes
``csrc/hot_step.cu`` (or ``--source``, another checkout's with the same
launch templates) with ``HOT_STEP_SWEEP`` defined (the port's entry points
left out) and instantiates the float32 explicit instances of G threads a
lane in blocks of 32, 64, 128 and 256 threads (``WRAPPER``), one ``nvcc``
a group, all started together, into ``build/grmonty_tpu_torch/``.  Then, at each width
and in both variants, it launches every shape through
``hot_kernels.hot_step`` on the synthetic lanes of ``chip_smoke.py``'s
kernel checks (seed 2024, the 256x256 torus): every output must be bit
for bit the port's own launch on the same step, and each shape's device
microseconds a launch are taken in two rounds (the shapes in order, then
in reverse; launches queued behind a GPU sleep).  Prints the card's line,
then one JSON line per (variant, width, G, threads) with its blocks an SM,
its ptxas registers and spills and both rounds, and one line per (variant,
width) naming the fastest shape.  Exits 1 if a shape's outputs differ from
the port's launch, 2 without a card.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess

THREADS = (32, 64, 128, 256)
WIDTHS = "512,1024,2048,4096,8192,16384,32768,65536"
# The sweep's source for one group: hot_step.cu's kernel and launch
# templates, and C entry points that launch the float explicit instance of
# the group in the block size asked for, or give its blocks an SM (-1: no
# such block size).
WRAPPER = r"""
#define HOT_STEP_SWEEP
#include "@SRC@"

namespace {
constexpr int SWEEP_G = @G@;
template <bool kRef>
int sweep_at(int threads, int what, void **ptrs, const double *scal, int n, void *stream) {
  switch (threads) {
#define SWEEP_CASE(TH)                                                           \
  case TH:                                                                       \
    return what ? blocks_per_sm_g<kRef, float, SWEEP_G, TH, false>()             \
                : launch_hot_g<kRef, float, SWEEP_G, TH, false>(ptrs, scal, n, stream);
    SWEEP_CASE(32)
    SWEEP_CASE(64)
    SWEEP_CASE(128)
    SWEEP_CASE(256)
  }
  return -1;
}
}  // namespace

extern "C" int hot_step_sweep_launch(int ref, int threads, void **ptrs, const double *scal,
                                     int n, void *stream) {
  return ref ? sweep_at<true>(threads, 0, ptrs, scal, n, stream)
             : sweep_at<false>(threads, 0, ptrs, scal, n, stream);
}
extern "C" int hot_step_sweep_blocks_per_sm(int ref, int threads) {
  return ref ? sweep_at<true>(threads, 1, nullptr, nullptr, 0, nullptr)
             : sweep_at<false>(threads, 1, nullptr, nullptr, 0, nullptr);
}
"""


def ptxas(log):
    """{(reference, group, threads): {registers, spill bytes}} of the sweep
    instances in nvcc's -Xptxas -v output."""
    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*hot_step_kernelILb([01])EfLi(\d+)ELi(\d+)E",
                      line)
        if m:
            key = (m.group(1) == "1", int(m.group(2)), int(m.group(3)))
            out[key] = {}
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and "spill_stores" not in out[key]:
            out[key].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and "registers" not in out[key]:
            out[key]["registers"] = int(m.group(1))
    return out


def build(src_path, groups, build_dir, flags):
    """{G: (loaded library, ptxas usage)} of the sweep builds of ``src_path``."""
    jobs = {}
    for g in groups:
        cu = os.path.join(build_dir, f"sweep_hot_shape_g{g}.cu")
        with open(cu, "w") as f:
            f.write(WRAPPER.replace("@SRC@", os.path.abspath(src_path)).replace("@G@", str(g)))
        so = cu[:-3] + ".so"
        jobs[g] = (so, subprocess.Popen(["nvcc", *flags, "-o", so, cu], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    libs = {}
    for g, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for G = {g}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.hot_step_sweep_launch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_void_p]
        lib.hot_step_sweep_launch.restype = ctypes.c_int
        lib.hot_step_sweep_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.hot_step_sweep_blocks_per_sm.restype = ctypes.c_int
        libs[g] = (lib, ptxas(log))
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=None, help="the hot_step.cu to build (default ours)")
    ap.add_argument("--widths", default=WIDTHS)
    ap.add_argument("--groups", default="1,2,4,8")
    args = ap.parse_args(argv)
    import torch

    from grmonty_tpu_torch.tools import card, require_cuda, validate_accuracy
    from grmonty_tpu_torch.tools.clock_hot_step import device_us
    from grmonty_tpu_torch.transport import driver, hot_kernels, profiles

    require_cuda("sweep_hot_shape")
    print(card(), flush=True)
    hot_kernels.build()
    src_path = args.source or os.path.join(hot_kernels.CSRC_DIR, "hot_step.cu")
    os.makedirs(hot_kernels.BUILD_DIR, exist_ok=True)
    groups = [int(g) for g in args.groups.split(",")]
    libs = build(src_path, groups, hot_kernels.BUILD_DIR, hot_kernels.NVCC_FLAGS)
    dt = torch.float32
    sim = driver.Simulation(validate_accuracy._torus(256, 256), photon_n=20000,
                            mass_unit=4.0e19, seed=123, device="cuda",
                            config=profiles.bench_config(pool=65536, dtype=dt))
    mc, tabs, dev = sim.mc, sim.tables, sim.device
    shapes = [(g, t) for g in groups for t in THREADS if t >= g]
    differ = []
    for reference in (False, True):
        name = hot_kernels.entry_point("hot_step", dt, reference)
        ours = hot_kernels._Build.fns[name]

        def shaped(g, t, _ref=int(reference)):
            fn = libs[g][0].hot_step_sweep_launch
            return lambda ptrs, sc, n, stream: fn(_ref, t, ptrs, sc, n, stream)

        for n in (int(w) for w in args.widths.split(",")):
            cfg = (profiles.reference_config(pool=n, dtype=dt, stall_steps=50000)
                   if reference else sim.cfg._replace(n_pool=n))
            lanes = hot_kernels.synthetic_lanes(mc, n, 2024, cfg.stall_steps, reference,
                                                events=True)
            pool, counters, u_roul, u_x1, bias = hot_kernels.synthetic_step(lanes, dt, dev)

            def step():
                c = counters._replace(**{k: getattr(counters, k).clone()
                                         for k in hot_kernels.CENSUS})
                return hot_kernels.step_outputs(
                    *hot_kernels.hot_step(pool, c, u_roul, u_x1, bias, mc, tabs, cfg),
                    reference)

            want_f, want_c = step()
            want = hot_kernels._flat(want_f)
            recs = {}
            try:
                for g, t in shapes:
                    hot_kernels._Build.fns[name] = shaped(g, t)
                    got_f, got_c = step()
                    got = hot_kernels._flat(got_f)
                    fields = sorted(f for f in want
                                    if not bool(hot_kernels._same_bits(want[f], got[f]).all()))
                    recs[(g, t)] = {
                        "name": name, "n": n, "group": g, "threads": t,
                        "blocks_per_sm": libs[g][0].hot_step_sweep_blocks_per_sm(
                            int(reference), t),
                        "ptxas": libs[g][1].get((reference, g, t)),
                        "bitwise": not fields and got_c == want_c, "differ": fields,
                        "device_us": []}
                for order in (shapes, shapes[::-1]):
                    for g, t in order:
                        hot_kernels._Build.fns[name] = shaped(g, t)
                        recs[(g, t)]["device_us"].append(device_us(
                            lambda: hot_kernels.hot_step(pool, counters, u_roul, u_x1, bias,
                                                         mc, tabs, cfg)))
            finally:
                hot_kernels._Build.fns[name] = ours
            for rec in recs.values():
                print(json.dumps(rec), flush=True)
                if not rec["bitwise"]:
                    differ.append((name, n, rec["group"], rec["threads"]))
            best = min(recs.values(), key=lambda r: sum(r["device_us"]))
            print(json.dumps({"name": name, "n": n, "fastest": [best["group"], best["threads"]],
                              "device_us": sum(best["device_us"]) / 2,
                              "port": hot_kernels.hot_step_shape(name, n)}), flush=True)
    if differ:
        raise SystemExit(f"sweep_hot_shape: not bit for bit the port's launch: {differ}")


if __name__ == "__main__":
    main()
