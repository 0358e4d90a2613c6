"""The whole hot step: the port's plain composition (``engine.hot_step_plain``)
against the JAX package's own (``hot_step_shared``'s sequence of module
functions), the wrapper's dispatch on the CPU, and the fused CUDA kernel
against the plain version on the card, for the shipped profile and for
reference semantics.

Inputs are synthetic lane states from a numpy seed
(``hot_kernels.synthetic_lanes(events=True)``: the two phases' lanes plus
``occupied`` and the detached-event registers) and one set of uniforms,
handed to both packages.  Float64: floats agree to rtol 1e-10 (absolute
floor 1e-12 of the field's largest magnitude), masks, integers and every
census counter exactly.  Float32 (JAX traced with x64 off): masks and
integers differ on at most 0.1% of lanes and floats agree to rtol 1e-4 and
atol 1e-6 on the lanes where every mask agrees (``dl_shrink``'s ill
conditioning as in tests/test_torch_hot.py); each census count, a count of
such masks, within 0.1% of the lanes.  On the card the kernel is held to
the plain version on every lane under ``hot_kernels.KERNEL_TOLERANCE`` (the
weight within ``hot_kernels.weight_slack`` besides) and its census counters
exactly, in float32 and in float64, at 65,536, 4,096, 1,024, 512, 513 and
1 lanes and on each side of every width where the instance changes
(``hot_kernels.hot_step_shape`` of the dtype: the group of threads a lane up
to one width, the narrow one-thread-a-lane blocks up to another), so that a
group instance with a partial last block, a block of one lane and each
one-thread-a-lane instance are all held to the plain version.

JAX is imported inside the tests that compare with it, so that the card
test runs on a machine with only the port's dependencies:
``python -m pytest --noconftest -m cuda tests/test_torch_hot_step.py``.
"""

import collections
import types

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.models import harm, torus
from grmonty_tpu_torch.ops import fluid
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

N = 4096
SEMANTICS = ("shipped", "reference")
CENSUS = hot_kernels.CENSUS
EVENT_FIELDS = hot_kernels.EVENT_FIELDS


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """mc and the engine tables (float64) of a 64x32 torus."""
    path = str(tmp_path_factory.mktemp("dump") / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    model = harm.read_dump(path, 4e19)
    mc = fluid.make_model_consts(model)
    host = driver.build_host_tables(model, mc, 2000, torch.device("cpu"))
    return mc, driver.build_engine_tables(host, mc, torch.float64)


def _config(semantics, dtype, n=N):
    make = profiles.reference_config if semantics == "reference" else profiles.bench_config
    return make(pool=n, dtype=dtype)


def _lanes(mc, cfg, n=N, seed=7):
    return hot_kernels.synthetic_lanes(mc, n, seed, cfg.stall_steps, cfg.reference,
                                       events=True)


def _inputs(lanes, tabs, dtype, device="cpu"):
    """((pool, counters, u_roul, u_x1, bias_scale), tables) as torch on device."""
    tables = tabs._replace(**{f: getattr(tabs, f).to(device, dtype).contiguous()
                              for f in ("hc_coeffs", "corner_rows", "hot_tab")})
    return hot_kernels.synthetic_step(lanes, dtype, device), tables


def _jax_step(mc, tabs, cfg, lanes, census, x64):
    """The JAX package's hot step on ``lanes``, composed of its module
    functions as ``hot_step_shared`` composes them (engine.py:1561-1589):
    ``census``: the counters it starts from.  Returns ({field: numpy},
    {counter: int})."""
    import jax
    import jax.numpy as jnp

    from grmonty_tpu.transport import engine as jengine

    ref = cfg.reference
    dt = jnp.float64 if x64 else jnp.float32
    if ref:
        a_kw = dict(grow_cap=cfg.grow_cap, grow_rate=2.0, step_ctrl=0.0)
        b_kw = dict(derived=False, tau_cap=0.0, grown=None)
        tab = tabs.corner_rows
    else:
        a_kw = dict(grow_cap=cfg.grow_cap, grow_tau_cap=engine.GROW_TAU_CAP,
                    step_ctrl=engine.STEP_CTRL)
        b_kw = dict(derived=True, tau_cap=engine.GROW_TAU_CAP)
        tab = tabs.hot_tab

    def j(v):
        if isinstance(v, tuple):
            return tuple(j(c) for c in v)
        a = np.asarray(v)
        return jnp.asarray(a if a.dtype in (np.bool_, np.int32) else a.astype(dt))

    with jax.enable_x64(x64):
        s = {k: j(v) for k, v in lanes.items() if k != "bias_scale"}
        A = jengine.hot_phase_a(
            s["x"], s["k"], s["dkdlam"], s["e_0_s"], s["dl_shrink"], s["pend_dl"],
            s["pend_push"], s["at_event"], s["alive"], s["w"], s["record_pending"],
            s["u_roul"], mc, engine.FP_ITERS, engine.WEIGHT_MIN, engine.SHRINK_FLOOR,
            alpha_scatti=s["alpha_scatti"], bi=s["bi"], **a_kw)
        rows = jnp.asarray(tab.numpy().astype(dt))[A["z"]]
        B = jengine.hot_phase_b(
            rows, A["x"], A["k"], A["dkdlam"], A["e_0_s"], A["w"],
            s["alpha_scatti"], s["alpha_absi"], s["bi"], s["tau_abs"],
            s["tau_scatt"], s["interacting"], A["pend_dl"], A["pend_push"],
            s["sec_w"], s["n_step"], A["alive"], s["x"], s["k"], s["dkdlam"],
            s["e_0_s"], A["seg"], A["commit"], A["moving"], A["was_pend"],
            A["stopped"], s["u_x1"], jnp.asarray(lanes["bias_scale"], dt), mc,
            jnp.asarray(tabs.hc_coeffs.numpy().astype(dt)), tabs.k2_coeffs,
            engine.WEIGHT_MIN, cfg.stall_steps, **{"grown": A["grown"], **b_kw})
        dl_shrink_n = A["dl_shrink"]
        if not ref:
            dl_shrink_n = jnp.where(B["tau_over"] | B["entry_roll"],
                                    jnp.minimum(dl_shrink_n, 1.0), dl_shrink_n)
        p = dict(x=B["x"], k=B["k"], dkdlam=B["dkdlam"], e_0_s=B["e_0_s"],
                 dl_shrink=dl_shrink_n, pend_dl=B["pend_dl"], pend_push=B["pend_push"],
                 at_event=A["at_event"], w=B["w"], alive=B["alive"],
                 record_pending=A["record_pending"], tau_abs=B["tau_abs"],
                 tau_scatt=B["tau_scatt"], alpha_scatti=B["alpha_scatti"],
                 alpha_absi=B["alpha_absi"], bi=B["bi"], interacting=B["interacting"],
                 sec_w=B["sec_w"], n_step=B["n_step"], occupied=s["occupied"])
        if not ref:
            pre = types.SimpleNamespace(**{f: s[f] for f in EVENT_FIELDS})
            p.update(jengine._capture_events(
                pre, A["arrived"], A["at_event"], B["x"], B["k"], B["w"], B["sec_w"],
                B["alive"], B["alpha_scatti"], B["alpha_absi"], B["bi"], B["a_scf"],
                B["a_abf"], B["bf"], B["nu"]))
        start = collections.namedtuple("Census", CENSUS[:-1])(
            *[jnp.asarray(census[c], jnp.int64 if x64 else jnp.int32) for c in CENSUS[:-1]])
        c = jengine._util_counters(start, p["occupied"], A["moving"], A["commit"],
                                   p["at_event"])
        out_census = {f: int(getattr(c, f)) for f in CENSUS[:-1]}
        out_census["n_hc_clamp"] = census["n_hc_clamp"] + int(jnp.sum(B["hc_clamp"]))
        fields = hot_kernels.STEP_FIELDS + (() if ref else EVENT_FIELDS)
        out = {f: (tuple(np.asarray(v) for v in p[f]) if isinstance(p[f], tuple)
                   else np.asarray(p[f])) for f in fields}
    return out, out_census


def _as_torch(d):
    return {k: (tuple(torch.as_tensor(np.array(c)) for c in v) if isinstance(v, tuple)
                else torch.as_tensor(np.array(v))) for k, v in d.items()}


# The step controller's next factor reads error estimates that are
# differences of nearly equal float32 numbers (tests/test_torch_hot.py):
# against JAX in float32 it must agree to rtol on all but 1% of the lanes,
# and everywhere to 50%.
_F32_ILL_CONDITIONED = {"dl_shrink": (0.01, 0.5)}


def _f32_failures(ref, got, rtol=1e-4, atol=1e-6, mask_frac=1e-3):
    ref, got = hot_kernels._flat(ref), hot_kernels._flat(got)
    agree, fails = None, []
    for name, a in ref.items():
        if a.dtype.is_floating_point:
            continue
        same = a == got[name].to(a.dtype)
        if 1.0 - float(same.double().mean()) > mask_frac:
            fails.append(f"{name}: {int((~same).sum())} lanes differ")
        agree = same if agree is None else agree & same
    for name, a in ref.items():
        if not a.dtype.is_floating_point:
            continue
        a64, b64 = a[agree].double(), got[name][agree].double()
        ok = (torch.abs(a64 - b64) <= atol + rtol * torch.abs(a64)) | (
            torch.isnan(a64) & torch.isnan(b64))
        if name in _F32_ILL_CONDITIONED:
            frac, rel_max = _F32_ILL_CONDITIONED[name]
            rel = torch.abs(a64 - b64) / torch.clamp(torch.abs(a64), min=atol / rtol)
            if float((~ok).double().mean()) > frac or bool((rel > rel_max).any()):
                fails.append(f"{name}: {int((~ok).sum())} lanes beyond rtol {rtol}")
        elif not bool(ok.all()):
            fails.append(f"{name}: {int((~ok).sum())} lanes beyond rtol {rtol} atol {atol}")
    return fails


@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_step_matches_jax(setup, semantics, dtype):
    mc, tabs = setup
    cfg = _config(semantics, dtype)
    lanes = _lanes(mc, cfg)
    args, tables = _inputs(lanes, tabs, dtype)
    start = hot_kernels.step_outputs(*args[:2], cfg.reference)[1]
    q, c = engine.hot_step_plain(*args, mc, tables, cfg)
    got, got_census = hot_kernels.step_outputs(q, c, cfg.reference)
    ref, ref_census = _jax_step(mc, tabs, cfg, lanes, start, x64=dtype == torch.float64)
    if dtype == torch.float64:
        assert got_census == ref_census
        for name, g in hot_kernels._flat(got).items():
            r = hot_kernels._flat(_as_torch(ref))[name].numpy()
            g = g.numpy()
            if g.dtype.kind in "bi":
                assert np.array_equal(g, r.astype(g.dtype)), name
                continue
            fin = np.isfinite(r)
            scale = np.abs(r[fin]).max() if fin.any() else 0.0
            np.testing.assert_allclose(g, r, rtol=1e-10, atol=1e-12 * scale, err_msg=name)
    else:
        fails = _f32_failures(_as_torch(ref), got)
        assert not fails, fails
        for name in CENSUS:
            assert abs(got_census[name] - ref_census[name]) <= 1e-3 * N, name


def test_event_lanes_reach_every_capture_branch(setup):
    mc, tabs = setup
    cfg = _config("shipped", torch.float64)
    args, tables = _inputs(_lanes(mc, cfg), tabs, torch.float64)
    pool = args[0]
    q, _ = engine.hot_step_plain(*args, mc, tables, cfg)
    reached = dict(
        captured=q.ev_pending & ~pool.ev_pending,
        parked_behind_an_event=q.at_event & ~pool.at_event,
        doomed_parent_freed=pool.occupied & ~q.occupied,
        tau_over_or_entry_clamp=(q.dl_shrink == 1.0) & (pool.dl_shrink > 1.0),
    )
    missing = [k for k, v in reached.items() if not bool(v.any())]
    assert not missing, f"branches never reached: {missing}"


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_wrapper_takes_the_plain_version_on_cpu(setup, semantics):
    mc, tabs = setup
    cfg = _config(semantics, torch.float64)
    lanes = _lanes(mc, cfg)
    before = dict(hot_kernels.launches)
    args, tables = _inputs(lanes, tabs, torch.float64)
    q, c = hot_kernels.hot_step(*args, mc, tables, cfg)
    ref_q, ref_c = engine.hot_step_plain(*_inputs(lanes, tabs, torch.float64)[0], mc,
                                         tables, cfg)
    for name, v in hot_kernels._flat(q._asdict()).items():
        assert torch.equal(v, hot_kernels._flat(ref_q._asdict())[name]), name
    for name in CENSUS:
        assert torch.equal(getattr(c, name), getattr(ref_c, name)), name
    assert hot_kernels.launches == before
    pool, counters, u_roul, u_x1, bias = args
    meta = pool._replace(**{f: (tuple(t.to("meta") for t in v) if isinstance(v, tuple)
                                else v.to("meta")) for f, v in pool._asdict().items()})
    with pytest.raises(ValueError):
        hot_kernels.hot_step(meta, counters, u_roul.to("meta"), u_x1.to("meta"), bias, mc,
                             tables, cfg)


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_weight_slack_scales_with_the_steps_optical_depth(setup, semantics):
    """A weight off by rtol * (1 + d_tau) / 2 relative passes under
    ``weight_slack`` and fails without it where d_tau > 1; the slack is the
    weight's alone."""
    mc, tabs = setup
    cfg = _config(semantics, torch.float64)
    args, tables = _inputs(_lanes(mc, cfg), tabs, torch.float64)
    ref = hot_kernels.step_outputs(*engine.hot_step_plain(*args, mc, tables, cfg),
                                   cfg.reference)[0]
    tol = hot_kernels.KERNEL_TOLERANCE["hot_step_ref" if cfg.reference else "hot_step"]
    d_tau = hot_kernels.step_d_tau(args[0], ref)
    assert float(d_tau.max()) > 1.0
    slack = hot_kernels.weight_slack(args[0], ref, tol["rtol"])
    off = 1.0 + tol["rtol"] * 0.5 * (1.0 + d_tau)
    assert not hot_kernels.compare(ref, {**ref, "w": ref["w"] * off}, **tol, slack=slack)[3]
    assert hot_kernels.compare(ref, {**ref, "w": ref["w"] * off}, **tol)[3]
    tau = {**ref, "tau_abs": ref["tau_abs"] * off, "tau_scatt": ref["tau_scatt"] * off}
    assert hot_kernels.compare(ref, tau, **tol, slack=slack)[3]


def test_entry_point_follows_semantics_and_dtype():
    ep, f32, f64 = hot_kernels.entry_point, torch.float32, torch.float64
    names = [ep("hot_step", dt, ref) for dt in (f32, f64) for ref in (False, True)]
    assert names == ["hot_step", "hot_step_ref", "hot_step_f64", "hot_step_ref_f64"]
    assert (ep("row_gather", f32), ep("row_gather", f64)) == ("row_gather", "row_gather_f64")
    assert ep("row_gather", f64, reference=True) == "row_gather_f64"
    for name in names + ["row_gather", "row_gather_f64"]:
        assert name in hot_kernels.launches and name in hot_kernels._ABI
        assert name in hot_kernels.KERNEL_TOLERANCE
    for dt in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(ValueError, match="no kernel"):
            ep("hot_step", dt)
        with pytest.raises(ValueError, match="no kernel"):
            ep("row_gather", dt)
    with pytest.raises(ValueError):
        ep("gather_rowsum", f32)


def test_float64_tolerance_is_far_tighter_than_float32():
    for name in ("hot_step", "hot_step_ref"):
        t32, t64 = (hot_kernels.KERNEL_TOLERANCE[n] for n in (name, f"{name}_f64"))
        for key in ("rtol", "atol", "mask_frac"):
            assert t64[key] <= 1e-4 * t32[key], (name, key)
    assert hot_kernels.KERNEL_TOLERANCE["row_gather_f64"] == dict(rtol=0.0, atol=0.0,
                                                                  mask_frac=0.0)


@pytest.mark.parametrize("c", [3.0, 0.1, 24.0, 2.99792458e10, 1.0e-3])
def test_recip_is_read_per_dtype(c):
    """``tensor / c`` multiplies by the reciprocal in the tensor's type:
    float32's is the float32 quotient, float64's the double one, each kept
    under its own key."""
    r32 = hot_kernels._recip(c, "cpu", torch.float32)
    r64 = hot_kernels._recip(c, "cpu", torch.float64)
    assert r64 == 1.0 / c
    assert r32 == float(np.float32(1.0) / np.float32(c))
    assert hot_kernels._recip(c, "cpu", torch.float32) == r32
    assert hot_kernels._recip(c, "cpu") == r32  # float32 unless asked


def test_float64_scalars_carry_float64_reciprocals(setup):
    from grmonty_tpu_torch import consts

    mc, tabs = setup
    cs = (mc.dx[1], mc.dx[2], consts.E_TOL, consts.E_DRIFT_TOL)
    a64 = hot_kernels._a_scalars(mc, 8.0, "cpu", torch.float64)
    a32 = hot_kernels._a_scalars(mc, 8.0, "cpu", torch.float32)
    assert a64[-4:] == [1.0 / c for c in cs]
    assert a32[-4:] == [float(np.float32(1.0) / np.float32(c)) for c in cs]
    assert a64[:-4] == a32[:-4]
    b64 = hot_kernels._b_scalars(mc, 100, tabs.k2_coeffs, "cpu", torch.float64)
    assert b64[hot_kernels._B_SCAL_HEAD.index("inv_24")] == 1.0 / 24.0
    assert b64[hot_kernels._B_SCAL_HEAD.index("inv_cl")] == 1.0 / consts.CL
    b32 = hot_kernels._b_scalars(mc, 100, tabs.k2_coeffs, "cpu", torch.float32)
    assert b32[hot_kernels._B_SCAL_HEAD.index("inv_24")] == float(np.float32(1.0) / 24)
    cfg = _config("shipped", torch.float64)._replace(grow_cap=8.0, stall_steps=100)
    s64 = list(hot_kernels._hot_scalars(mc, tabs, cfg, "cpu", torch.float64))
    s32 = list(hot_kernels._hot_scalars(mc, tabs, cfg, "cpu", torch.float32))
    assert len(s64) == len(s32) == hot_kernels._HOT_NSCAL
    assert s64 == a64 + b64 + [mc.n_e_unit, mc.theta_e_unit]
    assert s32 == a32 + b32 + [mc.n_e_unit, mc.theta_e_unit]


@pytest.mark.cuda
@pytest.mark.parametrize("semantics", SEMANTICS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_fused_kernel_matches_plain_on_the_card(setup, semantics, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    mc, tabs = setup
    dev = torch.device("cuda")
    name = hot_kernels.entry_point("hot_step", dtype, semantics == "reference")
    widths = [65536, 4096, 1024, 512, 513, 1]
    for edge in _shape_edges(name):
        widths += [edge, edge + 1]
    for n in widths:
        cfg = _config(semantics, dtype, n)
        lanes = _lanes(mc, cfg, n, seed=11)
        n0 = hot_kernels.launches[name]
        args, tables = _inputs(lanes, tabs, dtype, dev)
        ref = engine.hot_step_plain(*args, mc, tables, cfg)
        got = hot_kernels.hot_step(*_inputs(lanes, tabs, dtype, dev)[0], mc, tables, cfg)
        torch.cuda.synchronize()
        assert hot_kernels.launches[name] == n0 + 1
        (ref_f, ref_c), (got_f, got_c) = (hot_kernels.step_outputs(*ref, cfg.reference),
                                          hot_kernels.step_outputs(*got, cfg.reference))
        tol = hot_kernels.KERNEL_TOLERANCE[name]
        slack = hot_kernels.weight_slack(args[0], ref_f, tol["rtol"])
        _, _, _, fails = hot_kernels.compare(ref_f, got_f, **tol, slack=slack)
        shape = hot_kernels.hot_step_shape(name, n)
        assert not fails, f"{name} at {n} lanes ({shape}): {fails}"
        assert got_c == ref_c, (n, shape)


def _shape_edges(name, widest=65536):
    """``hot_kernels.hot_step_shape_edges``: a group of threads a lane at
    one lane, one thread a lane at the pool's width, at least one edge."""
    edges = hot_kernels.hot_step_shape_edges(name, widest)
    first, last = (hot_kernels.hot_step_shape(name, n)["group"] for n in (1, widest))
    assert len(edges) >= 1 and first > 1 and last == 1, edges
    return edges


def test_clock_stamps_find_every_anchor():
    """``tools/clock_hot_step`` stamps the kernel at lines it must find:
    every segment's stamp (the surface wait, which every instance of both
    dtypes reaches, among them) and the counters' read-out land in the
    source, and a source without an anchor raises."""
    import os

    from grmonty_tpu_torch.tools import clock_hot_step

    with open(os.path.join(hot_kernels.CSRC_DIR, "hot_step.cu")) as f:
        src = f.read()
    out = clock_hot_step.stamped(src)
    for k in range(len(clock_hot_step.SEGMENTS)):
        assert f"STAMP({k}, " in out, k
    # the surface wait at the top level of the step loop, which every
    # instance of both dtypes reaches: float32 stamps it too
    assert f"\n    barrier_wait(hc_bar);\n    STAMP({clock_hot_step._WAIT}, 0.0);\n" in out
    assert "clk_read" in out and "g_clk[15]" in out
    with pytest.raises(ValueError, match="no anchor"):
        clock_hot_step.stamped(src.replace("  // ---- the census", "  // the census"))


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ab_matches_kernels_across_checkouts():
    """``chip_smoke.py --ab-hot-step`` matches a kernel of two checkouts by
    its name with the anonymous namespace's mangled name, which hashes the
    source's path, named alike (and only that), and compares outputs by
    their bits (-0.0 is not 0.0; NaN is NaN)."""
    cs = _chip_smoke()
    ours = ("_ZN46_GLOBAL__N__32540f45_13_fresh_init_cu_bb2114d917fresh_init_kernel"
            "ILb0EdLi1EEEvNS_9FreshPtrsIT0_EE")
    theirs = ours.replace("32540f45", "0f0e1d2c").replace("bb2114d9", "0a1b2c3d")
    assert cs.anon(ours) == cs.anon(theirs) != ours
    assert cs.anon(ours.replace("ILb0E", "ILb1E")) != cs.anon(theirs)
    a = torch.tensor([0.0, -0.0, float("nan"), 1.0])
    assert cs.bit_diff(a, a.clone()).tolist() == [False] * 4
    b = torch.tensor([-0.0, -0.0, float("nan"), 1.0])
    assert cs.bit_diff(a, b).tolist() == [True, False, False, False]
    assert cs.bit_diff(a.double(), b.double()).tolist() == [True, False, False, False]


def test_sweep_reads_each_instance_registers():
    """``tools/sweep_hot_shape`` reads the registers and spills of each
    float32 sweep instance (variant, group, threads) from ptxas's output."""
    from grmonty_tpu_torch.tools import sweep_hot_shape

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115hot_step_kernelILb0EfLi8E"
        "Li128ELb0EEEvNS_7HotPtrsIT0_EE' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_115hot_step_kernelILb0EfLi8E",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 120 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115hot_step_kernelILb1EfLi2E"
        "Li32ELb0EEEvNS_7HotPtrsIT0_EE' for 'sm_90a'",
        "    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 255 registers",
    ])
    got = sweep_hot_shape.ptxas(log)
    assert got == {(False, 8, 128): {"spill_stores": 0, "spill_loads": 0, "registers": 120},
                   (True, 2, 32): {"spill_stores": 4, "spill_loads": 8, "registers": 255}}


def test_sweep_source_reaches_the_launch_templates():
    """The sweep's generated source includes the kernel's file with the
    port's entry points left out and calls its launch templates as they are
    declared there."""
    import os
    import re

    from grmonty_tpu_torch.tools import sweep_hot_shape

    with open(os.path.join(hot_kernels.CSRC_DIR, "hot_step.cu")) as f:
        src = f.read()
    wrapper = sweep_hot_shape.WRAPPER.replace("@SRC@", "hot_step.cu").replace("@G@", "8")
    assert wrapper.startswith("\n#define HOT_STEP_SWEEP\n#include \"hot_step.cu\"")
    assert re.search(r"#ifndef HOT_STEP_SWEEP\nHOT_ENTRY\(hot_step, false, float\)", src)
    for fn in ("launch_hot_g", "blocks_per_sm_g"):
        assert re.search(r"template <bool kRef, typename T, int G, int THREADS, bool kDraw>\n"
                         rf"(cudaError_t|int) {fn}\(", src), fn
        assert f"{fn}<kRef, float, SWEEP_G, TH, false>(" in wrapper
