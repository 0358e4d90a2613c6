"""The port's command line (``python -m grmonty_tpu_torch``) on the CPU.

It keeps the reference's five flags with the JAX command line's defaults,
writes the reference's 200 x 37 spectrum with ``--device cpu`` (the engine,
and ``--backend cpu``, the native tracker, under ``--profile_dir``'s
profiler), deletes its ``--checkpoint``
after a completed run, takes float64 on the card (it stops only where no
card is found), and refuses a checkpoint of the native tracker.
"""

import os
import subprocess
import sys

import pytest
import torch

from grmonty_tpu_torch import cli, consts
from grmonty_tpu_torch.models import torus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIVE = ("photon_n", "mass_unit", "harm_dump_path", "spectrum_path", "verbosity")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pools of a few hundred lanes: intra-op threads only add overhead, and
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return str(path)


def _small(dump, spectrum):
    return ["--harm_dump_path", dump, "--photon_n", "30", "--mass_unit", "4e18",
            "--pool", "256", "--spectrum_path", spectrum, "--verbosity", "warn"]


def _assert_spectrum(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == consts.N_E_BINS
    assert all(len(line.split()) == 1 + consts.N_TH_BINS * 6 for line in lines)


def test_five_flags_keep_the_jax_defaults():
    from grmonty_tpu import cli as jcli

    mine = cli.build_parser().parse_args(["--harm_dump_path", "d"])
    ref = jcli.build_parser().parse_args(["--harm_dump_path", "d"])
    for flag in FIVE + ("pool", "seed", "checkpoint", "profile_dir", "backend"):
        assert getattr(mine, flag) == getattr(ref, flag), flag
    assert (mine.device, mine.dtype, mine.reference) == ("cuda", "float32", False)


def test_module_writes_a_spectrum_on_the_cpu(dump, tmp_path):
    spec = str(tmp_path / "spectrum")
    out = subprocess.run([sys.executable, "-m", "grmonty_tpu_torch", "--device", "cpu",
                          *_small(dump, spec)], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    _assert_spectrum(spec)


def test_backend_cpu_runs_the_native_tracker(dump, tmp_path):
    spec, trace = str(tmp_path / "spectrum"), tmp_path / "trace"
    assert cli.main(["--device", "cpu", "--backend", "cpu", "--dtype", "float64",
                     "--profile_dir", str(trace), *_small(dump, spec)]) == 0
    _assert_spectrum(spec)
    assert (trace / "trace.json").stat().st_size > 0


def test_checkpoint_flag_runs_and_cleans_up(dump, tmp_path):
    spec, ck = str(tmp_path / "spectrum"), str(tmp_path / "run.ck")
    assert cli.main(["--device", "cpu", "--reference", "--checkpoint", ck,
                     *_small(dump, spec)]) == 0
    _assert_spectrum(spec)
    assert not os.path.exists(ck)


@pytest.mark.parametrize("extra,message", [
    # float64 on the default device (the card) passes the dtype check and
    # stops only at the missing card
    (["--dtype", "float64"], "^no CUDA device"),
    (["--device", "cpu", "--backend", "cpu", "--checkpoint", "x"], "--checkpoint applies"),
])
def test_refusals(dump, tmp_path, monkeypatch, extra, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=message):
        cli.main([*extra, *_small(dump, str(tmp_path / "spectrum"))])
