"""Resume and command line of the port's sharded run (CPU, gloo ranks), on
the 64x32 torus.

* A two-rank run stopped after two waves on every rank
  (``run_sharded(fail_after_waves=2)``) leaves one checkpoint per rank; a
  resume at world size 4 is refused on every rank before any collective
  and leaves them; the resume at world size 2 reproduces the uninterrupted
  run (the spectrum to rtol 1e-6, on the CPU to every bit, the counts
  exactly, the phase counts that the rank files carry among them) and
  deletes them.
* ``python -m grmonty_tpu_torch --devices 2 --device cpu`` runs two gloo
  ranks and writes the reference's 200 x 37 spectrum; ``--backend cpu``,
  ``--checkpoint`` and ``--profile_dir`` with ``--devices 2`` are refused
  with the JAX command line's reasons (the last is the port's own).
"""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

from grmonty_tpu_torch import cli, consts
from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.parallel import sharding
from grmonty_tpu_torch.transport import profiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dump") / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    return path


def _kwargs():
    # step caps cut to 5000 to bound the CPU drain; 128-photon chunks: the
    # ramp and whole waves on each rank
    cfg = profiles.bench_config(pool=256, dtype=torch.float64)._replace(
        m_period=8, sec_cap=4096, stall_steps=5000)
    return dict(photon_n=30, mass_unit=4.0e18, config=cfg, emit_chunk=128, warmup=128,
                tail_stall_steps=5000)


def test_sharded_resume_reproduces_the_uninterrupted_run(dump, tmp_path):
    spec_ref, stats_ref = sharding.run_sharded(dump, 2, "cpu", **_kwargs())
    assert stats_ref["waves"] >= 2 * 4  # the crash lands inside the ramp

    ck = str(tmp_path / "resume.npz")
    with pytest.raises(ProcessRaisedException, match="stopped after 2 waves"):
        sharding.run_sharded(dump, 2, "cpu", checkpoint_path=ck, fail_after_waves=2,
                             **_kwargs())
    files = sorted(glob.glob(ck + ".rank*"))
    assert files == [ck + ".rank0", ck + ".rank1"]

    with pytest.raises(ProcessRaisedException, match="world size \\[2\\]; this run has 4"):
        sharding.run_sharded(dump, 4, "cpu", checkpoint_path=ck, **_kwargs())
    assert sorted(glob.glob(ck + ".rank*")) == files

    spec, stats = sharding.run_sharded(dump, 2, "cpu", checkpoint_path=ck, **_kwargs())
    np.testing.assert_allclose(spec, spec_ref, rtol=1e-6, atol=0)
    for key in ("n_created", "n_recorded", "n_scatt_recorded", "n_tracked", "hot_iters",
                "n_secondary_dropped", "n_stall_killed", "full_phases", "light_phases"):
        assert stats[key] == stats_ref[key], key
    assert stats["pilot"] is None and stats_ref["pilot"]["photons"] == 128
    assert not glob.glob(ck + ".rank*"), "a completed run must delete the checkpoints"


@pytest.mark.parametrize("extra,reason", [
    (["--backend", "cpu"], "scalar tracker has no sharded mode"),
    (["--checkpoint", "ck.npz"], "not supported with --devices>1"),
    (["--profile_dir", "prof"], "traces one process"),
])
def test_cli_refuses_what_the_sharded_run_has_not(extra, reason):
    with pytest.raises(SystemExit, match=reason):
        cli.main(["--harm_dump_path", "d", "--device", "cpu", "--devices", "2", *extra])


def test_cli_devices_runs_gloo_ranks_on_the_cpu(dump, tmp_path):
    spectrum = str(tmp_path / "spectrum")
    cmd = [sys.executable, "-m", "grmonty_tpu_torch", "--harm_dump_path", dump,
           "--devices", "2", "--device", "cpu", "--dtype", "float64", "--photon_n", "30",
           "--pool", "256", "--mass_unit", "4e18", "--spectrum_path", spectrum,
           "--verbosity", "info"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "over 2 ranks" in out.stderr
    with open(spectrum) as f:
        lines = f.read().splitlines()
    assert len(lines) == consts.N_E_BINS
    assert all(len(line.split()) == 1 + consts.N_TH_BINS * 6 for line in lines)
