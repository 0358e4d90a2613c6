"""The port's spectrum plotter (``grmonty_tpu_torch/plot_spectrum.py``)
against the JAX package's, on one spectrum file.

A seeded synthetic spectrum is written in the reference's text format by the
port's ``ops/spectrum.write_spectrum``; the port's ``load_spectrum`` equals
JAX ``plot_spectrum.load_spectrum`` on it exactly (both are numpy on the
same text), the command line writes a PNG through the Agg backend, and
importing the module loads no matplotlib (the machine with the card has
none).
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from grmonty_tpu_torch import consts, plot_spectrum
from grmonty_tpu_torch.ops import spectrum

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def spec_file(tmp_path_factory):
    rng = np.random.default_rng(20)
    n = consts.N_TH_BINS * consts.N_E_BINS
    spec = rng.uniform(0.0, 1.0, (n + 1, 16)) * (rng.uniform(size=(n + 1, 1)) < 0.7)
    mc = types.SimpleNamespace(x_start=(0.0, 0.3, 0.0, 0.0), x_stop=(1.0, 3.5, 1.0, 6.28),
                               h_slope=0.3)
    path = str(tmp_path_factory.mktemp("spec") / "spectrum")
    spectrum.write_spectrum(path, spec, mc)
    return path


def test_load_spectrum_equals_the_jax_plotters(spec_file):
    from grmonty_tpu import plot_spectrum as jplot

    log_nu, nu_lnu, extras = plot_spectrum.load_spectrum(spec_file)
    j_log_nu, j_nu_lnu, j_extras = jplot.load_spectrum(spec_file)
    assert nu_lnu.shape == (consts.N_TH_BINS, consts.N_E_BINS)
    assert np.array_equal(log_nu, j_log_nu) and np.array_equal(nu_lnu, j_nu_lnu)
    assert set(extras) == set(j_extras)
    for k in extras:
        assert np.array_equal(extras[k], j_extras[k]), k
    assert (nu_lnu > 0).any()


def test_command_line_writes_a_png(spec_file, tmp_path):
    png = tmp_path / "spectrum.png"
    plot_spectrum.main(["--spectrum_path", spec_file, "--plot_path", str(png), "--i_bin", "2"])
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_import_loads_no_matplotlib():
    code = ("import sys, grmonty_tpu_torch.plot_spectrum; "
            "print(any(m.split('.')[0] == 'matplotlib' for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
