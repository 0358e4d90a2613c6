"""Plot a spectrum file.

Port of ``grmonty_tpu/plot_spectrum.py``: :func:`load_spectrum` parses the
reference's text format (``ops/spectrum.write_spectrum``) with numpy, and
:func:`plot` draws nu L_nu per inclination bin with matplotlib's Agg
backend.  matplotlib is imported inside :func:`plot` only, so nothing else
of the port needs it (the machine with the card has none).  Usage:

    python -m grmonty_tpu_torch.plot_spectrum --spectrum_path spectrum \\
        --plot_path spectrum.png [--i_bin 3]
"""

import argparse
import math

import numpy as np

from grmonty_tpu_torch import consts

ME_C2 = consts.ME * consts.CL * consts.CL


def load_spectrum(path):
    """A spectrum text file -> (log10 nu, nu L_nu [th_bin, e_bin] in L_sun,
    {"tau_abs", "tau_scatt"} per bin).

    Each row (harm_model.cpp:433-455): log10(E / m_e c^2), then 6 columns
    per inclination bin: nuLnu / L_sun, tau_abs, tau_scatt, x1i_av,
    x2i_rms, x3f_rms."""
    data = np.loadtxt(path)
    log_nu = data[:, 0] + math.log10(ME_C2 / consts.HPL)
    n_bins = (data.shape[1] - 1) // 6
    nu_lnu = np.stack([data[:, 1 + 6 * j] for j in range(n_bins)], axis=0)
    extras = {
        "tau_abs": np.stack([data[:, 2 + 6 * j] for j in range(n_bins)]),
        "tau_scatt": np.stack([data[:, 3 + 6 * j] for j in range(n_bins)]),
    }
    return log_nu, nu_lnu, extras


def plot(spectrum_path, plot_path, i_bin=-1):
    """Draw log10 nu L_nu [erg/s] against log10 nu for inclination bin
    ``i_bin`` (every bin at -1) into ``plot_path`` (Agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    log_nu, nu_lnu, _ = load_spectrum(spectrum_path)
    fig, ax = plt.subplots(figsize=(7, 5))
    for j in (range(nu_lnu.shape[0]) if i_bin < 0 else [i_bin]):
        mask = nu_lnu[j] > 0
        ax.plot(log_nu[mask], np.log10(nu_lnu[j][mask] * consts.L_SUN), label=f"bin {j}")
    ax.set_xlabel(r"$\log_{10} \nu$ [Hz]")
    ax.set_ylabel(r"$\log_{10} \nu L_\nu$ [erg/s]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(plot_path, dpi=150)
    plt.close(fig)


def main(argv=None):
    parser = argparse.ArgumentParser(description="plot a spectrum file")
    parser.add_argument("--spectrum_path", type=str, required=True)
    parser.add_argument("--plot_path", type=str, required=True)
    parser.add_argument("--i_bin", type=int, default=-1,
                        help="inclination bin to plot (-1 = all)")
    args = parser.parse_args(argv)
    plot(args.spectrum_path, args.plot_path, args.i_bin)
    print(f"wrote {args.plot_path}")


if __name__ == "__main__":
    main()
