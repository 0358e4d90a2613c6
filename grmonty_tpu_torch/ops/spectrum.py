"""Spectrum post-processing and the text report (numpy).

Port of ``grmonty_tpu/ops/spectrum.py`` (reference ``report_spectrum``,
``harm_model.cpp:416-471``): 200 rows of 1 + 6*6 columns, the same format.
"""

import math

import numpy as np

from grmonty_tpu_torch import consts

DN_DLE, DE_DLE, NPH, NSCATT, X1I_AV, X2I_SQ, X3F_SQ, TAU_ABS, TAU_SCATT = range(9)


def _d_omega(x2i, x2f, h_slope):
    def mu(x2):
        return np.cos(math.pi * x2 + 0.5 * (1.0 - h_slope) * np.sin(2.0 * math.pi * x2))

    return 2.0 * math.pi * (mu(x2i) - mu(x2f))


def spectrum_rows(spec, mc):
    """Physical per-bin quantities (N_TH_BINS, N_E_BINS) from the raw
    accumulators, plus the luminosity and the max mean scattering depth."""
    s = np.asarray(spec)[: consts.N_TH_BINS * consts.N_E_BINS]
    s = s.reshape(consts.N_TH_BINS, consts.N_E_BINS, -1)

    dx2 = (mc.x_stop[2] - mc.x_start[2]) / (2.0 * consts.N_TH_BINS)
    j = np.arange(consts.N_TH_BINS)
    d_omega = 2.0 * _d_omega(j * dx2, (j + 1) * dx2, mc.h_slope)

    nu_lnu = (
        (consts.ME * consts.CL**2)
        * (4.0 * math.pi / d_omega)[:, None]
        / consts.spectrum.D_L_E
        * s[:, :, DE_DLE]
        / consts.L_SUN
    )
    denom = s[:, :, DN_DLE] + consts.EPS
    tau_scatt = s[:, :, TAU_SCATT] / denom
    luminosity = float((nu_lnu * d_omega[:, None] * consts.spectrum.D_L_E).sum())
    return {
        "nu_lnu": nu_lnu,
        "tau_abs": s[:, :, TAU_ABS] / denom,
        "tau_scatt": tau_scatt,
        "x1i_av": s[:, :, X1I_AV] / denom,
        "x2i_rms": np.sqrt(np.abs(s[:, :, X2I_SQ] / denom)),
        "x3f_rms": np.sqrt(np.abs(s[:, :, X3F_SQ] / denom)),
        "luminosity": luminosity,
        "max_tau_scatt": float(tau_scatt.max()),
        "raw": s,
    }


def format_spectrum(spec, mc) -> str:
    """Render the reference's text format (harm_model.cpp:433-464)."""
    rows = spectrum_rows(spec, mc)
    out = []
    for i in range(consts.N_E_BINS):
        cols = ["%10.5g " % ((i * consts.spectrum.D_L_E + consts.spectrum.L_E_0)
                             / math.log(10.0))]
        for j in range(consts.N_TH_BINS):
            for name in ("nu_lnu", "tau_abs", "tau_scatt", "x1i_av", "x2i_rms", "x3f_rms"):
                cols.append("%10.5g " % rows[name][j, i])
        out.append("".join(cols))
    return "\n".join(out) + "\n"


def write_spectrum(path, spec, mc):
    with open(path, "w") as fh:
        fh.write(format_spectrum(spec, mc))
    return spectrum_rows(spec, mc)
