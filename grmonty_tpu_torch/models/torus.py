"""Synthetic HARM torus snapshot generator.

Port of ``grmonty_tpu/models/torus.py``: a smooth hot torus (peak near
r = 12 GM/c^2, near-Keplerian rotation, mild inflow, poloidal field at
plasma beta ~ 10) written in the exact HARM text format.  The diagnostic
columns (u_con, g_det) come from the port's own ``ops.fluid``.
"""

import math

import numpy as np
import torch

from grmonty_tpu_torch.models import harm

A_SPIN = 0.9375
H_SLOPE = 0.3
GAMMA_AD = 13.0 / 9.0
R_OUT = 40.0


def _grid(n1, n2):
    r_h = 1.0 + math.sqrt(1.0 - A_SPIN * A_SPIN)
    r_in = 0.98 * r_h  # grid starts just inside the horizon, as HARM does
    x1_start = math.log(r_in)
    dx1 = (math.log(R_OUT) - x1_start) / n1
    dx2 = 1.0 / n2
    x1 = x1_start + (np.arange(n1) + 0.5) * dx1
    x2 = (np.arange(n2) + 0.5) * dx2
    return x1_start, dx1, dx2, x1, x2


def torus_primitives(n1=256, n2=256):
    """Analytic torus primitives + header on an (n1, n2) MKS grid."""
    x1_start, dx1, dx2, x1, x2 = _grid(n1, n2)
    X1, X2 = np.meshgrid(x1, x2, indexing="ij")
    r = np.exp(X1)
    th = math.pi * X2 + 0.5 * (1.0 - H_SLOPE) * np.sin(2.0 * math.pi * X2)

    w = r * np.sin(th)  # cylindrical radius
    z = r * np.cos(th)

    r_peak, sig_r, h_over_r = 12.0, 0.45, 0.3
    rho = np.exp(
        -0.5 * (np.log(np.maximum(w, 1e-10) / r_peak) / sig_r) ** 2
        - 0.5 * (z / (h_over_r * np.maximum(w, 1e-10))) ** 2
    )
    rho = np.where(r < 2.2, 0.0, rho) + 1.0e-7  # atmosphere floor

    # u/rho ~ 0.02 in the core: theta_e ~ 4.5 with theta_e_unit ~ 224.
    u = rho * 0.02 * np.exp(-0.5 * (np.log(np.maximum(w, 1e-10) / r_peak) / (2 * sig_r)) ** 2)
    u = np.maximum(u, 1.0e-9)

    disk = rho / (rho.max())
    v_phi = 1.0 / (r ** 1.5 + A_SPIN) * np.clip(disk * 20.0, 0.0, 1.0)
    v_r = -0.3 * np.exp(-r / 4.0)
    u_1 = v_r
    u_2 = np.zeros_like(v_r)
    u_3 = v_phi

    # Poloidal field from A_phi ~ max(rho/rho_max - 0.2, 0).
    a_phi = np.maximum(disk - 0.2, 0.0)
    b_1 = np.zeros_like(a_phi)
    b_2 = np.zeros_like(a_phi)
    b_1[:, 1:-1] = -(a_phi[:, 2:] - a_phi[:, :-2]) / (2.0 * dx2)
    b_2[1:-1, :] = (a_phi[2:, :] - a_phi[:-2, :]) / (2.0 * dx1)
    b_sq = (b_1**2 + (math.pi * b_2) ** 2) * r * r
    p_gas = (GAMMA_AD - 1.0) * u
    beta_target = 10.0
    scale = math.sqrt(
        max(2.0 * p_gas.max() / (beta_target * max(b_sq.max(), 1e-30)), 0.0)
    )
    b_1 *= scale
    b_2 *= scale
    b_3 = np.zeros_like(b_1)

    header = harm.Header()
    header.t = 1000.0
    header.n = (n1, n2)
    header.x_start = (0.0, x1_start, 0.0, 0.0)
    header.dx = (1.0, dx1, dx2, 2.0 * math.pi)
    header.x_stop = (1.0, x1_start + n1 * dx1, n2 * dx2, 2.0 * math.pi)
    header.t_final = 2000.0
    header.n_step = 12345
    header.a = A_SPIN
    header.gamma = GAMMA_AD
    header.courant = 0.9
    header.dt_dump = 100.0
    header.dt_log = 1.0
    header.dt_img = 100.0
    header.dt_rdump = 100
    header.cnt_dump = 19
    header.cnt_img = 19
    header.cnt_rdump = 10
    header.dt = 0.01
    header.lim = 0
    header.failed = 0
    header.r_in = math.exp(x1_start)
    header.r_out = R_OUT
    header.h_slope = H_SLOPE
    header.r_0 = 0.0

    data = harm.Data(rho, u, u_1, u_2, u_3, b_1, b_2, b_3)
    return header, data


def write_torus_dump(filepath, n1=256, n2=256):
    """Generate a torus and write it as a HARM dump, with the diagnostic
    columns (u_con, g_det) filled so bias_norm comes out right."""
    from grmonty_tpu_torch.ops import fluid

    header, data = torus_primitives(n1, n2)
    units = harm.make_units(4.0e19)
    units.theta_e_unit = harm.theta_e_unit(header.gamma)
    model = harm.HARMModel(header=header, data=data, units=units,
                           bias_norm=1.0, rh=1.0,
                           x1_min=math.log(1.0 + math.sqrt(1.0 - header.a**2)))
    mc = fluid.make_model_consts(model)._replace(
        d_tau_k=1.0, max_tau_scatt0=1.0)

    cpu = torch.device("cpu")
    _, g_cov, g_con, g_det = fluid.precompute_zone_geometry(mc, cpu)
    prims = torch.as_tensor(data.stacked(), dtype=torch.float64)
    fs = fluid.get_fluid_zone(prims, g_cov, g_con, mc)

    n_cells = n1 * n2
    extras = np.zeros((n_cells, 22))
    extras[:, 1:5] = fs.u_con.reshape(n_cells, 4).numpy()  # cols 13..16
    extras[:, 21] = g_det.reshape(n_cells).numpy()  # col 33
    harm.write_dump(filepath, header, data, extras)
    return header, data
