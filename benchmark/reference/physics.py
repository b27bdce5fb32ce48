"""The physical side of the reference: normalization, the six residuals and the losses.

The inverse normalization is ``value * std + mean``, clipped to the configured bounds for
pressure, temperature, humidity and density (never for the two wind components).  The residuals
are the atmospheric primitive equations of the DeepPhysiNet paper (momentum in u and v with the
Coriolis term, continuity, energy, water vapour, the gas law), with the saturation humidity (Tetens),
the ascent-and-saturation switch and the vapour factor held out of the gradient, as the paper's
code holds them.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

OBS_ORDER = ("u10", "v10", "pres", "t2", "q2", "rio")
CLIPPED = (False, False, True, True, True, True)
OMEGA = 7.29e-5
R_D, R_V, C_P, LATENT, EPS_RHO = 287.0, 461.5, 1005.0, 2.5e6, 1e-6
TERMS = ("montion_u_loss", "montion_v_loss", "continous_loss", "energy_loss", "vapor_loss", "gas_loss")
FACTORS = ("motion_u_factor", "motion_v_factor", "continuous_factor", "energy_factor", "vapor_factor",
           "gas_factor")


def norm_columns(config: Mapping, device):
    """(mean [6], std [6], lo [6], hi [6]) in the output order, float32."""
    obs = config["obs_norm_cfg"]
    mean = torch.tensor([float(obs[k]["norm_factor"][0]) for k in OBS_ORDER], dtype=torch.float32, device=device)
    std = torch.tensor([float(obs[k]["norm_factor"][1]) for k in OBS_ORDER], dtype=torch.float32, device=device)
    inf = float("inf")
    lo = torch.tensor([float(obs[k]["bound"][0]) if c else -inf for k, c in zip(OBS_ORDER, CLIPPED)],
                      dtype=torch.float32, device=device)
    hi = torch.tensor([float(obs[k]["bound"][1]) if c else inf for k, c in zip(OBS_ORDER, CLIPPED)],
                      dtype=torch.float32, device=device)
    return mean, std, lo, hi


def to_physical(out_norm: torch.Tensor, config: Mapping) -> torch.Tensor:
    """[N, 6] normalized -> [N, 6] physical, with the clip."""
    mean, std, lo, hi = norm_columns(config, out_norm.device)
    return torch.clamp(out_norm * std + mean, min=lo, max=hi)


def coriolis(lat_deg: torch.Tensor) -> torch.Tensor:
    return 2.0 * OMEGA * torch.sin(lat_deg / 180.0 * torch.pi)


def residuals(fields: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor, dt: torch.Tensor,
              f: torch.Tensor):
    """fields [N, 6] physical (u, v, p, T, q, rho), their derivatives along x, y, t, and the
    Coriolis parameter [N] -> the six residuals, each [N]."""
    u, v, p, T, q, rho = fields.unbind(-1)

    def D(i):  # the advective derivative of variable i
        return dt[:, i] + u * dx[:, i] + v * dy[:, i]

    r_u = D(0) + dx[:, 2] / rho - f * v
    r_v = D(1) + dy[:, 2] / rho + f * u
    r_c = D(5) + rho * (dx[:, 0] + dy[:, 1])
    dp, dq = D(2), D(4)
    r_e = C_P * D(3) - dp / (rho + EPS_RHO) + LATENT * dq
    tc = T - 273.15
    e_s = 6.112 * torch.exp(17.67 * tc / (tc + 243.5)) * 100.0
    q_s = torch.clamp((0.622 * e_s / (p - 0.378 * e_s)).detach(), min=1e-6)
    delta = ((dp < 0) & (q >= q_s)).float().detach()
    factor = (LATENT * (1.0 + 0.608 * q) * R_D - C_P * R_V * T) / (C_P * R_V + T * T + LATENT ** 2 * q_s)
    factor = (factor * q_s * T).detach()
    r_q = -dp * delta * factor / (p + EPS_RHO) + dq
    r_g = p - rho * (1.0 + 0.608 * q) * R_D * T
    return (r_u, r_v, r_c, r_e, r_q, r_g)


def smooth_l1_sum(pred: torch.Tensor, target: torch.Tensor, beta: float) -> torch.Tensor:
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).sum()


def factors(config: Mapping) -> Dict[str, float]:
    return {k: float(v) for k, v in config["train_cfg"]["losses"]["loss_factor"].items()}
