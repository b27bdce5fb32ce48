"""Atmospheric primitive-equation residuals as pure functions of fields and derivatives.

Counterpart of ``deepphysinet_tpu/physics/equations.py``.  Each function maps
physical-unit fields (u, v, P, T, q, rho) and their space-time derivatives, as
dicts of ``[N, 1]`` columns, to the ``(diff_term, const_term)`` pair of one
governing equation, matching the reference formulas line by line:

* u momentum:  u_t + u u_x + v u_y + P_x/rho   = f v      (interface_physics.py:97-104)
* v momentum:  v_t + u v_x + v v_y + P_y/rho   = -f u     (:106-114)
* continuity:  rho_t + u rho_x + v rho_y + rho (u_x+v_y) = 0  (:116-124)
* energy:      c_p DT/Dt - (1/(rho+eps)) Dp/Dt + L Dq/Dt = 0  (:126-144)
* vapor:       Dq/Dt - delta F / (p+eps) Dp/Dt = 0, with q_s (Tetens), delta and
               F held out of the gradient (``detach()`` where the JAX package
               has ``stop_gradient`` and the reference ``.detach()``, :146-175)
* gas/state:   P = rho (1 + 0.608 q) R_d T               (:177-179)

The packed ``[6, N]`` form of the same equations is
``physics/engine.py::residual_losses_packed``.  The residual-sum kernels evaluate
them in device code, ``csrc/residual_equations.cuh``: the same formulas term by
term in the same order of operations, so a change here is made there too (the
on-card check holds the two together: the kernels against their plain versions,
which call this module).
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepphysinet_tpu_torch.physics.constants import DEFAULT_CONSTANTS, PhysicalConstants

Pair = Tuple[torch.Tensor, torch.Tensor]


def momentum_u_residual(fields, derivs, f, const: PhysicalConstants = DEFAULT_CONSTANTS) -> Pair:
    u, v, rho = fields["u"], fields["v"], fields["rio"]
    diff = derivs["u"]["t"] + u * derivs["u"]["x"] + v * derivs["u"]["y"] + derivs["p"]["x"] / rho
    return diff, f * v


def momentum_v_residual(fields, derivs, f, const: PhysicalConstants = DEFAULT_CONSTANTS) -> Pair:
    u, v, rho = fields["u"], fields["v"], fields["rio"]
    diff = derivs["v"]["t"] + u * derivs["v"]["x"] + v * derivs["v"]["y"] + derivs["p"]["y"] / rho
    return diff, -f * u


def continuity_residual(fields, derivs, const: PhysicalConstants = DEFAULT_CONSTANTS) -> Pair:
    u, v, rho = fields["u"], fields["v"], fields["rio"]
    d = derivs
    diff = (d["rio"]["t"] + u * d["rio"]["x"] + v * d["rio"]["y"]
            + rho * d["u"]["x"] + rho * d["v"]["y"])
    return diff, torch.zeros_like(diff)


def energy_residual(fields, derivs, const: PhysicalConstants = DEFAULT_CONSTANTS) -> Pair:
    u, v, rho = fields["u"], fields["v"], fields["rio"]
    d = derivs
    t_term = const.c_p * (d["T"]["t"] + u * d["T"]["x"] + v * d["T"]["y"])
    p_term = -(d["p"]["t"] + u * d["p"]["x"] + v * d["p"]["y"]) / (rho + const.eps_rho)
    q_term = const.latent_heat * (d["q"]["t"] + u * d["q"]["x"] + v * d["q"]["y"])
    diff = t_term + p_term + q_term
    return diff, torch.zeros_like(diff)


def saturation_specific_humidity(p: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Tetens formula, matching get_qs (interface_physics.py:181-185)."""
    t = T - 273.15
    e_s = 6.112 * torch.exp(17.67 * t / (t + 243.5)) * 100.0
    return 0.622 * e_s / (p - 0.378 * e_s)


def vapor_residual(fields, derivs, const: PhysicalConstants = DEFAULT_CONSTANTS) -> Pair:
    u, v, p, T, q = fields["u"], fields["v"], fields["p"], fields["T"], fields["q"]
    d = derivs
    dp = d["p"]["t"] + u * d["p"]["x"] + v * d["p"]["y"]
    dq = d["q"]["t"] + u * d["q"]["x"] + v * d["q"]["y"]

    q_s = saturation_specific_humidity(p, T).detach()
    q_s = torch.clamp(q_s, min=1e-6)
    # delta = 1 where the parcel is ascending-saturated (interface_physics.py:147-149)
    delta = torch.where((dp < 0) & (q >= q_s), torch.ones_like(dp), torch.zeros_like(dp)).detach()
    # F factor (interface_physics.py:151-155), as written there
    r_moist = (1.0 + 0.608 * q) * const.r_d
    f_fac = (const.latent_heat * r_moist - const.c_p * const.r_v * T) / (
        const.c_p * const.r_v + T * T + const.latent_heat**2 * q_s)
    f_fac = (f_fac * q_s * T).detach()

    p_term = -dp * delta * f_fac / (p + const.eps_rho)
    diff = p_term + dq
    return diff, torch.zeros_like(diff)


def gas_residual(fields, const: PhysicalConstants = DEFAULT_CONSTANTS) -> Pair:
    p, T, q, rho = fields["p"], fields["T"], fields["q"], fields["rio"]
    return p, rho * (1.0 + 0.608 * q) * const.r_d * T


def air_density(p: torch.Tensor, T: torch.Tensor, q: torch.Tensor, r_d: float = 287.0) -> torch.Tensor:
    """rho from the equation of state, matching calc_rio (interface_physics.py:265-268)
    exactly, including its inverted form."""
    return ((1.0 + 0.608 * q) * r_d * T / p).detach()
