"""Physical constants used by the primitive-equation residuals.

Values match the reference exactly: Omega (dataset/physics_dataset.py:522),
R_d / R_v / c_p / L (interface/interface_physics.py:126,146,177).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PhysicalConstants:
    omega: float = 7.29e-5  # Earth's angular velocity [1/s]
    r_d: float = 287.0  # dry-air gas constant [J/(kg K)]
    r_v: float = 461.5  # water-vapor gas constant [J/(kg K)]
    c_p: float = 1005.0  # isobaric specific heat of dry air [J/(kg K)]
    latent_heat: float = 2.5e6  # latent heat of vaporization [J/kg]
    eps_rho: float = 1e-6  # denominator guard (interface_physics.py:140,171)


DEFAULT_CONSTANTS = PhysicalConstants()
