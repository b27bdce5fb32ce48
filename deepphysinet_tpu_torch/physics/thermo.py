"""Moist thermodynamics helpers (metpy replacements for the ETL tools).

The port's own copy of ``deepphysinet_tpu/physics/thermo.py`` (numpy only, unchanged), so that
the port imports nothing of the JAX package.

``specific_humidity_from_dewpoint`` reproduces metpy's computation chain
(saturation vapor pressure via the Bolton/Magnus form consistent with
``get_qs`` at interface_physics.py:181-185, then mixing ratio -> specific
humidity), so ETL output matches the reference's preprocessed datasets to
within the formula's intrinsic approximation.
"""

from __future__ import annotations

import numpy as np

EPSILON = 0.622  # Rd/Rv


def saturation_vapor_pressure(temperature_k: np.ndarray) -> np.ndarray:
    """e_s in Pa (Bolton 1980 / Magnus, the same form as the training engine)."""
    t = np.asarray(temperature_k, np.float64) - 273.15
    return 611.2 * np.exp(17.67 * t / (t + 243.5))


def mixing_ratio(partial_pressure: np.ndarray, total_pressure: np.ndarray) -> np.ndarray:
    return EPSILON * partial_pressure / (total_pressure - partial_pressure)


def specific_humidity_from_dewpoint(pressure_pa: np.ndarray, dewpoint_k: np.ndarray) -> np.ndarray:
    """q [kg/kg] from dew point and pressure (replaces metpy's function)."""
    e = saturation_vapor_pressure(dewpoint_k)
    w = mixing_ratio(e, np.asarray(pressure_pa, np.float64))
    return w / (1.0 + w)


def dewpoint_from_specific_humidity(pressure_pa: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Inverse of the above (useful for product export round trips)."""
    q = np.asarray(q, np.float64)
    w = q / (1.0 - q)
    e = np.asarray(pressure_pa, np.float64) * w / (EPSILON + w)
    ln = np.log(e / 611.2)
    return 243.5 * ln / (17.67 - ln) + 273.15
