"""Derived meteorological products from pressure-level fields.

The port's own copy of ``deepphysinet_tpu/utils/products.py`` (numpy only, unchanged), so that
the port imports nothing of the JAX package.

Port of ProductsUtils (utils/downscale_utils.py:91-480): given the basic
variables (u, v, w, z, T, q) on a pressure-level stack, derive
rh / rho / wind speed / slp / sst / t2 / td2 / rh2 / 10 m & 100 m winds via
Lagrange polynomial interpolation over geopotential height (``interp_z``,
:403-431) and the standard moist-thermodynamics formulas (:228-334).

The reference wires these to a stale 4-D (x, y, p, t) model variant
(``model.forward_single(var_name, input_samples)`` -- SURVEY Q5); here the
data source is pluggable: pass a ``gather_fn(var_name) -> [P, H, W]`` (e.g. a
neural-field sweep over pressure levels, or raw reanalysis arrays).  All math
is numpy/JAX-agnostic elementwise code; ``smooth2d`` replaces wrf-python's
9-point smoother with an identical explicit kernel.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

R_D = 287.0


def smooth2d(field: np.ndarray, passes: int = 3, cenweight: float = 4.0) -> np.ndarray:
    """wrf-python-style 9-point smoother: center weight ``cenweight``, edge 1."""
    f = np.asarray(field, dtype=np.float64)
    kernel = np.ones((3, 3), np.float64)
    kernel[1, 1] = cenweight
    kernel /= kernel.sum()
    for _ in range(passes):
        padded = np.pad(f, 1, mode="edge")
        out = np.zeros_like(f)
        for dy in range(3):
            for dx in range(3):
                out += kernel[dy, dx] * padded[dy : dy + f.shape[0], dx : dx + f.shape[1]]
        f = out
    return f


def lagrange_interp_z(
    height,
    z: np.ndarray,
    data: np.ndarray,
    selected_levels: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Lagrange-polynomial interpolation of ``data`` to ``height`` using ``z``
    as the vertical coordinate (downscale_utils.py:403-431).

    z, data: [P, H, W]; height: scalar or [H, W]; returns [H, W].
    """
    z = np.asarray(z, np.float64)
    data = np.asarray(data, np.float64)
    if selected_levels is not None:
        sel = list(selected_levels)
        z = z[sel]
        data = data[sel]
    n = z.shape[0]
    height = np.broadcast_to(np.asarray(height, np.float64), z.shape[1:])

    out = np.zeros(z.shape[1:], np.float64)
    for k in range(n):
        basis = np.ones(z.shape[1:], np.float64)
        for j in range(n):
            if j == k:
                continue
            basis *= (height - z[j]) / (z[k] - z[j])
        out += basis * data[k]
    return out


class ProductsUtils:
    """Derived products with the reference's API surface.

    ``gather_fn(var_name)`` must return [P, H, W] physical-unit arrays for the
    basic variables 'u', 'v', 'w', 'z', 'T', 'q'.
    """

    AVAILABLE = (
        "u", "v", "w", "z", "T", "q", "rh", "rio",
        "slp", "sst", "t2", "td2", "rh2", "u10m", "v10m", "u100m", "v100m",
        "wd10m", "wd",
    )

    def __init__(
        self,
        gather_fn: Callable[[str], np.ndarray],
        press_levels: Sequence[float],
        altitude: np.ndarray,  # terrain height [H, W], meters
        smooth_passes: int = 3,
    ):
        self.gather_fn = gather_fn
        self.press_levels = list(press_levels)
        self.altitude = np.asarray(altitude, np.float64)
        self.smooth_passes = smooth_passes
        self._cache: Dict[str, np.ndarray] = {}
        # derived-intermediate memo (per forward() call, like _cache): rh
        # stacks, t2, raw rh2 and height-interpolated winds are shared by
        # several products (td2 needs t2+rh2, wd10m needs u10m/v10m/w) and
        # the Lagrange interp + 9-point smoother dominate runtime on real
        # grids — identical values, computed once.
        self._derived: Dict = {}

    # ---- plumbing ----

    def check_available(self, opt_variables: Sequence[str]) -> None:
        for name in opt_variables:
            parts = name.split("_")
            if len(parts) not in (1, 2):
                raise ValueError(f"{name} format not supported")
            if parts[0] not in self.AVAILABLE:
                raise NotImplementedError(f"{parts[0]} not supported")

    def _gather(self, var_name: str) -> np.ndarray:
        if var_name not in self._cache:
            self._cache[var_name] = np.asarray(self.gather_fn(var_name), np.float64)
        return self._cache[var_name]

    def _memo(self, key, fn) -> np.ndarray:
        if key not in self._derived:
            self._derived[key] = fn()
        return self._derived[key]

    def _select_level(self, data: np.ndarray, params: Optional[str]) -> np.ndarray:
        if params is None:
            return data
        p = float(params[1:]) * 100.0  # 'p850' -> 85000 Pa
        p_id = self.press_levels.index(p)
        return smooth2d(data[p_id], self.smooth_passes, cenweight=4)

    def forward(self, opt_variables: List[str]) -> Dict[str, np.ndarray]:
        """Compute the requested products (downscale_utils.py:157-198)."""
        self.check_available(opt_variables)
        self._cache.clear()
        self._derived.clear()
        out: Dict[str, np.ndarray] = {}
        for name in opt_variables:
            parts = name.split("_")
            var_name = parts[0]
            params = parts[1] if len(parts) == 2 else None
            if var_name in ("u", "v", "w", "z", "T", "q"):
                out[name] = self._select_level(self._gather(var_name), params) \
                    if params else self._gather(var_name)
            else:
                out[name] = getattr(self, f"forward_{var_name}")(params=params)
        self._cache.clear()
        self._derived.clear()
        return out

    # ---- products (formulas from downscale_utils.py:228-401) ----

    def _press_col(self) -> np.ndarray:
        return np.reshape(np.asarray(self.press_levels, np.float64), (-1, 1, 1))

    def forward_rh(self, params=None) -> np.ndarray:
        def _stack():
            T = self._gather("T")
            q = self._gather("q")
            e = q * self._press_col() / 0.622
            t = T - 273.15
            E = 611.2 * np.exp(17.67 * t / (t + 243.5))
            return e * 100.0 / E
        rh = self._memo(("rh",), _stack)
        return self._select_level(rh, params) if params else rh

    def forward_rio(self, params=None) -> np.ndarray:
        T = self._gather("T")
        q = self._gather("q")
        rio = self._press_col() / (1 + 0.608 * q) / T / R_D
        return self._select_level(rio, params) if params else rio

    def forward_wd(self, params=None) -> np.ndarray:
        u, v, w = self._gather("u"), self._gather("v"), self._gather("w")
        wd = np.sqrt(u**2 + v**2 + w**2)
        return self._select_level(wd, params) if params else wd

    def forward_slp(self, params=None) -> np.ndarray:
        z = self._gather("z")
        press = np.broadcast_to(self._press_col(), z.shape)
        slp = lagrange_interp_z(0.0, z, press, selected_levels=range(min(5, len(z))))
        return smooth2d(slp, self.smooth_passes, cenweight=4)

    def forward_sst(self, params=None) -> np.ndarray:
        z, T = self._gather("z"), self._gather("T")
        sst = lagrange_interp_z(0.0, z, T, selected_levels=range(min(5, len(z))))
        return smooth2d(sst, self.smooth_passes, cenweight=4)

    def forward_t2(self, params=None) -> np.ndarray:
        def _t2():
            z, T = self._gather("z"), self._gather("T")
            t2 = lagrange_interp_z(self.altitude + 2, z, T,
                                   selected_levels=range(min(5, len(z))))
            return smooth2d(t2, self.smooth_passes, cenweight=4)
        return self._memo(("t2",), _t2)

    def _rh2_raw(self) -> np.ndarray:
        """Unsmoothed 2 m relative humidity (shared by rh2 and td2)."""
        def _raw():
            rh = self.forward_rh()
            z = self._gather("z")
            return lagrange_interp_z(self.altitude + 2, z, rh,
                                     selected_levels=range(min(5, len(z))))
        return self._memo(("rh2_raw",), _raw)

    def forward_rh2(self, params=None) -> np.ndarray:
        return smooth2d(self._rh2_raw(), self.smooth_passes, cenweight=4)

    def forward_td2(self, params=None) -> np.ndarray:
        """2 m dew point via the Magnus formula (downscale_utils.py:352-372).

        Faithful to the reference: td2 is built from the SMOOTHED t2 but the
        UNSMOOTHED rh2 interp (forward_td2 never applies smooth2d to its rh2,
        downscale_utils.py:311-327, while forward_rh2 does at :337)."""
        t2 = self.forward_t2()
        rh2 = self._rh2_raw()
        a, b = 17.27, 237.7
        t = t2 - 273.15
        gamma = a * t / (b + t) + np.log(rh2 / 100 + 1e-16)
        return b * gamma / (a - gamma) + 273.15

    def _wind_at(self, var: str, height_above_ground: float) -> np.ndarray:
        def _wind():
            z = self._gather("z")
            u = self._gather(var)
            data = lagrange_interp_z(
                self.altitude + height_above_ground, z, u,
                selected_levels=range(min(5, len(z)))
            )
            return smooth2d(data, self.smooth_passes, cenweight=4)
        return self._memo(("wind", var, float(height_above_ground)), _wind)

    def forward_u10m(self, params=None) -> np.ndarray:
        return self._wind_at("u", 10)

    def forward_v10m(self, params=None) -> np.ndarray:
        return self._wind_at("v", 10)

    def forward_u100m(self, params=None) -> np.ndarray:
        return self._wind_at("u", 100)

    def forward_v100m(self, params=None) -> np.ndarray:
        return self._wind_at("v", 100)

    def forward_wd10m(self, params=None) -> np.ndarray:
        u = self._wind_at("u", 10)
        v = self._wind_at("v", 10)
        w = self._wind_at("w", 10)
        return smooth2d(np.sqrt(u**2 + v**2 + w**2), self.smooth_passes, cenweight=4)
