"""PyTorch port against the JAX package: the numpy modules that the evaluation tools use.

``physics/thermo.py``, ``utils/products.py`` (``smooth2d``, ``lagrange_interp_z`` and every product
of ``ProductsUtils``) and ``utils/coord_utils.py::CoordUtils`` are numpy in both packages, and the
port's are copies, so each output must equal the JAX package's bit for bit on the same seeded
inputs.
"""

import pickle

import numpy as np
import pytest

from deepphysinet_tpu.physics import thermo as jthermo
from deepphysinet_tpu.utils import coord_utils as jcoord
from deepphysinet_tpu.utils import products as jproducts

from deepphysinet_tpu_torch.physics import thermo as tthermo
from deepphysinet_tpu_torch.utils import coord_utils as tcoord
from deepphysinet_tpu_torch.utils import products as tproducts

PRESS = [100000.0, 92500.0, 85000.0, 70000.0, 50000.0]
PRODUCTS = ("u", "v", "w", "z", "T", "q", "rh", "rio", "wd", "slp", "sst", "t2", "td2", "rh2", "u10m", "v10m",
            "u100m", "v100m", "wd10m", "rh_p850", "T_p500", "wd_p700", "rio_p925", "u_p1000")


def _columns(seed: int, h: int = 9, w: int = 11):
    """Hydrostatic-ish pressure-level columns [5, h, w] and terrain [h, w], as
    tests/test_products_and_tools.py builds them."""
    rng = np.random.RandomState(seed)
    z = np.array([100.0, 750.0, 1450.0, 3000.0, 5600.0])[:, None, None] * np.ones((1, h, w))
    z = z + rng.randn(5, h, w) * 5
    fields = {"z": z, "T": 288.0 - 0.0065 * z + rng.randn(5, h, w), "q": 0.008 * np.exp(-z / 2500.0),
              "u": 5.0 + rng.randn(5, h, w), "v": -3.0 + rng.randn(5, h, w), "w": 0.1 * rng.randn(5, h, w)}
    return fields, np.abs(rng.rand(h, w)) * 200.0


@pytest.mark.parametrize("fn", ["saturation_vapor_pressure", "mixing_ratio", "specific_humidity_from_dewpoint",
                                "dewpoint_from_specific_humidity"])
def test_thermo_is_jax_bit_for_bit(fn):
    rng = np.random.RandomState(0)
    t = 230.0 + 70.0 * rng.rand(64)
    p = 5e4 + 5e4 * rng.rand(64)
    args = {"saturation_vapor_pressure": (t,), "mixing_ratio": (0.01 * p * rng.rand(64), p),
            "specific_humidity_from_dewpoint": (p, t), "dewpoint_from_specific_humidity": (p, 0.02 * rng.rand(64))}[fn]
    np.testing.assert_array_equal(getattr(tthermo, fn)(*args), getattr(jthermo, fn)(*args))
    assert tthermo.EPSILON == jthermo.EPSILON


@pytest.mark.parametrize("passes, cenweight", [(1, 4.0), (3, 4.0), (2, 1.0)])
def test_smooth2d_is_jax_bit_for_bit(passes, cenweight):
    f = np.random.RandomState(1).randn(13, 17) * 100.0
    np.testing.assert_array_equal(tproducts.smooth2d(f, passes, cenweight), jproducts.smooth2d(f, passes, cenweight))


@pytest.mark.parametrize("levels", [None, range(3), [0, 2, 4]])
def test_lagrange_interp_z_is_jax_bit_for_bit(levels):
    fields, alt = _columns(2)
    for height in (0.0, alt + 2.0, alt + 100.0):
        np.testing.assert_array_equal(tproducts.lagrange_interp_z(height, fields["z"], fields["T"], levels),
                                      jproducts.lagrange_interp_z(height, fields["z"], fields["T"], levels))


@pytest.mark.parametrize("smooth_passes", [3, 1])
def test_every_product_is_jax_bit_for_bit(smooth_passes):
    """All of ``ProductsUtils.AVAILABLE`` (and level selections of the basics and of rh, wd, rio) in
    one ``forward`` call, as the derive-products tool asks for them; the memo of shared
    intermediates (rh, t2, rh2, the 10 m winds) is the JAX class's."""
    fields, alt = _columns(3)
    assert tproducts.ProductsUtils.AVAILABLE == jproducts.ProductsUtils.AVAILABLE
    assert set(tproducts.ProductsUtils.AVAILABLE) <= {p.split("_")[0] for p in PRODUCTS}
    got = tproducts.ProductsUtils(fields.__getitem__, PRESS, alt, smooth_passes).forward(list(PRODUCTS))
    want = jproducts.ProductsUtils(fields.__getitem__, PRESS, alt, smooth_passes).forward(list(PRODUCTS))
    assert list(got) == list(want) == list(PRODUCTS)
    for k in PRODUCTS:
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("bad, error", [("xyz", NotImplementedError), ("rh_p850_x", ValueError)])
def test_products_reject_what_jax_rejects(bad, error):
    fields, alt = _columns(4)
    for module in (tproducts, jproducts):
        with pytest.raises(error):
            module.ProductsUtils(fields.__getitem__, PRESS, alt).forward([bad])


def test_coord_utils_is_jax_bit_for_bit(tmp_path):
    lon, lat = np.meshgrid(np.arange(72.0, 88.01, 0.25), np.arange(18.0, 27.01, 0.25))
    path = str(tmp_path / "coord.pickle")
    with open(path, "wb") as fp:
        pickle.dump((lon, lat), fp)
    t, j = tcoord.CoordUtils(path), jcoord.CoordUtils(path)
    assert (t.lat_size, t.lon_size) == (j.lat_size, j.lon_size) == lon.shape
    rng = np.random.RandomState(5)
    qlon, qlat = 70.0 + 20.0 * rng.rand(50), 17.0 + 11.0 * rng.rand(50)  # some outside the grid
    for a, b in zip(t.geo2xy(qlon, qlat), j.geo2xy(qlon, qlat)):
        np.testing.assert_array_equal(a, b)
    qx, qy = 300.0 * rng.rand(50), 150.0 * rng.rand(50)
    for size in (145, (145, 257), [37, 65]):
        for a, b in zip(t.xy2geo(qx, qy, size), j.xy2geo(qx, qy, size)):
            np.testing.assert_array_equal(a, b)
