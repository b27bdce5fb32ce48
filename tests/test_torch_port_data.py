"""PyTorch port (deepphysinet_tpu_torch) against the JAX package: the host data layer.

The port keeps its own copies of the JAX package's numpy modules (``data/synthetic.py``,
``data/geotiff.py``, ``data/dataset.py``, the ``native`` binding): on the smoke configuration's
small synthetic tree they must write the same bytes, read the same values bit for bit, and index,
assemble and sample the same windows.
"""

import os
import types

import numpy as np
import pytest
import torch

from deepphysinet_tpu.config import Config
from deepphysinet_tpu.data import dataset as jds
from deepphysinet_tpu.data import geotiff as jgt
from deepphysinet_tpu.data import synthetic as jsyn

from deepphysinet_tpu_torch import native as tnative
from deepphysinet_tpu_torch.data import dataset as tds
from deepphysinet_tpu_torch.data import geotiff as tgt
from deepphysinet_tpu_torch.data import synthetic as tsyn
from deepphysinet_tpu_torch.data.window import Window

torch.set_num_threads(1)  # one thread per test process (see test_torch_port_slice.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_TREE = dict(n_init_times=3, bbox=(72.0, 18.0, 88.0, 27.0))  # configs/smoke_cpu_cfg.py's tree


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            out[os.path.relpath(path, root)] = path
    return out


def _rooted(data_cfg, old_root, new_root):
    """A dataset configuration with its paths moved from one tree's root to another's."""
    def move(v):
        if isinstance(v, str) and v.startswith(old_root):
            return new_root + v[len(old_root):]
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        return v
    return move(dict(data_cfg))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The smoke configuration, its tree written by the JAX package and the same tree by the port,
    and both packages' datasets (seeded) on their own trees."""
    jroot = str(tmp_path_factory.mktemp("jax_tree"))
    troot = str(tmp_path_factory.mktemp("port_tree"))
    old = os.environ.get("DPN_SMOKE_DATA")
    os.environ["DPN_SMOKE_DATA"] = jroot  # the configuration writes the JAX package's tree here
    try:
        cfg = Config.fromfile(os.path.join(REPO, "configs", "smoke_cpu_cfg.py"))["config"]
    finally:
        if old is None:
            del os.environ["DPN_SMOKE_DATA"]
        else:
            os.environ["DPN_SMOKE_DATA"] = old
    tsyn.ensure_synthetic_tree(troot, **SMOKE_TREE)
    data = cfg["train_cfg"]["train_data"]
    kw = dict(input_variable_cfg=cfg["variable_cfg"], out_variable_cfg=cfg["obs_norm_cfg"], dx=27000.0,
              dy=27000.0, seed=3)
    jd = jds.PhysicsDataset(**data, **kw)
    td = tds.PhysicsDataset(**_rooted(data, jroot, troot), **kw)
    return types.SimpleNamespace(cfg=cfg, jroot=jroot, troot=troot, jd=jd, td=td)


def test_synthetic_trees_are_byte_identical(trees):
    jf, tf = _files(trees.jroot), _files(trees.troot)
    assert sorted(jf) == sorted(tf) and len(jf) > 500
    for rel in jf:
        with open(jf[rel], "rb") as a, open(tf[rel], "rb") as b:
            assert a.read() == b.read(), rel
    # the field generator itself, at an odd shape and seed
    lon, lat = np.meshgrid(np.linspace(72, 80, 7), np.linspace(18, 22, 5))
    for name, levels in (("t2", 1), ("QQ", 5)):
        np.testing.assert_array_equal(tsyn._field(name, lon, lat, 7.5, levels, seed=4),
                                      jsyn._field(name, lon, lat, 7.5, levels, seed=4))


CODECS = [  # (compression, predictor, tiled, dtype)
    ("none", 1, False, np.float32), ("deflate", 1, True, np.float32), ("deflate", 3, False, np.float32),
    ("lzw", 1, False, np.float32), ("lzw", 3, True, np.float64), ("packbits", 1, True, np.float32),
    ("packbits", 2, False, np.int16), ("lzw", 2, True, np.uint8), ("deflate", 2, True, np.int32),
]


@pytest.mark.parametrize("compression, predictor, tiled, dtype", CODECS)
def test_geotiff_reads_are_bit_equal(tmp_path, compression, predictor, tiled, dtype):
    """Each package's writer is read by the other's reader; both write the same bytes."""
    rng = np.random.RandomState(7)
    img = (rng.randn(37, 29, 3) * 1000).astype(dtype) if np.dtype(dtype).kind != "u" else \
        rng.randint(0, 255, (37, 29, 3)).astype(dtype)
    geo = (72.0, 0.25, 0.0, 54.0, 0.0, -0.25)
    kw = dict(compression=compression, tiled=tiled, predictor=predictor, projection="EPSG:4326")
    if tiled:
        kw["tile_size"] = 16
    paths = {}
    for name, mod in (("jax", jgt), ("port", tgt)):
        paths[name] = str(tmp_path / f"{name}.tiff")
        mod.write_tiff(paths[name], img, geo, **kw)
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()
    for writer in paths.values():
        (a, ga), (b, gb) = tgt.read_tiff(writer), jgt.read_tiff(writer)
        assert a.dtype == b.dtype == img.dtype and ga == gb == geo
        np.testing.assert_array_equal(a, img)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tgt.read_full_image(writer), jgt.read_full_image(writer))
        assert tgt.get_projection(writer) == jgt.get_projection(writer) == "EPSG:4326"


def test_native_library_matches_jax():
    """The port's binding builds its own library from native/src/dpn_native.cc (never the JAX
    package's copy) and agrees with the JAX package's kernels; the numpy fallbacks agree too."""
    from deepphysinet_tpu import native as jnative

    assert tnative.available(), tnative.BUILD_ERROR
    assert tnative.library_path().startswith(os.path.join(REPO, "deepphysinet_tpu_torch"))
    rng = np.random.RandomState(8)
    cube = rng.randn(6, 10, 17, 5).astype(np.float32)
    lon, lat, t = rng.uniform(71.5, 88.5, 400), rng.uniform(17.5, 27.5, 400), rng.uniform(0, 24, 400)
    args = (cube, lon, lat, t, 72.0, 1.0, 18.0, 1.0, 0.0, 6.0)
    got = tnative.trilinear(*args)
    want = jnative.trilinear(*args)
    if jnative.available():  # one source, one compiler: the same bits
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    lat_g, lon_g, th = 18 + np.arange(10.0), 72 + np.arange(17.0), np.arange(5) * 6.0
    for v in range(6):  # the numpy fallback
        np.testing.assert_allclose(got[:, v], tds._np_trilinear(cube[v], lat_g, lon_g, th, lat, lon, t),
                                   rtol=1e-5, atol=1e-6)
    data = bytes(rng.randint(0, 4, 3000).astype(np.uint8))
    enc = jgt._lzw_encode(data)
    assert tnative.lzw_decode(enc, len(data)) == jnative.lzw_decode(enc, len(data)) == tgt._lzw_decode(enc) == data


def test_dataset_matches_jax(trees):
    from deepphysinet_tpu import native as jnative

    jd, td = trees.jd, trees.td
    both_native = jnative.available() and tnative.available()
    assert td.input_files == jd.input_files and len(td) == len(jd) >= 2
    np.testing.assert_array_equal(td.constant_variables, jd.constant_variables)
    for attr in ("in_lon", "in_lat", "out_lon", "out_lat"):
        np.testing.assert_array_equal(getattr(td, attr), getattr(jd, attr))
    assert (td.begin_lon, td.begin_lat, td.fine_lon_step, td.fine_lat_step) == (
        jd.begin_lon, jd.begin_lat, jd.fine_lon_step, jd.fine_lat_step)
    rng = np.random.RandomState(9)
    xs, ys = rng.rand(300) * 64, rng.rand(300) * 36
    ts = rng.rand(300) * 24
    for f in jd.input_files[:2]:
        assert td._parse_item(f) == jd._parse_item(f)
        np.testing.assert_array_equal(td.get_item_input(f), jd.get_item_input(f))
        np.testing.assert_array_equal(td._nwp_cube(f), jd._nwp_cube(f))
        np.testing.assert_array_equal(td.get_label_cube(f), jd.get_label_cube(f))
        for a, b in zip(td.get_margin_grid(f, xs, ys, ts), jd.get_margin_grid(f, xs, ys, ts)):
            assert a.shape == b.shape and a.dtype == b.dtype
            if both_native:  # one source, one compiler: the same bits
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)  # as test_window_matches_dataset


def test_dataset_draws_match_jax(trees):
    """Seeded ``__getitem__`` draws (margin and collocation points with their conditioning)."""
    jd, td = trees.jd, trees.td
    for item in (0, 1):
        a, b = td[item], jd[item]
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray) and a[k].dtype.kind == "f" and k not in ("field_data", "labels"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_window_from_port_dataset_matches_jax_dataset(trees):
    for f in trees.jd.input_files[:1]:
        a, b = Window.from_dataset(trees.td, f), Window.from_dataset(trees.jd, f)
        for field in ("field", "nwp_cube", "label_cube", "in_lon", "in_lat", "out_lon", "out_lat"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert (a.forecast_h, a.dx, a.dy, a.input_time_step, a.forecast_time_period) == (
            b.forecast_h, b.dx, b.dy, b.input_time_step, b.forecast_time_period)
        assert Window.from_dataset(trees.td, f, labels=False).label_cube is None


def test_coord_pickles_round_trip(tmp_path):
    from deepphysinet_tpu.ops import coords as jc
    from deepphysinet_tpu_torch.ops import coords as tc

    lon, lat = tc.make_latlon_grid(72.0, 18.0, 80.0, 22.0, 0.25)
    tc.save_coord_pickle(str(tmp_path / "t.pickle"), lon, lat)
    jc.save_coord_pickle(str(tmp_path / "j.pickle"), lon, lat)
    assert open(tmp_path / "t.pickle", "rb").read() == open(tmp_path / "j.pickle", "rb").read()
    for a, b in zip(tc.load_coord_pickle(str(tmp_path / "j.pickle")), jc.load_coord_pickle(str(tmp_path / "t.pickle"))):
        np.testing.assert_array_equal(a, b)
