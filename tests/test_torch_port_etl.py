"""PyTorch port (deepphysinet_tpu_torch) against the JAX package: the ETL codecs and tools.

The port keeps numpy-only copies of the JAX package's codecs (``data/netcdf_classic.py``,
``data/grib2.py``, ``data/hdf5_lite.py``) and its own ETL tools (``deepphysinet_tpu_torch/tools/``).
On the same bytes the two read the same arrays and attributes bit for bit, write the same bytes,
and the tools write the same rasters.  Where they differ on purpose the JAX behaviour is shown
beside the port's: the surface extraction that reads the ``_2m`` / ``_10m`` files (C45), and the
workers whose failures reach the exit code and that honour ``--sample_stride`` (C46).  Last, a raw
GRIB2 / NetCDF archive goes through the port's tools to ``PhysicsDataset`` and one training step.
"""

import datetime
import glob
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from deepphysinet_tpu.data import grib2 as jgrib2
from deepphysinet_tpu.data import hdf5_lite as jhdf5
from deepphysinet_tpu.data import netcdf_classic as jnc
from tools import calc_mean_std as jmeanstd
from tools import calc_rio as jrio
from tools import cvt_grib_to_nc as jcvt
from tools import extract_variable_from_ERA5 as jera5
from tools import extract_variable_from_nc as jextract
from tools import generate_input_map as jmap

from deepphysinet_tpu_torch.data import grib2 as tgrib2
from deepphysinet_tpu_torch.data import hdf5_lite as thdf5
from deepphysinet_tpu_torch.data import netcdf_classic as tnc
from deepphysinet_tpu_torch.data.geotiff import read_tiff
from deepphysinet_tpu_torch.data.raw_archive import write_era5_netcdf, write_gfs_grib2
from deepphysinet_tpu_torch.data.synthetic import generate_synthetic_dataset
from deepphysinet_tpu_torch.tools import calc_mean_std as tmeanstd
from deepphysinet_tpu_torch.tools import calc_rio as trio
from deepphysinet_tpu_torch.tools import cvt_grib_to_nc as tcvt
from deepphysinet_tpu_torch.tools import extract_variable_from_ERA5 as tera5
from deepphysinet_tpu_torch.tools import extract_variable_from_nc as textract
from deepphysinet_tpu_torch.tools import generate_input_map as tmap
from deepphysinet_tpu_torch.tools import run_etl

torch.set_num_threads(1)  # one thread per test process (see test_torch_port_slice.py)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_BBOX = (72.0, 18.0, 84.0, 22.0)  # a 5 x 13 input grid: enc_in 65, the dims of tests/test_train_step.py
INIT = datetime.datetime(2008, 1, 1)
SURFACE_VARS = (["sp", "t2m", "u10", "v10", "d2m"], ["PSFC", "t2", "u10", "v10", "q2"])


def _test_module(name):
    """A module of this directory by path (the producers and stubs that the JAX tests use)."""
    spec = importlib.util.spec_from_file_location(f"_etl_{name}", os.path.join(REPO, "tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root) for d, _, names in os.walk(root) for n in names)


def assert_same_tree(a, b, min_files=1):
    """The two directories hold the same files byte for byte; each GeoTIFF also read back with the
    same values and geo-transform."""
    fa = _files(a)
    assert fa == _files(b) and len(fa) >= min_files, (fa, _files(b))
    for rel in fa:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        with open(pa, "rb") as x, open(pb, "rb") as y:
            assert x.read() == y.read(), rel
        if rel.endswith(".tiff"):
            (ia, ga), (ib, gb) = read_tiff(pa), read_tiff(pb)
            assert ga == gb
            np.testing.assert_array_equal(ia, ib)


def assert_same_variables(tv, jv):
    """Two ``.variables`` mappings: names, dimensions, attributes and every read bit for bit."""
    assert list(tv) == list(jv)
    for name in jv:
        a, b = tv[name], jv[name]
        assert a.shape == b.shape and a.dtype == b.dtype and getattr(a, "dimensions", None) == getattr(
            b, "dimensions", None)
        assert list(a.attributes) == list(b.attributes)
        for k in b.attributes:
            np.testing.assert_array_equal(a.attributes[k], b.attributes[k])
        ra, rb = a[...] if a.shape else a[()], b[...] if b.shape else b[()]
        assert ra.dtype == rb.dtype
        np.testing.assert_array_equal(np.ma.getdata(ra), np.ma.getdata(rb))
        np.testing.assert_array_equal(np.ma.getmaskarray(ra), np.ma.getmaskarray(rb))
        if a.shape:
            assert float(np.ma.getdata(a[0]).ravel()[0]) == float(np.ma.getdata(b[0]).ravel()[0])
            np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))


# ---- the codecs -------------------------------------------------------------------------------------


@pytest.mark.parametrize("version", [1, 2])
def test_netcdf_classic_reads_equal(tmp_path, version):
    """scipy's writer (an independent producer): a record dimension, float, int and packed int16
    variables with scale, offset and fill, and attributes of each type."""
    rng = np.random.RandomState(version)
    path = str(tmp_path / "f.nc")
    f = netcdf_file(path, "w", version=version)
    f.history = b"written by scipy"
    f.createDimension("time", None)
    for name, n in (("step", 3), ("latitude", 5), ("longitude", 7)):
        f.createDimension(name, n)
    v = f.createVariable("time", "f8", ("time",))
    v[:] = 1.2e9 + 3600.0 * np.arange(2)
    v.units = b"seconds since 1970-01-01"
    f.createVariable("step", "i4", ("step",))[:] = [0, 6, 12]
    f.createVariable("latitude", "f4", ("latitude",))[:] = np.linspace(50, 10, 5)
    f.createVariable("longitude", "f4", ("longitude",))[:] = np.linspace(70, 140, 7)
    f.createVariable("sp", "f4", ("time", "step", "latitude", "longitude"))[:] = rng.rand(2, 3, 5, 7) * 2e4 + 9e4
    packed = rng.randint(-32766, 32767, (2, 3, 5, 7)).astype(np.int16)
    packed[0, 0, 0, :3] = -32767
    p = f.createVariable("t2m", "i2", ("time", "step", "latitude", "longitude"))
    p[:] = packed
    p.scale_factor, p.add_offset = np.float64(4.6e-4), np.float64(265.5)
    p._FillValue = p.missing_value = np.int16(-32767)
    f.createVariable("mask", "b", ("latitude", "longitude"))[:] = rng.randint(0, 2, (5, 7))
    f.close()
    a, b = tnc.NetCDFClassicFile(path), jnc.NetCDFClassicFile(path)
    assert a.dimensions == b.dimensions and a.attributes == b.attributes
    assert_same_variables(a.variables, b.variables)
    assert_same_variables(tnc.open_variables(path), jnc.open_variables(path))


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_hdf5_reads_equal(tmp_path, libver):
    """h5py's writer in both libver modes (tests/test_hdf5_lite.py's ERA5-shaped file: packed int16,
    shuffle + deflate chunks, a contiguous float variable)."""
    pytest.importorskip("h5py")
    path = str(tmp_path / f"era5_{libver}.nc")
    _test_module("test_hdf5_lite")._write_era5_like(path, libver)
    a, b = thdf5.HDF5LiteFile(path), jhdf5.HDF5LiteFile(path)
    assert list(a.datasets) == list(b.datasets)
    for name, ds in b.datasets.items():
        got = a.datasets[name]
        assert got.shape == ds.shape and got.dtype == ds.dtype and list(got.attributes) == list(ds.attributes)
        for k in ds.attributes:
            np.testing.assert_array_equal(got.attributes[k], ds.attributes[k])
        np.testing.assert_array_equal(got.read(), ds.read())
    assert_same_variables(thdf5.open_variables(path), jhdf5.open_variables(path))


def test_grib2_foreign_reads_equal(tmp_path):
    """The foreign GRIB2 bytes of tests/test_grib2_foreign.py (a producer that shares no code with
    the codec: D = 1, negative reference values, 12-bit packing, bitmaps, a repeated section group)."""
    path = str(tmp_path / "foreign.grib2")
    _test_module("test_grib2_foreign").build_foreign_file(path)
    ta, ja = tgrib2.read_messages(path), jgrib2.read_messages(path)
    assert len(ta) == len(ja) == 8
    for a, b in zip(ta, ja):
        for field in ("discipline", "param_category", "param_number", "ref_time", "forecast_hours",
                      "type_of_level", "level", "short_name"):
            assert getattr(a, field) == getattr(b, field), field
        for field in ("lat", "lon", "values"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    for keys in ({}, {"typeOfLevel": "isobaricInhPa"}, {"typeOfLevel": "heightAboveGround", "level": 2},
                 {"typeOfLevel": "surface", "level": 0}, {"shortName": "u10"}):
        a, b = tgrib2.load_dataset(path, keys), jgrib2.load_dataset(path, keys)
        assert sorted(a.data_vars) == sorted(b.data_vars) and (a.type_of_level, a.level) == (b.type_of_level, b.level)
        for name in ("time", "step", "latitude", "longitude"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        for name in b.data_vars:
            np.testing.assert_array_equal(a.data_vars[name], b.data_vars[name])


def test_writers_write_same_bytes(tmp_path):
    """``write_messages`` (with a bitmap field), ``GribDataset.to_netcdf`` and ``write_classic`` (every
    dtype and attribute type) write the JAX writers' bytes, and the port reads them back as JAX does."""
    rng = np.random.RandomState(0)
    lat, lon = np.linspace(30.0, 20.0, 11), np.linspace(100.0, 115.0, 16)

    def msg(mod, name_code, tol, level, fh, values):
        return mod.Grib2Message(discipline=0, param_category=name_code[0], param_number=name_code[1],
                                ref_time=INIT, forecast_hours=fh, type_of_level=tol, level=level, lat=lat,
                                lon=lon, values=values)

    fields = [((0, 0), "isobaricInhPa", 850.0, 6, 280 + 10 * rng.rand(11, 16)),
              ((3, 0), "surface", 0.0, 6, 9e4 + 2e3 * rng.rand(11, 16)),
              ((0, 6), "heightAboveGround", 2.0, 12, np.where(rng.rand(11, 16) > 0.2, 270 + rng.rand(11, 16), np.nan))]
    paths = {}
    for name, mod in (("port", tgrib2), ("jax", jgrib2)):
        paths[name] = str(tmp_path / f"{name}.grib2")
        mod.write_messages(paths[name], [msg(mod, *f) for f in fields], nbits=12)
    assert open(paths["port"], "rb").read() == open(paths["jax"], "rb").read()
    for keys in ({"typeOfLevel": "isobaricInhPa"}, {"typeOfLevel": "heightAboveGround", "level": 2}):
        for name, mod in (("port", tgrib2), ("jax", jgrib2)):
            mod.load_dataset(paths["port"], keys).to_netcdf(str(tmp_path / f"{name}.nc"))
        assert open(tmp_path / "port.nc", "rb").read() == open(tmp_path / "jax.nc", "rb").read()
        assert_same_variables(tnc.open_variables(str(tmp_path / "port.nc")),
                              jnc.open_variables(str(tmp_path / "jax.nc")))

    dims = {"time": 3, "latitude": 4, "longitude": 5, "nchar": 6}
    variables = [("time", ("time",), np.arange(3, dtype=np.int32), {"units": "hours since 1900-01-01"}),
                 ("latitude", ("latitude",), np.linspace(40, 37, 4), {"units": "degrees_north"}),
                 ("longitude", ("longitude",), np.linspace(100, 101, 5).astype(np.float32), None),
                 ("t2m", ("time", "latitude", "longitude"), rng.randint(-300, 300, (3, 4, 5)).astype(np.int16),
                  {"scale_factor": np.float64(0.01), "add_offset": np.float64(270.0), "_FillValue": np.int16(-32767),
                   "valid": np.array([1.5, 2.5], np.float32)}),
                 ("flag", ("latitude", "longitude"), rng.randint(-5, 5, (4, 5)).astype(np.int8), {"n": 7}),
                 ("label", ("nchar",), np.array(list(b"abcdef"), dtype="S1"), {})]
    for name, mod in (("port", tnc), ("jax", jnc)):
        mod.write_classic(str(tmp_path / f"{name}_w.nc"), dims, variables, {"title": "x", "version": np.int32(2)})
    assert open(tmp_path / "port_w.nc", "rb").read() == open(tmp_path / "jax_w.nc", "rb").read()
    assert_same_variables(tnc.open_variables(str(tmp_path / "port_w.nc")),
                          jnc.open_variables(str(tmp_path / "jax_w.nc")))


# ---- the tools ----------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A tiny synthetic tree (one init time, a 5 x 13 input grid, 17 x 49 labels) and its raw archive:
    one GRIB2 file and two ERA5 NetCDF-3 files (the port's ``raw_archive``)."""
    root = str(tmp_path_factory.mktemp("etl_raw"))
    paths = generate_synthetic_dataset(os.path.join(root, "tree"), n_init_times=1, bbox=TINY_BBOX)
    grib = write_gfs_grib2(paths, os.path.join(root, "grib"))
    era5 = write_era5_netcdf(paths, os.path.join(root, "era5"))
    return dict(root=root, paths=paths, grib=grib, era5=era5, grib_dir=os.path.dirname(grib[0]),
                era5_dir=os.path.dirname(era5[0]))


def _combined_surface_file(nc_dir, out):
    """The three surface files of one GRIB file as one netCDF file, as the JAX surface core reads it."""
    name = os.path.basename(out)[:-len("_surface.nc")]
    merged = {}
    for group in ("surface", "2m", "10m"):
        f = tnc.NetCDFClassicFile(os.path.join(nc_dir, f"{name}_{group}.nc"))
        for k, v in f.variables.items():
            merged.setdefault(k, (v.dimensions, np.asarray(v[...]), dict(v.attributes)))
    dims = dict(tnc.NetCDFClassicFile(os.path.join(nc_dir, f"{name}_surface.nc")).dimensions)
    tnc.write_classic(out, dims, [(k, d, a, at) for k, (d, a, at) in merged.items()])


def test_tools_write_same_files(raw, tmp_path):
    """Each tool's core from both packages on the raw archive, into two directories: the netCDF files
    and every raster (values and geo-transform) byte for byte, the statistics and the index."""
    out = {}
    for name, cvt, extract, era5, rio, meanstd, index in (
            ("jax", jcvt, jextract, jera5, jrio, jmeanstd, jmap),
            ("port", tcvt, textract, tera5, trio, tmeanstd, tmap)):
        root = str(tmp_path / name)
        nc, inputs, labels = f"{root}/nc", f"{root}/tree/NCEP", f"{root}/tree/labels"
        os.makedirs(nc)
        cvt.process_surface(raw["grib"], nc)
        cvt.process_pressure(raw["grib"], nc)
        pressure = sorted(os.path.join(nc, f) for f in os.listdir(nc) if f.endswith("_1000hpa.nc"))
        extract.process_pressure(pressure, nc, inputs)
        # the JAX surface core reads one file that holds all five variables (C45: not cvt's split)
        combined = f"{root}/combined/{os.path.basename(raw['grib'][0])[:-6]}_surface.nc"
        os.makedirs(os.path.dirname(combined))
        _combined_surface_file(nc, combined)
        extract.process_surface([combined], inputs, *SURFACE_VARS)
        era5.process(raw["era5"], labels, *SURFACE_VARS, INIT, INIT + datetime.timedelta(days=2), (17, 49))
        for d in (inputs, labels):
            rio.process(sorted(glob.glob(f"{d}/*/*_PSFC.tiff") + glob.glob(f"{d}/*_PSFC.tiff")))
        meanstd.process(inputs, meanstd.DEFAULT_VARS, f"{root}/tree/stats", sample_stride=2)
        out[name] = index.build_input_map(inputs, INIT, INIT, 12, lead_list=list(range(0, 25, 6)))
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "port"), min_files=8 + 50 + 5 * 25 + 5 + 25 + 11)
    assert out["jax"] == out["port"] and len(out["port"][0]) == 55 and out["port"][1] == []


def test_era5_tool_reads_netcdf4(raw, tmp_path):
    """The same hours as a netCDF-4 (HDF5) download, written by h5py: both packages' ERA5 cores write
    the same rasters."""
    h5py = pytest.importorskip("h5py")
    src = tnc.NetCDFClassicFile(raw["era5"][0])
    path = str(tmp_path / "era5_nc4.nc")
    with h5py.File(path, "w") as f:
        for name, v in src.variables.items():
            raw_values = v._raw()
            d = f.create_dataset(name, data=raw_values.astype(raw_values.dtype.newbyteorder("<")),
                                 chunks=raw_values.shape if raw_values.ndim < 3 else (4,) + raw_values.shape[1:],
                                 compression="gzip", shuffle=True)
            for k, a in v.attributes.items():
                d.attrs[k] = np.bytes_(a) if isinstance(a, str) else a
    outs = {}
    for name, era5 in (("port", tera5), ("jax", jera5)):
        outs[name] = str(tmp_path / name)
        era5.process([path], outs[name], *SURFACE_VARS, INIT, INIT + datetime.timedelta(days=2), None)
    assert_same_tree(outs["jax"], outs["port"], min_files=5 * 24)


def test_c45_surface_chain(raw, tmp_path):
    """C45: the JAX chain on one GRIB2 file stops at the surface extraction (its ``*_surface.nc`` holds
    ``sp`` alone); the port's writes all five variables, equal to the JAX extraction of the same
    fields from a stub (the stub of tests/test_products_and_tools.py)."""
    grib = raw["grib"][0]
    jax_nc, jax_out = str(tmp_path / "jax_nc"), str(tmp_path / "jax_out")
    os.makedirs(jax_nc)
    jcvt.process_surface([grib], jax_nc)
    surface = sorted(os.path.join(jax_nc, f) for f in os.listdir(jax_nc) if f.endswith("_surface.nc"))
    with pytest.raises(KeyError, match="t2m"):
        jextract.process_surface(surface, jax_out, *SURFACE_VARS)
    assert _files(jax_out) == [f"2008/GFS_2008-01-01-00-00-00_f{fh:03d}_PSFC.tiff" for fh in range(0, 25, 6)]

    port_nc, port_out = str(tmp_path / "port_nc"), str(tmp_path / "port_out")
    tcvt.main(["--data_path", raw["grib_dir"], "--result_path", port_nc])
    assert tcvt.main(["--data_path", raw["grib_dir"], "--result_path", port_nc]) == []  # outputs kept
    written = textract.main(["--data_path", port_nc, "--result_path", port_out])
    assert len(written) == 5 * 5

    stub_cls = _test_module("test_products_and_tools")._NCVar
    stub = {}
    for keys in ({"typeOfLevel": "surface", "level": 0}, {"typeOfLevel": "heightAboveGround", "level": 2},
                 {"typeOfLevel": "heightAboveGround", "level": 10}):
        ds = jgrib2.load_dataset(grib, keys)
        stub.update({k: stub_cls(v) for k, v in ds.data_vars.items()})
        stub.update(time=stub_cls(ds.time), step=stub_cls(ds.step))
    stub_out = str(tmp_path / "stub_out")
    jextract.process_surface(["x_surface.nc"], stub_out, *SURFACE_VARS, open_fn=lambda p: stub)
    assert_same_tree(stub_out, port_out, min_files=25)


def test_c46_workers(raw, tmp_path):
    """C46: with ``--num_threads 2`` each port tool writes what it writes with 0, byte for byte; a
    worker's exception ends the run with a non-zero exit; ``--sample_stride`` reaches the workers.
    The JAX tools' worker branches: the surface extraction's lambda writes nothing, a worker's
    exception exits 0, and the workers take a stride of 10 whatever ``--sample_stride`` says."""
    runs = {}
    for threads in (0, 2):
        root = str(tmp_path / f"t{threads}")
        th = ["--num_threads", str(threads)]
        nc, inputs, labels = f"{root}/nc", f"{root}/input/NCEP", f"{root}/labels"
        tcvt.main(["--data_path", raw["grib_dir"], "--result_path", nc] + th)
        tcvt.main(["--data_path", raw["grib_dir"], "--result_path", nc, "--pressure"] + th)
        textract.main(["--data_path", nc, "--result_path", inputs] + th)
        textract.main(["--data_path", nc, "--result_path", inputs, "--pressure"] + th)
        tera5.main(["--data_path", raw["era5_dir"], "--result_path", labels, "--start_time", "2008-01-01-00:00:00",
                    "--end_time", "2008-01-02-00:00:00"] + th)
        for d in (inputs, labels):
            trio.main(["--data_path", d] + th)
        runs[threads] = {stride: tmeanstd.main(["--data_path", labels, "--result_path", f"{root}/stats{stride}",
                                                "--sample_stride", str(stride)] + th) for stride in (1, 10)}
    assert_same_tree(str(tmp_path / "t0"), str(tmp_path / "t2"), min_files=8 + 55 + 150 + 12)
    assert runs[0] == runs[2] and runs[2][1] != runs[2][10] and len(runs[2][1]) == 6

    # a corrupt raster: the port's worker raises and the run exits non-zero
    labels = str(tmp_path / "t2" / "labels")
    bad = os.path.join(labels, "ERA5_2008-01-01-05-00-00_PSFC.tiff")
    for f in glob.glob(f"{labels}/*_rio.tiff"):
        os.remove(f)
    with open(bad, "wb") as fp:
        fp.write(b"not a tiff")
    jax_calls = {
        "rio": [os.path.join(REPO, "tools", "calc_rio.py"), "--data_path", labels, "--num_threads", "2"],
        "surface": [os.path.join(REPO, "tools", "extract_variable_from_nc.py"), "--data_path",
                    str(tmp_path / "t0" / "nc"), "--result_path", str(tmp_path / "jax_surface"), "--num_threads", "2"],
        "stride": [os.path.join(REPO, "tools", "calc_mean_std.py"), "--data_path", str(tmp_path / "t0" / "labels"),
                   "--result_path", str(tmp_path / "jax_stats"), "--sample_stride", "1", "--num_threads", "2"],
    }
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    procs = {k: subprocess.Popen([sys.executable] + v, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True) for k, v in jax_calls.items()}
    port = subprocess.run([sys.executable, "-m", "deepphysinet_tpu_torch.tools.calc_rio", "--data_path", labels,
                           "--num_threads", "2"], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    jax = {k: (p.communicate(timeout=120), p.returncode) for k, p in procs.items()}
    assert port.returncode != 0 and "not a TIFF file" in port.stderr, port.stderr[-2000:]
    assert jax["rio"][1] == 0 and jax["surface"][1] == 0 and jax["stride"][1] == 0, jax
    assert not os.path.exists(tmp_path / "jax_surface" / "2008")  # the lambda never ran
    jax_stats = {}
    for var in tmeanstd.DEFAULT_VARS:
        path = tmp_path / "jax_stats" / f"{var}.txt"
        if path.exists():
            assert path.read_text() == (tmp_path / "t0" / "stats10" / f"{var}.txt").read_text(), var
            jax_stats[var] = path.read_text()
    assert len(jax_stats) == 6 and (tmp_path / "t0" / "stats1" / "t2.txt").read_text() != jax_stats["t2"]


def test_cvt_takes_cfgrib_only_with_xarray(monkeypatch, raw):
    """xarray without cfgrib: the port's GRIB loader goes to its own codec (the JAX tool called
    ``xr.load_dataset(engine="cfgrib")`` whenever xarray imported)."""
    import types

    monkeypatch.setitem(sys.modules, "xarray", types.ModuleType("xarray"))
    monkeypatch.setitem(sys.modules, "cfgrib", None)
    ds = tcvt._default_load(raw["grib"][0], {"typeOfLevel": "surface", "level": 0})
    assert isinstance(ds, tgrib2.GribDataset) and list(ds.data_vars) == ["sp"]


# ---- end to end ---------------------------------------------------------------------------------------


def test_etl_to_training_step(raw, tmp_path):
    """The raw archive through the port's tools (``run_etl``, the README's order) to a tree that
    ``PhysicsDataset`` reads, and one PDE training step of the port at the dims of
    tests/test_train_step.py, on the CPU: finite losses, and the ETL tree's index equal to the
    generator's."""
    import pickle

    from deepphysinet_tpu_torch.config import Config
    from deepphysinet_tpu_torch.data.dataset import PhysicsDataset
    from deepphysinet_tpu_torch.train.train_step import (batch_to_device, create_train_state, make_train_step,
                                                         step_config_from_cfg)

    etl = run_etl(raw["grib_dir"], raw["era5_dir"], str(tmp_path / "etl"), INIT, INIT, 24, 24)
    paths = raw["paths"]
    with open(paths["input_map_file"], "rb") as a, open(etl["paths"]["input_map_file"], "rb") as b:
        assert pickle.load(a) == pickle.load(b)
    assert etl["results"]["extract_variable_from_ERA5"] and etl["results"]["calc_rio labels"]
    for name in ("constant", "coord_1d.pickle", "coord_0p25d.pickle"):  # no ETL tool makes these
        src = os.path.join(os.path.dirname(paths["input_path"]), name)
        (shutil.copytree if os.path.isdir(src) else shutil.copy)(src, str(tmp_path / "etl" / name))

    cfg = Config.fromfile(os.path.join(REPO, "configs", "DeepPhysiNet_NCEP_cfg.py"))["config"]
    cfg["meta_cfg"].update(enc_in=65, c_out=32, d_model=32, n_heads=4, e_layers=1, d_ff=32, learnable_token_num=8)
    cfg["net_cfg"].update(hidden_channels=32, learnable_token_num=16)
    tc = cfg["train_cfg"]
    root = str(tmp_path / "etl")
    data = dict(tc["train_data"], input_path=etl["paths"]["input_path"], label_path=etl["paths"]["label_path"],
                constant_path=f"{root}/constant", in_coord_file=f"{root}/coord_1d.pickle",
                out_coord_file=f"{root}/coord_0p25d.pickle",
                input_data_map_cfg=dict(NCEP=etl["paths"]["input_map_file"]), label_img_size=(17, 49),
                start_time="2008-01-01_00_00_00", end_time="2008-01-01_00_00_00", label_batch_size=48,
                batch_size_inter=24, seed=0)
    ds = PhysicsDataset(**data, input_variable_cfg=cfg["variable_cfg"], out_variable_cfg=cfg["obs_norm_cfg"],
                        dx=float(tc["dx"]), dy=float(tc["dy"]))
    assert len(ds) == 1
    item = {k: np.asarray(v)[None] for k, v in ds[0].items()}

    def points(p, nwp, labels=None):
        out = dict(x=item[f"{p}_x"], y=item[f"{p}_y"], t=item[f"{p}_t"], f=item[f"{p}_f"], nwp=item[nwp])
        return dict(out, labels=item[labels]) if labels else out

    batch = batch_to_device(dict(field=item["field_data"], forecast_h=item["forecast_h"].reshape(-1),
                                 margin=points("margin", "margin_input_data", "margin_data"),
                                 inter=points("inter", "inter_data")), device="cpu")
    state = create_train_state(cfg["meta_cfg"], cfg["net_cfg"], tc["optimizer"], torch.Generator().manual_seed(0),
                               torch.bfloat16, device="cpu")
    state, metrics = make_train_step(step_config_from_cfg(cfg))(state, batch, True)
    metrics = {k: float(v) for k, v in metrics.items()}
    assert state.step == 1 and "inter_total" in metrics and all(np.isfinite(v) for v in metrics.values()), metrics
