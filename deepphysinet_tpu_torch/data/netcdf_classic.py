"""Stdlib-only NetCDF-classic (CDF-1 / CDF-2) reader and writer.

The port's own copy of ``deepphysinet_tpu/data/netcdf_classic.py`` (numpy only, unchanged), so that
the port's ETL tools run on a machine without netCDF4 and import nothing of the JAX package.

The ETL tools (``deepphysinet_tpu_torch/tools/extract_variable_from_nc.py`` and
``extract_variable_from_ERA5.py``) consume netCDF files through the small slice of the netCDF4
``Dataset(...).variables`` interface they use: ``variables[name]`` supports ``len()``, integer /
tuple indexing returning arrays whose ``.data`` is the raw payload, and CF packing conventions
(``scale_factor`` / ``add_offset`` / ``_FillValue`` / ``missing_value``).

The classic binary format is parsed directly from the published spec (magic ``CDF\\x01`` or
``CDF\\x02``, big-endian header tag/nelems lists, contiguous non-record data, interleaved record
slabs).  It is deliberately not built on scipy.io.netcdf_file, so that scipy can serve the tests as
an independent writer.

Scope: classic CDF-1 (32-bit offsets) and CDF-2 (64-bit offsets).  NetCDF-4 (HDF5-based, magic
``\\x89HDF``) goes through ``hdf5_lite.py``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# header tags (spec: netcdf classic format, "The File Format")
_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C
_ABSENT = 0

_STREAMING = 0xFFFFFFFF

# nc_type -> (numpy dtype (big-endian on disk), element size)
_NC_TYPES = {
    1: ("b", 1),   # NC_BYTE
    2: ("S1", 1),  # NC_CHAR
    3: (">i2", 2),  # NC_SHORT
    4: (">i4", 4),  # NC_INT
    5: (">f4", 4),  # NC_FLOAT
    6: (">f8", 8),  # NC_DOUBLE
}


class _Parser:
    """Sequential big-endian reader over the header bytes."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def i4(self) -> int:
        v = struct.unpack_from(">i", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def u4(self) -> int:
        v = struct.unpack_from(">I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def i8(self) -> int:
        v = struct.unpack_from(">q", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def name(self) -> str:
        n = self.i4()
        s = self.buf[self.pos:self.pos + n].decode("utf-8")
        self.pos += n + (-n % 4)  # names are padded to a 4-byte boundary
        return s

    def values(self, nc_type: int, nelems: int):
        dt, size = _NC_TYPES[nc_type]
        nbytes = size * nelems
        raw = np.frombuffer(self.buf, dtype=dt, count=nelems, offset=self.pos)
        self.pos += nbytes + (-nbytes % 4)
        if nc_type == 2:  # char attr -> python str (CF convention)
            return raw.tobytes().decode("utf-8", errors="replace")
        return raw[0] if nelems == 1 else raw.copy()


def _parse_attrs(p: _Parser) -> Dict[str, object]:
    tag = p.i4()
    n = p.i4()
    if tag == _ABSENT:
        return {}
    if tag != _NC_ATTRIBUTE:
        raise ValueError(f"bad attribute list tag 0x{tag:x}")
    out: Dict[str, object] = {}
    for _ in range(n):
        name = p.name()
        out[name] = p.values(p.i4(), p.i4())
    return out


class NCVariable:
    """One variable: lazy strided reads + CF packing applied on access.

    Indexing returns ``np.ma.MaskedArray`` (scalars included), matching the
    ``value.data`` access pattern the ETL cores use with netCDF4.
    """

    def __init__(self, name: str, dim_names: Tuple[str, ...],
                 shape: Tuple[int, ...], nc_type: int, vsize: int, begin: int,
                 attrs: Dict[str, object], path: str, is_record: bool,
                 recsize: int, numrecs: int):
        self.name = name
        self.dimensions = dim_names
        self._static_shape = shape  # record dim excluded for record vars
        self.attributes = attrs
        self._nc_type = nc_type
        self._dtype = np.dtype(_NC_TYPES[nc_type][0])
        self._vsize = vsize
        self._begin = begin
        self._path = path
        self._is_record = is_record
        self._recsize = recsize
        self._numrecs = numrecs

    # -- shape / dtype -----------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        if self._is_record:
            return (self._numrecs,) + self._static_shape
        return self._static_shape

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    def ncattrs(self) -> List[str]:
        return list(self.attributes)

    def getncattr(self, name: str):
        return self.attributes[name]

    def __len__(self) -> int:
        if not self.shape:
            raise TypeError(f"len() of scalar variable {self.name!r}")
        return self.shape[0]

    # -- data --------------------------------------------------------------
    def _raw(self) -> np.ndarray:
        """Full raw (packed) array, decoded from file bytes."""
        n_static = int(np.prod(self._static_shape, dtype=np.int64))
        if not self._is_record:
            with open(self._path, "rb") as f:
                f.seek(self._begin)
                raw = np.fromfile(f, dtype=self._dtype, count=n_static)
            return raw.reshape(self._static_shape)
        # record variable: one slab per record, slabs from all record vars
        # interleaved with stride `recsize`
        out = np.empty((self._numrecs,) + self._static_shape, self._dtype)
        with open(self._path, "rb") as f:
            for r in range(self._numrecs):
                f.seek(self._begin + r * self._recsize)
                out[r] = np.fromfile(
                    f, dtype=self._dtype, count=n_static,
                ).reshape(self._static_shape)
        return out

    def _convert(self, raw: np.ndarray) -> np.ma.MaskedArray:
        """Apply _FillValue/missing_value mask then scale_factor/add_offset."""
        mask = np.ma.nomask
        for key in ("_FillValue", "missing_value"):
            if key in self.attributes:
                fv = self.attributes[key]
                m = raw == np.asarray(fv, raw.dtype)
                mask = m if mask is np.ma.nomask else (mask | m)
        scale = self.attributes.get("scale_factor")
        offset = self.attributes.get("add_offset")
        data = raw
        if scale is not None or offset is not None:
            data = raw.astype(np.float64 if self._dtype.itemsize > 4
                              else np.float32)
            if scale is not None:
                data = data * scale
            if offset is not None:
                data = data + offset
        elif data.dtype.byteorder == ">":
            data = data.astype(data.dtype.newbyteorder("="))
        return np.ma.MaskedArray(data, mask=mask)

    def __getitem__(self, idx) -> np.ma.MaskedArray:
        out = self._convert(self._raw())[idx]
        if np.ndim(out) == 0:
            # netCDF4 returns 0-d masked arrays for scalar reads; plain numpy
            # scalars have a memoryview `.data`, which would break the ETL
            # cores' ``value.data`` access
            return np.ma.MaskedArray(out)
        return out

    def __array__(self, dtype=None):
        arr = np.ma.filled(self._convert(self._raw()), np.nan)
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self) -> str:
        return (f"<NCVariable {self.name} {self._dtype} "
                f"dims={self.dimensions} shape={self.shape}>")


class NetCDFClassicFile:
    """Parsed classic-format file: ``.dimensions``, ``.variables``, attrs."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            # headers are small; 64 KiB covers every file the pipeline makes,
            # grow if a huge attribute table overflows
            head = f.read(1 << 16)
            while True:
                try:
                    self._parse_header(head)
                    break
                except (struct.error, IndexError):
                    more = f.read(len(head))
                    if not more:
                        raise ValueError(f"truncated netCDF header: {path}")
                    head += more

    def _parse_header(self, buf: bytes) -> None:
        if buf[:3] != b"CDF" or buf[3] not in (1, 2):
            raise ValueError(
                f"not a classic netCDF file (magic {buf[:4]!r}); NetCDF-4/"
                "HDF5 files need the netCDF4 package")
        version = buf[3]
        p = _Parser(buf)
        p.pos = 4
        numrecs = p.u4()
        if numrecs == _STREAMING:
            raise ValueError("STREAMING numrecs unsupported")

        # dim_list
        tag, n = p.i4(), p.i4()
        dims: List[Tuple[str, int]] = []
        if tag == _NC_DIMENSION:
            for _ in range(n):
                dims.append((p.name(), p.i4()))
        elif tag != _ABSENT:
            raise ValueError(f"bad dim list tag 0x{tag:x}")

        self.attributes = _parse_attrs(p)

        # var_list
        tag, n = p.i4(), p.i4()
        self.variables: Dict[str, NCVariable] = {}
        raw_vars = []
        if tag == _NC_VARIABLE:
            for _ in range(n):
                name = p.name()
                ndims = p.i4()
                dimids = [p.i4() for _ in range(ndims)]
                attrs = _parse_attrs(p)
                nc_type = p.i4()
                vsize = p.u4()
                begin = p.i8() if version == 2 else p.u4()
                raw_vars.append((name, dimids, attrs, nc_type, vsize, begin))
        elif tag != _ABSENT:
            raise ValueError(f"bad var list tag 0x{tag:x}")

        self.dimensions = {name: (size if size else None)
                           for name, size in dims}
        rec_dim = next((i for i, (_, s) in enumerate(dims) if s == 0), None)

        # record size: sum of record-var slab sizes; the spec special-cases a
        # single record variable (no per-record padding -> use element bytes)
        rec_vars = [(name, dimids, nc_type)
                    for name, dimids, _, nc_type, _, _ in raw_vars
                    if dimids and dimids[0] == rec_dim and rec_dim is not None]
        if len(rec_vars) == 1:
            name, dimids, nc_type = rec_vars[0]
            n_static = 1
            for d in dimids[1:]:
                n_static *= dims[d][1]
            recsize = n_static * _NC_TYPES[nc_type][1]
        else:
            recsize = 0
            for name, dimids, _, nc_type, _, _ in raw_vars:
                if dimids and rec_dim is not None and dimids[0] == rec_dim:
                    n_static = 1
                    for d in dimids[1:]:
                        n_static *= dims[d][1]
                    nbytes = n_static * _NC_TYPES[nc_type][1]
                    recsize += nbytes + (-nbytes % 4)

        for name, dimids, attrs, nc_type, vsize, begin in raw_vars:
            is_record = bool(dimids) and rec_dim is not None and dimids[0] == rec_dim
            shape_ids = dimids[1:] if is_record else dimids
            shape = tuple(dims[d][1] for d in shape_ids)
            dim_names = tuple(dims[d][0] for d in dimids)
            self.variables[name] = NCVariable(
                name, dim_names, shape, nc_type, vsize, begin, attrs,
                self.path, is_record, recsize, numrecs)

    def ncattrs(self) -> List[str]:
        return list(self.attributes)

    def close(self) -> None:  # parity with netCDF4.Dataset
        pass


def open_variables(path: str) -> Dict[str, NCVariable]:
    """``netCDF4.Dataset(path).variables`` drop-in for classic files."""
    return NetCDFClassicFile(path).variables


# --------------------------------------------------------------------------
# writer (CDF-1, non-record variables) -- used by the GRIB ETL path
# (data/grib2.py::GribDataset.to_netcdf) so grib->nc->tiff runs end to end on
# real bytes without netCDF4/xarray.  Mirrors the reader's spec subset.
# --------------------------------------------------------------------------

_DTYPE_TO_NC = {
    np.dtype("int8"): 1,
    np.dtype("S1"): 2,
    np.dtype("int16"): 3,
    np.dtype("int32"): 4,
    np.dtype("float32"): 5,
    np.dtype("float64"): 6,
}


def _pack_name(name: str) -> bytes:
    raw = name.encode("utf-8")
    return struct.pack(">i", len(raw)) + raw + b"\x00" * (-len(raw) % 4)


def _pack_attr_value(value) -> bytes:
    """attr value -> nc_type + nelems + padded payload bytes."""
    if isinstance(value, str):
        raw = value.encode("utf-8")
        return (struct.pack(">ii", 2, len(raw)) + raw
                + b"\x00" * (-len(raw) % 4))
    arr = np.atleast_1d(np.asarray(value))
    if arr.dtype == np.float64:
        nc_type = 6
    elif arr.dtype == np.float32:
        nc_type = 5
    elif arr.dtype.kind == "i" and arr.dtype.itemsize <= 2:
        nc_type = 3
        arr = arr.astype(np.int16)
    else:
        nc_type = 4
        arr = arr.astype(np.int32)
    payload = arr.astype(_NC_TYPES[nc_type][0]).tobytes()
    return (struct.pack(">ii", nc_type, arr.size) + payload
            + b"\x00" * (-len(payload) % 4))


def _pack_attrs(attrs: Dict[str, object]) -> bytes:
    if not attrs:
        return struct.pack(">ii", _ABSENT, 0)
    out = [struct.pack(">ii", _NC_ATTRIBUTE, len(attrs))]
    for name, value in attrs.items():
        out.append(_pack_name(name) + _pack_attr_value(value))
    return b"".join(out)


def write_classic(path: str, dims: Dict[str, int], variables,
                  global_attrs: Optional[Dict[str, object]] = None) -> None:
    """Write a CDF-1 classic netCDF file.

    ``variables`` is a sequence of ``(name, dim_names, data, attrs)`` with
    ``data`` a numpy array whose shape matches ``dims`` and whose dtype is in
    {int8, S1, int16, int32, float32, float64}.  All variables are non-record
    (every dim has a fixed size), which is all the grib->nc interchange needs.
    """
    dim_ids = {name: i for i, name in enumerate(dims)}
    prepared = []
    for name, dim_names, data, attrs in variables:
        arr = np.ascontiguousarray(data)
        nc_type = _DTYPE_TO_NC.get(arr.dtype.newbyteorder("="))
        if nc_type is None:
            raise ValueError(f"unsupported dtype {arr.dtype} for {name!r}")
        shape = tuple(dims[d] for d in dim_names)
        if arr.shape != shape:
            raise ValueError(
                f"{name!r}: shape {arr.shape} != dims {dim_names} -> {shape}")
        nbytes = arr.size * _NC_TYPES[nc_type][1]
        vsize = nbytes + (-nbytes % 4)
        prepared.append((name, dim_names, arr, attrs or {}, nc_type, vsize))

    def header(begins) -> bytes:
        out = [b"CDF\x01", struct.pack(">i", 0)]  # numrecs = 0
        out.append(struct.pack(">ii", _NC_DIMENSION, len(dims)))
        for name, size in dims.items():
            out.append(_pack_name(name) + struct.pack(">i", size))
        out.append(_pack_attrs(global_attrs or {}))
        out.append(struct.pack(">ii", _NC_VARIABLE, len(prepared)))
        for (name, dim_names, _arr, attrs, nc_type, vsize), begin in zip(
                prepared, begins):
            out.append(_pack_name(name))
            out.append(struct.pack(">i", len(dim_names)))
            out.extend(struct.pack(">i", dim_ids[d]) for d in dim_names)
            out.append(_pack_attrs(attrs))
            out.append(struct.pack(">iIi", nc_type, vsize, begin))
        return b"".join(out)

    # two passes: header size fixes the first begin, the rest follow
    hlen = len(header([0] * len(prepared)))
    begins = []
    pos = hlen
    for _name, _dims, _arr, _attrs, _nc, vsize in prepared:
        begins.append(pos)
        pos += vsize

    with open(path, "wb") as f:
        f.write(header(begins))
        for _name, _dims, arr, _attrs, nc_type, vsize in prepared:
            payload = arr.astype(_NC_TYPES[nc_type][0]).tobytes()
            f.write(payload + b"\x00" * (vsize - len(payload)))
