"""Stdlib-only GRIB2 codec (read + write) for the offline GRIB ETL path.

The port's own copy of ``deepphysinet_tpu/data/grib2.py`` (numpy only; ``GribDataset.to_netcdf``
writes through the port's ``netcdf_classic``), so that ``tools/cvt_grib_to_nc.py`` of the port runs
on a machine without cfgrib / eccodes and imports nothing of the JAX package.

The reference converts NCEP GFS GRIB archives to per-level netCDF files with xarray + cfgrib
(filter_by_keys on typeOfLevel / level).  This module parses GRIB edition 2 directly from the WMO
FM 92 spec:

* sections 0-8 of multi-message files (section 0 indicator, 1 identification,
  3 grid definition, 4 product definition, 5 data representation, 6 bitmap,
  7 data, 8 end),
* grid template 3.0 (regular latitude/longitude, the GFS 0.25/1.0 degree
  layout), sign-magnitude integers, scanning modes 0x00/0x40,
* product template 4.0 (analysis/forecast at a horizontal level),
* data template 5.0 (simple packing: Y = (R + X * 2^E) / 10^D at arbitrary
  bits-per-value), with or without a section-6 bitmap.

A writer for the same subset builds real GRIB byte streams, so that tests and synthetic archives
exercise the reader against file bytes.

Variable naming mirrors cfgrib so downstream tools see identical datasets:
(discipline, category, number) -> short name, with the cfgrib level-suffix
convention at heightAboveGround (t->t2m, dpt->d2m at 2 m; u->u10, v->v10 at
10 m) and pres->sp at the surface.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# (discipline, parameterCategory, parameterNumber) -> cfgrib short name
_PARAM_NAMES = {
    (0, 0, 0): "t",       # temperature [K]
    (0, 0, 6): "dpt",     # dew point temperature [K]
    (0, 1, 0): "q",       # specific humidity [kg/kg]
    (0, 1, 1): "r",       # relative humidity [%]
    (0, 2, 2): "u",       # u wind [m/s]
    (0, 2, 3): "v",       # v wind [m/s]
    (0, 3, 0): "pres",    # pressure [Pa]
    (0, 3, 1): "prmsl",   # mean sea level pressure [Pa]
    (0, 3, 5): "gh",      # geopotential height [gpm]
}
_PARAM_CODES = {v: k for k, v in _PARAM_NAMES.items()}

# typeOfFirstFixedSurface code <-> cfgrib typeOfLevel string
_LEVEL_TYPES = {
    1: "surface",
    100: "isobaricInhPa",
    101: "meanSea",
    103: "heightAboveGround",
}
_LEVEL_CODES = {v: k for k, v in _LEVEL_TYPES.items()}

# cfgrib renames the raw short name by level (t at 2 m AGL -> t2m, ...)
_HAG_RENAMES = {
    (2, "t"): "t2m",
    (2, "dpt"): "d2m",
    (2, "q"): "sh2",
    (2, "r"): "r2",
    (10, "u"): "u10",
    (10, "v"): "v10",
}


def _sm_decode(raw: int, nbits: int) -> int:
    """GRIB2 sign-magnitude integer: MSB set -> negative magnitude."""
    sign_bit = 1 << (nbits - 1)
    if raw & sign_bit:
        return -(raw & (sign_bit - 1))
    return raw


def _sm_encode(value: int, nbits: int) -> int:
    if value < 0:
        return (1 << (nbits - 1)) | (-value)
    return value


@dataclasses.dataclass
class Grib2Message:
    """One decoded GRIB2 field on a regular lat/lon grid."""

    discipline: int
    param_category: int
    param_number: int
    ref_time: datetime.datetime
    forecast_hours: int
    type_of_level: str
    level: float           # hPa for isobaricInhPa, metres for hag, 0 surface
    lat: np.ndarray        # [Nj] degrees, in storage row order
    lon: np.ndarray        # [Ni] degrees
    values: np.ndarray     # [Nj, Ni] float64, NaN where bitmap-masked

    @property
    def short_name(self) -> str:
        name = _PARAM_NAMES.get(
            (self.discipline, self.param_category, self.param_number),
            f"p{self.discipline}_{self.param_category}_{self.param_number}")
        if self.type_of_level == "heightAboveGround":
            return _HAG_RENAMES.get((int(self.level), name), name)
        if self.type_of_level == "surface" and name == "pres":
            return "sp"
        return name


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

def _unpack_bits(buf: bytes, nbits: int, count: int) -> np.ndarray:
    """First ``count`` big-endian ``nbits``-wide unsigned ints from ``buf``."""
    if nbits == 0:
        return np.zeros(count, np.int64)
    if nbits == 8:
        return np.frombuffer(buf, np.uint8, count).astype(np.int64)
    if nbits == 16:
        return np.frombuffer(buf, ">u2", count).astype(np.int64)
    if nbits == 32:
        return np.frombuffer(buf, ">u4", count).astype(np.int64)
    bits = np.unpackbits(np.frombuffer(buf, np.uint8))
    bits = bits[: count * nbits].reshape(count, nbits).astype(np.int64)
    weights = (1 << np.arange(nbits - 1, -1, -1, dtype=np.int64))
    return bits @ weights


def _pack_bits(vals: np.ndarray, nbits: int) -> bytes:
    """Inverse of _unpack_bits (big-endian bit stream, zero-padded)."""
    if nbits == 0:
        return b""
    vals = np.asarray(vals, np.int64)
    shifts = np.arange(nbits - 1, -1, -1, dtype=np.int64)
    bits = ((vals[:, None] >> shifts) & 1).astype(np.uint8).ravel()
    return np.packbits(bits).tobytes()


def read_messages(path: str) -> List[Grib2Message]:
    """Decode every GRIB2 field in ``path`` (supported templates only).

    A single GRIB2 message may repeat sections 3-7 (or just 4-7 under one
    grid) for several fields -- the WMO FM 92 repetition rule, used by real
    NCEP/ECMWF archives -- so one on-disk message can yield several
    ``Grib2Message`` records: one per section-7 occurrence, inheriting the
    most recent sections 1/3/4/5/6 state.
    """
    with open(path, "rb") as f:
        buf = f.read()
    out: List[Grib2Message] = []
    pos = 0
    while True:
        pos = buf.find(b"GRIB", pos)
        if pos < 0:
            break
        out.extend(_read_one(buf, pos))
        total_len = struct.unpack_from(">Q", buf, pos + 8)[0]
        pos += total_len
    return out


def _read_one(buf: bytes, start: int) -> List[Grib2Message]:
    edition = buf[start + 7]
    if edition != 2:
        raise ValueError(f"GRIB edition {edition} unsupported (only 2)")
    discipline = buf[start + 6]
    total_len = struct.unpack_from(">Q", buf, start + 8)[0]
    end = start + total_len
    pos = start + 16

    ref_time = None
    grid = None
    product = None
    packing = None
    bitmap = None
    out: List[Grib2Message] = []

    def emit(values: np.ndarray) -> Grib2Message:
        if ref_time is None or grid is None or product is None:
            raise ValueError("incomplete GRIB2 message")
        ni, nj, lat, lon = grid
        category, number, fh, surf_type, level = product
        type_of_level = _LEVEL_TYPES.get(surf_type, f"level_{surf_type}")
        if type_of_level == "isobaricInhPa":
            level = level / 100.0  # stored in Pa
        return Grib2Message(
            discipline=discipline, param_category=category,
            param_number=number, ref_time=ref_time, forecast_hours=fh,
            type_of_level=type_of_level, level=level, lat=lat, lon=lon,
            values=values.reshape(nj, ni))

    while pos < end:
        if buf[pos:pos + 4] == b"7777":
            break
        sec_len, sec_num = struct.unpack_from(">IB", buf, pos)
        sec = buf[pos:pos + sec_len]
        if sec_num == 1:
            year, month, day, hour, minute, second = struct.unpack_from(
                ">HBBBBB", sec, 12)
            ref_time = datetime.datetime(year, month, day, hour, minute, second)
        elif sec_num == 3:
            grid = _parse_grid(sec)
        elif sec_num == 4:
            product = _parse_product(sec)
        elif sec_num == 5:
            packing = _parse_packing(sec)
        elif sec_num == 6:
            indicator = sec[5]
            if indicator == 0:
                bitmap = np.unpackbits(
                    np.frombuffer(sec[6:], np.uint8)).astype(bool)
            elif indicator == 254:
                pass  # re-use the previously defined bitmap (FM 92 code 254)
            elif indicator == 255:
                bitmap = None
            else:
                raise ValueError(f"bitmap indicator {indicator} unsupported")
        elif sec_num == 7:
            out.append(emit(_unpack_data(sec, packing, grid, bitmap)))
        pos += sec_len

    if not out:
        raise ValueError("incomplete GRIB2 message")
    return out


def _parse_grid(sec: bytes) -> Tuple[int, int, np.ndarray, np.ndarray]:
    template = struct.unpack_from(">H", sec, 12)[0]
    if template != 0:
        raise ValueError(f"grid template 3.{template} unsupported (only 3.0 "
                         "regular lat/lon)")
    ni, nj = struct.unpack_from(">II", sec, 30)
    la1 = _sm_decode(struct.unpack_from(">I", sec, 46)[0], 32) * 1e-6
    lo1 = _sm_decode(struct.unpack_from(">I", sec, 50)[0], 32) * 1e-6
    la2 = _sm_decode(struct.unpack_from(">I", sec, 55)[0], 32) * 1e-6
    lo2 = _sm_decode(struct.unpack_from(">I", sec, 59)[0], 32) * 1e-6
    scan = sec[71]
    if scan not in (0x00, 0x40):
        raise ValueError(f"scanning mode 0x{scan:02x} unsupported")
    # rows run la1 -> la2 in storage order for both supported scan modes
    # (0x00: north-first descending, 0x40: south-first ascending)
    lat = np.linspace(la1, la2, nj)
    lon = np.linspace(lo1, lo2, ni)
    return ni, nj, lat, lon


def _parse_product(sec: bytes) -> Tuple[int, int, int, int, float]:
    template = struct.unpack_from(">H", sec, 7)[0]
    if template not in (0, 1):
        raise ValueError(f"product template 4.{template} unsupported")
    category = sec[9]
    number = sec[10]
    time_unit = sec[17]
    forecast_time = struct.unpack_from(">I", sec, 18)[0]
    hours_per_unit = {0: 1.0 / 60.0, 1: 1.0, 2: 24.0, 10: 3.0, 11: 6.0,
                      12: 12.0}.get(time_unit)
    if hours_per_unit is None:
        raise ValueError(f"forecast time unit {time_unit} unsupported")
    fh = int(forecast_time * hours_per_unit)
    surf_type = sec[22]
    scale = _sm_decode(sec[23], 8)
    scaled = _sm_decode(struct.unpack_from(">I", sec, 24)[0], 32)
    level = scaled * (10.0 ** -scale) if scaled or scale else 0.0
    return category, number, fh, surf_type, level


def _parse_packing(sec: bytes) -> Tuple[int, float, int, int, int]:
    n_values = struct.unpack_from(">I", sec, 5)[0]
    template = struct.unpack_from(">H", sec, 9)[0]
    if template != 0:
        raise ValueError(f"data template 5.{template} unsupported (only 5.0 "
                         "simple packing)")
    ref = struct.unpack_from(">f", sec, 11)[0]
    e = _sm_decode(struct.unpack_from(">H", sec, 15)[0], 16)
    d = _sm_decode(struct.unpack_from(">H", sec, 17)[0], 16)
    nbits = sec[19]
    return n_values, ref, e, d, nbits


def _unpack_data(sec: bytes, packing, grid, bitmap) -> np.ndarray:
    if packing is None or grid is None:
        raise ValueError("data section before representation/grid sections")
    n_values, ref, e, d, nbits = packing
    x = _unpack_bits(sec[5:], nbits, n_values)
    y = (ref + x.astype(np.float64) * (2.0 ** e)) * (10.0 ** -d)
    if bitmap is not None:
        ni, nj, _, _ = grid
        full = np.full(ni * nj, np.nan)
        full[bitmap[: ni * nj]] = y
        return full
    return y


# --------------------------------------------------------------------------
# dataset assembly (the slice of the xarray surface the ETL tools use)
# --------------------------------------------------------------------------

class GribDataset:
    """Messages grouped into (time, step, lat, lon) arrays per variable.

    Mirrors the slice of ``xr.load_dataset(..., engine='cfgrib')`` the ETL
    pipeline consumes: ``.variables`` with dims (time, step, latitude,
    longitude), epoch-second ``time``, hour ``step``, and ``to_netcdf``
    writing a classic CDF-1 file readable by data/netcdf_classic.py.
    """

    def __init__(self, messages: Sequence[Grib2Message]):
        if not messages:
            raise ValueError("empty GRIB selection")
        g0 = messages[0]
        epoch = datetime.datetime(1970, 1, 1)
        times = sorted({m.ref_time for m in messages})
        steps = sorted({m.forecast_hours for m in messages})
        t_index = {t: i for i, t in enumerate(times)}
        s_index = {s: i for i, s in enumerate(steps)}
        self.latitude = np.asarray(g0.lat, np.float64)
        self.longitude = np.asarray(g0.lon, np.float64)
        self.time = np.asarray(
            [(t - epoch).total_seconds() for t in times], np.float64)
        self.step = np.asarray(steps, np.int32)
        self.type_of_level = g0.type_of_level
        self.level = g0.level
        nj, ni = len(self.latitude), len(self.longitude)
        self.data_vars: Dict[str, np.ndarray] = {}
        for m in messages:
            if m.values.shape != (nj, ni):
                raise ValueError("inconsistent grids in one selection")
            arr = self.data_vars.setdefault(
                m.short_name,
                np.full((len(times), len(steps), nj, ni), np.nan, np.float32))
            arr[t_index[m.ref_time], s_index[m.forecast_hours]] = m.values

    def to_netcdf(self, path: str) -> None:
        from deepphysinet_tpu_torch.data.netcdf_classic import write_classic

        dims = {"time": len(self.time), "step": len(self.step),
                "latitude": len(self.latitude),
                "longitude": len(self.longitude)}
        variables = [
            ("time", ("time",), self.time.astype(np.float64),
             {"units": "seconds since 1970-01-01T00:00:00"}),
            ("step", ("step",), self.step.astype(np.int32),
             {"units": "hours"}),
            ("latitude", ("latitude",), self.latitude,
             {"units": "degrees_north"}),
            ("longitude", ("longitude",), self.longitude,
             {"units": "degrees_east"}),
        ]
        for name, arr in sorted(self.data_vars.items()):
            variables.append(
                (name, ("time", "step", "latitude", "longitude"),
                 arr.astype(np.float32),
                 {"typeOfLevel": self.type_of_level,
                  "level": np.float64(self.level)}))
        # the reference tool's history string, so that the two write the same bytes
        write_classic(path, dims, variables,
                      {"Conventions": "CF-1.7",
                       "history": "deepphysinet_tpu grib2->netcdf"})


def load_dataset(path: str, filter_by_keys: Optional[Dict] = None) -> GribDataset:
    """cfgrib-style selection: filter on typeOfLevel / level / shortName."""
    filter_by_keys = filter_by_keys or {}
    selected = []
    for m in read_messages(path):
        tol = filter_by_keys.get("typeOfLevel")
        if tol is not None and m.type_of_level != tol:
            continue
        level = filter_by_keys.get("level")
        if level is not None and int(round(m.level)) != int(level):
            continue
        sn = filter_by_keys.get("shortName")
        if sn is not None and m.short_name != sn:
            continue
        selected.append(m)
    return GribDataset(selected)


# --------------------------------------------------------------------------
# writer (real-bytes fixtures and synthetic archives)
# --------------------------------------------------------------------------

def encode_message(msg: Grib2Message, nbits: int = 16) -> bytes:
    """One GRIB2 message (templates 3.0 / 4.0 / 5.0) as raw bytes."""
    nj, ni = msg.values.shape
    flat = np.asarray(msg.values, np.float64).ravel()
    mask = np.isfinite(flat)
    use_bitmap = not mask.all()
    data = flat[mask] if use_bitmap else flat

    # simple packing parameters: D = 0, E sized so the range fits nbits
    ref = float(data.min()) if data.size else 0.0
    rng = float(data.max()) - ref if data.size else 0.0
    if rng > 0:
        # negative E = sub-unit quantum (the usual case for met fields)
        e = math.ceil(math.log2(rng / ((1 << nbits) - 1)))
    else:
        e = 0
    x = np.round((data - ref) / (2.0 ** e)).astype(np.int64)
    x = np.clip(x, 0, (1 << nbits) - 1)

    sec1 = struct.pack(
        ">IBHHBBBHBBBBBBB", 21, 1, 0, 0, 2, 1, 1,
        msg.ref_time.year, msg.ref_time.month, msg.ref_time.day,
        msg.ref_time.hour, msg.ref_time.minute, msg.ref_time.second, 0, 1)

    la1, lo1 = msg.lat[0], msg.lon[0]
    la2, lo2 = msg.lat[-1], msg.lon[-1]
    di = abs(msg.lon[1] - msg.lon[0]) if ni > 1 else 1.0
    dj = abs(msg.lat[1] - msg.lat[0]) if nj > 1 else 1.0
    scan = 0x40 if (nj > 1 and msg.lat[1] > msg.lat[0]) else 0x00

    def deg(v):
        return _sm_encode(int(round(v * 1e6)), 32)

    tmpl30 = struct.pack(
        ">BBIBIBIIIIIIIBIIIIB",
        6,              # shape of earth: spherical r=6371229 m
        0, 0, 0, 0, 0, 0,
        ni, nj,
        0, 0,           # basic angle / subdivisions
        deg(la1), deg(lo1 % 360.0),
        0x30,           # resolution/component flags: di/dj given
        deg(la2), deg(lo2 % 360.0),
        deg(di), deg(dj),
        scan)
    sec3 = struct.pack(">IBBIBBH", 14 + len(tmpl30), 3, 0, ni * nj, 0, 0, 0) + tmpl30

    if msg.type_of_level == "isobaricInhPa":
        surf_type, level_val = 100, int(round(msg.level * 100.0))
    else:
        surf_type = _LEVEL_CODES[msg.type_of_level]
        level_val = int(round(msg.level))
    tmpl40 = struct.pack(
        ">BBBBBHBBIBBIBBI",
        msg.param_category, msg.param_number,
        2, 0, 0,          # generating process: forecast
        0, 0,             # cutoff
        1,                # time unit: hours
        msg.forecast_hours,
        surf_type, 0, _sm_encode(level_val, 32),
        255, 0, 0)        # no second surface
    sec4 = struct.pack(">IBHH", 9 + len(tmpl40), 4, 0, 0) + tmpl40

    tmpl50 = struct.pack(">fHHBB", ref, _sm_encode(e, 16), 0, nbits, 0)
    sec5 = struct.pack(">IBIH", 11 + len(tmpl50), 5, int(data.size), 0) + tmpl50

    if use_bitmap:
        bm = np.packbits(mask.astype(np.uint8)).tobytes()
        sec6 = struct.pack(">IBB", 6 + len(bm), 6, 0) + bm
    else:
        sec6 = struct.pack(">IBB", 6, 6, 255)

    payload = _pack_bits(x, nbits)
    sec7 = struct.pack(">IB", 5 + len(payload), 7) + payload

    body = sec1 + sec3 + sec4 + sec5 + sec6 + sec7
    total = 16 + len(body) + 4
    sec0 = b"GRIB" + struct.pack(">HBBQ", 0, msg.discipline, 2, total)
    return sec0 + body + b"7777"


def write_messages(path: str, messages: Iterable[Grib2Message],
                   nbits: int = 16) -> None:
    with open(path, "wb") as f:
        for m in messages:
            f.write(encode_message(m, nbits=nbits))
