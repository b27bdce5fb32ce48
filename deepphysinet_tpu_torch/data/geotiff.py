"""Self-contained GeoTIFF reader/writer (no GDAL dependency).

The reference's raster IO goes through GDAL (utils/gdal_utils.py:90-227:
``read_full_image`` / ``save_full_image`` with multiband float rasters and
geo-transform metadata), and its ETL tools emit **tiled DEFLATE** rasters
(tools/extract_variable_from_nc.py:34, extract_variable_from_ERA5.py:28,
calc_rio.py:18: ``TILED=TRUE, COMPRESS=DEFLATE``).  GDAL is not available in
this environment, so this module implements the subset of TIFF 6.0 + GeoTIFF
the framework needs in pure numpy:

* striped AND tiled layouts, contiguous or planar, little or big endian;
* compressions: none, DEFLATE (8 / legacy 32946, via zlib), LZW (5),
  PackBits (32773);
* predictors: none (1), horizontal differencing (2), floating-point (3,
  TIFF Technical Note 3 byte-plane split + differencing);
* uint8 / u/int16 / u/int32 / float32 / float64 samples, 1..N bands;
* ModelPixelScale/ModelTiepoint (affine geo-transform) and the GeoKey
  directory (34735) carrying the CRS, read and written (EPSG codes;
  WKT with an EPSG AUTHORITY is parsed down to its code).

API mirrors gdal_utils so call sites translate one-to-one:
  read_full_image(path, data_format='NUMPY_FORMAT') -> [H, W, C]  (or [C, H, W])
  save_full_image(path, img, geo_transform=..., projection=...)
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_PLANAR_CONFIG = 284
_PREDICTOR = 317
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339
_MODEL_PIXEL_SCALE = 33550  # GeoTIFF
_MODEL_TIEPOINT = 33922  # GeoTIFF
_GEO_KEY_DIRECTORY = 34735
_GEO_DOUBLE_PARAMS = 34736
_GEO_ASCII_PARAMS = 34737

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 11: 4, 12: 8, 16: 8, 17: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 11: "f", 12: "d", 16: "Q", 17: "q"}

_COMP_NONE, _COMP_LZW, _COMP_DEFLATE, _COMP_PACKBITS, _COMP_DEFLATE_OLD = 1, 5, 8, 32773, 32946
_COMPRESSION_NAMES = {
    "none": _COMP_NONE, "deflate": _COMP_DEFLATE, "lzw": _COMP_LZW,
    "packbits": _COMP_PACKBITS,
}

# GeoKey ids (GeoTIFF 1.1)
_GT_MODEL_TYPE = 1024  # 1 = projected, 2 = geographic
_GT_RASTER_TYPE = 1025  # 1 = PixelIsArea
_GEOGRAPHIC_TYPE = 2048  # geographic EPSG code
_PROJECTED_CS_TYPE = 3072  # projected EPSG code

# Geographic-vs-projected classification for the GeoKey directory.  There is
# no closed form over EPSG codes; 4000..4999 is overwhelmingly geographic
# (with a couple of projected exceptions) and a handful of common modern
# geographic CRS live outside it.  Codes not covered default to projected --
# extend _GEOGRAPHIC_EXTRA if a dataset needs another geographic CRS.
_PROJECTED_IN_4XXX = {4087, 4088}  # World Equidistant Cylindrical (+sphere)
_GEOGRAPHIC_EXTRA = {
    6318, 6319,  # NAD83(2011) 2D/3D
    7843, 7844,  # GDA2020 3D/2D
    8999,  # ITRF2008
    9000,  # ITRF2014
    9057,  # ITRF2020... (9057 = ISN2016)
    9989,  # ITRF2020
}


def _is_geographic_epsg(code: int) -> bool:
    if code in _GEOGRAPHIC_EXTRA:
        return True
    return 4000 <= code < 5000 and code not in _PROJECTED_IN_4XXX


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-flavoured LZW (MSB-first bit order, early code-size change)."""
    CLEAR, EOI = 256, 257
    strings = {i: bytes([i]) for i in range(256)}
    next_code, code_size = 258, 9
    result = bytearray()
    bitpos, nbits = 0, len(data) * 8
    prev: Optional[int] = None
    while bitpos + code_size <= nbits:
        byte_pos = bitpos >> 3
        chunk = int.from_bytes(data[byte_pos : byte_pos + 4].ljust(4, b"\0"), "big")
        code = (chunk >> (32 - (bitpos & 7) - code_size)) & ((1 << code_size) - 1)
        bitpos += code_size
        if code == EOI:
            break
        if code == CLEAR:
            strings = {i: bytes([i]) for i in range(256)}
            next_code, code_size, prev = 258, 9, None
            continue
        if prev is None:
            entry = strings[code]
        elif code in strings:
            entry = strings[code]
            strings[next_code] = strings[prev] + entry[:1]
            next_code += 1
        elif code == next_code:
            entry = strings[prev] + strings[prev][:1]
            strings[next_code] = entry
            next_code += 1
        else:
            raise ValueError(f"corrupt LZW stream: code {code} > table size {next_code}")
        # TIFF writers use "early change": the code width grows one code early
        if next_code == (1 << code_size) - 1 and code_size < 12:
            code_size += 1
        result += entry
        prev = code
    return bytes(result)


def _lzw_encode(data: bytes) -> bytes:
    """TIFF-flavoured LZW encoder (MSB-first, early change), for write_tiff."""
    CLEAR, EOI = 256, 257
    table = {bytes([i]): i for i in range(256)}
    next_code, code_size = 258, 9
    out = bytearray()
    acc, nacc = 0, 0

    def emit(code: int, size: int):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    emit(CLEAR, code_size)
    w = b""
    for b in data:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        emit(table[w], code_size)
        table[wc] = next_code
        next_code += 1
        # The encoder's table add leads the decoder's by one code, so its
        # width switch fires one entry later than the decoder's check below
        # (verified against Pillow's TIFF-LZW in both directions).
        if next_code == (1 << code_size) and code_size < 12:
            code_size += 1
        if next_code >= 4094:  # reset before the 12-bit table fills
            emit(CLEAR, code_size)
            table = {bytes([i]): i for i in range(256)}
            next_code, code_size = 258, 9
        w = bytes([b])
    if w:
        emit(table[w], code_size)
    # The decoder adds a table entry after EVERY data code, so after the
    # final code its table is one entry ahead of ours and may have crossed
    # the early-change boundary -- EOI must be written at the width the
    # decoder will read it with (found by fuzzing: EOI at a stale width
    # misparses as a data code past the table).
    if next_code == (1 << code_size) - 1 and code_size < 12:
        code_size += 1
    emit(EOI, code_size)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def _packbits_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n < 128:
            out += data[i : i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i : i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _packbits_encode(data: bytes) -> bytes:
    """Simple literal-run PackBits encoder (valid, not maximally compact)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # find a run of >= 3 identical bytes
        j = i
        while j < n - 1 and j - i < 127 and data[j] == data[j + 1]:
            j += 1
        run = j - i + 1
        if run >= 3:
            out.append((256 - (run - 1)) & 0xFF)  # signed -(run-1)
            out.append(data[i])
            i += run
        else:
            # literal stretch up to the next run or 128 bytes
            k = i
            while (k < n and k - i < 128
                   and not (k < n - 2 and data[k] == data[k + 1] == data[k + 2])):
                k += 1
            out.append(k - i - 1)
            out += data[i:k]
            i = k
    return bytes(out)


def _decompress(seg: bytes, comp: int, expected: Optional[int] = None) -> bytes:
    if comp == _COMP_NONE:
        return seg
    if comp in (_COMP_DEFLATE, _COMP_DEFLATE_OLD):
        return zlib.decompress(seg)  # zlib = C already
    if comp == _COMP_LZW:
        if expected:  # C++ kernel (native/src/dpn_native.cc::dpn_lzw_decode)
            from deepphysinet_tpu_torch import native

            out = native.lzw_decode(seg, expected)
            if out is not None:
                return out
        return _lzw_decode(seg)
    if comp == _COMP_PACKBITS:
        return _packbits_decode(seg)
    raise NotImplementedError(f"TIFF compression {comp} not supported")


def _undo_predictor_values(arr: np.ndarray, predictor: int) -> np.ndarray:
    """Undo predictor 2 on a decoded segment shaped [rows, width, spp]."""
    if predictor == 1:
        return arr
    if predictor == 2:  # horizontal differencing on integer samples
        return np.add.accumulate(arr, axis=1, dtype=arr.dtype)
    raise NotImplementedError(f"TIFF predictor {predictor} not supported")


def _undo_float_predictor(raw: bytes, n_rows: int, row_values: int, itemsize: int) -> np.ndarray:
    """TTN3 floating-point predictor decode -> [n_rows, row_values] float bytes.

    Encoded layout per row: byte-plane-separated big-endian value bytes with
    byte-wise horizontal differencing.  Returns a little-endian byte view.
    """
    b = np.frombuffer(raw, np.uint8).reshape(n_rows, row_values * itemsize).copy()
    b = np.add.accumulate(b, axis=1, dtype=np.uint8)  # undo differencing
    planes = b.reshape(n_rows, itemsize, row_values)  # plane p = byte p of all values
    be = np.moveaxis(planes, 1, 2)  # [rows, values, itemsize] big-endian bytes
    return be[..., ::-1].reshape(n_rows, row_values * itemsize)  # -> little-endian


def _apply_float_predictor(arr: np.ndarray) -> bytes:
    """TTN3 floating-point predictor encode for one segment [rows, w, spp]."""
    n_rows = arr.shape[0]
    row_values = arr.shape[1] * arr.shape[2]
    be = arr.reshape(n_rows, row_values).astype(arr.dtype.newbyteorder(">"))
    bb = be.view(np.uint8).reshape(n_rows, row_values, arr.dtype.itemsize)
    planes = np.moveaxis(bb, 2, 1).reshape(n_rows, -1)  # byte-plane separation
    diff = planes.copy()
    diff[:, 1:] = planes[:, 1:] - planes[:, :-1]
    return diff.tobytes()


def _apply_int_predictor(arr: np.ndarray) -> np.ndarray:
    """Horizontal differencing for one segment [rows, w, spp] (predictor 2)."""
    out = arr.copy()
    out[:, 1:] = arr[:, 1:] - arr[:, :-1]
    return out


def _dtype_from(bits: int, sample_format: int) -> np.dtype:
    if sample_format == 3:  # IEEE float
        return np.dtype({32: np.float32, 64: np.float64}[bits])
    if sample_format == 2:  # signed int
        return np.dtype({8: np.int8, 16: np.int16, 32: np.int32}[bits])
    return np.dtype({8: np.uint8, 16: np.uint16, 32: np.uint32}[bits])


def _read_ifd_entries(buf: bytes, offset: int, bo: str):
    (count,) = struct.unpack_from(bo + "H", buf, offset)
    entries = {}
    for i in range(count):
        tag, typ, n = struct.unpack_from(bo + "HHI", buf, offset + 2 + i * 12)
        value_off = offset + 2 + i * 12 + 8
        size = _TYPE_SIZES.get(typ, 1) * n
        if size > 4:
            (ptr,) = struct.unpack_from(bo + "I", buf, value_off)
            data_off = ptr
        else:
            data_off = value_off
        if typ == 5:  # RATIONAL
            vals = []
            for k in range(n):
                num, den = struct.unpack_from(bo + "II", buf, data_off + 8 * k)
                vals.append(num / den if den else 0.0)
        else:
            fmt = _TYPE_FMT.get(typ)
            if fmt is None:
                continue
            vals = list(struct.unpack_from(bo + fmt * n, buf, data_off))
        entries[tag] = vals
    (next_ifd,) = struct.unpack_from(bo + "I", buf, offset + 2 + count * 12)
    return entries, next_ifd


def _segment_to_values(seg: bytes, comp: int, predictor: int, n_rows: int,
                       seg_w: int, n_ch: int, dtype: np.dtype) -> np.ndarray:
    """Decode one strip/tile to [n_rows, seg_w, n_ch] native-order values."""
    needed = n_rows * seg_w * n_ch * dtype.itemsize
    raw = _decompress(seg, comp, expected=needed)
    if len(raw) < needed:  # tolerate writers that truncate the last segment
        raw = raw + b"\0" * (needed - len(raw))
    if predictor == 3:
        if dtype.kind != "f":
            raise ValueError("float predictor (3) on non-float samples")
        le = _undo_float_predictor(raw[:needed], n_rows, seg_w * n_ch, dtype.itemsize)
        vals = le.view(dtype.newbyteorder("<")).reshape(n_rows, seg_w, n_ch)
        return vals.astype(dtype.newbyteorder("="))
    vals = np.frombuffer(raw, dtype=dtype, count=n_rows * seg_w * n_ch)
    vals = vals.reshape(n_rows, seg_w, n_ch)
    vals = _undo_predictor_values(vals, predictor)
    return vals.astype(dtype.newbyteorder("="))


def _parse_tiff_tags(path: str):
    """(buf, byteorder, first-IFD tag dict) without decoding pixel data."""
    with open(path, "rb") as fp:
        buf = fp.read()
    if buf[:2] == b"II":
        bo = "<"
    elif buf[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    magic, first_ifd = struct.unpack_from(bo + "HI", buf, 2)
    if magic != 42:
        raise ValueError(f"{path}: bad TIFF magic {magic}")
    tags, _ = _read_ifd_entries(buf, first_ifd, bo)
    return buf, bo, tags


def _meta_from_tags(tags):
    """(geo_transform or None, 'EPSG:n' or None) from a parsed tag dict."""
    geo = None
    if _MODEL_PIXEL_SCALE in tags and _MODEL_TIEPOINT in tags:
        sx, sy = tags[_MODEL_PIXEL_SCALE][0], tags[_MODEL_PIXEL_SCALE][1]
        tie = tags[_MODEL_TIEPOINT]
        # tiepoint: (i, j, k, x, y, z) for raster (i, j)
        x0 = tie[3] - tie[0] * sx
        y0 = tie[4] + tie[1] * sy
        geo = (x0, sx, 0.0, y0, 0.0, -sy)

    projection = None
    if _GEO_KEY_DIRECTORY in tags:
        kd = tags[_GEO_KEY_DIRECTORY]
        keys = {}
        for i in range(4, len(kd), 4):
            key_id, loc, count, value = kd[i : i + 4]
            if loc == 0:
                keys[key_id] = value
        code = keys.get(_PROJECTED_CS_TYPE) or keys.get(_GEOGRAPHIC_TYPE)
        if code:
            projection = f"EPSG:{code}"
    return geo, projection


def _read_tiff_impl(path: str):
    buf, bo, tags = _parse_tiff_tags(path)

    width = tags[_IMAGE_WIDTH][0]
    height = tags[_IMAGE_LENGTH][0]
    spp = tags.get(_SAMPLES_PER_PIXEL, [1])[0]
    bits = tags.get(_BITS_PER_SAMPLE, [8])[0]
    comp = tags.get(_COMPRESSION, [1])[0]
    predictor = tags.get(_PREDICTOR, [1])[0]
    sample_format = tags.get(_SAMPLE_FORMAT, [1])[0]
    planar = tags.get(_PLANAR_CONFIG, [1])[0]
    dtype = _dtype_from(bits, sample_format).newbyteorder(bo)
    n_ch = 1 if planar == 2 else spp

    img = np.zeros((height, width, spp), dtype.newbyteorder("="))
    if _TILE_OFFSETS in tags:  # tiled layout (reference tools: TILED=TRUE)
        tw = tags[_TILE_WIDTH][0]
        tl = tags[_TILE_LENGTH][0]
        offsets = tags[_TILE_OFFSETS]
        counts = tags[_TILE_BYTE_COUNTS]
        across = (width + tw - 1) // tw
        down = (height + tl - 1) // tl
        per_plane = across * down
        for idx, (o, c) in enumerate(zip(offsets, counts)):
            plane, rem = divmod(idx, per_plane)
            ty, tx = divmod(rem, across)
            vals = _segment_to_values(buf[o : o + c], comp, predictor, tl, tw, n_ch, dtype)
            y0, x0 = ty * tl, tx * tw
            hh, ww = min(tl, height - y0), min(tw, width - x0)
            if planar == 2:
                img[y0 : y0 + hh, x0 : x0 + ww, plane] = vals[:hh, :ww, 0]
            else:
                img[y0 : y0 + hh, x0 : x0 + ww, :] = vals[:hh, :ww, :]
    else:  # striped layout
        offsets = tags[_STRIP_OFFSETS]
        counts = tags[_STRIP_BYTE_COUNTS]
        rps = tags.get(_ROWS_PER_STRIP, [height])[0]
        strips_per_plane = (height + rps - 1) // rps
        for idx, (o, c) in enumerate(zip(offsets, counts)):
            plane, s = divmod(idx, strips_per_plane) if planar == 2 else (0, idx)
            y0 = s * rps
            n_rows = min(rps, height - y0)
            vals = _segment_to_values(buf[o : o + c], comp, predictor, n_rows, width, n_ch, dtype)
            if planar == 2:
                img[y0 : y0 + n_rows, :, plane] = vals[:, :, 0]
            else:
                img[y0 : y0 + n_rows, :, :] = vals

    geo, projection = _meta_from_tags(tags)
    return np.ascontiguousarray(img), geo, projection


def read_tiff(path: str) -> Tuple[np.ndarray, Optional[Tuple[float, ...]]]:
    """Read a TIFF -> ([H, W, C] array, geo_transform or None).

    geo_transform is GDAL-ordered: (x0, dx, 0, y0, 0, dy).
    """
    img, geo, _ = _read_tiff_impl(path)
    return img, geo


def read_tiff_meta(path: str):
    """Read a TIFF -> ([H, W, C], geo_transform or None, 'EPSG:n' or None)."""
    return _read_tiff_impl(path)


def _epsg_from_projection(projection) -> Optional[int]:
    """EPSG code from an int, 'EPSG:n', or WKT with an EPSG AUTHORITY node."""
    if projection is None:
        return None
    if isinstance(projection, int):
        return projection
    s = str(projection).strip()
    m = re.fullmatch(r"(?i)epsg:\s*(\d+)", s)
    if m:
        return int(m.group(1))
    if s.isdigit():
        return int(s)
    # WKT: the LAST AUTHORITY["EPSG","code"] is the whole-CRS authority
    codes = re.findall(r'AUTHORITY\[\s*"EPSG"\s*,\s*"?(\d+)"?\s*\]', s, re.IGNORECASE)
    if codes:
        return int(codes[-1])
    if "WGS" in s and "84" in s:  # bare WKT without authority nodes
        return 4326
    return None


def _compress_segment(raw: bytes, comp: int) -> bytes:
    if comp == _COMP_NONE:
        return raw
    if comp == _COMP_DEFLATE:
        return zlib.compress(raw, 6)
    if comp == _COMP_LZW:
        return _lzw_encode(raw)
    if comp == _COMP_PACKBITS:
        return _packbits_encode(raw)
    raise NotImplementedError(f"TIFF compression {comp} not supported for write")


def write_tiff(
    path: str,
    img: np.ndarray,
    geo_transform: Optional[Tuple[float, ...]] = None,
    projection=None,
    compression: str = "none",
    tiled: bool = False,
    tile_size: int = 256,
    predictor: int = 1,
) -> None:
    """Write [H, W], [H, W, C] or [C, H, W] as a (Geo)TIFF.

    ``compression``: 'none' | 'deflate' | 'lzw' | 'packbits'.  ``tiled=True``
    writes the tile layout the reference's ETL tools produce (TILED=TRUE,
    extract_variable_from_nc.py:34).  ``predictor``: 1 (none), 2 (integer
    horizontal differencing), 3 (TTN3 float).  ``projection`` (EPSG int,
    'EPSG:n', or WKT with an EPSG authority) is stored in the GeoKey
    directory, mirroring gdal_utils.save_full_image's SetProjection
    (utils/gdal_utils.py:90-127).
    """
    if img.ndim == 2:
        img = img[:, :, None]
    elif img.ndim == 3 and img.shape[0] < min(img.shape[1], img.shape[2]):
        img = np.moveaxis(img, 0, -1)  # [C, H, W] -> [H, W, C]
    h, w, c = img.shape
    img = np.ascontiguousarray(img)

    dt = img.dtype
    if dt == np.float64:
        bits, sf = 64, 3
    elif dt == np.float32:
        bits, sf = 32, 3
    elif dt == np.int32:
        bits, sf = 32, 2
    elif dt == np.int16:
        bits, sf = 16, 2
    elif dt == np.uint8:
        bits, sf = 8, 1
    else:
        img = img.astype(np.float32)
        dt, bits, sf = np.dtype(np.float32), 32, 3
    if predictor == 2 and dt.kind == "f":
        raise ValueError("predictor 2 is for integer samples; use 3 for float")
    if predictor == 3 and dt.kind != "f":
        raise ValueError("predictor 3 is for float samples; use 2 for integers")

    comp = _COMPRESSION_NAMES.get(compression.lower())
    if comp is None:
        raise ValueError(f"unknown compression {compression!r}")
    img_le = img.astype(dt.newbyteorder("<"))

    def encode_segment(seg: np.ndarray) -> bytes:
        """seg: [rows, seg_w, c] -> compressed bytes with predictor applied."""
        if predictor == 3:
            raw = _apply_float_predictor(seg)
        elif predictor == 2:
            raw = _apply_int_predictor(seg).tobytes()
        else:
            raw = seg.tobytes()
        return _compress_segment(raw, comp)

    segments = []
    if tiled:
        ts = tile_size
        if ts % 16:
            raise ValueError("TIFF tile size must be a multiple of 16")
        across = (w + ts - 1) // ts
        down = (h + ts - 1) // ts
        for ty in range(down):
            for tx in range(across):
                tile = np.zeros((ts, ts, c), img_le.dtype)
                y0, x0 = ty * ts, tx * ts
                hh, ww = min(ts, h - y0), min(ts, w - x0)
                tile[:hh, :ww] = img_le[y0 : y0 + hh, x0 : x0 + ww]
                segments.append(encode_segment(tile))
    else:
        # strips of ~64 KiB (many rows) keep memory modest and match libtiff
        rps = max(1, min(h, (1 << 16) // max(1, w * c * dt.itemsize)))
        if comp == _COMP_NONE:
            rps = h  # single strip, round-1 layout
        for y0 in range(0, h, rps):
            segments.append(encode_segment(img_le[y0 : y0 + min(rps, h - y0)]))

    tags = []  # (tag, type, count, value-or-bytes)

    def short(tag, v):
        tags.append((tag, 3, 1, v))

    def long(tag, v):
        tags.append((tag, 4, 1, v))

    def longs(tag, vals):
        tags.append((tag, 4, len(vals), struct.pack("<" + "I" * len(vals), *vals)))

    short(_IMAGE_WIDTH, w)
    short(_IMAGE_LENGTH, h)
    shorts = struct.pack("<" + "H" * c, *([bits] * c))
    tags.append((_BITS_PER_SAMPLE, 3, c, shorts))
    short(_COMPRESSION, comp)
    short(_PHOTOMETRIC, 1)  # BlackIsZero
    short(_SAMPLES_PER_PIXEL, c)
    short(_PLANAR_CONFIG, 1)
    if predictor != 1:
        short(_PREDICTOR, predictor)
    sfs = struct.pack("<" + "H" * c, *([sf] * c))
    tags.append((_SAMPLE_FORMAT, 3, c, sfs))
    if geo_transform is not None:
        x0, dx, _, y0, _, dy = geo_transform
        scale = struct.pack("<3d", abs(dx), abs(dy), 0.0)
        tie = struct.pack("<6d", 0.0, 0.0, 0.0, x0, y0, 0.0)
        tags.append((_MODEL_PIXEL_SCALE, 12, 3, scale))
        tags.append((_MODEL_TIEPOINT, 12, 6, tie))
    epsg = _epsg_from_projection(projection)
    if epsg is not None:
        geographic = _is_geographic_epsg(epsg)
        keys = [
            (_GT_MODEL_TYPE, 0, 1, 2 if geographic else 1),
            (_GT_RASTER_TYPE, 0, 1, 1),  # PixelIsArea (GDAL default)
            (_GEOGRAPHIC_TYPE if geographic else _PROJECTED_CS_TYPE, 0, 1, epsg),
        ]
        kd = [1, 1, 0, len(keys)]
        for k in keys:
            kd.extend(k)
        tags.append((_GEO_KEY_DIRECTORY, 3, len(kd),
                     struct.pack("<" + "H" * len(kd), *kd)))

    # segment offsets/counts (patched after layout)
    counts = [len(s) for s in segments]
    if tiled:
        short(_TILE_WIDTH, tile_size)
        short(_TILE_LENGTH, tile_size)
        longs(_TILE_BYTE_COUNTS, counts)
        offsets_tag = _TILE_OFFSETS
    else:
        short(_ROWS_PER_STRIP, rps if comp != _COMP_NONE else h)
        longs(_STRIP_BYTE_COUNTS, counts)
        offsets_tag = _STRIP_OFFSETS
    longs(offsets_tag, [0] * len(segments))  # patched below

    tags.sort(key=lambda t: t[0])
    n = len(tags)
    header_size = 8
    ifd_size = 2 + n * 12 + 4

    # lay out the out-of-line area, then patch the segment offsets
    extra_offsets = {}
    extra_len = 0
    for tag, typ, count, val in tags:
        if isinstance(val, bytes) and len(val) > 4:
            extra_offsets[tag] = header_size + ifd_size + extra_len
            extra_len += len(val)
    data_offset = header_size + ifd_size + extra_len
    seg_offsets = []
    cursor = data_offset
    for s in segments:
        seg_offsets.append(cursor)
        cursor += len(s)
    patched = struct.pack("<" + "I" * len(seg_offsets), *seg_offsets)
    tags = [
        (tag, typ, count, patched if tag == offsets_tag else val)
        for tag, typ, count, val in tags
    ]

    extra = b""
    out = bytearray()
    out += struct.pack("<2sHI", b"II", 42, header_size)
    out += struct.pack("<H", n)
    for tag, typ, count, val in tags:
        if isinstance(val, bytes):
            if len(val) > 4:
                out += struct.pack("<HHII", tag, typ, count, extra_offsets[tag])
                extra += val
            else:
                out += struct.pack("<HHI", tag, typ, count) + val.ljust(4, b"\0")
        else:
            if typ == 3:
                out += struct.pack("<HHIHH", tag, typ, count, val, 0)
            else:
                out += struct.pack("<HHII", tag, typ, count, val)
    out += struct.pack("<I", 0)  # no next IFD
    out += extra
    for s in segments:
        out += s
    with open(path, "wb") as fp:
        fp.write(out)


# ---- gdal_utils-compatible surface (utils/gdal_utils.py:90-227) ----

def read_full_image(
    img_file: str,
    scale_factor: float = 1.0,
    as_rgb: bool = False,
    data_format: str = "GDAL_FORMAT",
    normalize: bool = False,
) -> np.ndarray:
    """Read a raster; GDAL_FORMAT -> [C, H, W], NUMPY_FORMAT -> [H, W, C]."""
    img, _ = read_tiff(img_file)  # [H, W, C]
    if normalize:
        lo, hi = img.min(), img.max()
        img = (img - lo) / (hi - lo + 1e-12) * 255.0
    if as_rgb and img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if data_format == "NUMPY_FORMAT":
        return img
    return np.moveaxis(img, -1, 0)


def save_full_image(
    img_file: str,
    img: np.ndarray,
    data_format: str = "NUMPY_FORMAT",
    geo_transform: Optional[Tuple[float, ...]] = None,
    projection=None,  # EPSG int / 'EPSG:n' / WKT -> GeoKey directory
    compression: str = "none",
    tiled: bool = False,
) -> None:
    if data_format == "GDAL_FORMAT" and img.ndim == 3:
        img = np.moveaxis(img, 0, -1)
    write_tiff(img_file, np.asarray(img), geo_transform, projection=projection,
               compression=compression, tiled=tiled)


def get_projection(img_file: str) -> Optional[str]:
    """CRS of a raster as 'EPSG:n' (or None), from the GeoKey directory.

    Tag-parse only -- no pixel decode."""
    _, _, tags = _parse_tiff_tags(img_file)
    return _meta_from_tags(tags)[1]


def get_geo_transform(img_file: str):
    """Affine geo-transform; tag-parse only, no pixel decode."""
    _, _, tags = _parse_tiff_tags(img_file)
    return _meta_from_tags(tags)[0]


# gdal_utils naming parity (utils/gdal_utils.py:229)
def get_geoTransform(img_file: str):  # noqa: N802
    return get_geo_transform(img_file)


def get_image_shape(img_file: str) -> Tuple[int, int, int]:
    """(height, width, bands), matching gdal_utils.get_image_shape usage.

    Tag-parse only -- no pixel decode."""
    _, _, tags = _parse_tiff_tags(img_file)
    return (tags[_IMAGE_LENGTH][0], tags[_IMAGE_WIDTH][0],
            tags.get(_SAMPLES_PER_PIXEL, [1])[0])


def read_image(
    img_path: str,
    width_offset: int,
    height_offset: int,
    width: int,
    height: int,
    scale_factor: float = 1,
    as_rgb: bool = True,
    data_format: str = "GDAL_FORMAT",
    normalize: bool = True,
    normalize_factor=16,
    band_idx=None,
) -> np.ndarray:
    """Windowed read with zero-padding past the raster edge
    (utils/gdal_utils.py:150-227).  ``scale_factor`` decimates by striding
    (nearest), which is what GDAL's ReadAsArray resampling amounts to for the
    integer factors the reference uses.
    """
    if data_format not in ("GDAL_FORMAT", "NUMPY_FORMAT"):
        raise ValueError("data_format must be GDAL_FORMAT or NUMPY_FORMAT")
    full, _ = read_tiff(img_path)  # [H, W, C]
    im_h, im_w, im_bands = full.shape
    if band_idx is not None:
        full = full[:, :, [i - 1 for i in band_idx]]  # GDAL bands are 1-based
        im_bands = full.shape[-1]

    block_w = min(width, im_w - width_offset)
    block_h = min(height, im_h - height_offset)
    block = full[height_offset : height_offset + block_h,
                 width_offset : width_offset + block_w].astype(np.float64)
    if scale_factor != 1:
        stride = int(scale_factor)
        block = block[::stride, ::stride]
    out = np.moveaxis(block, -1, 0)  # [C, h, w]

    if im_bands == 1 and as_rgb:
        out = np.tile(out, (3, 1, 1))
    elif im_bands >= 4 and as_rgb:
        out = out[0:3]

    if normalize:
        if isinstance(normalize_factor, int):
            out = (out.astype(np.float32) / normalize_factor).astype(np.uint16)
        elif len(normalize_factor) == 2:
            lo, hi = normalize_factor
            out = np.clip((out.astype(np.float32) - lo) / (hi - lo), 0.0, 1.0) * 255
            out = out.astype(np.uint16)
        else:
            raise NotImplementedError
        out = out.astype(np.uint8)

    scale_w = int(width / scale_factor)
    scale_h = int(height / scale_factor)
    if out.shape[1] != scale_h or out.shape[2] != scale_w:
        out = np.pad(out, ((0, 0), (0, scale_h - out.shape[1]), (0, scale_w - out.shape[2])),
                     mode="constant")
    if data_format == "NUMPY_FORMAT":
        out = np.moveaxis(out, 0, -1)
    return out


# ---- geographic <-> projected transforms (utils/gdal_utils.py:344-397) ----
# Closed form, no pyproj/osr.  Default EPSG:3857 preserves the original
# Web-Mercator-only signature; any CRS data/crs.py supports (4326, 3857, UTM
# 326xx/327xx, LambertConformalConic params) can be passed explicitly.

_EARTH_R = 6378137.0


def lonlat2geo(lon, lat, crs=3857):
    """(lon, lat) degrees -> projected (x, y) meters in ``crs``."""
    from deepphysinet_tpu_torch.data.crs import lonlat2geo as _fwd

    return _fwd(lon, lat, crs)


def geo2lonlat(x, y, crs=3857):
    """Projected (x, y) meters in ``crs`` -> (lon, lat) degrees."""
    from deepphysinet_tpu_torch.data.crs import geo2lonlat as _inv

    return _inv(x, y, crs)
