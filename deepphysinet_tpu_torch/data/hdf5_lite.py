"""Stdlib-only minimal HDF5 reader for netCDF-4 ERA5 ingest.

The port's own copy of ``deepphysinet_tpu/data/hdf5_lite.py`` (numpy and zlib only, unchanged), so
that ``tools/extract_variable_from_ERA5.py`` of the port reads CDS netCDF-4 downloads on a machine
without netCDF4 or h5py, and imports nothing of the JAX package.

Modern CDS ERA5 downloads are netCDF-4 (an HDF5 container); the reference read them with the
netCDF4 library.  This module parses the HDF5 file format (spec v3) directly with struct + zlib,
covering what netCDF-4 / h5py writers produce for such files:

* superblock versions 0/1 (old-style, what the netCDF-4 C library and h5py's
  default 'earliest' libver write) and 2/3 (libver='latest'),
* object headers version 1 (with continuation blocks) and 2 ("OHDR", gzip'd
  chunk checksums skipped, "OCHK" continuations),
* groups via v1 symbol tables (B-tree + local heap + SNOD nodes) AND via
  compact Link messages (new-style groups); dense (fractal-heap) link
  storage is detected and rejected with a clear error,
* dataspace/datatype/data-layout/filter-pipeline/attribute messages,
  fixed-point / IEEE-float / fixed-string datatypes,
* contiguous and chunked (v1 chunk B-tree) data layouts with the
  shuffle + deflate filters ERA5 files use (fletcher32 checksums stripped),
* CF mask-and-scale on access (scale_factor/add_offset/_FillValue), so the
  packed-int16 ERA5 convention decodes exactly like netCDF4's default
  ``set_auto_maskandscale(True)``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off_size = 8  # size of offsets, set by the superblock
        self.len_size = 8  # size of lengths

    def u(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def offset(self, pos: int) -> int:
        return self.u(pos, self.off_size)

    def length(self, pos: int) -> int:
        return self.u(pos, self.len_size)


class H5Dataset:
    """One dataset: metadata + lazy decode of contiguous/chunked storage."""

    def __init__(self, name: str, rd: _Reader, shape, dtype, layout, filters,
                 attrs):
        self.name = name
        self._rd = rd
        self.shape = tuple(shape)
        self.dtype = dtype
        self._layout = layout  # ("contiguous", addr, size) | ("chunked", addr, chunk_dims) | ("compact", bytes)
        self._filters = filters  # list of (filter_id, client_values)
        self.attributes = attrs

    # -- raw decode ---------------------------------------------------------
    def _apply_filters(self, raw: bytes, filter_mask: int) -> bytes:
        # filters apply in reverse order on read; mask bit i set = skipped
        for i, (fid, cd) in reversed(list(enumerate(self._filters))):
            if filter_mask & (1 << i):
                continue
            if fid == 1:  # deflate
                raw = zlib.decompress(raw)
            elif fid == 2:  # shuffle: de-interleave bytes
                (esize,) = cd[:1] or (self.dtype.itemsize,)
                n = len(raw) // esize
                arr = np.frombuffer(raw, np.uint8)
                raw = arr.reshape(esize, n).T.tobytes()
            elif fid == 3:  # fletcher32: payload + 4-byte checksum
                raw = raw[:-4]
            else:
                raise NotImplementedError(f"HDF5 filter id {fid} unsupported "
                                          "(deflate/shuffle/fletcher32 only)")
        return raw

    def _read_chunk_btree(self, addr: int, rank: int,
                          out: np.ndarray, chunk_dims) -> None:
        rd = self._rd
        if rd.buf[addr:addr + 4] != b"TREE":
            raise ValueError("bad chunk B-tree signature")
        node_type = rd.buf[addr + 4]
        level = rd.buf[addr + 5]
        n_used = rd.u(addr + 6, 2)
        if node_type != 1:
            raise ValueError("expected raw-data chunk B-tree (type 1)")
        pos = addr + 8 + 2 * rd.off_size  # skip siblings
        key_size = 8 + 8 * (rank + 1)  # size(4) + mask(4) + offsets
        for _ in range(n_used):
            chunk_size = rd.u(pos, 4)
            filter_mask = rd.u(pos + 4, 4)
            offs = [rd.u(pos + 8 + 8 * d, 8) for d in range(rank)]
            child = rd.offset(pos + key_size)
            if level > 0:
                self._read_chunk_btree(child, rank, out, chunk_dims)
            else:
                raw = rd.buf[child:child + chunk_size]
                raw = self._apply_filters(raw, filter_mask)
                chunk = np.frombuffer(raw, self.dtype,
                                      int(np.prod(chunk_dims)))
                chunk = chunk.reshape(chunk_dims)
                sel_out, sel_in = [], []
                for d in range(rank):
                    lo = offs[d]
                    hi = min(lo + chunk_dims[d], self.shape[d])
                    sel_out.append(slice(lo, hi))
                    sel_in.append(slice(0, hi - lo))
                out[tuple(sel_out)] = chunk[tuple(sel_in)]
            pos += key_size + rd.off_size

    def read(self) -> np.ndarray:
        kind = self._layout[0]
        n = int(np.prod(self.shape, dtype=np.int64)) if self.shape else 1
        if kind == "compact":
            raw = self._layout[1]
            return np.frombuffer(raw, self.dtype, n).reshape(self.shape)
        if kind == "contiguous":
            addr, size = self._layout[1], self._layout[2]
            if addr == _UNDEFINED:
                return np.zeros(self.shape, self.dtype)
            raw = self._rd.buf[addr:addr + size]
            return np.frombuffer(raw, self.dtype, n).reshape(self.shape)
        if kind == "chunked":
            addr, chunk_dims = self._layout[1], self._layout[2]
            out = np.zeros(self.shape, self.dtype)
            if addr != _UNDEFINED:
                self._read_chunk_btree(addr, len(self.shape), out, chunk_dims)
            return out
        if kind == "chunked4_single":
            addr, chunk_dims, csize, mask = self._layout[1:5]
            out = np.zeros(self.shape, self.dtype)
            if addr != _UNDEFINED:
                raw = self._rd.buf[addr:addr + csize] if csize is not None \
                    else self._rd.buf[addr:addr + self.dtype.itemsize
                                      * int(np.prod(chunk_dims))]
                if csize is not None:
                    raw = self._apply_filters(raw, mask)
                self._place_chunk(out, (0,) * len(self.shape), chunk_dims, raw)
            return out
        if kind == "chunked4_farr":
            addr, chunk_dims = self._layout[1], self._layout[2]
            return self._read_fixed_array(addr, chunk_dims)
        if kind == "chunked4_implicit":
            addr, chunk_dims = self._layout[1], self._layout[2]
            out = np.zeros(self.shape, self.dtype)
            nbytes = self.dtype.itemsize * int(np.prod(chunk_dims))
            for i, origin in enumerate(self._chunk_origins(chunk_dims)):
                raw = self._rd.buf[addr + i * nbytes:addr + (i + 1) * nbytes]
                self._place_chunk(out, origin, chunk_dims, raw)
            return out
        raise NotImplementedError(kind)

    def _chunk_origins(self, chunk_dims):
        """Row-major chunk-grid origins (the fixed/implicit index order)."""
        from itertools import product as iproduct
        ranges = [range(0, self.shape[d], chunk_dims[d])
                  for d in range(len(self.shape))]
        return iproduct(*ranges)

    def _place_chunk(self, out, origin, chunk_dims, raw: bytes) -> None:
        chunk = np.frombuffer(raw, self.dtype, int(np.prod(chunk_dims)))
        chunk = chunk.reshape(chunk_dims)
        sel_out, sel_in = [], []
        for d in range(len(self.shape)):
            lo = origin[d]
            hi = min(lo + chunk_dims[d], self.shape[d])
            sel_out.append(slice(lo, hi))
            sel_in.append(slice(0, hi - lo))
        out[tuple(sel_out)] = chunk[tuple(sel_in)]

    def _read_fixed_array(self, addr: int, chunk_dims):
        """Layout-v4 Fixed Array chunk index (FAHD header + FADB block)."""
        rd = self._rd
        out = np.zeros(self.shape, self.dtype)
        if addr == _UNDEFINED:
            return out
        if rd.buf[addr:addr + 4] != b"FAHD":
            raise ValueError("bad fixed-array header signature")
        filtered = rd.buf[addr + 5] == 1  # client id 1: filtered chunks
        entry_size = rd.buf[addr + 6]
        page_bits = rd.buf[addr + 7]
        nelmts = rd.length(addr + 8)
        db_addr = rd.offset(addr + 8 + rd.len_size)
        if rd.buf[db_addr:db_addr + 4] != b"FADB":
            raise ValueError("bad fixed-array data block signature")
        pos = db_addr + 6 + rd.off_size
        page_size = 1 << page_bits
        origins = list(self._chunk_origins(chunk_dims))
        if nelmts > page_size:
            # paged layout: bitmap, then pages of elements each + checksum
            npages = (nelmts + page_size - 1) // page_size
            pos += (npages + 7) // 8
            pos += 4  # checksum of the data-block header part
            elements = b""
            left = nelmts
            while left > 0:
                take = min(page_size, left)
                elements += rd.buf[pos:pos + take * entry_size]
                pos += take * entry_size + 4  # + page checksum
                left -= take
        else:
            elements = rd.buf[pos:pos + nelmts * entry_size]
        for i in range(min(nelmts, len(origins))):
            e = elements[i * entry_size:(i + 1) * entry_size]
            caddr = int.from_bytes(e[:rd.off_size], "little")
            if caddr == _UNDEFINED:
                continue
            if filtered:
                size_len = entry_size - rd.off_size - 4
                csize = int.from_bytes(
                    e[rd.off_size:rd.off_size + size_len], "little")
                mask = int.from_bytes(e[-4:], "little")
                raw = self._apply_filters(rd.buf[caddr:caddr + csize], mask)
            else:
                raw = rd.buf[caddr:caddr + self.dtype.itemsize
                             * int(np.prod(chunk_dims))]
            self._place_chunk(out, origins[i], chunk_dims, raw)
        return out


# ---------------------------------------------------------------------------
# message parsers
# ---------------------------------------------------------------------------

def _parse_dataspace(body: bytes) -> Tuple[int, ...]:
    version = body[0]
    rank = body[1]
    if version == 1:
        pos = 8
    elif version == 2:
        pos = 4
    else:
        raise ValueError(f"dataspace version {version} unsupported")
    return tuple(int.from_bytes(body[pos + 8 * d:pos + 8 * d + 8], "little")
                 for d in range(rank))


def _parse_datatype(body: bytes) -> np.dtype:
    cls = body[0] & 0x0F
    bits0 = body[1]
    size = int.from_bytes(body[4:8], "little")
    if cls == 0:  # fixed-point
        order = ">" if (bits0 & 1) else "<"
        kind = "i" if (bits0 >> 3) & 1 else "u"
        return np.dtype(f"{order}{kind}{size}")
    if cls == 1:  # IEEE float
        order = ">" if (bits0 & 1) else "<"
        return np.dtype(f"{order}f{size}")
    if cls == 3:  # fixed string
        return np.dtype(f"S{size}")
    raise NotImplementedError(f"HDF5 datatype class {cls} unsupported "
                              "(fixed-point/float/fixed-string only)")


def _parse_layout(rd: _Reader, body: bytes):
    version = body[0]
    if version == 3:
        cls = body[1]
        if cls == 0:  # compact
            size = int.from_bytes(body[2:4], "little")
            return ("compact", body[4:4 + size], None)
        if cls == 1:  # contiguous
            addr = int.from_bytes(body[2:2 + rd.off_size], "little")
            size = int.from_bytes(
                body[2 + rd.off_size:2 + rd.off_size + rd.len_size], "little")
            return ("contiguous", addr, size)
        if cls == 2:  # chunked: dimensionality = rank + 1 (element size last)
            dimensionality = body[2]
            addr = int.from_bytes(body[3:3 + rd.off_size], "little")
            pos = 3 + rd.off_size
            dims = [int.from_bytes(body[pos + 4 * d:pos + 4 * d + 4], "little")
                    for d in range(dimensionality)]
            return ("chunked", addr, tuple(dims[:-1]))
        raise NotImplementedError(f"layout class {cls} unsupported")
    if version in (1, 2):
        dimensionality = body[1]
        cls = body[2]
        pos = 8
        if cls == 1:
            addr = int.from_bytes(body[pos:pos + rd.off_size], "little")
            pos += rd.off_size
            dims = [int.from_bytes(body[pos + 4 * d:pos + 4 * d + 4], "little")
                    for d in range(dimensionality)]
            size = int.from_bytes(body[pos + 4 * dimensionality:
                                       pos + 4 * dimensionality + 4], "little")
            return ("contiguous", addr, size)
        if cls == 2:
            addr = int.from_bytes(body[pos:pos + rd.off_size], "little")
            pos += rd.off_size
            dims = [int.from_bytes(body[pos + 4 * d:pos + 4 * d + 4], "little")
                    for d in range(dimensionality)]
            return ("chunked", addr, tuple(dims[:-1]))
        raise NotImplementedError(f"layout v{version} class {cls} unsupported")
    if version == 4:
        cls = body[1]
        if cls == 0:
            size = int.from_bytes(body[2:4], "little")
            return ("compact", body[4:4 + size], None)
        if cls == 1:
            addr = int.from_bytes(body[2:2 + rd.off_size], "little")
            size = int.from_bytes(
                body[2 + rd.off_size:2 + rd.off_size + rd.len_size], "little")
            return ("contiguous", addr, size)
        if cls == 2:
            # v4 chunked: flags(1), dimensionality(1), dim-size-encoded-
            # length(1), dims, chunk-index type(1), index fields, address(O)
            flags = body[2]
            dimensionality = body[3]
            enc = body[4]
            pos = 5
            dims = [int.from_bytes(body[pos + enc * d:pos + enc * (d + 1)],
                                   "little") for d in range(dimensionality)]
            pos += enc * dimensionality
            dims = dims[:-1]  # final entry is the element size (like v3)
            index_type = body[pos]
            pos += 1
            if index_type == 1:  # single chunk
                if flags & 0x02:  # filtered: size + mask precede the address
                    csize = int.from_bytes(body[pos:pos + rd.len_size],
                                           "little")
                    mask = int.from_bytes(body[pos + rd.len_size:
                                               pos + rd.len_size + 4], "little")
                    pos += rd.len_size + 4
                    addr = int.from_bytes(body[pos:pos + rd.off_size], "little")
                    return ("chunked4_single", addr, tuple(dims), csize, mask)
                addr = int.from_bytes(body[pos:pos + rd.off_size], "little")
                return ("chunked4_single", addr, tuple(dims), None, 0)
            if index_type == 2:  # implicit: contiguous unfiltered chunks
                addr = int.from_bytes(body[pos:pos + rd.off_size], "little")
                return ("chunked4_implicit", addr, tuple(dims))
            if index_type == 3:  # fixed array
                pos += 1  # page bits
                addr = int.from_bytes(body[pos:pos + rd.off_size], "little")
                # filtered-ness lives in the FAHD client id, read later
                return ("chunked4_farr", addr, tuple(dims))
            raise NotImplementedError(
                f"layout v4 chunk index type {index_type} unsupported "
                "(single/implicit/fixed-array only)")
        raise NotImplementedError(f"layout v4 class {cls} unsupported")
    raise NotImplementedError(f"data layout version {version} unsupported")


def _parse_filters(body: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
    version = body[0]
    nfilters = body[1]
    out = []
    if version == 1:
        pos = 8
        for _ in range(nfilters):
            fid = int.from_bytes(body[pos:pos + 2], "little")
            name_len = int.from_bytes(body[pos + 2:pos + 4], "little")
            n_cd = int.from_bytes(body[pos + 6:pos + 8], "little")
            pos += 8
            pos += (name_len + 7) // 8 * 8
            cd = tuple(int.from_bytes(body[pos + 4 * i:pos + 4 * i + 4],
                                      "little") for i in range(n_cd))
            pos += 4 * n_cd
            if n_cd % 2:
                pos += 4
            out.append((fid, cd))
        return out
    if version == 2:
        pos = 2
        for _ in range(nfilters):
            fid = int.from_bytes(body[pos:pos + 2], "little")
            pos += 2
            name_len = 0
            if fid >= 256:
                name_len = int.from_bytes(body[pos:pos + 2], "little")
                pos += 2
            pos += 2  # flags
            n_cd = int.from_bytes(body[pos:pos + 2], "little")
            pos += 2
            pos += name_len
            cd = tuple(int.from_bytes(body[pos + 4 * i:pos + 4 * i + 4],
                                      "little") for i in range(n_cd))
            pos += 4 * n_cd
            out.append((fid, cd))
        return out
    raise ValueError(f"filter pipeline version {version} unsupported")


def _attr_value(dtype: np.dtype, shape, data: bytes):
    if dtype.kind == "S":
        raw = data[:dtype.itemsize]
        return raw.split(b"\x00", 1)[0].decode("utf-8", "replace")
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    arr = np.frombuffer(data, dtype, n)
    if not shape:
        return arr[0].item() if dtype.kind in "iu" else arr.astype(
            arr.dtype.newbyteorder("="))[0]
    return arr.reshape(shape).astype(arr.dtype.newbyteorder("="))


def _parse_attribute(body: bytes):
    version = body[0]
    name_size = int.from_bytes(body[2:4], "little")
    dt_size = int.from_bytes(body[4:6], "little")
    ds_size = int.from_bytes(body[6:8], "little")
    if version == 1:
        pos = 8
        name = body[pos:pos + name_size].split(b"\x00")[0].decode()
        pos += (name_size + 7) // 8 * 8
        dt = body[pos:pos + dt_size]
        pos += (dt_size + 7) // 8 * 8
        ds = body[pos:pos + ds_size]
        pos += (ds_size + 7) // 8 * 8
    elif version in (2, 3):
        pos = 8 + (1 if version == 3 else 0)
        name = body[pos:pos + name_size].split(b"\x00")[0].decode()
        pos += name_size
        dt = body[pos:pos + dt_size]
        pos += dt_size
        ds = body[pos:pos + ds_size]
        pos += ds_size
    else:
        raise ValueError(f"attribute message version {version} unsupported")
    try:
        dtype = _parse_datatype(dt)
    except NotImplementedError:
        return name, None  # reference/vlen attrs (DIMENSION_LIST): skipped
    shape = _parse_dataspace(ds)
    return name, _attr_value(dtype, shape, body[pos:])


# ---------------------------------------------------------------------------
# object headers
# ---------------------------------------------------------------------------

def _messages_v1(rd: _Reader, addr: int):
    nmsgs = rd.u(addr + 2, 2)
    header_size = rd.u(addr + 8, 4)
    blocks = [(addr + 16, header_size)]
    msgs = []
    bi = 0
    while bi < len(blocks):
        pos, size = blocks[bi]
        end = pos + size
        while pos + 8 <= end and len(msgs) < nmsgs:
            mtype = rd.u(pos, 2)
            msize = rd.u(pos + 2, 2)
            body = rd.buf[pos + 8:pos + 8 + msize]
            if mtype == 0x0010:  # continuation
                blocks.append((int.from_bytes(body[:rd.off_size], "little"),
                               int.from_bytes(body[rd.off_size:rd.off_size
                                                   + rd.len_size], "little")))
            else:
                msgs.append((mtype, body))
            pos += 8 + msize
        bi += 1
    return msgs


def _messages_v2(rd: _Reader, addr: int):
    if rd.buf[addr:addr + 4] != b"OHDR":
        raise ValueError("bad v2 object header signature")
    flags = rd.buf[addr + 5]
    pos = addr + 6
    if flags & 0x20:
        pos += 16  # times
    if flags & 0x10:
        pos += 4  # max compact / min dense
    size_bytes = 1 << (flags & 0x03)
    chunk0_size = rd.u(pos, size_bytes)
    pos += size_bytes
    track_order = bool(flags & 0x04)
    blocks = [(pos, chunk0_size)]
    msgs = []
    bi = 0
    while bi < len(blocks):
        p, size = blocks[bi]
        end = p + size - 4  # trailing checksum
        while p + 4 <= end:
            mtype = rd.buf[p]
            msize = rd.u(p + 1, 2)
            p += 4
            if track_order:
                p += 2
            body = rd.buf[p:p + msize]
            if mtype == 0x10:
                caddr = int.from_bytes(body[:rd.off_size], "little")
                clen = int.from_bytes(body[rd.off_size:rd.off_size
                                           + rd.len_size], "little")
                # OCHK continuation: signature(4) ... checksum(4)
                blocks.append((caddr + 4, clen - 4))
            else:
                msgs.append((mtype, body))
            p += msize
        bi += 1
    return msgs


def _read_messages(rd: _Reader, addr: int):
    if rd.buf[addr:addr + 4] == b"OHDR":
        return _messages_v2(rd, addr)
    if rd.buf[addr] == 1:
        return _messages_v1(rd, addr)
    raise ValueError(f"unknown object header at {addr:#x}")


# ---------------------------------------------------------------------------
# groups
# ---------------------------------------------------------------------------

def _walk_symbol_table(rd: _Reader, btree_addr: int, heap_addr: int):
    """Old-style group: B-tree of SNOD nodes, names in the local heap."""
    if rd.buf[heap_addr:heap_addr + 4] != b"HEAP":
        raise ValueError("bad local heap signature")
    heap_data = rd.offset(heap_addr + 8 + 2 * rd.len_size)

    def name_at(off: int) -> str:
        end = rd.buf.index(b"\x00", heap_data + off)
        return rd.buf[heap_data + off:end].decode()

    links = []

    def walk(addr: int):
        if rd.buf[addr:addr + 4] == b"SNOD":
            nsyms = rd.u(addr + 6, 2)
            pos = addr + 8
            entry = 2 * rd.off_size + 24
            for _ in range(nsyms):
                links.append((name_at(rd.offset(pos)),
                              rd.offset(pos + rd.off_size)))
                pos += entry
            return
        if rd.buf[addr:addr + 4] != b"TREE":
            raise ValueError("bad group B-tree signature")
        n_used = rd.u(addr + 6, 2)
        pos = addr + 8 + 2 * rd.off_size + rd.len_size  # skip siblings + key0
        for _ in range(n_used):
            walk(rd.offset(pos))
            pos += rd.off_size + rd.len_size
    walk(btree_addr)
    return links


def _parse_link(rd: _Reader, body: bytes) -> Optional[Tuple[str, int]]:
    version = body[0]
    if version != 1:
        raise ValueError(f"link message version {version} unsupported")
    flags = body[1]
    pos = 2
    ltype = 0
    if flags & 0x08:
        ltype = body[pos]
        pos += 1
    if flags & 0x04:
        pos += 8  # creation order
    if flags & 0x10:
        pos += 1  # charset
    len_size = 1 << (flags & 0x03)
    name_len = int.from_bytes(body[pos:pos + len_size], "little")
    pos += len_size
    name = body[pos:pos + name_len].decode()
    pos += name_len
    if ltype != 0:
        return None  # soft/external links: not needed for ERA5 ingest
    return name, int.from_bytes(body[pos:pos + rd.off_size], "little")


# ---------------------------------------------------------------------------
# file
# ---------------------------------------------------------------------------

class HDF5LiteFile:
    """Flat view of an HDF5 file: root-group datasets (ERA5 layout)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            buf = f.read()
        pos = 0
        while True:
            if buf[pos:pos + 8] == _SIGNATURE:
                break
            pos = 512 if pos == 0 else pos * 2
            if pos + 8 > len(buf):
                raise ValueError(f"{path}: not an HDF5 file")
        rd = _Reader(buf)
        version = buf[pos + 8]
        if version in (0, 1):
            rd.off_size = buf[pos + 13]
            rd.len_size = buf[pos + 14]
            entry = (pos + 24 + 4 * rd.off_size
                     + (4 if version == 1 else 0))
            root_oh = rd.offset(entry + rd.off_size)
        elif version in (2, 3):
            rd.off_size = buf[pos + 9]
            rd.len_size = buf[pos + 10]
            # sig(8) ver(1) off(1) len(1) flags(1), then base / extension /
            # eof / root-object-header addresses (each off_size) + checksum
            root_oh = rd.offset(pos + 12 + 3 * rd.off_size)
        else:
            raise ValueError(f"superblock version {version} unsupported")
        self._rd = rd
        self.datasets: Dict[str, H5Dataset] = {}
        self._load_group(root_oh, prefix="")

    def _load_group(self, oh_addr: int, prefix: str) -> None:
        rd = self._rd
        links: List[Tuple[str, int]] = []
        for mtype, body in _read_messages(rd, oh_addr):
            if mtype == 0x0011:  # symbol table
                btree = int.from_bytes(body[:rd.off_size], "little")
                heap = int.from_bytes(body[rd.off_size:2 * rd.off_size],
                                      "little")
                links.extend(_walk_symbol_table(rd, btree, heap))
            elif mtype == 0x0006:  # compact link
                link = _parse_link(rd, body)
                if link:
                    links.append(link)
            elif mtype == 0x0002:  # link info: dense storage check
                flags = body[1]
                p = 2 + (8 if flags & 1 else 0)
                fheap = int.from_bytes(body[p:p + rd.off_size], "little")
                if fheap != _UNDEFINED:
                    raise NotImplementedError(
                        "dense (fractal-heap) link storage unsupported; "
                        "file written with many links + latest libver")
        for name, addr in links:
            self._load_object(addr, prefix + name)

    def _load_object(self, oh_addr: int, name: str) -> None:
        rd = self._rd
        msgs = _read_messages(rd, oh_addr)
        types = {t for t, _ in msgs}
        if 0x0011 in types or 0x0002 in types or (
                0x0006 in types and 0x0008 not in types):
            self._load_group(oh_addr, prefix=name + "/")
            return
        if 0x0008 not in types:
            return  # neither dataset nor group we understand
        shape: Tuple[int, ...] = ()
        dtype = None
        layout = None
        filters: List = []
        attrs: Dict[str, object] = {}
        for mtype, body in msgs:
            if mtype == 0x0001:
                shape = _parse_dataspace(body)
            elif mtype == 0x0003:
                dtype = _parse_datatype(body)
            elif mtype == 0x0008:
                layout = _parse_layout(rd, body)
            elif mtype == 0x000B:
                filters = _parse_filters(body)
            elif mtype == 0x000C:
                aname, aval = _parse_attribute(body)
                if aval is not None:
                    attrs[aname] = aval
        if dtype is None or layout is None:
            raise ValueError(f"dataset {name!r}: missing datatype/layout")
        self.datasets[name] = H5Dataset(name, rd, shape, dtype, layout,
                                        filters, attrs)


class H5Variable:
    """netCDF4-compatible variable view over one HDF5 dataset.

    Indexing returns ``np.ma.MaskedArray`` with CF mask-and-scale applied —
    the same access contract as data/netcdf_classic.py's NCVariable, so the
    ERA5 ETL core works identically over classic and HDF5 containers.
    """

    def __init__(self, ds: H5Dataset):
        self._ds = ds
        self.name = ds.name
        self.attributes = ds.attributes
        self.shape = ds.shape
        self.dtype = ds.dtype
        self._cache: Optional[np.ndarray] = None

    def ncattrs(self):
        return list(self.attributes)

    def getncattr(self, name):
        return self.attributes[name]

    def __len__(self):
        if not self.shape:
            raise TypeError(f"len() of scalar variable {self.name!r}")
        return self.shape[0]

    def _raw(self) -> np.ndarray:
        if self._cache is None:
            self._cache = self._ds.read()
        return self._cache

    def _convert(self, raw: np.ndarray) -> np.ma.MaskedArray:
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
            # netCDF4's set_auto_maskandscale unpacks in the ATTRIBUTE dtype
            # (float64 for CDS-produced ERA5 int16 packing), not a size class
            # of the packed dtype — match it so labels ingested through this
            # reader agree with the netCDF4 path to float64 round-off.
            attr_dt = np.result_type(*[np.asarray(a).dtype
                                       for a in (scale, offset)
                                       if a is not None])
            data = raw.astype(np.promote_types(attr_dt, np.float32))
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
            return np.ma.MaskedArray(out)
        return out

    def __array__(self, dtype=None):
        arr = np.ma.filled(self._convert(self._raw()), np.nan)
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return (f"<H5Variable {self.name} {self.dtype} shape={self.shape}>")


def open_variables(path: str) -> Dict[str, H5Variable]:
    """netCDF4-like ``.variables`` dict for a netCDF-4/HDF5 file."""
    f = HDF5LiteFile(path)
    return {name: H5Variable(ds) for name, ds in f.datasets.items()}
