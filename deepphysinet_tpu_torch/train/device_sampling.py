"""Sampling on the device: a window's cubes stay on the card and every step draws fresh points.

Counterpart of ``deepphysinet_tpu/train/device_sampling.py``.  The host builds a window's cubes
once (``PhysicsDataset.get_cube_item``):

  field       [159, 2405]      token matrix
  nwp_cube    [Hc, Wc, Tc, 6]  normalized coarse NWP window
  label_cube  [Hl, Wl, Tl, 6]  normalized ERA5 window

channel-last and flattened to row tables ``[B*H*W*T, 6]`` (``CubeBatch``), so that a point's six
variables are one row and a lookup is one row gather.  The trainer keeps them on the device in an
LRU (``DeviceLRU``), and each step draws margin and collocation points there, gathers the labels,
interpolates the conditioning (``ops/interp.py``'s row-table forms) and computes the Coriolis
parameter.  The distributions are the reference's (dataset/physics_dataset.py:334-338, 442-446):

  margin  integer grid x ~ U{0..Wl-1}, y ~ U{0..Hl-1}, slot ~ U{0..Tl-1}
  inter   continuous x ~ U[0, 1) (Wl-1), y ~ U[0, 1) (Hl-1), integer hour t ~ U{0..window_h}

The ``'pool'`` sampler takes a step's margin points as one contiguous slice, at a random offset,
of a per-window permutation of the label grid built once on the host (``build_pool``), with its
conditioning interpolated once on the device (``attach_pool_nwp``).

Where the JAX module draws with ``jax.random`` keys split per window, the port draws from one
``torch.Generator`` on the cubes' device through one seam, ``draw_points``: the integer and uniform
tensors ``mx, my, slot, off, ix, iy, it`` of a ``Draws``.  Both samplers consume all seven, so the
sampler switch changes no collocation point of a run (JAX: the same key splits k4..k6 in both), and
tests can hand the samplers JAX's own draws.  The steps are ``train/train_step.py``'s on the
``Batch`` that ``sample_batch`` draws, with the lead time unsnapped, as JAX's (``make_ds_loss_fn``);
the host-sampled step snaps it when ``forecast_h_snap`` > 0.
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.ops.coords import OMEGA
from deepphysinet_tpu_torch.ops.interp import (
    trilinear_interp_rows, trilinear_interp_table, trilinear_interp_table_batched)
from deepphysinet_tpu_torch.train.train_step import (
    Batch, PointBatch, StepConfig, TrainState, make_eval_step, make_loss_fn, make_train_step)


class CubeBatch(NamedTuple):
    """A batch of windows' cubes as channel-last, window-major row tables: row ``b*X + flat`` is
    window b's grid point ``flat`` = ``(y*W + x)*T + t``.  The ``pool_*`` fields are the optional
    per-window permuted label pool of the ``'pool'`` sampler (``build_pool``); with a pool,
    ``label_cube`` may be None, since the pool holds every label row.  Host instances hold numpy
    arrays (``cube_batch_host``), device instances tensors (``cube_to_device``)."""

    field: object  # [B, L, enc_in]
    forecast_h: object  # [B]
    nwp_cube: object  # [B*Hc*Wc*Tc, 6] normalized NWP window rows
    label_cube: Optional[object]  # [B*Hl*Wl*Tl, 6] normalized ERA5 rows
    pool_rows: Optional[object] = None  # [B, X+pad, 6] permuted label rows
    pool_idx: Optional[object] = None  # [B, X+pad] int32 flat grid indices
    pool_nwp: Optional[object] = None  # [B, X+pad, 6] NWP conditioning at the pool's points


class DeviceLRU:
    """A bounded LRU of device-resident values (window cubes), shared by the training loop's cube
    cache and the validation cubes.  ``builds`` and ``hits`` count what ``get`` did."""

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._d: "OrderedDict" = OrderedDict()
        self.builds = self.hits = 0

    def get(self, key, build):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        value = build()
        self.builds += 1
        self._d[key] = value
        if len(self._d) > self.cap:
            self._d.popitem(last=False)
        return value


def build_pool(label_cube_cl, pad: int, seed: int):
    """The permuted label pool of one window (host numpy, the ``'pool'`` sampler).

    ``label_cube_cl``: [Hl, Wl, Tl, C] channel-last window.  Returns ``(rows [X+pad, C] float32,
    idx [X+pad] int32)``: row j holds the labels at the flat grid index ``idx[j] = (y*Wl + x)*Tl +
    slot``, ``idx`` a uniform permutation of the X = Hl*Wl*Tl grid points followed by its own first
    ``pad`` entries, so that any slice ``[off, off + pad)`` with ``off < X`` lies inside.  A step's
    points are then marginally uniform over the grid, as the iid draw's, but without replacement
    within a step."""
    lab = np.asarray(label_cube_cl, np.float32)
    Hl, Wl, Tl, C = lab.shape
    X = Hl * Wl * Tl
    perm = np.random.RandomState(seed).permutation(X).astype(np.int32)
    rows = lab.reshape(X, C)[perm]
    rows = np.concatenate([rows, rows[:pad]], axis=0)
    idx = np.concatenate([perm, perm[:pad]], axis=0)
    return np.ascontiguousarray(rows), np.ascontiguousarray(idx)


def expected_cube_dims(scfg, coord_spec):
    """((Hl, Wl, Tl), (Hc, Wc, Tc)) that the samplers assume for this configuration: the
    ``expect_dims`` of the cube builders, which fail on a geometry the flat row tables could not
    tell apart (a transposed lat / lon size has the same row count)."""
    return (label_grid_dims(scfg, coord_spec), coarse_grid_dims(scfg, coord_spec))


def cube_batch_host(field, forecast_h, nwp_cube_cf, label_cube_cf, pool_pad: Optional[int] = None, pool_seeds=None,
                    keep_label_cube: bool = True, expect_dims=None) -> CubeBatch:
    """A host (numpy) ``CubeBatch`` from the dataset's channel-first cubes [B, 6, ...].

    With ``pool_pad`` it also builds each window's label pool (``build_pool``, seeds
    ``pool_seeds``; the pad covers the largest n_margin that a consumer slices);
    ``keep_label_cube=False`` then drops the label cube.  ``pool_nwp`` stays None: it is computed
    on the device (``attach_pool_nwp``), by the interpolator that the iid sampler runs."""
    label_cl = np.ascontiguousarray(np.moveaxis(np.asarray(label_cube_cf, np.float32), 1, -1))
    B, C = label_cl.shape[0], label_cl.shape[-1]
    if expect_dims is not None:
        ldims, cdims = expect_dims
        got_l = tuple(label_cl.shape[1:4])
        got_c = tuple(np.asarray(nwp_cube_cf).shape[2:5])
        if got_l != tuple(ldims) or got_c != tuple(cdims):
            raise ValueError(f"window cube dims label={got_l} coarse={got_c} do not match the sampler geometry "
                             f"label={tuple(ldims)} coarse={tuple(cdims)} derived from SamplerConfig + CoordSpec")
    pool_rows = pool_idx = None
    if pool_pad is not None:
        if pool_seeds is None:
            pool_seeds = list(range(B))
        pools = [build_pool(label_cl[b], pool_pad, int(pool_seeds[b])) for b in range(B)]
        pool_rows = np.stack([p[0] for p in pools])
        pool_idx = np.stack([p[1] for p in pools])
    nwp_cl = np.ascontiguousarray(np.moveaxis(np.asarray(nwp_cube_cf, np.float32), 1, -1))
    return CubeBatch(
        field=np.asarray(field, np.float32),
        forecast_h=np.asarray(forecast_h, np.float32).reshape(-1),
        nwp_cube=nwp_cl.reshape(-1, nwp_cl.shape[-1]),
        label_cube=label_cl.reshape(-1, C) if (keep_label_cube or pool_pad is None) else None,
        pool_rows=pool_rows,
        pool_idx=pool_idx,
    )


def _pool_seed_of(key) -> int:
    """The 31-bit pool seed of a window's identity (its input file): every process builds the same
    pool for the same window."""
    return zlib.crc32(repr(key).encode()) & 0x7FFFFFFF


def cube_batch_from_items(items, pool_pad: Optional[int] = None, keep_label_cube: bool = True,
                          expect_dims=None) -> CubeBatch:
    """A host ``CubeBatch`` from a list of ``get_cube_item`` dicts."""
    return cube_batch_host(
        np.stack([np.asarray(it["field_data"], np.float32) for it in items]),
        np.asarray([np.float32(it["forecast_h"]) for it in items], np.float32),
        np.stack([np.asarray(it["nwp_cube"], np.float32) for it in items]),
        np.stack([np.asarray(it["label_cube"], np.float32) for it in items]),
        pool_pad=pool_pad,
        pool_seeds=[_pool_seed_of(it.get("input_file", i)) for i, it in enumerate(items)],
        keep_label_cube=keep_label_cube,
        expect_dims=expect_dims,
    )


def cube_to_device(cube: CubeBatch, device) -> CubeBatch:
    """A host ``CubeBatch`` as tensors on ``device`` (float32; the pool's indices int32)."""
    def put(a):
        if a is None:
            return None
        a = np.asarray(a)
        return torch.from_numpy(np.ascontiguousarray(a if a.dtype == np.int32 else a.astype(np.float32))).to(device)

    return CubeBatch(*(put(a) for a in cube))


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    n_margin: int  # label_batch_size
    n_inter: int  # inter_batch_size
    window_h: int = 24  # input_time_step * input_time_step_nums
    input_time_step: int = 6
    label_time_step: int = 1  # hours between label-cube slices
    begin_lat: float = 18.0
    begin_lon: float = 72.0
    fine_step: float = 0.25
    coarse_step: float = 1.0


def label_grid_dims(scfg: SamplerConfig, coord_spec) -> Tuple[int, int, int]:
    """(Hl, Wl, Tl) of the label (output) grid: one slice every label_time_step hours of the
    window, the reference's label sampling domain (physics_dataset.py:334-338)."""
    return (coord_spec.lat_size, coord_spec.lon_size, scfg.window_h // scfg.label_time_step + 1)


def coarse_grid_dims(scfg: SamplerConfig, coord_spec) -> Tuple[int, int, int]:
    """(Hc, Wc, Tc) of the coarse NWP grid: the same box at coarse_step spacing (37 x 65 for the
    145 x 257 study area), one slice every input_time_step hours."""
    r = scfg.fine_step / scfg.coarse_step
    return (int(round((coord_spec.lat_size - 1) * r)) + 1, int(round((coord_spec.lon_size - 1) * r)) + 1,
            scfg.window_h // scfg.input_time_step + 1)


def _as_row_table(cube: torch.Tensor, dims: Tuple[int, int, int], B: int, name: str) -> torch.Tensor:
    """A cube argument as the ``[B*H*W*T, C]`` row table: the table form as it is (its row count
    checked), or a ``[B, H, W, T, C]`` cube checked against ``dims`` and flattened."""
    if cube.dim() == 2:
        X = dims[0] * dims[1] * dims[2]
        if cube.shape[0] != B * X:
            raise ValueError(f"{name} row table has {cube.shape[0]} rows, expected B*H*W*T = {B}*{X} for static "
                             f"dims {dims}")
        return cube
    if tuple(cube.shape[1:4]) != tuple(dims):
        raise ValueError(f"{name} grid dims {tuple(cube.shape[1:4])} do not match the config-derived static "
                         f"dims {dims}")
    return cube.reshape(-1, cube.shape[-1])


def _coriolis_from_lat(lat_deg: torch.Tensor) -> torch.Tensor:
    return (2.0 * OMEGA * torch.sin(lat_deg / 180.0 * math.pi))[..., None]


# ---- the draws -------------------------------------------------------------------------------------


class Draws(NamedTuple):
    """One step's random numbers for a batch of B windows (the samplers' only source of
    randomness).  Integer tensors are int64; ``ix`` / ``iy`` float32 in [0, 1)."""

    mx: torch.Tensor  # [B, nm] margin x in {0..Wl-1}
    my: torch.Tensor  # [B, nm] margin y in {0..Hl-1}
    slot: torch.Tensor  # [B, nm] margin label slot in {0..Tl-1}
    off: torch.Tensor  # [B] the pool sampler's offset in {0..X-1}, X = Hl*Wl*Tl
    ix: torch.Tensor  # [B, ni] collocation x / (Wl-1)
    iy: torch.Tensor  # [B, ni] collocation y / (Hl-1)
    it: torch.Tensor  # [B, ni] collocation hour in {0..window_h}


def draw_points(generator: torch.Generator, B: int, scfg: SamplerConfig, coord_spec) -> Draws:
    """A step's draws for B windows from ``generator``, on the generator's device (the cubes')."""
    Hl, Wl, Tl = label_grid_dims(scfg, coord_spec)
    nm, ni = scfg.n_margin, scfg.n_inter
    kw = dict(generator=generator, device=generator.device)
    return Draws(
        mx=torch.randint(0, Wl, (B, nm), **kw),
        my=torch.randint(0, Hl, (B, nm), **kw),
        slot=torch.randint(0, Tl, (B, nm), **kw),
        off=torch.randint(0, Hl * Wl * Tl, (B,), **kw),
        ix=torch.rand((B, ni), **kw),
        iy=torch.rand((B, ni), **kw),
        it=torch.randint(0, scfg.window_h + 1, (B, ni), **kw),
    )


def window_draws(draws: Draws, b: int) -> Draws:
    """Window b's draws (no leading axis), for the single-window samplers."""
    return Draws(*(a[b] for a in draws))


# ---- the samplers ----------------------------------------------------------------------------------


def _interp_kw(scfg: SamplerConfig) -> dict:
    return dict(lon0=scfg.begin_lon, dlon=scfg.coarse_step, lat0=scfg.begin_lat, dlat=scfg.coarse_step, t0=0.0,
                dt=float(scfg.input_time_step))


def _inter_points(draws: Draws, nwp_cube: torch.Tensor, Hl: int, Wl: int, scfg: SamplerConfig,
                  coord_spec) -> PointBatch:
    """Continuous collocation points of one window (``draws`` without the batch axis; ``nwp_cube``
    [Hc, Wc, Tc, 6]), shared by the iid and pool samplers."""
    ix = draws.ix * (Wl - 1)
    iy = draws.iy * (Hl - 1)
    it = draws.it
    i_lon = scfg.begin_lon + ix * scfg.fine_step
    i_lat = scfg.begin_lat + iy * scfg.fine_step
    i_nwp = trilinear_interp_rows(nwp_cube, i_lon, i_lat, it.float(), **_interp_kw(scfg))
    return PointBatch(x=(ix * coord_spec.dx).float(), y=(iy * coord_spec.dy).float(), t=(it * 3600.0).float(),
                      f=_coriolis_from_lat(i_lat), nwp=i_nwp.float(),
                      labels=torch.zeros((ix.shape[0], 6), device=ix.device))


def _inter_points_batched(draws: Draws, nwp_tab: torch.Tensor, scfg: SamplerConfig, coord_spec) -> PointBatch:
    """``_inter_points`` for a batch of windows from the ``[B*Hc*Wc*Tc, 6]`` row table."""
    Hl, Wl, _ = label_grid_dims(scfg, coord_spec)
    ix = draws.ix * (Wl - 1)
    iy = draws.iy * (Hl - 1)
    it = draws.it
    i_lon = scfg.begin_lon + ix * scfg.fine_step
    i_lat = scfg.begin_lat + iy * scfg.fine_step
    i_nwp = trilinear_interp_table_batched(nwp_tab, coarse_grid_dims(scfg, coord_spec), i_lon, i_lat, it.float(),
                                           **_interp_kw(scfg))
    return PointBatch(x=(ix * coord_spec.dx).float(), y=(iy * coord_spec.dy).float(), t=(it * 3600.0).float(),
                      f=_coriolis_from_lat(i_lat), nwp=i_nwp.float(),
                      labels=torch.zeros((*ix.shape, 6), device=ix.device))


def _margin_points(mx, my, slot, labels, nwp, scfg: SamplerConfig, coord_spec) -> PointBatch:
    m_lat = (scfg.begin_lat + my * scfg.fine_step).float()
    return PointBatch(x=(mx * coord_spec.dx).float(), y=(my * coord_spec.dy).float(),
                      t=(slot * scfg.label_time_step * 3600.0).float(), f=_coriolis_from_lat(m_lat), nwp=nwp.float(),
                      labels=labels.float())


def sample_window_points(draws: Draws, nwp_cube: torch.Tensor, label_cube: torch.Tensor, scfg: SamplerConfig,
                         coord_spec) -> Tuple[PointBatch, PointBatch]:
    """One window's margin and collocation points (``draws`` without the batch axis; channel-last
    cubes [Hc, Wc, Tc, 6] and [Hl, Wl, Tl, 6]): the labels by one row gather, the conditioning by
    the row interpolator."""
    Hl, Wl, Tl = label_cube.shape[0], label_cube.shape[1], label_cube.shape[2]
    mx, my, slot = draws.mx, draws.my, draws.slot
    flat = (my * Wl + mx) * Tl + slot
    labels = label_cube.reshape(-1, label_cube.shape[-1]).index_select(0, flat)
    m_lon = (scfg.begin_lon + mx * scfg.fine_step).float()
    m_lat = (scfg.begin_lat + my * scfg.fine_step).float()
    m_nwp = trilinear_interp_rows(nwp_cube, m_lon, m_lat, (slot * scfg.label_time_step).float(), **_interp_kw(scfg))
    margin = _margin_points(mx, my, slot, labels, m_nwp, scfg, coord_spec)
    return margin, _inter_points(draws, nwp_cube, Hl, Wl, scfg, coord_spec)


def sample_window_points_batched(draws: Draws, nwp_cube: torch.Tensor, label_cube: torch.Tensor,
                                 scfg: SamplerConfig, coord_spec) -> Tuple[PointBatch, PointBatch]:
    """A batch of windows' points (leading [B]) from the row tables (or [B, H, W, T, 6] cubes):
    every lookup a row gather at the absolute row ``b*X + flat``."""
    B = draws.mx.shape[0]
    ldims = label_grid_dims(scfg, coord_spec)
    cdims = coarse_grid_dims(scfg, coord_spec)
    label_tab = _as_row_table(label_cube, ldims, B, "label_cube")
    nwp_tab = _as_row_table(nwp_cube, cdims, B, "nwp_cube")
    Hl, Wl, Tl = ldims
    nm = scfg.n_margin
    mx, my, slot = draws.mx, draws.my, draws.slot
    flat = (my * Wl + mx) * Tl + slot + (torch.arange(B, device=mx.device) * (Hl * Wl * Tl))[:, None]
    labels = label_tab.index_select(0, flat.reshape(-1)).reshape(B, nm, -1)
    m_lon = (scfg.begin_lon + mx * scfg.fine_step).float()
    m_lat = (scfg.begin_lat + my * scfg.fine_step).float()
    m_nwp = trilinear_interp_table_batched(nwp_tab, cdims, m_lon, m_lat, (slot * scfg.label_time_step).float(),
                                           **_interp_kw(scfg))
    margin = _margin_points(mx, my, slot, labels, m_nwp, scfg, coord_spec)
    return margin, _inter_points_batched(draws, nwp_tab, scfg, coord_spec)


def _decode_pool_idx(idx: torch.Tensor, scfg: SamplerConfig, coord_spec):
    """Flat pool index -> (x, y, slot) on the label grid: the inverse of ``(y*Wl + x)*Tl + slot``."""
    _, Wl, Tl = label_grid_dims(scfg, coord_spec)
    slot = idx % Tl
    rest = idx // Tl
    return rest % Wl, rest // Wl, slot


def _pooled_margin(off: torch.Tensor, pool_rows: torch.Tensor, pool_idx: torch.Tensor, pool_nwp: torch.Tensor,
                   scfg: SamplerConfig, coord_spec) -> PointBatch:
    """The margin points of windows whose pools are ``pool_*`` [..., X+nm, ...]: the slice
    ``[off, off + nm)`` of each (``off`` [...], one offset a window)."""
    sel = off[..., None] + torch.arange(scfg.n_margin, device=off.device)  # [..., nm]
    rows = torch.take_along_dim(pool_rows, sel[..., None], dim=-2)
    idx = torch.take_along_dim(pool_idx, sel, dim=-1)
    cond = torch.take_along_dim(pool_nwp, sel[..., None], dim=-2)
    mx, my, slot = _decode_pool_idx(idx, scfg, coord_spec)
    return _margin_points(mx, my, slot, rows, cond, scfg, coord_spec)


def sample_window_points_pooled(draws: Draws, nwp_cube: torch.Tensor, pool_rows: torch.Tensor,
                                pool_idx: torch.Tensor, pool_nwp: torch.Tensor, scfg: SamplerConfig,
                                coord_spec) -> Tuple[PointBatch, PointBatch]:
    """The ``'pool'`` counterpart of ``sample_window_points`` (one window: pool [X+nm, ...]): the
    margin points from one slice of the window's pool, the collocation points drawn as the iid
    sampler draws them."""
    margin = _pooled_margin(draws.off, pool_rows, pool_idx, pool_nwp, scfg, coord_spec)
    return margin, _inter_points(draws, nwp_cube, coord_spec.lat_size, coord_spec.lon_size, scfg, coord_spec)


def sample_window_points_pooled_batched(draws: Draws, nwp_cube: torch.Tensor, pool_rows: torch.Tensor,
                                        pool_idx: torch.Tensor, pool_nwp: torch.Tensor, scfg: SamplerConfig,
                                        coord_spec) -> Tuple[PointBatch, PointBatch]:
    """The pooled sampler for a batch of windows (leading [B]; pools [B, X+nm, ...])."""
    nwp_tab = _as_row_table(nwp_cube, coarse_grid_dims(scfg, coord_spec), draws.off.shape[0], "nwp_cube")
    margin = _pooled_margin(draws.off, pool_rows, pool_idx, pool_nwp, scfg, coord_spec)
    return margin, _inter_points_batched(draws, nwp_tab, scfg, coord_spec)


def attach_pool_nwp(cube: CubeBatch, scfg: SamplerConfig, coord_spec, chunk: int = 65536) -> CubeBatch:
    """``cube`` with ``pool_nwp``: the NWP conditioning at every pool point, on the device, by the
    interpolator that the iid sampler runs each step (the same values to the bit), in chunks of
    ``chunk`` points; once a window, when its cube enters the cache."""
    if cube.pool_rows is None or cube.pool_nwp is not None:
        return cube
    B, Xpad = cube.pool_idx.shape
    cdims = coarse_grid_dims(scfg, coord_spec)
    nwp_tab = _as_row_table(cube.nwp_cube, cdims, B, "nwp_cube")
    Xc = cdims[0] * cdims[1] * cdims[2]
    out = []
    for b in range(B):
        tab_b = nwp_tab[b * Xc:(b + 1) * Xc]
        parts = []
        for s in range(0, Xpad, chunk):
            mx, my, slot = _decode_pool_idx(cube.pool_idx[b, s:s + chunk], scfg, coord_spec)
            lon = (scfg.begin_lon + mx * scfg.fine_step).float()
            lat = (scfg.begin_lat + my * scfg.fine_step).float()
            parts.append(trilinear_interp_table(tab_b, cdims, lon, lat, (slot * scfg.label_time_step).float(),
                                                **_interp_kw(scfg)).float())
        out.append(torch.cat(parts))
    return cube._replace(pool_nwp=torch.stack(out))


# ---- the steps -------------------------------------------------------------------------------------


def sample_batch(cube: CubeBatch, draws: Draws, scfg: SamplerConfig, coord_spec, device) -> Batch:
    """The ``Batch`` of ``train/train_step.py`` that ``draws`` pick from ``cube``: the margin points
    from the pool when the cube has one, else by the iid row gather.  The cubes and the draws must
    lie on ``device``, the model's: nothing moves them."""
    for group, fields in (("cube", cube), ("draws", draws)):
        for name, a in zip(fields._fields, fields):
            if a is not None and a.device != device:
                raise ValueError(f"device-sampled step: {group}.{name} lies on {a.device}, the model on {device}; "
                                 "the cubes, the pool and the draws live on the trainer's device")
    if cube.pool_rows is not None:
        margin, inter = sample_window_points_pooled_batched(draws, cube.nwp_cube, cube.pool_rows, cube.pool_idx,
                                                            cube.pool_nwp, scfg, coord_spec)
    else:
        margin, inter = sample_window_points_batched(draws, cube.nwp_cube, cube.label_cube, scfg, coord_spec)
    return Batch(field=cube.field, forecast_h=cube.forecast_h, margin=margin, inter=inter)


def _unsnapped(cfg: StepConfig) -> StepConfig:
    """JAX's device-sampled loss takes the lead time as it is, whatever ``forecast_h_snap`` says."""
    return dataclasses.replace(cfg, forecast_h_snap=0.0)


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def make_ds_loss_fn(model, cfg: StepConfig, scfg: SamplerConfig):
    """``loss_fn(cube: CubeBatch, draws: Draws, with_pde) -> (total, (metrics, pred_norm, labels))``:
    ``make_loss_fn``'s loss on ``sample_batch``'s batch, with that batch's margin labels."""
    loss_fn = make_loss_fn(model, _unsnapped(cfg))
    device = _device_of(model)

    def ds_loss_fn(cube: CubeBatch, draws: Draws, with_pde: bool):
        batch = sample_batch(cube, draws, scfg, cfg.coord_spec, device)
        total, (metrics, pred_norm) = loss_fn(batch, with_pde)
        return total, (metrics, pred_norm, batch.margin.labels)

    return ds_loss_fn


def make_device_sampling_train_step(cfg: StepConfig, scfg: SamplerConfig):
    """``train_step(state, cube: CubeBatch, draws: Draws, with_pde) -> (state, metrics)``:
    ``make_train_step``'s step on ``sample_batch``'s batch (``state`` updated in place)."""
    train_step = make_train_step(_unsnapped(cfg))

    def ds_train_step(state: TrainState, cube: CubeBatch, draws: Draws, with_pde: bool):
        return train_step(state, sample_batch(cube, draws, scfg, cfg.coord_spec, _device_of(state.model)), with_pde)

    return ds_train_step


def make_device_sampling_eval_step(cfg: StepConfig, scfg: SamplerConfig):
    """``eval_step(model, cube: CubeBatch, draws: Draws, with_pde) -> metrics``: ``make_eval_step``'s
    on ``sample_batch``'s batch.  The loop's validation draws from a generator of a fixed seed, so
    that repeated validations score the same points."""
    eval_step = make_eval_step(_unsnapped(cfg))

    def ds_eval_step(model, cube: CubeBatch, draws: Draws, with_pde: bool):
        return eval_step(model, sample_batch(cube, draws, scfg, cfg.coord_spec, _device_of(model)), with_pde)

    return ds_eval_step
