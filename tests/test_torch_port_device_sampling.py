"""PyTorch port against the JAX package: sampling on the device (``train/device_sampling.py``).

On the smoke configuration's geometry (``configs/smoke_cpu_cfg.py``: a 37 x 65 label grid of 25
hourly slots, a 10 x 17 coarse grid of 5 six-hourly slots, 512 margin and 128 collocation points
a window) and ``test_torch_port_train.py``'s tiny widths.  JAX's samplers draw with
``jax.random``; the port's take their draws through one seam (``Draws``), so the tests hand them
JAX's own draws, made from the same key splits as ``sample_window_points_batched`` makes them
(``_jax_draws``), and hold every ``PointBatch`` field to JAX's bit for bit.  The one exception is
the Coriolis parameter ``f`` = ``2 Omega sin(lat)``, held to 2 ulps: XLA's CPU ``sin`` and
PyTorch's round some arguments one ulp apart (7% of the margin points' latitudes, which lie on the
0.25 degree grid, as of the collocation points'), and the product by ``2 Omega`` rounds that to
one or two.  The port's own draws
(``draw_points``, a ``torch.Generator``) are held in distribution: chi-squared over the integer
draws, Kolmogorov-Smirnov over the uniform ones, p > 1e-6 at a fixed seed.

The device-sampled loss, its gradients, the train step (both samplers) and the eval step run in
both packages under the ``'kernel'`` engine (the port's plain versions on the CPU) on one cube and
JAX's draws: float32 with the PDE terms at ``test_torch_port_train.py``'s tolerances, bfloat16
data-only at a bf16 rounding (``step_world`` and ``_tolerances`` say why).  The v4s kernels
themselves are held on the card by ``chip_smoke.py``'s phases 4 to 6.
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

from deepphysinet_tpu.data.dataset import PhysicsDataset as JaxDataset
from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops import interp as jinterp
from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec
from deepphysinet_tpu.ops.normalization import OBS_NAME_ORDER as J_ORDER
from deepphysinet_tpu.ops.normalization import norm_specs_from_cfg as j_norm_specs
from deepphysinet_tpu.train import device_sampling as jds
from deepphysinet_tpu.train import train_step as jts
from deepphysinet_tpu.train.optim import build_optimizer as j_build_optimizer

from deepphysinet_tpu_torch.data.dataset import PhysicsDataset
from deepphysinet_tpu_torch.data.synthetic import ensure_synthetic_tree
from deepphysinet_tpu_torch.ops import interp as tinterp
from deepphysinet_tpu_torch.ops.coords import CoordSpec
from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg
from deepphysinet_tpu_torch.train import device_sampling as tds
from deepphysinet_tpu_torch.train import train_step as tts
from deepphysinet_tpu_torch.train.torch_import import load_train_state, state_dict_from_jax
from tests.test_torch_port_train import FACTORS, META, METRIC_RTOL, NET, OBS_CFG, OPT, PARAM_ATOL, _adam_state

torch.set_num_threads(1)  # one thread per test process (see test_torch_port_train.py)

GEOM = dict(lon_size=65, lat_size=37, dx=27000.0, dy=27000.0, pred_t_span=86400.0)
COORD, JCOORD = CoordSpec(**GEOM), JaxCoordSpec(**GEOM)
SCFG = dict(n_margin=512, n_inter=128, window_h=24, input_time_step=6, begin_lat=18.0, begin_lon=72.0)
TS, JS = tds.SamplerConfig(**SCFG), jds.SamplerConfig(**SCFG)
HL, WL, TL = 37, 65, 25
HC, WC, TC = 10, 17, 5
X = HL * WL * TL
SMOKE_TREE = dict(n_init_times=3, bbox=(72.0, 18.0, 88.0, 27.0))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _jax_draws(keys, scfg=TS, coord_spec=COORD):
    """JAX's draws for the windows' ``keys`` [B], as ``sample_window_points_batched`` (iid) and
    ``_pooled_margin`` (the pool's offset, from the same k1) make them, as the port's ``Draws``
    (``scfg`` and ``coord_spec`` the port's)."""
    nm, ni = scfg.n_margin, scfg.n_inter
    HL, WL, TL = tds.label_grid_dims(scfg, coord_spec)
    X = HL * WL * TL
    ks = jax.vmap(lambda k: jax.random.split(k, 6))(keys)

    def each(fn, k):
        return np.asarray(jax.vmap(fn)(k))

    return tds.Draws(
        mx=_t(each(lambda k: jax.random.randint(k, (nm,), 0, WL), ks[:, 0])).long(),
        my=_t(each(lambda k: jax.random.randint(k, (nm,), 0, HL), ks[:, 1])).long(),
        slot=_t(each(lambda k: jax.random.randint(k, (nm,), 0, TL), ks[:, 2])).long(),
        off=_t(each(lambda k: jax.random.randint(k, (), 0, X), ks[:, 0])).long(),
        ix=_t(each(lambda k: jax.random.uniform(k, (ni,)), ks[:, 3])),
        iy=_t(each(lambda k: jax.random.uniform(k, (ni,)), ks[:, 4])),
        it=_t(each(lambda k: jax.random.randint(k, (ni,), 0, scfg.window_h + 1), ks[:, 5])).long())


def _cubes(seed, B):
    rng = np.random.RandomState(seed)
    nwp = (rng.randn(B, HC, WC, TC, 6) * 0.1).astype(np.float32)
    label = (rng.randn(B, HL, WL, TL, 6) * 0.1).astype(np.float32)
    return nwp, label


def _pools(label, seeds, pad=SCFG["n_margin"]):
    pools = [jds.build_pool(label[b], pad, s) for b, s in enumerate(seeds)]
    return np.stack([p[0] for p in pools]), np.stack([p[1] for p in pools])


def _assert_points_equal(got, want, where, ulp_fields=()):
    for name in tts.PointBatch._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, (where, name)
        if name in ulp_fields:
            np.testing.assert_array_max_ulp(g, w, maxulp=2)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}.{name}")


# ---- ops/interp.py: the row-table forms -------------------------------------------------------------

def test_row_interpolators_match_jax_and_the_cube_form():
    rng = np.random.RandomState(5)
    B, N = 3, 333
    cube = rng.randn(B, HC, WC, TC, 6).astype(np.float32)
    # inside the grid, on its nodes, and outside it (clipped)
    lon = np.concatenate([72 + 16 * rng.rand(B, N), np.tile([[72.0, 88.0, 60.0, 99.0]], (B, 1))], 1)
    lat = np.concatenate([18 + 9 * rng.rand(B, N), np.tile([[18.0, 27.0, 10.0, 40.0]], (B, 1))], 1)
    t = np.concatenate([24 * rng.rand(B, N), np.tile([[0.0, 24.0, -3.0, 30.0]], (B, 1))], 1)
    lon, lat, t = (a.astype(np.float32) for a in (lon, lat, t))
    kw = dict(lon0=72.0, dlon=1.0, lat0=18.0, dlat=1.0, t0=0.0, dt=6.0)
    dims = (HC, WC, TC)
    tab = cube.reshape(-1, 6)
    pairs = {
        "table": (jinterp.trilinear_interp_table(jnp.asarray(tab[:HC * WC * TC]), dims, lon[0], lat[0], t[0], **kw),
                  tinterp.trilinear_interp_table(_t(tab[:HC * WC * TC]), dims, _t(lon[0]), _t(lat[0]), _t(t[0]),
                                                 **kw)),
        "table_batched": (jinterp.trilinear_interp_table_batched(jnp.asarray(tab), dims, lon, lat, t, **kw),
                          tinterp.trilinear_interp_table_batched(_t(tab), dims, _t(lon), _t(lat), _t(t), **kw)),
        "rows": (jinterp.trilinear_interp_rows(jnp.asarray(cube[1]), lon[1], lat[1], t[1], **kw),
                 tinterp.trilinear_interp_rows(_t(cube[1]), _t(lon[1]), _t(lat[1]), _t(t[1]), **kw)),
        "rows_batched": (jinterp.trilinear_interp_rows_batched(jnp.asarray(cube), lon, lat, t, **kw),
                         tinterp.trilinear_interp_rows_batched(_t(cube), _t(lon), _t(lat), _t(t), **kw)),
    }
    for name, (want, got) in pairs.items():
        assert got.dtype == torch.float32 and tuple(got.shape) == np.asarray(want).shape, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    # the batched forms are the single form window by window, and the port's cube form on the
    # channel-first cube is the same function (its lerps in the same order)
    batched = pairs["rows_batched"][1]
    for b in range(B):
        one = tinterp.trilinear_interp_rows(_t(cube[b]), _t(lon[b]), _t(lat[b]), _t(t[b]), **kw)
        assert torch.equal(batched[b], one)
        cube_form = tinterp.trilinear_interp_cube(_t(np.moveaxis(cube[b], -1, 0)), _t(lon[b]), _t(lat[b]), _t(t[b]),
                                                  **kw)
        np.testing.assert_allclose(cube_form.numpy().T, one.numpy(), rtol=1e-6, atol=1e-6)
    # a single time level: the degenerate axis
    one_t = tinterp.trilinear_interp_rows(_t(cube[0][:, :, :1]), _t(lon[0]), _t(lat[0]), _t(t[0]), **kw)
    want = jinterp.trilinear_interp_rows(jnp.asarray(cube[0][:, :, :1]), lon[0], lat[0], t[0], **kw)
    np.testing.assert_array_equal(one_t.numpy(), np.asarray(want))


# ---- the cubes: pools, seeds, the dataset's cube items ------------------------------------------------

@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Both packages' ``PhysicsDataset`` on one port-written smoke tree."""
    from deepphysinet_tpu.config import Config

    root = str(tmp_path_factory.mktemp("ds_tree"))
    ensure_synthetic_tree(root, **SMOKE_TREE)
    old = os.environ.get("DPN_SMOKE_DATA")
    os.environ["DPN_SMOKE_DATA"] = root
    try:
        cfg = Config.fromfile(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                                           "smoke_cpu_cfg.py"))["config"]
    finally:
        if old is None:
            del os.environ["DPN_SMOKE_DATA"]
        else:
            os.environ["DPN_SMOKE_DATA"] = old
    tc = cfg["train_cfg"]
    kw = dict(input_variable_cfg=cfg["variable_cfg"], out_variable_cfg=cfg["obs_norm_cfg"], dx=27000.0, dy=27000.0)
    return JaxDataset(**copy.deepcopy(tc["train_data"]), **kw), PhysicsDataset(**copy.deepcopy(tc["train_data"]), **kw)


def test_get_cube_item_matches_jax(datasets):
    jd, td = datasets
    assert len(td) == len(jd) == 2
    for i in range(len(td)):
        want, got = jd.get_cube_item(i), td.get_cube_item(i)
        assert sorted(got) == sorted(want) == ["field_data", "forecast_h", "input_file", "label_cube", "nwp_cube"]
        assert got["input_file"] == want["input_file"] and got["forecast_h"] == want["forecast_h"]
        for k in ("field_data", "nwp_cube", "label_cube"):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["label_cube"].shape == (6, HL, WL, TL) and got["nwp_cube"].shape == (6, HC, WC, TC)


@pytest.mark.parametrize("pool", [False, True], ids=["iid", "pool"])
def test_cube_batch_from_items_matches_jax(datasets, pool):
    """``build_pool``, ``_pool_seed_of`` and ``cube_batch_from_items`` array for array, on each
    package's own cube items."""
    jd, td = datasets
    dims = tds.expected_cube_dims(TS, COORD)
    assert dims == jds.expected_cube_dims(JS, JCOORD) == ((HL, WL, TL), (HC, WC, TC))
    items_j, items_t = [jd.get_cube_item(i) for i in (1, 0)], [td.get_cube_item(i) for i in (1, 0)]
    kw = dict(pool_pad=SCFG["n_margin"] if pool else None, keep_label_cube=not pool, expect_dims=dims)
    want = jds.cube_batch_from_items(items_j, **kw)
    got = tds.cube_batch_from_items(items_t, **kw)
    for name in tds.CubeBatch._fields:
        w, g = getattr(want, name), getattr(got, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.pool_rows is not None) == pool and (got.label_cube is None) == pool
    for it in items_t:
        assert tds._pool_seed_of(it["input_file"]) == jds._pool_seed_of(it["input_file"])
    assert tds._pool_seed_of(("a", 3)) == jds._pool_seed_of(("a", 3))
    rows, idx = tds.build_pool(items_t[0]["label_cube"].transpose(1, 2, 3, 0), 64, seed=3)
    rows_j, idx_j = jds.build_pool(items_t[0]["label_cube"].transpose(1, 2, 3, 0), 64, seed=3)
    np.testing.assert_array_equal(rows, rows_j)
    np.testing.assert_array_equal(idx, idx_j)
    assert sorted(idx[:X].tolist()) == list(range(X)) and np.array_equal(idx[X:], idx[:64])
    dev = tds.cube_to_device(got, "cpu")
    assert dev.field.dtype == torch.float32 and (not pool or dev.pool_idx.dtype == torch.int32)


def test_cube_dims_guards():
    """A geometry that the flat row tables cannot tell apart fails loudly: a row table of the
    wrong length, a [B, H, W, T, C] cube of other dims, and (only the host builder sees it) a
    transposed lat / lon of the same row count."""
    draws = tds.draw_points(torch.Generator().manual_seed(0), 1, TS, COORD)
    nwp_tab = torch.zeros((HC * WC * TC, 6))
    with pytest.raises(ValueError, match="row table"):
        tds.sample_window_points_batched(draws, nwp_tab, torch.zeros((999, 6)), TS, COORD)
    with pytest.raises(ValueError, match="static dims"):
        tds.sample_window_points_batched(draws, nwp_tab, torch.zeros((1, WL, HL, TL, 6)), TS, COORD)
    with pytest.raises(ValueError, match="sampler geometry"):
        tds.cube_batch_host(np.zeros((1, 12, 65), np.float32), np.asarray([24.0], np.float32),
                            np.zeros((1, 6, WC, HC, TC), np.float32), np.zeros((1, 6, WL, HL, TL), np.float32),
                            expect_dims=tds.expected_cube_dims(TS, COORD))


# ---- the samplers against JAX's on JAX's draws --------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("pool", [False, True], ids=["iid", "pool"])
def test_samplers_match_jax_on_jax_draws(pool, batched):
    B = 3
    nwp, label = _cubes(7, B)
    keys = jax.random.split(jax.random.PRNGKey(123), B)
    draws = _jax_draws(keys)
    if pool:
        rows, idx = _pools(label, [11, 22, 33])
        jcube = jds.attach_pool_nwp(jds.CubeBatch(field=None, forecast_h=None, nwp_cube=jnp.asarray(nwp),
                                                  label_cube=None, pool_rows=jnp.asarray(rows),
                                                  pool_idx=jnp.asarray(idx)), JS, JCOORD)
        tcube = tds.attach_pool_nwp(tds.CubeBatch(field=None, forecast_h=None, nwp_cube=_t(nwp), label_cube=None,
                                                  pool_rows=_t(rows), pool_idx=_t(idx)), TS, COORD)
        # JAX's pool conditioning runs in a scanned program that may fuse otherwise (its own test
        # allows f32 ulps); each side is held bit for bit to its own per-step interpolator below, so
        # the samplers are compared on one pool_nwp
        np.testing.assert_allclose(tcube.pool_nwp.numpy(), np.asarray(jcube.pool_nwp), rtol=1e-5, atol=5e-7)
        pn = np.asarray(jcube.pool_nwp)
    if batched:
        if pool:
            want = jds.sample_window_points_pooled_batched(keys, jnp.asarray(nwp.reshape(-1, 6)), jnp.asarray(rows),
                                                           jnp.asarray(idx), jnp.asarray(pn), JS, JCOORD)
            got = tds.sample_window_points_pooled_batched(draws, _t(nwp.reshape(-1, 6)), _t(rows), _t(idx), _t(pn),
                                                          TS, COORD)
        else:
            want = jds.sample_window_points_batched(keys, jnp.asarray(nwp.reshape(-1, 6)),
                                                    jnp.asarray(label.reshape(-1, 6)), JS, JCOORD)
            got = tds.sample_window_points_batched(draws, _t(nwp.reshape(-1, 6)), _t(label.reshape(-1, 6)), TS,
                                                   COORD)
        cases = [(got, want, "batched")]
    else:
        cases = []
        for b in range(B):
            wd = tds.window_draws(draws, b)
            if pool:
                want = jds.sample_window_points_pooled(keys[b], jnp.asarray(nwp[b]), jnp.asarray(rows[b]),
                                                       jnp.asarray(idx[b]), jnp.asarray(pn[b]), JS, JCOORD)
                got = tds.sample_window_points_pooled(wd, _t(nwp[b]), _t(rows[b]), _t(idx[b]), _t(pn[b]), TS, COORD)
            else:
                want = jds.sample_window_points(keys[b], jnp.asarray(nwp[b]), jnp.asarray(label[b]), JS, JCOORD)
                got = tds.sample_window_points(wd, _t(nwp[b]), _t(label[b]), TS, COORD)
            cases.append((got, want, f"window {b}"))
    for (g_m, g_i), (w_m, w_i), where in cases:
        _assert_points_equal(g_m, w_m, f"{where} margin", ulp_fields=("f",))
        _assert_points_equal(g_i, w_i, f"{where} inter", ulp_fields=("f",))
    # the labels are the label cube's rows at the decoded points, exactly
    m = cases[0][0][0]
    mx, my = (m.x / COORD.dx).long(), (m.y / COORD.dy).long()
    mt = (m.t / 3600.0).long()
    lab = _t(label[0] if not batched else label)
    want_labels = lab[my, mx, mt] if not batched else lab[torch.arange(B)[:, None], my, mx, mt]
    assert torch.equal(m.labels, want_labels)


def test_attach_pool_nwp_is_the_per_step_interpolator():
    """The pool's conditioning, computed once a window in chunks, equals the row interpolator
    that the iid sampler runs each step, on the same points, bit for bit."""
    B = 2
    nwp, label = _cubes(3, B)
    rows, idx = _pools(label, [5, 6])
    cube = tds.attach_pool_nwp(tds.CubeBatch(field=None, forecast_h=None, nwp_cube=_t(nwp.reshape(-1, 6)),
                                             label_cube=None, pool_rows=_t(rows), pool_idx=_t(idx)), TS, COORD,
                               chunk=10000)
    assert tuple(cube.pool_nwp.shape) == (B, X + SCFG["n_margin"], 6)
    for b in range(B):
        ix = idx[b].astype(np.int64)
        slot, rest = ix % TL, ix // TL
        lon = _t((72.0 + (rest % WL) * 0.25).astype(np.float32))
        lat = _t((18.0 + (rest // WL) * 0.25).astype(np.float32))
        want = tinterp.trilinear_interp_rows(_t(nwp[b]), lon, lat, _t(slot.astype(np.float32)), lon0=72.0, dlon=1.0,
                                             lat0=18.0, dlat=1.0, t0=0.0, dt=6.0)
        assert torch.equal(cube.pool_nwp[b], want)
    assert tds.attach_pool_nwp(cube, TS, COORD) is cube  # already attached


def test_pool_keeps_the_iid_collocation_stream():
    """From one seed, the two samplers draw the same collocation points at every step: both
    consume all seven draws."""
    B = 2
    nwp, label = _cubes(9, B)
    rows, idx = _pools(label, [1, 2])
    cube = tds.attach_pool_nwp(tds.CubeBatch(field=None, forecast_h=None, nwp_cube=_t(nwp.reshape(-1, 6)),
                                             label_cube=None, pool_rows=_t(rows), pool_idx=_t(idx)), TS, COORD)
    g_iid, g_pool = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    for _ in range(3):
        d_iid, d_pool = (tds.draw_points(g, B, TS, COORD) for g in (g_iid, g_pool))
        m_iid, i_iid = tds.sample_window_points_batched(d_iid, cube.nwp_cube, _t(label.reshape(-1, 6)), TS, COORD)
        m_pool, i_pool = tds.sample_window_points_pooled_batched(d_pool, cube.nwp_cube, cube.pool_rows, cube.pool_idx,
                                                                 cube.pool_nwp, TS, COORD)
        _assert_points_equal(i_pool, i_iid, "inter")
        assert not torch.equal(m_pool.x, m_iid.x)
        # a pool step takes distinct grid points, an iid step may repeat one
        flat = ((m_pool.y / COORD.dy).long() * WL + (m_pool.x / COORD.dx).long()) * TL + (m_pool.t / 3600).long()
        assert all(len(set(f.tolist())) == SCFG["n_margin"] for f in flat)


def test_draws_in_distribution():
    """The port's draws from a fixed seed: the integers uniform over their ranges (chi-squared),
    the uniforms over [0, 1) (Kolmogorov-Smirnov), the pool offsets over [0, X) in 25 bins."""
    g = torch.Generator().manual_seed(2024)
    scfg = tds.SamplerConfig(**dict(SCFG, n_margin=20480, n_inter=20480))
    d = tds.draw_points(g, 1, scfg, COORD)
    offs = torch.cat([tds.draw_points(g, 1, tds.SamplerConfig(**dict(SCFG, n_margin=1, n_inter=1)), COORD).off
                      for _ in range(500)])
    for name, vals, n in (("mx", d.mx, WL), ("my", d.my, HL), ("slot", d.slot, TL), ("it", d.it, 25),
                          ("off", offs * 25 // X, 25)):
        assert int(vals.min()) >= 0 and int(vals.max()) == n - 1, name
        counts = np.bincount(vals.reshape(-1).numpy(), minlength=n)
        p = stats.chisquare(counts).pvalue
        assert p > 1e-6, (name, p)
    for name, vals in (("ix", d.ix), ("iy", d.iy)):
        v = vals.reshape(-1).numpy()
        assert v.dtype == np.float32 and v.min() >= 0.0 and v.max() < 1.0
        assert stats.kstest(v, "uniform").pvalue > 1e-6, name
    assert d.mx.dtype == torch.int64 and tuple(d.mx.shape) == (1, 20480) and tuple(d.off.shape) == (1,)


def test_the_step_refuses_tensors_on_another_device():
    model = tts.create_train_state(META, NET, OPT, torch.Generator().manual_seed(0), device="cpu").model
    nwp, label = _cubes(1, 1)
    cube = tds.CubeBatch(field=torch.zeros(1, 12, 65), forecast_h=torch.tensor([24.0]), nwp_cube=_t(nwp.reshape(-1, 6)),
                         label_cube=_t(label.reshape(-1, 6)))
    draws = tds.draw_points(torch.Generator().manual_seed(0), 1, TS, COORD)
    loss_fn = tds.make_ds_loss_fn(model, _tcfg(), TS)
    meta = torch.empty(1, 12, 65, device="meta")
    with pytest.raises(ValueError, match="cube.field lies on meta"):
        loss_fn(cube._replace(field=meta), draws, False)


def test_the_ds_loss_takes_the_lead_time_unsnapped():
    """JAX's device-sampled loss ignores ``forecast_h_snap`` (ROADMAP C38), where the host loss,
    on the same sampled batch, snaps the lead time."""
    model = tts.create_train_state(META, NET, OPT, torch.Generator().manual_seed(0), device="cpu").model
    nwp, label = _cubes(2, 1)
    cube = tds.CubeBatch(field=torch.randn(1, 12, 65, generator=torch.Generator().manual_seed(3)),
                         forecast_h=torch.tensor([30.0]), nwp_cube=_t(nwp.reshape(-1, 6)),
                         label_cube=_t(label.reshape(-1, 6)))
    draws = tds.draw_points(torch.Generator().manual_seed(0), 1, TS, COORD)
    snapped = dataclasses.replace(_tcfg(), forecast_h_snap=24.0)
    batch = tds.sample_batch(cube, draws, TS, COORD, torch.device("cpu"))
    with torch.no_grad():
        plain = tds.make_ds_loss_fn(model, _tcfg(), TS)(cube, draws, False)[0]
        ds_snapped = tds.make_ds_loss_fn(model, snapped, TS)(cube, draws, False)[0]
        host_snapped = tts.make_loss_fn(model, snapped)(batch, False)[0]
        host_plain = tts.make_loss_fn(model, _tcfg())(batch, False)[0]
    assert torch.equal(ds_snapped, plain) and torch.equal(host_plain, plain)
    assert not torch.equal(host_snapped, plain)


# ---- the device-sampled loss and steps against JAX's ---------------------------------------------------

def _tcfg():
    tspecs = norm_specs_from_cfg(OBS_CFG)
    return tts.StepConfig(coord_spec=COORD, obs_specs=tuple(tspecs[k] for k in OBS_NAME_ORDER), loss_factor=FACTORS)


def _jcfg():
    jspecs = j_norm_specs(OBS_CFG)
    return jts.StepConfig(coord_spec=JCOORD, obs_specs=tuple(jspecs[k] for k in J_ORDER), loss_factor=FACTORS,
                          pde_engine="kernel", kernel_version=7)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def step_world(request):
    """A JAX state (seeded init) and one cube of two windows, with JAX's loss and gradients, train
    step and eval step under fixed keys (iid), and its train step on the pooled cube.  float32
    with the PDE terms: off the TPU JAX's ``'kernel'`` engine is the v4s XLA twin, in float32 the
    function of the Pallas pair and of the port's plain versions.  bfloat16 data-only: JAX's bf16
    XLA twin has no CPU product (bf16 x bf16 -> f32), and through the Pallas pair in interpret
    mode the PDE metrics of the two packages part by up to 4%, the encoder's bf16 roundings flipped
    by another summation order and carried into differences of large terms (ROADMAP C17); the
    v4s pair's bf16 rounding is held in ``test_torch_port_v4s.py``."""
    dtype = request.param
    with_pde = dtype == "float32"
    B = 2
    nwp, label = _cubes(21, B)
    rng = np.random.RandomState(4)
    field = rng.randn(B, 12, 65).astype(np.float32)
    fh = np.array([24.0, 30.0], np.float32)
    rows, idx = _pools(label, [3, 4])
    host = {False: tds.CubeBatch(field=field, forecast_h=fh, nwp_cube=nwp.reshape(-1, 6),
                                 label_cube=label.reshape(-1, 6)),
            True: tds.CubeBatch(field=field, forecast_h=fh, nwp_cube=nwp.reshape(-1, 6), label_cube=None,
                                pool_rows=rows, pool_idx=idx)}
    jm = JaxPhysicsNet(meta_cfg=META, net_cfg=NET, compute_dtype=getattr(jnp, dtype))
    tx = j_build_optimizer(**OPT)
    zeros = lambda n: jts.PointBatch(x=jnp.zeros((B, n)), y=jnp.zeros((B, n)), t=jnp.zeros((B, n)),  # noqa: E731
                                     f=jnp.zeros((B, n, 1)), nwp=jnp.zeros((B, n, 6)), labels=jnp.zeros((B, n, 6)))
    dummy = jts.Batch(field=jnp.asarray(field), forecast_h=jnp.asarray(fh), margin=zeros(8), inter=zeros(4))
    state0 = jts.create_train_state(jm, tx, jax.random.PRNGKey(0), dummy)
    jcfg = _jcfg()
    key = jax.random.PRNGKey(31)
    keys = jax.random.split(key, B)
    cubes = {False: jax.tree.map(jnp.asarray, jds.CubeBatch(*host[False])),
             True: jds.attach_pool_nwp(jax.tree.map(jnp.asarray, jds.CubeBatch(*host[True])), JS, JCOORD)}
    # iid: the loss and its gradients, then the train step's update and metrics from them as
    # make_device_sampling_train_step composes them (one compiled program of the loss less)
    grad_fn = jax.jit(jax.value_and_grad(jds.make_ds_loss_fn(jm, jcfg, JS), has_aux=True), static_argnums=(3,))
    (_, (metrics, pred_norm, labels)), grads = grad_fn(state0.params, cubes[False], keys, with_pde)
    state1, m1 = jax.jit(lambda st, g, m: jts.apply_gradient_update(tx, jcfg, st, g, m))(
        jax.tree.map(lambda x: x.copy(), state0), grads, dict(metrics))
    m1.update(jts._variable_metrics(pred_norm, labels, jcfg))
    ev = jds.make_device_sampling_eval_step(jm, jcfg, JS)(state0.params, cubes[False], jax.random.PRNGKey(7919),
                                                          with_pde)
    out = {False: dict(cube=cubes[False], keys=keys, metrics={k: float(v) for k, v in metrics.items()},
                       grads=state_dict_from_jax(jax.tree.map(np.asarray, grads)),
                       step_metrics={k: float(v) for k, v in m1.items()},
                       params1=jax.tree.map(np.asarray, state1.params),
                       eval_keys=jax.random.split(jax.random.PRNGKey(7919), B),
                       eval_metrics={k: float(v) for k, v in ev.items()})}
    # pool: JAX's jitted train step itself
    state1, m1 = jds.make_device_sampling_train_step(jm, tx, jcfg, JS)(jax.tree.map(lambda x: x.copy(), state0),
                                                                         cubes[True], key, with_pde)
    out[True] = dict(cube=cubes[True], keys=keys, step_metrics={k: float(v) for k, v in m1.items()},
                     params1=jax.tree.map(np.asarray, state1.params))
    snap = dict(params=jax.tree.map(np.asarray, state0.params), adam=_adam_state(state0.opt_state))
    return dict(dtype=dtype, with_pde=with_pde, host=host, jax=out, snap=snap)


def _port_state(world):
    td = getattr(torch, world["dtype"])
    state = tts.create_train_state(META, NET, OPT, torch.Generator().manual_seed(0), compute_dtype=td, device="cpu")
    count, mu, nu = world["snap"]["adam"]
    return load_train_state(state, world["snap"]["params"], mu, nu, count, 0)


def _port_cube(world, pool):
    cube = tds.cube_to_device(world["host"][pool], "cpu")
    if pool:  # the samplers compared on one pool conditioning (see test_samplers_match_jax_on_jax_draws)
        cube = cube._replace(pool_nwp=_t(np.asarray(world["jax"][pool]["cube"].pool_nwp)))
    return cube


def _tolerances(world):
    """(metric rtol, gradient share of its largest entry, parameter bound after one step, share of
    the entries allowed past it).  float32: ``METRIC_RTOL``; 2e-2, the relative gradient
    difference behind ``PARAM_ATOL``; ``PARAM_ATOL`` for one step, all but one entry in 10,000.
    bfloat16: a bf16 rounding of the loss (2^-8); 2^-3 of a gradient's largest entry, since every
    cotangent of a bf16 product is rounded to 8 bits and a bias's gradient sums 1,024 of them in
    another order; one step moves an entry by about lr * sign(gradient) (Adam's first step), so an
    entry whose gradient lies within that noise of zero may step the other way: ``PARAM_ATOL`` for
    one step, all but one entry in 100."""
    if world["dtype"] == "float32":
        return METRIC_RTOL, 2e-2, PARAM_ATOL / 3, 1e-4
    return 2.0 ** -8, 2.0 ** -3, PARAM_ATOL / 3, 1e-2


# bfloat16: the per-variable errors in physical units, each the mean square of a bf16 prediction
# less its label, move by a prediction's rounding (2^-9) over the prediction's error, about 2^-9
# x 8 on these random weights and cubes: held to 2^-5
VARIABLE_METRICS = tuple(f"margin_{k}_loss" for k in ("u", "v", "p", "T", "q", "rio"))


def _assert_metrics(got, want, rtol, where):
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        assert np.isfinite(got[k]), (where, k)
        r = max(rtol, 2.0 ** -5) if rtol > METRIC_RTOL and k in VARIABLE_METRICS else rtol
        np.testing.assert_allclose(got[k], w, rtol=r, atol=1e-12, err_msg=f"{where} {k}")


def test_ds_loss_and_gradients_match_jax(step_world):
    want = step_world["jax"][False]
    rtol, gshare, _, _ = _tolerances(step_world)
    state = _port_state(step_world)
    total, (metrics, _, labels) = tds.make_ds_loss_fn(state.model, _tcfg(), TS)(
        _port_cube(step_world, False), _jax_draws(want["keys"]), step_world["with_pde"])
    total.backward()
    _assert_metrics({k: float(v.detach()) for k, v in metrics.items()}, want["metrics"], rtol, "loss")
    assert ("inter_total" in metrics) == step_world["with_pde"]
    assert tuple(labels.shape) == (2, SCFG["n_margin"], 6)
    for name, p in state.model.named_parameters():
        if name.endswith("key_projection.bias"):  # exact gradient zero: rounding noise in both
            continue
        w = want["grads"][name].float().numpy()
        err = float(np.abs(p.grad.float().numpy() - w).max())
        assert err <= gshare * float(np.abs(w).max()) + 1e-30, (name, err, float(np.abs(w).max()))


def test_ds_eval_step_matches_jax(step_world):
    want = step_world["jax"][False]
    state = _port_state(step_world)
    evals = tds.make_device_sampling_eval_step(_tcfg(), TS)
    cube, draws = _port_cube(step_world, False), _jax_draws(want["eval_keys"])
    ev = {k: float(v) for k, v in evals(state.model, cube, draws, step_world["with_pde"]).items()}
    _assert_metrics(ev, want["eval_metrics"], _tolerances(step_world)[0], "eval step")
    assert {k: float(v) for k, v in evals(state.model, cube, draws, step_world["with_pde"]).items()} == ev


@pytest.mark.parametrize("pool", [False, True], ids=["iid", "pool"])
def test_ds_train_step_matches_jax(step_world, pool):
    want = step_world["jax"][pool]
    rtol, _, patol, share = _tolerances(step_world)
    state = _port_state(step_world)
    state, m = tds.make_device_sampling_train_step(_tcfg(), TS)(state, _port_cube(step_world, pool),
                                                                _jax_draws(want["keys"]), step_world["with_pde"])
    _assert_metrics({k: float(v) for k, v in m.items()}, want["step_metrics"], rtol, "train step")
    assert state.step == 1 and m["skipped_nonfinite"] == 0.0
    jp = state_dict_from_jax(want["params1"])
    off = total = 0
    for k, v in state.model.state_dict().items():
        diff = np.abs(v.float().numpy() - jp[k].float().numpy())
        assert diff.max() <= 2 * OPT["lr"] * 1.01, (k, diff.max())  # what Adam can put between two runs
        if not k.endswith("key_projection.bias"):
            off += int((diff > patol).sum())
            total += diff.size
    assert off <= share * total, (off, total)
