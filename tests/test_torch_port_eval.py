"""PyTorch port against the JAX package: the evaluation sweeps.

A synthetic GeoTIFF tree is generated and read by the JAX package's
``PhysicsDataset`` (the ``diag_setup`` pattern of tests/test_residual_diag.py);
each window is copied out with ``Window.from_dataset``, the JAX model's weights
are carried over with ``state_dict_from_jax``, and ``evaluate_residuals``,
``residual_field_maps`` and ``evaluate_rmse_fullgrid`` of both packages are
compared key by key.  The JAX residual sweep runs its Pallas v4t kernel in
interpret mode; its field maps have no interpret option and run the XLA twin,
which is the same function in float32.

Tolerances (float32 throughout).  RMSE and bias: rtol 2e-4 (sums over 28,050
points of a matmul chain in another summation order; the bias of a variable
whose errors cancel is held to 2e-4 of its RMSE).  Residual MSEs: rtol 2e-3, and
the maps 2e-3 of each map's largest value: squares of differences of large
terms (the gas law subtracts two pressures of 1e5 Pa).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.eval import residuals as jresiduals
from deepphysinet_tpu.eval import rmse as jrmse

from deepphysinet_tpu_torch.data.window import Window
from deepphysinet_tpu_torch.eval import residuals as tresiduals
from deepphysinet_tpu_torch.eval import rmse as trmse
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet
from deepphysinet_tpu_torch.ops.coords import CoordSpec
from deepphysinet_tpu_torch.ops.normalization import OBS_NAME_ORDER, norm_specs_from_cfg
from deepphysinet_tpu_torch.train.torch_import import state_dict_from_jax
from deepphysinet_tpu_torch.train.train_step import StepConfig

# One PyTorch thread per test process: the suite runs in several worker processes at once,
# and a thread pool in each would oversubscribe the cores (it about doubled these files' time).
torch.set_num_threads(1)

RMSE_RTOL = 2e-4
RESIDUAL_RTOL = 2e-3
N_WINDOWS = 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from deepphysinet_tpu.data.dataset import PhysicsDataset
    from deepphysinet_tpu.data.synthetic import generate_synthetic_dataset
    from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
    from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec
    from deepphysinet_tpu.ops.normalization import OBS_NAME_ORDER as J_ORDER
    from deepphysinet_tpu.ops.normalization import norm_specs_from_cfg as j_norm_specs
    from deepphysinet_tpu.train.train_step import StepConfig as JaxStepConfig
    from tests.test_dataset import OBS_CFG, VARIABLE_CFG
    from tests.test_train_step import FACTORS

    root = str(tmp_path_factory.mktemp("port_eval"))
    synth = generate_synthetic_dataset(root, n_init_times=N_WINDOWS, bbox=(72.0, 18.0, 80.0, 22.0))
    h, w = synth["img_size"]
    dataset = PhysicsDataset(
        input_path=synth["input_path"], label_path=synth["label_path"],
        input_data_map_cfg={"NCEP": synth["input_map_file"]},
        start_time="2008-01-01_00_00_00", end_time="2008-01-10_00_00_00",
        input_variable_cfg=VARIABLE_CFG, out_variable_cfg=OBS_CFG,
        in_coord_file=synth["in_coord_file"], out_coord_file=synth["out_coord_file"],
        constant_path=synth["constant_path"],
        constant_variables=("landsea", "elevation", "lat", "lon"),
        label_img_size=(h, w), dx=27000.0, dy=27000.0, label_batch_size=256, inter_batch_size=64,
        forecast_time_period=24, seed=0)
    assert len(dataset) >= N_WINDOWS
    geometry = dict(lon_size=w, lat_size=h, dx=27000.0, dy=27000.0, pred_t_span=86400.0)
    jspecs, tspecs = j_norm_specs(OBS_CFG), norm_specs_from_cfg(OBS_CFG)
    jcfg = JaxStepConfig(coord_spec=JaxCoordSpec(**geometry), obs_specs=tuple(jspecs[k] for k in J_ORDER),
                         loss_factor=FACTORS)
    tcfg = StepConfig(coord_spec=CoordSpec(**geometry), obs_specs=tuple(tspecs[k] for k in OBS_NAME_ORDER),
                      loss_factor=FACTORS)
    windows = [Window.from_dataset(dataset, f) for f in dataset.input_files[:N_WINDOWS]]
    meta = dict(enc_in=windows[0].field.shape[-1], c_out=32, d_model=32, n_heads=4, e_layers=1,
                d_ff=32, activation="gelu", learnable_token_num=8)
    net = dict(in_channels=192, hidden_channels=32, learnable_token_num=16)
    jmodel = JaxPhysicsNet(meta_cfg=meta, net_cfg=net)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(windows[0].field[None], jnp.float32),
                         jnp.zeros((4, 192)), jnp.zeros((4, 6)), jnp.asarray([[0.1]]))
    tmodel = PhysicsNet(meta, net, device="cpu")
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    tmodel.eval()
    return dict(jmodel=jmodel, params=params, jcfg=jcfg, dataset=dataset, tmodel=tmodel, tcfg=tcfg,
                windows=windows, shape=(h, w))


def test_window_carries_what_the_sweeps_read(setup):
    ds, w = setup["dataset"], setup["windows"][0]
    h, wd = setup["shape"]
    np.testing.assert_array_equal(w.label_cube, ds.get_label_cube(ds.input_files[0]))
    assert w.label_cube.shape == (6, h, wd, 25) and w.n_label_hours == 25
    assert (w.label_time_step, w.input_time_step_nums, w.forecast_time_period) == (
        ds.label_time_step, ds.input_time_step_nums, float(ds.forecast_time_period))
    assert Window.from_dataset(ds, ds.input_files[0], labels=False).label_cube is None


def test_evaluate_residuals_matches_jax(setup):
    want = jresiduals.evaluate_residuals(setup["jmodel"], setup["params"], setup["jcfg"], setup["dataset"],
                                         max_windows=N_WINDOWS, use_kernel=True, interpret=True)
    got = tresiduals.evaluate_residuals(setup["tmodel"], setup["tcfg"], setup["windows"], device="cpu")
    assert sorted(got) == sorted(want)
    assert tresiduals.EQ_NAMES == jresiduals.EQ_NAMES
    for k, v in want.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], v, rtol=RESIDUAL_RTOL, err_msg=k)
    assert got["n_windows"] == N_WINDOWS and got["n_hours"] == 25.0
    assert got["residual_mse_momentum_u"] > 0.0  # an untrained model cannot satisfy the physics
    one = tresiduals.evaluate_residuals(setup["tmodel"], setup["tcfg"], setup["windows"], max_windows=1,
                                        device="cpu")
    assert one["n_windows"] == 1.0 and one["weighted_total"] != got["weighted_total"]


def test_residual_field_maps_match_jax(setup):
    want = jresiduals.residual_field_maps(setup["jmodel"], setup["params"], setup["jcfg"], setup["dataset"],
                                          window=1, hour=7, use_kernel=False)
    got = tresiduals.residual_field_maps(setup["tmodel"], setup["tcfg"], setup["windows"], window=1, hour=7,
                                         device="cpu")
    assert list(got) == list(want) == list(tresiduals.EQ_NAMES)
    for k, v in want.items():
        assert got[k].shape == v.shape == setup["shape"]
        np.testing.assert_allclose(got[k], v, rtol=RESIDUAL_RTOL, atol=RESIDUAL_RTOL * v.max(), err_msg=k)


@pytest.mark.parametrize("per_lead", [False, True])
def test_evaluate_rmse_fullgrid_matches_jax(setup, per_lead):
    want = jrmse.evaluate_rmse_fullgrid(setup["jmodel"], setup["params"], setup["jcfg"], setup["dataset"],
                                        max_windows=N_WINDOWS, per_lead=per_lead)
    got = trmse.evaluate_rmse_fullgrid(setup["tmodel"], setup["tcfg"], setup["windows"], per_lead=per_lead,
                                       device="cpu")
    assert sorted(got) == sorted(want)
    assert any(k.startswith("rmse_t2_f") for k in got) == per_lead
    for k, v in want.items():
        scale = want["rmse_" + k[len("bias_"):]] if k.startswith("bias_") else 0.0
        np.testing.assert_allclose(got[k], v, rtol=RMSE_RTOL, atol=RMSE_RTOL * scale, err_msg=k)
    h, w = setup["shape"]
    assert got["n_points"] == float(N_WINDOWS * 25 * h * w) and got["full_grid"] == 1.0


def test_sweeps_need_a_device_or_an_explicit_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device exists")
    for sweep in (trmse.evaluate_rmse_fullgrid, tresiduals.evaluate_residuals, tresiduals.residual_field_maps):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sweep(setup["tmodel"], setup["tcfg"], setup["windows"])
    no_labels = [Window.from_dataset(setup["dataset"], setup["dataset"].input_files[0], labels=False)]
    with pytest.raises(ValueError, match="no label cube"):
        trmse.evaluate_rmse_fullgrid(setup["tmodel"], setup["tcfg"], no_labels, device="cpu")
