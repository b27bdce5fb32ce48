"""Full-scale synthetic config: reference model dims + full study area (the port's copy).

The port's own copy of ``configs/synthetic_fullscale_cfg.py``, which writes its tree with the JAX
package's generator and so loads only where jax is installed.  This copy writes the same tree with
the port's generator (``deepphysinet_tpu_torch/data/synthetic.py``, byte for byte the same files);
every other value is the original's.

Same geometry as the production NCEP config (1 deg 37x65 -> 0.25 deg 145x257,
159x2405 tokens, d_model 256) but trained on auto-generated synthetic
harmonics -- used to validate training stability, throughput, and the full
pipeline at production scale without real TIGGE/ERA5 data.
``DPN_FULLSYNTH_DATA`` overrides the data root.  Train it with

    python -m deepphysinet_tpu_torch.cli --config_file deepphysinet_tpu_torch/configs/synthetic_fullscale_cfg.py
"""

import os
import tempfile

_ROOT = os.environ.get(
    "DPN_FULLSYNTH_DATA", os.path.join(tempfile.gettempdir(), "dpn_fullsynth_data")
)

from deepphysinet_tpu_torch.data.synthetic import ensure_synthetic_tree

# regenerates iff stale; flock-serialized (multi-process launches import this
# config concurrently)
ensure_synthetic_tree(_ROOT, n_init_times=4, bbox=(72.0, 18.0, 136.0, 54.0))

mode = "train"
img_size = (145, 257)

_data = dict(
    input_path=os.path.join(_ROOT, "input"),
    label_path=os.path.join(_ROOT, "labels"),
    input_data_map_cfg=dict(NCEP=os.path.join(_ROOT, "input_map.pickle")),
    constant_path=os.path.join(_ROOT, "constant"),
    constant_variables=("landsea", "elevation", "lat", "lon"),
    in_coord_file=os.path.join(_ROOT, "coord_1d.pickle"),
    out_coord_file=os.path.join(_ROOT, "coord_0p25d.pickle"),
    input_time_step=6,
    input_time_step_nums=4,
    forecast_time_period=24,
    label_time_step=1,
    label_img_size=img_size,
    label_batch_size=2048 * 10,
    batch_size_inter=2048 * 2,
    in_memory=True,
    auto_norm=False,
)

# synthetic-field normalization stats (match data/synthetic.py amplitudes)
_OBS = dict(
    pres=dict(name="PSFC", norm_factor=[9.0e4, 800.0], norm_type="mean_norm",
              bound=[10000, 500000], use_norm=True),
    t2=dict(name="t2", norm_factor=[284.0, 8.0], norm_type="mean_norm",
            bound=[50, 500], use_norm=True),
    u10=dict(name="u10", norm_factor=[0.3, 4.0], norm_type="mean_norm",
             bound=[-500, 500], use_norm=True),
    v10=dict(name="v10", norm_factor=[-0.1, 4.0], norm_type="mean_norm",
             bound=[-500, 500], use_norm=True),
    q2=dict(name="q2", norm_factor=[0.0076, 0.003], norm_type="mean_norm",
            bound=[1e-6, 10], use_norm=True),
    rio=dict(name="rio", norm_factor=[1.09, 0.08], norm_type="mean_norm",
             bound=[1e-6, 10], use_norm=True),
)

config = dict(
    name="InterfacePhysics",
    meta_cfg=dict(
        name="TransformerNet", enc_in=2405, c_out=256, d_model=256, n_heads=8,
        e_layers=4, d_ff=256, activation="gelu", output_attention=False,
    ),
    net_cfg=dict(
        name="PhysicsNet", in_channels=192, hidden_channels=256, out_channels=1,
        token_num=155 + 4, learnable_token_num=256,
    ),
    variable_cfg=dict(
        pres=dict(name="PSFC", norm_factor=[9.0e4, 800.0], norm_type="mean_norm", use_norm=True),
        t2=dict(name="t2", norm_factor=[284.0, 8.0], norm_type="mean_norm", use_norm=True),
        u10=dict(name="u10", norm_factor=[0.3, 4.0], norm_type="mean_norm", use_norm=True),
        v10=dict(name="v10", norm_factor=[-0.1, 4.0], norm_type="mean_norm", use_norm=True),
        q2=dict(name="q2", norm_factor=[0.0076, 0.003], norm_type="mean_norm", use_norm=True),
        rio=dict(name="rio", norm_factor=[1.09, 0.08], norm_type="mean_norm", use_norm=True),
        GHT=dict(name="GHT", norm_factor=[[100.0, 770.0, 1478.0, 3067.0, 5699.0], [100.0] * 5], norm_type="mean_norm", use_norm=True),
        TT=dict(name="TT", norm_factor=[[292.0, 288.0, 284.0, 275.0, 259.0], [6.0] * 5], norm_type="mean_norm", use_norm=True),
        UU=dict(name="UU", norm_factor=[[0.4, 0.8, 1.9, 4.8, 10.1], [4.0] * 5], norm_type="mean_norm", use_norm=True),
        VV=dict(name="VV", norm_factor=[[0.04, 0.18, 0.1, -0.42, -0.95], [4.0] * 5], norm_type="mean_norm", use_norm=True),
        QQ=dict(name="QQ", norm_factor=[[0.009, 0.008, 0.006, 0.004, 0.002], [0.003, 0.0027, 0.002, 0.0013, 0.0006]], norm_type="mean_norm", use_norm=True),
    ),
    obs_norm_cfg=_OBS,
    train_cfg=dict(
        batch_size=1,
        batch_size_inter=2048 * 2,
        device="tpu",
        num_epoch=10000,
        num_workers=2,
        with_pde=True,
        lable_time_step=1,
        dx=27000,
        dy=27000,
        img_size=img_size,
        train_data=dict(start_time=r"2008-01-01_00_00_00", end_time=r"2008-01-03_00_00_00", **_data),
        valid_data=dict(start_time=r"2008-01-04_00_00_00", end_time=r"2008-01-04_00_00_00", **_data),
        losses=dict(
            pde_loss=dict(name="MSELoss"),
            prediction_loss=dict(name="WeightSmoothL1Loss", beta=0.1),
            loss_factor=dict(
                sample_factor=1.0e6, margin_factor=1.0e6,
                motion_u_factor=1.0e3, motion_v_factor=1.0e3,
                continuous_factor=1.0e10, energy_factor=1e1,
                vapor_factor=1.0e14, gas_factor=1.0e-7,
            ),
        ),
        optimizer=dict(name="Adam", lr=1e-4, weight_decay=1e-4),
        # epochs are ~3 steps on the synthetic tree; save_step=500 epochs keeps
        # checkpoint saves from dominating soak wall time (the original's value)
        checkpoints=dict(checkpoints_path=os.path.join(_ROOT, "checkpoints"), save_step=500),
        lr_schedule=dict(name="CosineAnnealingLR", T_max=5, eta_min=5e-6),
        log=dict(
            log_path=os.path.join(_ROOT, "log"),
            log_step=100,
            with_vis=False,
            vis_path=os.path.join(_ROOT, "vis"),
            vis_downscale_cfg=dict(
                coord_file=os.path.join(_ROOT, "coord_0p25d.pickle"),
                project_dict=dict(name="LatLon"),
            ),
        ),
        tpu=dict(compute_dtype="bfloat16", attn_impl=None, pde_start_step=100,
                 mesh=dict(data=-1, points=1), sample_mode="device"),
    ),
    test_cfg=dict(),
    inference_cfg=dict(
        batch_size=1, device="tpu", dt=60 * 60, img_size=img_size, pred_t_span=-1,
        start_time=r"2008-01-01_01_00_00", end_time=r"2008-01-01_06_00_00",
        checkpoints=dict(checkpoints_path=os.path.join(_ROOT, "checkpoints")),
        inference_data=dict(start_time=r"2008-01-01_00_00_00",
                            end_time=r"2008-01-03_00_00_00", **_data),
        log=dict(
            with_vis=True, vis_path=os.path.join(_ROOT, "inference_out"),
            result_path=os.path.join(_ROOT, "inference_out"), write_source=True,
            export_variable=["T", "U", "P"], time_offset_hours=0,
            vis_downscale_cfg=dict(
                coord_file=os.path.join(_ROOT, "coord_0p25d.pickle"),
                project_dict=dict(name="LatLon"),
            ),
        ),
    ),
)
