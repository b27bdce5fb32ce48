"""The plain reference against the measured program's plain versions, at a tiny width on the CPU,
where both compute in float32: the same weights, windows and draws give the same points, tokens,
losses, gradients, updates and frames up to rounding."""

import math

import pytest
import torch

from benchmark.lib import checks, inputs
from benchmark.reference import model as M
from benchmark.reference.precision import Precision
from benchmark.reference.sampler import geometry, inter_points, margin_points
from benchmark.tests.conftest import tiny_cell

torch.set_num_threads(2)
CPU = torch.device("cpu")
SEEDS = (3, 2 ** 31 + 11)


def _f32(cell):
    cell.precision = dict(cell.precision, dtype="float32")
    return cell


def test_sampler_points_match_the_program():
    from deepphysinet_tpu_torch.train import device_sampling as ds

    cell = tiny_cell("f32.train_pde")
    cfg, g = cell.config, geometry(cell.config)
    win = inputs.windows(cfg, cell.traffic, 5, CPU)[0]
    d = inputs.DrawStream(cfg, 96, 32, 5, CPU).next()
    scfg = ds.SamplerConfig(n_margin=96, n_inter=32)
    from deepphysinet_tpu_torch.train.train_step import step_config_from_cfg

    spec_ = step_config_from_cfg(cfg).coord_spec
    margin, inter = ds.sample_window_points_batched(
        ds.Draws(*(d[k][None] for k in ("mx", "my", "slot", "off", "ix", "iy", "it"))), win["nwp_rows"],
        win["label_rows"], scfg, spec_)
    m, i = margin_points(win, d, g), inter_points(win, d, g)
    for ours, theirs in ((m, margin), (i, inter)):
        torch.testing.assert_close(ours["coords"], torch.stack([theirs.x[0], theirs.y[0], theirs.t[0]], -1))
        torch.testing.assert_close(ours["nwp"], theirs.nwp[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(ours["f"], theirs.f[0, :, 0], rtol=1e-5, atol=1e-12)
    torch.testing.assert_close(m["labels"], margin.labels[0])


def test_reference_tokens_match_the_program():
    from deepphysinet_tpu_torch.models.physics_net import PhysicsNet

    cell = tiny_cell("f32.train_pde")
    cfg = cell.config
    w0 = inputs.weights(cfg, 9, CPU)
    net = PhysicsNet(cfg["meta_cfg"], cfg["net_cfg"], device="cpu")
    net.load_state_dict(w0, strict=True)
    win = inputs.windows(cfg, cell.traffic, 9, CPU)[0]
    fh = torch.tensor([[0.2]])
    with torch.no_grad():
        got = net.encode(win["field"][None], fh)
    want = M.encode(w0, cfg, win["field"][None], fh, Precision("float32"))
    torch.testing.assert_close(want, got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", SEEDS)
def test_training_steps_match_the_program(seed):
    from benchmark.kinds import train_ds

    cell = tiny_cell("f32.train_pde")
    S = train_ds.setup(cell, seed, CPU)
    train_ds.release(S)
    n = train_ds.numbers(S)
    assert n["loss_gap"]["value"] < 1e-4 and n["grad_gap"]["value"] < 1e-3 and n["change_gap"]["value"] < 1e-3, n
    assert n["batch_gap"]["steps"] == train_ds.CHECKED_STEPS and n["batch_gap"]["value"] < 1e-5, n
    assert n["field1_gap"]["value"] < 1e-5, n


def test_reference_blocks_do_not_change_the_step():
    from benchmark.reference import train as ref_train

    cell = tiny_cell("f32.train_pde")
    cfg = cell.config
    w0 = inputs.weights(cfg, 4, CPU)
    win = inputs.windows(cfg, cell.traffic, 4, CPU)[0]
    d = inputs.DrawStream(cfg, 96, 32, 4, CPU).next()
    whole = ref_train.run_steps(w0, cfg, [win], [d], Precision("float32"))
    blocks = ref_train.run_steps(w0, cfg, [win], [d], Precision("float32"), block=40)
    assert math.isclose(whole["losses"][0], blocks["losses"][0], rel_tol=1e-5)
    # Adam's step flips the sign of gradients at round-off, so the gradients are compared, as grad_gap does
    assert max(checks.leaf_gaps(blocks["grad"], whole["grad"]).values()) < 1e-4


@pytest.mark.parametrize("seed", SEEDS)
def test_frames_match_the_program(seed):
    from benchmark.kinds import infer_grid

    cell = _f32(tiny_cell("bf16.infer_grid"))
    S = infer_grid.setup(cell, seed, CPU)
    for _ in range(4):
        assert infer_grid.step(S) == (1.0, True)
    infer_grid.release(S)
    n = infer_grid.numbers(S)
    assert n["field_gap"]["frames"] == 4 and n["field_gap"]["value"] < 1e-4, n  # fewer than CHECKED_FRAMES: all


def test_fp8_control_departs_from_float32():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    exact = Precision("float32").mm(a, a)
    rough = Precision("fp8").mm(a, a)
    rel = float((rough - exact).abs().max() / exact.abs().max())
    assert 1e-3 < rel < 0.2 and math.isfinite(rel)


def test_fp8_control_rounds_tangents_and_gradients():
    """A product's tangent, and the gradient it hands an operand, lie on e4m3's grid."""
    from benchmark.reference.precision import _e4m3

    gen = torch.Generator().manual_seed(1)
    a, t = torch.randn(32, 16, generator=gen), torch.randn(32, 16, generator=gen)
    w = torch.randn(16, 8, generator=gen, requires_grad=True)
    fp8 = Precision("fp8")
    out, tangent = torch.func.jvp(lambda x: fp8.mm(x, w), (a,), (t,))
    out.backward(torch.randn(32, 8, generator=gen))
    for x in (out.detach(), tangent.detach(), w.grad):
        assert torch.equal(_e4m3(x), x)
    exact = t @ w.detach()
    assert 1e-3 < float((tangent - exact).abs().max() / exact.abs().max()) < 0.2
