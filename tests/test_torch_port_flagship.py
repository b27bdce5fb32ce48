"""PyTorch port against the JAX package at the flagship width, through a record.

The JAX side of ``deepphysinet_tpu_torch/diagnostics/flagship_parity.py``: ``jax_record`` builds
the JAX ``PhysicsNet`` at the width of ``configs/DeepPhysiNet_NCEP_cfg.py`` on the CPU from the
port's ``seeded_state_dict`` (through ``convert_torch_state_dict``), runs it on
``flagship_inputs`` and returns the record that the card's ``chip_smoke.py`` (phase 24b) reads.
It takes the XLA paths that the JAX package itself takes off the TPU: the ``'jvp'`` engine
(``interface_physics.py:162``), ``decode_jvp_xla_v4s`` and ``decode_xla_v4_primal``; no Pallas
kernel runs.  Rewrite the committed record with

    JAX_PLATFORMS=cpu python tests/test_torch_port_flagship.py --write

Each reading's JAX spread is the largest of what other equivalent JAX computations part from the
main one by, on the same inputs: the same weights with the inner units of each two-layer block (each
encoder layer's feed-forward ``conv1`` / ``conv2``, each variable net's ``cat_fc1.fc.0`` / ``fc.2``)
in four seeded orders (``permuted_state_dict``: the same function, other sums, as another BLAS would
order them, the encoder's roundings moved as C17 has them move; the gradients permuted back); R1
also the same window encoded in the B = 2 batch; R2 to R6 also the v6 twin of the same algebra
(``jvp_fields(version=6)``: the trig operand, the PE derivative folded into the weights, as the
port's v4s pair has them; the ``'jvp'`` step under ``kernel_version=6``); in float32 also
``PhysicsNet.decode`` (R2) and ``jax.linearize`` over it (R3 and R4, and R5's ``'linearize'``
engine), which XLA's CPU backend cannot run jitted in bf16 ("Unsupported element type for
DotThunk::Execute: BF16 x BF16 = F32"); and for R6 what JAX's B = 2 step parts from its two
micro-batches by.  A port reading passes when its error is
within the larger of ``FLOORS`` and ``SPREAD_TIMES`` times that spread (``flagship_parity.compare``).

Tier-1 checks only the recipe (the record's checksums, names and shapes from the weights and
inputs made here, no forward at the flagship width).  The ``slow`` tests write the record again
and hold it to the committed one, and hold the port's plain versions on the CPU to it.
"""

import os
import sys
import time

if __name__ == "__main__":  # run as a script from the repository root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepphysinet_tpu.models.physics_net import PhysicsNet as JaxPhysicsNet
from deepphysinet_tpu.ops import decode_kernel as jdk
from deepphysinet_tpu.ops.coords import CoordSpec as JaxCoordSpec
from deepphysinet_tpu.ops.coords import encode_coord
from deepphysinet_tpu.ops.normalization import OBS_NAME_ORDER as J_ORDER
from deepphysinet_tpu.ops.normalization import norm_specs_from_cfg as j_norm_specs
from deepphysinet_tpu.physics import engine as jengine
from deepphysinet_tpu.train import train_step as jts
from deepphysinet_tpu.train.optim import build_optimizer as j_build_optimizer
from deepphysinet_tpu.train.point_fn import inverse_norm_stack, make_phys_fn
from deepphysinet_tpu.train.torch_import import convert_torch_state_dict, export_torch_state_dict

from deepphysinet_tpu_torch.diagnostics import flagship_parity as fp
from deepphysinet_tpu_torch.models.physics_net import PhysicsNet

torch.set_num_threads(1)

VARIABLES = ("u10", "v10", "psfc", "t2", "q2", "rio")
VARIABLE_NETS = ("U_net", "V_net", "P_net", "T_net", "q_net", "rio_net")
PERMUTATION_SEEDS = (1, 2, 3, 4)  # four reorderings of the inner units in the spread
FIELD_READINGS = ("tokens", "frame", "v4s_primal", "v4s_tangents")  # kept in float32, the rest float64
# The slow regeneration test: XLA on the CPU runs the same program on the same inputs, but its
# thread pool may split a reduction otherwise between runs and machines; the readings stay
# within 1e-5 of their scale (float32) and 1e-2 (bfloat16, a flipped rounding), the spreads
# within 1e-3 and 1e-1 absolute (they are errors already).
REGEN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
REGEN_SPREAD_TOL = {"float32": 1e-3, "bfloat16": 1e-1}


def _port_template():
    cfg = fp.flagship_config()
    return cfg, PhysicsNet(cfg["meta_cfg"], cfg["net_cfg"], device="cpu")


def _jax_model(cfg, dtype):
    meta = {k: v for k, v in cfg["meta_cfg"].items() if k != "name"}
    net = {k: v for k, v in cfg["net_cfg"].items() if k != "name"}
    return JaxPhysicsNet(meta_cfg=meta, net_cfg=net, compute_dtype=getattr(jnp, dtype),
                         attn_impl=cfg["train_cfg"]["tpu"].get("attn_impl"))


def _step_config(cfg, engine, kernel_version=7):
    """The JAX interface's step configuration of the flagship (interface_physics.py:218-238)."""
    train = cfg["train_cfg"]
    lat, lon = train["img_size"]
    specs = j_norm_specs(cfg["obs_norm_cfg"])
    losses = train["losses"]
    return jts.StepConfig(
        coord_spec=JaxCoordSpec(lon_size=lon, lat_size=lat, dx=float(train["dx"]), dy=float(train["dy"]),
                                pred_t_span=86400.0),
        obs_specs=tuple(specs[k] for k in J_ORDER), loss_factor=dict(losses["loss_factor"]),
        forecast_time_period=float(train["train_data"].get("forecast_time_period", 360)),
        prediction_loss=losses["prediction_loss"]["name"],
        prediction_beta=float(losses["prediction_loss"].get("beta", 0.1)),
        pde_loss=losses["pde_loss"]["name"], pde_engine=engine, kernel_version=kernel_version)


def _jax_batch(nb):
    def pts(d):
        return jts.PointBatch(**{k: jnp.asarray(v) for k, v in d.items()})

    return jts.Batch(field=jnp.asarray(nb["field"]), forecast_h=jnp.asarray(nb["forecast_h"]),
                     margin=pts(nb["margin"]), inter=pts(nb["inter"]))


def _np_tree(tree):
    return export_torch_state_dict(jax.tree.map(np.asarray, tree))


class _JaxSide:
    """The JAX model at one compute dtype, with its jitted pieces: each returns the main form and
    the other form of the spread (float32: ``PhysicsNet.decode`` and ``jax.linearize``; bfloat16:
    the v6 twin)."""

    def __init__(self, cfg, variables, dtype):
        self.variables = variables
        self.model = model = _jax_model(cfg, dtype)
        self.cdt = getattr(jnp, dtype)
        self.jvp_cfg, self.v6_cfg = _step_config(cfg, "jvp"), _step_config(cfg, "jvp", 6)
        lin = dtype == "float32"  # the plain decode under jit: float32 only
        self.spec = self.jvp_cfg.coord_spec
        self.obs = self.jvp_cfg.obs_specs
        self.tx = j_build_optimizer(**cfg["train_cfg"]["optimizer"])
        self.encode = jax.jit(lambda v, f, fh: model.apply(v, f, fh, method=JaxPhysicsNet.encode))

        def decode_norm(v, tokens, coords, nwp, fh):
            pe = encode_coord(coords[:, 0], coords[:, 1], coords[:, 2], self.spec)
            return model.apply(v, tokens, pe, nwp, fh, method=JaxPhysicsNet.decode)

        def v6_fields(v, tokens, coords, nwp, fh):  # [N, 6], [3, N, 6]
            return jengine.jvp_fields(model, v, tokens, coords, nwp, fh, self.spec, self.obs, with_clip=True,
                                      version=6, raw_tangents=True)

        phys_t = lambda out: inverse_norm_stack(out, self.obs, True).T  # noqa: E731

        @jax.jit
        def frame(v, tokens, coords, nwp, fh):  # the inference paths' collapsed decode, and the others
            others = [v6_fields(v, tokens, coords, nwp, fh)[0]]
            if lin:
                others.append(decode_norm(v, tokens, coords, nwp, fh))
            return phys_t(jengine.collapsed_decode(model, v, tokens, coords, nwp, fh, self.spec)), \
                [phys_t(o) for o in others]

        @jax.jit
        def v4s(v, tokens, coords, nwp, fh):  # the v4s XLA twin; the v6 twin, jax.linearize over decode
            weights, pe_cm, cd_pe = jengine._kernel_inputs_s(model, v, tokens, coords, nwp, fh, self.spec)
            fw6 = jdk.fuse_v6_from_v4(jdk.fuse_decode_weights(weights), self.spec)
            primal_t, tang_t = jdk.decode_jvp_xla_v4s(fw6, pe_cm, cd_pe, jax.lax.stop_gradient(nwp).T, self.cdt)
            primal, tang = v6_fields(v, tokens, coords, nwp, fh)
            others = [(primal.T, jnp.transpose(tang, (0, 2, 1)))]
            if lin:
                primal, lin_fn = jax.linearize(lambda c: decode_norm(v, tokens, c, nwp, fh), coords)
                n = coords.shape[0]
                tangs = [lin_fn(jnp.zeros((n, 3), coords.dtype).at[:, k].set(1.0)) for k in range(3)]
                others.append((primal.T, jnp.stack([t.T for t in tangs])))
            return (primal_t, tang_t), others

        @jax.jit
        def residual(v, tokens, coords, nwp, fh, f):  # bench.py's evaluation, both engines
            weights, pe_cm, cd_pe = jengine._kernel_inputs_s(model, v, tokens, coords, nwp, fh, self.spec)
            fw6 = jdk.fuse_v6_from_v4(jdk.fuse_decode_weights(weights), self.spec)
            primal_t, tang_t = jdk.decode_jvp_xla_v4s(fw6, pe_cm, cd_pe, jax.lax.stop_gradient(nwp).T, self.cdt)
            factors = self.jvp_cfg.factors()
            a = jengine.packed_residual_losses_from_primal_tangents_t(primal_t, tang_t, f, self.obs, factors,
                                                                      with_clip=True)
            others = [jengine.packed_residual_losses_from_primal_tangents(
                *v6_fields(v, tokens, coords, nwp, fh), f, self.obs, factors, with_clip=True)]
            if lin:
                phys_fn = make_phys_fn(model, v, tokens, nwp, fh, self.spec, self.obs, with_clip=True)
                others.append(jengine.pde_residual_losses(phys_fn, coords, f, factors))
            return a, others

        self.frame, self.v4s, self.residual = frame, v4s, residual
        configs = {"jvp": self.jvp_cfg, "v6": self.v6_cfg}
        if lin:
            configs["linearize"] = _step_config(cfg, "linearize")
        self.grad = {name: jax.jit(jax.value_and_grad(jts.make_loss_fn(model, c), has_aux=True),
                                   static_argnames=("with_pde",))
                     for name, c in configs.items()}

    def step(self, engine, batches, variables=None, perms=None):
        """R5's readings of one step from ``variables`` (the seeded weights, or a permutation of
        them, ``perms``, whose gradients and changes are permuted back): ``batches`` one after the
        other (averaged, as two micro-batches), then the clip and Adam of ``apply_gradient_update``."""
        variables = self.variables if variables is None else variables
        outs = [self.grad[engine](variables, _jax_batch(nb), with_pde=True) for nb in batches]
        grads = jax.tree.map(lambda *g: sum(g) / len(g), *[o[1] for o in outs])
        metrics = {k: sum(o[0][1][0][k] for o in outs) / len(outs) for k in outs[0][0][1][0]}
        pred = jnp.concatenate([o[0][1][1] for o in outs])
        labels = jnp.concatenate([jnp.asarray(nb["margin"]["labels"]) for nb in batches])
        state = jts.TrainState(step=jnp.asarray(0), params=variables, opt_state=self.tx.init(variables))
        new, metrics = jts.apply_gradient_update(self.tx, self.jvp_cfg, state, grads, metrics)
        metrics.update(jts._variable_metrics(pred, labels, self.jvp_cfg))
        before, after = _np_tree(variables), _np_tree(new.params)
        m = {k: float(v) for k, v in metrics.items() if k not in fp.STEP_METRICS_SKIPPED}
        change = {k: after[k] - before[k] for k in after}
        return (fp.step_readings(m, float(metrics["grad_norm"]), _unpermute(_np_tree(grads), perms),
                                 _unpermute(change, perms)), sorted(m))


def _hidden_pairs(sd):
    """(first layer, second layer) name prefixes of the two-layer blocks whose inner units can be
    reordered: each encoder layer's feed-forward ``conv1`` / ``conv2`` and each variable net's
    ``cat_fc1.fc.0`` / ``fc.2``."""
    layers = sorted({k.split(".conv1.")[0] for k in sd if ".conv1." in k})
    return ([(f"{l}.conv1.", f"{l}.conv2.") for l in layers]
            + [(f"{v}.cat_fc1.fc.0.", f"{v}.cat_fc1.fc.2.") for v in VARIABLE_NETS])


def permuted_state_dict(sd, seed):
    """The same function in another summation order: the inner units of each ``_hidden_pairs``
    block in a seeded order (the first layer's rows and bias, the second layer's columns), which
    moves the encoder's roundings and the decode's.  Returns the state dict and the permutations."""
    rng = np.random.RandomState(seed)
    out, perms = dict(sd), {}
    for first, second in _hidden_pairs(sd):
        perm = perms[(first, second)] = rng.permutation(sd[first + "weight"].shape[0])
        out[first + "weight"], out[first + "bias"] = sd[first + "weight"][perm], sd[first + "bias"][perm]
        out[second + "weight"] = sd[second + "weight"][:, perm]
    return out, perms


def _unpermute(tree, perms):
    """Gradients or changes of a ``permuted_state_dict``'s parameters in the seeded order."""
    if not perms:
        return tree
    out = dict(tree)
    for (first, second), perm in perms.items():
        for name, axis in ((first + "weight", 0), (first + "bias", 0), (second + "weight", 1)):
            a = np.asarray(tree[name])
            b = np.empty_like(a)
            if axis == 0:
                b[perm] = a
            else:
                b[:, perm] = a
            out[name] = b
    return out


def _micro_batches(b2):
    return [{k: (v[i : i + 1] if not isinstance(v, dict) else {q: w[i : i + 1] for q, w in v.items()})
             for k, v in b2.items()} for i in range(2)]


def jax_record(seed=fp.SEED, log=print):
    """(meta, arrays) of the record: the JAX package's readings at both dtypes and their spreads."""
    cfg, template = _port_template()
    sd = fp.seeded_state_dict(template, seed)
    inputs = fp.flagship_inputs(cfg, seed)
    to_jax = lambda d: jax.tree.map(jnp.asarray, convert_torch_state_dict({k: v.numpy() for k, v in d.items()}))  # noqa: E731
    variables = to_jax(sd)
    permuted = []  # (variables, permutations) of each permutation seed
    for ps in PERMUTATION_SEEDS:
        psd, perms = permuted_state_dict(sd, ps)
        permuted.append((to_jax(psd), perms))
    names = sorted(k for k, _ in template.named_parameters())
    meta = dict(seed=seed, frame_hour=fp.FRAME_HOUR, frame_stride=fp.FRAME_STRIDE,
                residual_points=fp.RESIDUAL_POINTS, probes=fp.PROBES, variables=list(VARIABLES),
                parameters=names, parameter_sizes=[int(sd[k].numel()) for k in names],
                permutation_seeds=list(PERMUTATION_SEEDS), checksums=fp.checksums(sd, inputs),
                jax=jax.__version__,
                written_by="tests/test_torch_port_flagship.py --write (the JAX package on the CPU)")
    arrays = {}
    nb, fr, rs, b2 = inputs["batch"], inputs["frame"], inputs["residual"], inputs["batch2"]
    fh_b = jnp.asarray(nb["forecast_h"] / 360.0)[:, None]
    fh = jnp.asarray(nb["forecast_h"] / 360.0)
    fh_f = jnp.asarray([float(fr["forecast_h"]) / 360.0])
    f_coords = jnp.asarray(np.stack([fr["x"], fr["y"], fr["t"]], -1))
    inter = nb["inter"]
    i_coords = jnp.asarray(np.stack([inter["x"][0], inter["y"][0], inter["t"][0]], -1))
    i_nwp = jnp.asarray(inter["nwp"][0])
    r_args = (jnp.asarray(rs["coords"]), jnp.asarray(rs["nwp"]), fh, jnp.asarray(rs["f"]))
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        js = _JaxSide(cfg, variables, dtype)
        got, alts = {}, {}  # the main form's readings; each reading's other forms

        def add(name, main, *others):
            got[name] = np.asarray(main)
            alts.setdefault(name, []).extend(np.asarray(o) for o in others)

        tokens = js.encode(variables, jnp.asarray(nb["field"]), fh_b)
        tokens2 = js.encode(variables, jnp.asarray(b2["field"]), jnp.asarray(b2["forecast_h"] / 360.0)[:, None])
        add("tokens", tokens[0], tokens2[0])
        ftok = js.encode(variables, jnp.asarray(fr["field"]), fh_f[:, None])[0]
        f_nwp = jnp.asarray(fr["nwp"])
        strided = lambda a: np.asarray(a)[:, :: fp.FRAME_STRIDE]  # noqa: E731
        a, others = js.frame(variables, ftok, f_coords, f_nwp, fh_f)
        add("frame", strided(a), *map(strided, others))
        (p_t, t_t), others = js.v4s(variables, tokens[0], i_coords, i_nwp, fh)
        add("v4s_primal", p_t, *(o[0] for o in others))
        add("v4s_tangents", t_t, *(o[1] for o in others))
        ra, others = js.residual(variables, tokens[0], *r_args)
        meta["residual_terms"] = terms = sorted(ra)
        vec = lambda r: np.array([float(r[k]) for k in terms])  # noqa: E731
        add("residual", vec(ra), *map(vec, others))
        for pv, _ in permuted:  # the permuted encoder's own tokens
            p_tok = js.encode(pv, jnp.asarray(nb["field"]), fh_b)[0]
            alts["tokens"].append(np.asarray(p_tok))
            p_ftok = js.encode(pv, jnp.asarray(fr["field"]), fh_f[:, None])[0]
            alts["frame"].append(strided(js.frame(pv, p_ftok, f_coords, f_nwp, fh_f)[0]))
            p_t, t_t = js.v4s(pv, p_tok, i_coords, i_nwp, fh)[0]
            alts["v4s_primal"].append(np.asarray(p_t))
            alts["v4s_tangents"].append(np.asarray(t_t))
            alts["residual"].append(vec(js.residual(pv, p_tok, *r_args)[0]))
        log(f"[record] {dtype}: R1-R4 in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        groups = {"step": [nb]}
        if dtype == "float32":
            groups.update(b2=[b2], micro=_micro_batches(b2))
        for prefix, batches in groups.items():
            main, meta["metrics"] = js.step("jvp", batches)
            others = [js.step("jvp", batches, pv, perms)[0] for pv, perms in permuted]
            others += [js.step(engine, batches)[0] for engine in js.grad
                       if engine == "v6" or (engine == "linearize" and prefix == "step")]
            for part in fp.STEP_PARTS:
                add(f"{prefix}.{part}", main[part], *(o[part] for o in others))
        log(f"[record] {dtype}: R5{' and R6' if dtype == 'float32' else ''} in {time.perf_counter() - t0:.1f} s")
        spread = {name: np.max([fp.item_errors(name, o, main, meta, got) for o in alts[name]], axis=0)
                  for name, main in got.items()}
        if dtype == "float32":  # R6: JAX's own B = 2 against its two micro-batches, in the spread too
            own = fp.difference_errors(got, meta)
            for part in fp.STEP_PARTS:
                arrays[f"jax_b2_vs_micro/{part}"] = own[part]
                for prefix in ("b2", "micro"):
                    spread[f"{prefix}.{part}"] = np.maximum(spread[f"{prefix}.{part}"], own[part])
        for k, v in got.items():
            arrays[f"{dtype}/{k}"] = np.asarray(v, np.float32 if k in FIELD_READINGS else np.float64)
            arrays[f"spread/{dtype}/{k}"] = np.asarray(spread[k], np.float64)
        del js
    return meta, arrays


# ---- tier-1: the recipe ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def record():
    return fp.load_record()


def test_record_is_small_and_from_the_jax_package(record):
    meta, arrays = record
    assert os.path.getsize(fp.RECORD) <= 2 * 1024 * 1024
    assert meta["written_by"].startswith("tests/test_torch_port_flagship.py --write")
    assert meta["seed"] == fp.SEED and meta["frame_stride"] == fp.FRAME_STRIDE
    assert meta["probes"] == fp.PROBES and meta["residual_points"] == fp.RESIDUAL_POINTS
    for dtype in fp.DTYPES:
        for k in [k for k in arrays if k.startswith(dtype + "/")]:
            assert np.all(np.isfinite(arrays[k])), k
            assert arrays[f"spread/{k}"].shape[0] >= 1


def test_weights_and_inputs_give_the_record_checksums(record):
    """The recipe of ``flagship_parity`` still makes the record's weights and inputs, bit for bit
    (seconds: the flagship model is built, nothing runs at its width)."""
    meta, _ = record
    cfg, template = _port_template()
    sd = fp.seeded_state_dict(template, meta["seed"])
    inputs = fp.flagship_inputs(cfg, meta["seed"])
    assert fp.checksum_mismatches(meta, fp.checksums(sd, inputs)) == []
    names = sorted(k for k, _ in template.named_parameters())
    assert meta["parameters"] == names == sorted(sd)
    assert meta["parameter_sizes"] == [int(sd[k].numel()) for k in names]
    assert sum(meta["parameter_sizes"]) == sum(p.numel() for p in template.parameters())
    # the LayerNorms are not the identity, the learnable tokens in [0, 1)
    norm = sd["meta_net.model.encoder.norm.weight"]
    assert 0.5 < float(norm.mean()) < 1.5 and float(norm.std()) > 0.05
    tok = sd["meta_net.model.learnable_token"]
    assert float(tok.min()) >= 0.0 and float(tok.max()) < 1.0


def test_record_shapes_follow_the_inputs(record):
    meta, arrays = record
    cfg = fp.flagship_config()
    inputs = fp.flagship_inputs(cfg, meta["seed"])
    n_inter = inputs["batch"]["inter"]["x"].shape[1]
    n_frame = inputs["frame"]["x"].size
    assert n_frame == 145 * 257 and inputs["residual"]["coords"].shape == (fp.RESIDUAL_POINTS, 3)
    assert inputs["batch2"]["margin"]["x"].shape == (2, 20480) and n_inter == 4096
    n_par, n_met = len(meta["parameters"]), len(meta["metrics"])
    shapes = {"tokens": (287, 256), "frame": (6, -(-n_frame // fp.FRAME_STRIDE)),
              "v4s_primal": (6, n_inter), "v4s_tangents": (3, 6, n_inter),
              "residual": (len(meta["residual_terms"]),), "step.metrics": (n_met,),
              "step.grad_norm": (1,), "step.leaf_norms": (n_par,), "step.grad_probes": (n_par, fp.PROBES),
              "step.step_norms": (n_par,), "step.step_probes": (n_par, fp.PROBES)}
    for dtype in fp.DTYPES:
        for name, shape in shapes.items():
            assert arrays[f"{dtype}/{name}"].shape == shape, (dtype, name)
    for prefix in ("b2", "micro"):
        for part in fp.STEP_PARTS:
            assert arrays[f"float32/{prefix}.{part}"].shape == arrays[f"float32/step.{part}"].shape
            assert f"bfloat16/{prefix}.{part}" not in arrays
    assert meta["residual_terms"] == ["continous_loss", "energy_loss", "gas_loss", "montion_u_loss",
                                      "montion_v_loss", "total", "vapor_loss"]  # the reference's names
    assert {"margin_loss", "inter_total", "margin_total", "total_loss"} <= set(meta["metrics"])


# ---- slow: the record again, and the port's plain versions against it --------------------------


@pytest.mark.slow
def test_rewriting_the_record_gives_the_committed_numbers(record):
    meta, arrays = record
    t0 = time.perf_counter()
    meta2, arrays2 = jax_record(meta["seed"])
    print(f"the record rewritten in {time.perf_counter() - t0:.1f} s")
    assert meta2["checksums"] == meta["checksums"] and sorted(arrays2) == sorted(arrays)
    for k, want in arrays.items():
        got = arrays2[k]
        dtype = k.split("/")[1] if k.startswith("spread/") else k.split("/")[0]
        if k.startswith("spread/") or k.startswith("jax_b2_vs_micro/"):
            tol = REGEN_SPREAD_TOL.get(dtype, REGEN_SPREAD_TOL["float32"])
            assert np.abs(got - want).max() <= tol, k
        else:
            scale = np.maximum(np.abs(want), np.abs(want).max() if want.ndim > 1 else 0.0)
            assert np.all(np.abs(got - want) <= REGEN_TOL[dtype] * np.maximum(scale, 1e-30)), k


@pytest.mark.slow
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_plain_versions_hold_the_record(record, dtype):
    meta, arrays = record
    cfg, template = _port_template()
    sd = fp.seeded_state_dict(template, meta["seed"])
    inputs = fp.flagship_inputs(cfg, meta["seed"])
    t0 = time.perf_counter()
    readings, launches = fp.port_readings(cfg, sd, inputs, fp.DTYPES[dtype], device="cpu")
    rows = fp.compare(readings, meta, arrays, dtype)
    print(f"port_readings ({dtype}, CPU) in {time.perf_counter() - t0:.1f} s")
    print("\n".join(fp.format_rows(rows + (fp.b2_micro_rows(readings, meta, arrays) if dtype == "float32" else []))))
    assert launches == {k: 0 for k in launches}  # the CPU takes the plain versions
    assert sorted(r["reading"] for r in rows if not r["reading"].endswith(".noise")) == sorted(
        k.split("/", 1)[1] for k in arrays if k.startswith(dtype + "/"))
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]


def main(argv):
    import argparse

    parser = argparse.ArgumentParser(description="Write the flagship parity record from the JAX package.")
    parser.add_argument("--write", action="store_true", help=f"write {os.path.relpath(fp.RECORD)}")
    parser.add_argument("--out", default=fp.RECORD)
    args = parser.parse_args(argv)
    if not args.write:
        parser.error("nothing to do without --write")
    jax.config.update("jax_platforms", "cpu")
    t0 = time.perf_counter()
    meta, arrays = jax_record()
    fp.save_record(args.out, meta, arrays)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes) in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
