"""Weight bridge: JAX parameter trees and reference ``.pth`` files -> port state_dicts.

The port's modules carry the reference torch model's names, so a reference
checkpoint is already a port state_dict.  ``state_dict_from_jax`` turns the
JAX package's flax parameter tree (numpy or array leaves) into the same names,
key for key what ``deepphysinet_tpu/train/torch_import.py::
export_torch_state_dict`` (:144) gives, without importing jax:

* flax dense kernels are [in, out]; torch Linear weights [out, in];
* the token embedding's im2col kernel [3, enc_in, d_model] is the Conv1d
  weight [d_model, enc_in, 3] transposed (2, 1, 0), no tap flip;
* the FFN ``conv1`` / ``conv2`` are kernel-size-1 Conv1d weights [out, in, 1];
* flax LayerNorm ``scale`` is torch ``weight``;
* the six variable nets are stacked on a leading axis in VARIABLE_ORDER.

``load_train_state`` carries a whole JAX ``TrainState`` across (parameters,
Adam's first and second moments and its step count, handed over as numpy
trees), so that both packages can continue the same run.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from deepphysinet_tpu_torch.models.physics_net import VARIABLE_NETS

_META_PFX = "meta_net.model."


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``PhysicsNet`` variables -> reference-named state_dict (float32 tensors)."""
    params = variables["params"] if "params" in variables else variables
    sd: Dict[str, torch.Tensor] = {}
    meta = params["meta_net"]
    g = _META_PFX
    ve = meta["enc_embedding"]["value_embedding"]
    sd[g + "enc_embedding.value_embedding.tokenConv.weight"] = _t(np.asarray(ve["kernel"]).transpose(2, 1, 0))
    sd[g + "enc_embedding.value_embedding.tokenConv.bias"] = _t(ve["bias"])
    sd[g + "learnable_token"] = _t(meta["learnable_token"])
    sd[g + "encoder.norm.weight"] = _t(meta["norm"]["scale"])
    sd[g + "encoder.norm.bias"] = _t(meta["norm"]["bias"])
    sd[g + "projection.weight"] = _t(np.asarray(meta["projection"]["kernel"]).T)
    sd[g + "projection.bias"] = _t(meta["projection"]["bias"])
    for key in meta:
        if not key.startswith("layer_"):
            continue
        lp = g + f"encoder.attn_layers.{int(key.split('_')[1])}."
        layer = meta[key]
        for p in ("query_projection", "key_projection", "value_projection", "out_projection"):
            sd[lp + f"attention.{p}.weight"] = _t(np.asarray(layer["attention"][p]["kernel"]).T)
            sd[lp + f"attention.{p}.bias"] = _t(layer["attention"][p]["bias"])
        for c in ("conv1", "conv2"):
            sd[lp + c + ".weight"] = _t(np.asarray(layer[c]["kernel"]).T[:, :, None])
            sd[lp + c + ".bias"] = _t(layer[c]["bias"])
        for n in ("norm1", "norm2"):
            sd[lp + n + ".weight"] = _t(layer[n]["scale"])
            sd[lp + n + ".bias"] = _t(layer[n]["bias"])

    vn = params["variable_nets"]

    def unstack(name: str, leaf: Mapping[str, Any]) -> None:
        kernel, bias = np.asarray(leaf["kernel"]), np.asarray(leaf["bias"])
        for v, var in enumerate(VARIABLE_NETS):
            sd[f"{var}.{name}.weight"] = _t(kernel[v].T)
            sd[f"{var}.{name}.bias"] = _t(bias[v])

    for name in ("coord_input_fc", "coord_hidden_fc", "data_input_fc", "fore_h_fc", "out_fc"):
        unstack(name, vn[name])
    unstack("cat_fc1.fc.0", vn["cat_fc1"]["fc1"])
    unstack("cat_fc1.fc.2", vn["cat_fc1"]["fc2"])
    return sd


def load_pth(path: str) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Read a reference ``physics_{epoch}.pth`` bundle -> (state_dict, epoch, gobal_step).

    Loads with ``weights_only=True`` and strips a DDP ``module.`` prefix; pass
    the state_dict to ``PhysicsNet.load_state_dict(..., strict=True)``."""
    bundle = torch.load(path, map_location="cpu", weights_only=True)
    has_model = isinstance(bundle, dict) and "model" in bundle
    model_sd = bundle["model"] if has_model else bundle
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in model_sd.items()}
    epoch = int(bundle.get("epoch", -1)) if has_model else -1
    step = int(bundle.get("gobal_step", 0)) if has_model else 0
    return sd, epoch, step


def load_train_state(state, params: Mapping[str, Any], mu: Mapping[str, Any],
                     nu: Mapping[str, Any], adam_count: int, step: int):
    """Load a JAX ``TrainState`` into the port's ``TrainState`` (in place).

    ``params`` is the flax parameter tree; ``mu`` / ``nu`` are optax's
    ``ScaleByAdamState`` moment trees (the same structure as ``params``) and
    ``adam_count`` its update count; ``step`` is ``TrainState.step``.  All
    leaves are numpy arrays (or convertible).  The optimizer must be
    ``torch.optim.Adam``, whose state per parameter is ``step`` / ``exp_avg`` /
    ``exp_avg_sq``."""
    state.model.load_state_dict(state_dict_from_jax(params), strict=True)
    load_adam_moments(state.model, state.optimizer, mu, nu, adam_count)
    state.step = int(step)
    return state


def load_adam_moments(model: torch.nn.Module, optimizer: torch.optim.Optimizer, mu: Mapping[str, Any],
                      nu: Mapping[str, Any], adam_count: int) -> None:
    """Set ``optimizer``'s state (``torch.optim.Adam``: ``step`` / ``exp_avg`` / ``exp_avg_sq`` per
    parameter) to the moment trees ``mu`` / ``nu`` of an optax ``ScaleByAdamState`` (the structure
    of the flax parameters) and its update count.  Raises ``TypeError`` for another optimizer and
    ``KeyError`` / ``ValueError`` when the trees do not fit the model's parameters."""
    if not isinstance(optimizer, torch.optim.Adam):
        raise TypeError(f"Adam moments need torch.optim.Adam, got {type(optimizer).__name__}")
    moments = {"exp_avg": state_dict_from_jax(mu), "exp_avg_sq": state_dict_from_jax(nu)}
    state = {}
    for name, p in model.named_parameters():
        for k, sd in moments.items():
            if sd[name].shape != p.shape:
                raise ValueError(f"Adam {k} of {name} is {tuple(sd[name].shape)}, the parameter {tuple(p.shape)}")
        state[p] = {"step": torch.tensor(float(adam_count), dtype=torch.float32),
                    **{k: sd[name].to(p.device).clone() for k, sd in moments.items()}}
    optimizer.state.clear()
    optimizer.state.update(state)
