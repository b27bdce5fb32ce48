"""Checkpoints: save in the reference ``.pth`` layout; load that layout and the JAX package's pickles.

Counterpart of ``deepphysinet_tpu/train/checkpoint.py`` (its pickle backend) with the reference's
file layout (interface_physics.py:53-88): ``{prefix}_{epoch}.pth`` plus a ``{prefix}_latest.pth``
copy, each a ``torch.save`` bundle of ``model`` (a state_dict under the port's names, which are
the reference model's), ``epoch``, ``gobal_step`` [sic], ``optimizer`` (the torch optimizer's
state_dict, or None) and the metadata keyword arguments (dx, dy, ``pred_t_span``, the variable
configurations...), written by ``save_checkpoint`` (the JAX ``save_model``).  Each file is written
to a temporary file in the same directory and moved into place with ``os.replace``, so a crash
never leaves a truncated file at either name.
``AsyncCheckpointer`` writes on a worker thread from ``.clone()`` snapshots.

``load_checkpoint`` takes a file or a directory (and there an epoch or ``latest``), falls back to
the newest epoch file when ``latest`` cannot be read, and reads three formats into one form:

* the port's own files and the reference's ``.pth`` bundles (``torch.load(weights_only=True)``; a
  DDP ``module.`` prefix is stripped);
* the JAX package's pickles ``{prefix}_{epoch}.ckpt``: the flax parameter tree as numpy arrays,
  turned into the port's names by ``state_dict_from_jax``, and optax's optimizer state, whose
  classes are optax's.  A restricted unpickler reads them without optax, flax or jax installed:
  every class of those packages becomes a ``JaxObject``, a tuple that keeps the class's name and
  the values it was built from (optax's states are named tuples; e.g. ``ScaleByAdamState`` holds
  ``count``, ``mu`` and ``nu``), numpy's array constructors are allowed, and any other global is
  refused.

The orbax backend is not ported (a JAX library; the ``.pth`` layout serves instead).

``restore_train_state`` resumes a training state from any of the three (``_restore_state`` of the
JAX interface, interface_physics.py:1254): the parameters, and the optimizer's state where the file
says which parameter each entry belongs to.  The port's files carry ``param_names``, the names of
the optimizer's parameters in the order its state_dict indexes them; a reference ``.pth`` indexes
them by the reference model's ``parameters()`` order, which nothing in the repository establishes,
so its parameters load alone (with a warning) and Adam starts afresh; a JAX pickle's Adam moments
are optax's ``ScaleByAdamState``, found by name.
"""

from __future__ import annotations

import io
import os
import pickle
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from deepphysinet_tpu_torch.train.torch_import import load_adam_moments, state_dict_from_jax
from deepphysinet_tpu_torch.utils.async_worker import AsyncWorker

_JAX_PACKAGES = ("optax", "flax", "jax", "jaxlib")
_SUFFIXES = (".pth", ".ckpt")  # the port's and the reference's; the JAX package's


class JaxObject(tuple):
    """Stand-in for an object of a JAX-side class in a JAX checkpoint: the values it was built
    from, as a tuple; ``name`` is the class's qualified name."""

    name = ""

    def __new__(cls, *args):
        return super().__new__(cls, args)

    def __repr__(self):
        return f"JaxObject({self.name}{tuple.__repr__(self)})"


def _stand_in(module: str, name: str):
    return type(name, (JaxObject,), {"name": f"{module}.{name}", "__module__": __name__})


class _JaxCheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        top = module.split(".")[0]
        if top in _JAX_PACKAGES:
            return _stand_in(module, name)
        if top == "numpy":
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):  # a pickle of numpy 2 read by numpy 1
                return super().find_class(module.replace("numpy._core", "numpy.core"), name)
        if (module, name) in (("collections", "OrderedDict"), ("builtins", "slice"), ("builtins", "complex")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a JAX checkpoint may not name {module}.{name}")


def find_jax_objects(tree, suffix: str):
    """Every ``JaxObject`` in ``tree`` (nested dicts, lists and tuples) whose class name ends
    with ``suffix``, e.g. ``"ScaleByAdamState"``: a JAX checkpoint's Adam moments."""
    found = []
    if isinstance(tree, JaxObject) and tree.name.endswith(suffix):
        found.append(tree)
    if isinstance(tree, dict):
        for v in tree.values():
            found += find_jax_objects(v, suffix)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            found += find_jax_objects(v, suffix)
    return found


def _cpu(tree):
    """Tensors of a nested dict / list / tuple moved to the host (everything else as it is)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def _clone(tree):
    """Tensors of a nested dict / list / tuple cloned on their device."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _state(obj):
    """A module's or an optimizer's state_dict; a state_dict (or None) as it is."""
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def _param_names(model, optimizer) -> Dict[str, Any]:
    """``{"param_names": [...]}``: the names of ``optimizer``'s parameters in the order its
    state_dict indexes them, when both are objects (nothing otherwise)."""
    if not (hasattr(model, "named_parameters") and hasattr(optimizer, "param_groups")):
        return {}
    name_of = {id(p): name for name, p in model.named_parameters()}
    return {"param_names": [name_of[id(p)] for group in optimizer.param_groups for p in group["params"]]}


def save_checkpoint(checkpoint_path: str, epoch: int, global_step: int, model, optimizer=None,
                    prefix: str = "physics", **metadata) -> str:
    """Write ``{prefix}_{epoch}.pth`` and its copy ``{prefix}_latest.pth`` into ``checkpoint_path``.

    ``model`` is the ``PhysicsNet`` or its state_dict, ``optimizer`` the torch optimizer, its
    state_dict or None; the metadata keyword arguments go into the bundle beside them (plain
    Python values, which ``torch.load(weights_only=True)`` reads).  Given the model and the optimizer
    themselves, the bundle also names the optimizer's parameters (``param_names``).  Returns the
    epoch file."""
    os.makedirs(checkpoint_path, exist_ok=True)
    payload = {"model": _cpu(_state(model)), "epoch": epoch, "gobal_step": global_step,  # [sic], the reference's key
               "optimizer": _cpu(_state(optimizer)), **_param_names(model, optimizer)}
    payload.update(metadata)
    ckpt_file = os.path.join(checkpoint_path, f"{prefix}_{epoch}.pth")
    tmp = f"{ckpt_file}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, ckpt_file)
    latest = os.path.join(checkpoint_path, f"{prefix}_latest.pth")
    shutil.copy(ckpt_file, f"{latest}.{os.getpid()}.tmp")
    os.replace(f"{latest}.{os.getpid()}.tmp", latest)
    return ckpt_file


class AsyncCheckpointer:
    """Epoch saves off the training loop's thread.

    ``submit`` snapshots the model's and the optimizer's tensors with ``.clone()`` on their device
    (so later steps cannot change what is written) and hands the copy to the host and the write to
    a worker thread (``utils/async_worker.py``).  At most one snapshot exists at a time: ``submit``
    waits for the save in flight before it clones, so saves asked for faster than they finish
    become synchronous rather than piling up copies on the card.  ``wait()`` blocks until every
    submitted save is on disk and re-raises a worker's error; ``close()`` also stops the worker."""

    def __init__(self):
        self._w = AsyncWorker(maxsize=1)

    def submit(self, checkpoint_path: str, epoch: int, global_step: int, model, optimizer=None,
               prefix: str = "physics", **metadata) -> None:
        self._w.wait()  # at most one snapshot alive
        model_c, opt_c = _clone(_state(model)), _clone(_state(optimizer))
        metadata = {**_param_names(model, optimizer), **metadata}
        self._w.submit(lambda: save_checkpoint(checkpoint_path, epoch, global_step, model_c, opt_c,
                                               prefix=prefix, **metadata))

    def wait(self) -> None:
        self._w.wait()

    def close(self) -> None:
        self._w.close()

    def close_quietly(self) -> None:
        self._w.close_quietly()


def _read(path: str) -> Dict[str, Any]:
    """One checkpoint file in any of the three formats -> a payload whose ``model`` is a state_dict
    under the port's names."""
    with open(path, "rb") as fp:
        head = fp.read(4)
    if head.startswith(b"PK"):  # a torch.save zip: the port's or the reference's .pth
        bundle = torch.load(path, map_location="cpu", weights_only=True)
        if not (isinstance(bundle, dict) and "model" in bundle):
            bundle = {"model": bundle}
        bundle["model"] = {k[len("module."):] if k.startswith("module.") else k: v
                           for k, v in bundle["model"].items()}
        return bundle
    with open(path, "rb") as fp:  # the JAX package's pickle
        payload = _JaxCheckpointUnpickler(io.BytesIO(fp.read())).load()
    if not (isinstance(payload, dict) and "model" in payload):
        raise pickle.UnpicklingError(f"{path} holds no checkpoint payload")
    payload["model"] = state_dict_from_jax(payload["model"])
    return payload


def _newest_epoch_ckpt(ckpt_dir: str, prefix: str, exclude: str = "") -> Optional[str]:
    """The highest-epoch ``{prefix}_{N}.pth`` or ``.ckpt`` in ``ckpt_dir`` (None if none)."""
    best, best_epoch = None, -1
    if not os.path.isdir(ckpt_dir):
        return None
    pat = re.compile(rf"^{re.escape(prefix)}_(\d+)\.(pth|ckpt)$")
    for name in sorted(os.listdir(ckpt_dir)):
        m = pat.match(name)
        path = os.path.join(ckpt_dir, name)
        if m and path != exclude and int(m.group(1)) > best_epoch:
            best, best_epoch = path, int(m.group(1))
    return best


def _resolve(checkpoint_path: str, current_epoch: Optional[int], prefix: str) -> str:
    if os.path.isfile(checkpoint_path):
        return checkpoint_path
    stem = f"{prefix}_latest" if current_epoch is None else f"{prefix}_{current_epoch}"
    for suffix in _SUFFIXES:
        path = os.path.join(checkpoint_path, stem + suffix)
        if os.path.exists(path):
            return path
    return os.path.join(checkpoint_path, stem + _SUFFIXES[0])


def load_checkpoint(checkpoint_path: str, current_epoch: Optional[int] = None,
                    prefix: str = "physics") -> Tuple[Optional[Dict[str, Any]], int, int]:
    """(payload, next epoch, global step); (None, 0, 0) when there is no file.

    ``checkpoint_path`` is a file, or a directory in which ``{prefix}_latest`` or, given
    ``current_epoch``, ``{prefix}_{current_epoch}`` is read (``.pth`` first, then ``.ckpt``).
    ``payload["model"]`` is a state_dict under the port's names for
    ``PhysicsNet.load_state_dict(..., strict=True)``; the other entries are the bundle's own
    (``optimizer`` or, from the JAX package, ``opt_state``, and the metadata), without ``epoch``
    and ``gobal_step``."""
    model_file = _resolve(checkpoint_path, current_epoch, prefix)
    if not os.path.exists(model_file):
        print(f"warning:{model_file} does not exist!")
        return None, 0, 0
    print(f"start to resume from {model_file}")
    try:
        payload = _read(model_file)
    except Exception as e:  # a corrupt file: the newest readable epoch instead
        fallback = _newest_epoch_ckpt(os.path.dirname(model_file), prefix, exclude=model_file)
        if fallback is None:
            raise
        print(f"warning:{model_file} is corrupt ({e!r}); falling back to {fallback}")
        payload = _read(fallback)
    global_step = int(payload.pop("gobal_step", 0))
    epoch = int(payload.pop("epoch", -1))
    return payload, epoch + 1, global_step


def gather_key_from_state(key: str, state_dict: dict, default):
    """interface_physics.py:1529-1536."""
    if key in state_dict:
        print(f"find {key}, set {key} to {state_dict[key]}")
        return state_dict[key]
    print(f"cannot find {key}, use it as default")
    return default


def restore_train_state(state, payload: Dict[str, Any], allow_partial_resume: bool = False):
    """Resume ``state`` (``train/train_step.py::TrainState``: the model and its torch optimizer) in
    place from a ``load_checkpoint`` payload: the parameters, then the optimizer's state.

    * The port's own files: the optimizer's state_dict, its entries matched to the model's
      parameters by ``param_names``.
    * A reference ``.pth``: no ``param_names``; its optimizer state (if any) indexes the reference
      model's ``parameters()`` order, which the repository does not establish, so only the
      parameters load and the optimizer starts afresh, with a warning.
    * A JAX pickle: optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) becomes the Adam
      state of every parameter (``train/torch_import.py::load_adam_moments``).

    An optimizer state that does not fit the optimizer (another optimizer, other parameters or
    shapes) raises, as the JAX interface does, unless ``allow_partial_resume``
    (``train_cfg.tpu.allow_partial_resume``): then the optimizer starts afresh, with a warning."""
    model, optimizer = state.model, state.optimizer
    model.load_state_dict(payload["model"], strict=True)
    try:
        if payload.get("optimizer") is not None:
            names = payload.get("param_names")
            if names is None:
                print("warning: the checkpoint's optimizer state indexes the reference model's parameter "
                      "order, which the port cannot map; resuming from the parameters alone (fresh Adam moments)")
                optimizer.state.clear()
                return state
            saved = payload["optimizer"]
            params = dict(model.named_parameters())
            by_name = {n: i for i, n in enumerate(names)}
            position = {id(params[n]): by_name[n] for n in params}  # KeyError: a parameter the file lacks
            if len(names) != len(params):
                raise ValueError(f"the checkpoint's optimizer holds {len(names)} parameters, the model {len(params)}")
            wanted = {"exp_avg", "exp_avg_sq"} if isinstance(optimizer, torch.optim.Adam) else set()
            if any(not wanted <= set(st) for st in saved["state"].values()):
                raise ValueError(f"the checkpoint's optimizer state is not that of {type(optimizer).__name__}")
            groups = [dict(g, params=[position[id(p)] for p in live["params"]])
                      for g, live in zip(saved["param_groups"], optimizer.param_groups)]
            optimizer.load_state_dict({"state": saved["state"], "param_groups": groups})
        elif payload.get("opt_state") is not None:
            adam = find_jax_objects(payload["opt_state"], "ScaleByAdamState")
            if len(adam) != 1:
                raise ValueError(f"the JAX optimizer state holds {len(adam)} ScaleByAdamState, not one")
            count, mu, nu = adam[0]
            load_adam_moments(model, optimizer, mu, nu, int(count))
    except (KeyError, ValueError, TypeError) as e:
        if not allow_partial_resume:
            raise RuntimeError("checkpoint optimizer state does not match the current optimizer structure; pass "
                               "train_cfg.tpu.allow_partial_resume=True to resume from parameters only "
                               "(reinitialized Adam moments)") from e
        print(f"warning: optimizer state not restored ({e!r}); reinitializing (allow_partial_resume)")
        optimizer.state.clear()
    return state
