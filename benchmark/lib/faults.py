"""Faults planted in the measured program, for the control runs and the harness's own tests.

* ``unchanged``: the training step computes its loss and gradient but leaves the parameters and
  the optimizer's state as they were;
* ``half_batch``: the training step sees only the first half of each window's margin and
  collocation points, and takes its means over those;
* ``altered``: a grid frame's answer is changed where it is produced: one point's temperature
  moves by one normalization scale.
"""

from __future__ import annotations

import contextlib
from unittest import mock

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(name: str):
    if name == "unchanged":
        from deepphysinet_tpu_torch.train import train_step as ts

        def no_update(cfg, state, metrics):
            state.step += 1
            return metrics

        with mock.patch.object(ts, "apply_gradient_update", no_update):
            yield
    elif name == "half_batch":
        from deepphysinet_tpu_torch.train import device_sampling as ds

        original = ds.sample_batch

        def half(*args, **kwargs):
            batch = original(*args, **kwargs)

            def cut(points):
                return type(points)(*(None if a is None else a[:, : a.shape[1] // 2] for a in points))

            return batch._replace(margin=cut(batch.margin), inter=cut(batch.inter))

        with mock.patch.object(ds, "sample_batch", half):
            yield
    elif name == "altered":
        from deepphysinet_tpu_torch.inference import runner

        original = runner.inverse_norm_stack_t

        def altered(out_t, obs_specs, with_clip):
            phys = original(out_t, obs_specs, with_clip).clone()
            phys[3, 0] += float(obs_specs[3].norm_factor[1])
            return phys

        with mock.patch.object(runner, "inverse_norm_stack_t", altered):
            yield
    else:
        raise KeyError(f"no fault {name!r}; there are {FAULTS}")
