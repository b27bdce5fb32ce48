"""``BENCHMARK.json`` and the files its names lead to.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.  The harness finds:

* the configuration's file at the ``file`` of its entry (``configs/<config>.json``): the model's
  configuration as run (``config``) and its ``precision``;
* the mix at ``traffic/<traffic>.json``: the parameters that the module of its ``kind`` reads;
* that module at ``kinds/<kind>.py``;
* each metric's reader at ``metrics/<metric>.py``;
* the limits of the cell's comparison at ``limits/<workload>.json``.

Nothing here lists a cell, a mix or a metric: adding one is adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Mapping, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> Any:
    with open(path) as fp:
        return json.load(fp)


def benchmark_json(root: str = REPO) -> Dict[str, Any]:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]  # the model configuration as run
    precision: Dict[str, Any]  # dtype, the reference's control
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def dtype(self) -> str:
        return str(self.precision["dtype"])


def _reports(metric: Mapping, cell: str, reported_e2e: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported_e2e is None or metric["moves"] in reported_e2e


def cell(name: str, bench: Optional[Mapping] = None) -> Cell:
    bench = bench if bench is not None else benchmark_json()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = load_json(os.path.join(REPO, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json"))
    limits_path = os.path.join(BENCH_DIR, "limits", name + ".json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, config_name=w["config"], traffic_name=w["traffic"], chips=int(w["chips"]),
                config=cfg_file["config"], precision=cfg_file["precision"], traffic=traffic,
                limits=limits.get("limits", {}), end_to_end=e2e, per_layer=per_layer)


def kind_module(traffic: Mapping):
    name = traffic["kind"]
    return load_module(os.path.join(BENCH_DIR, "kinds", name + ".py"), f"benchmark_kind_{name}")


def reader(metric_name: str):
    return load_module(os.path.join(BENCH_DIR, "metrics", metric_name + ".py"),
                       "benchmark_metric_" + metric_name.replace(".", "_").replace("-", "_"))
