"""BENCHMARK.json against the benchmark's contract, the files its names lead to, the metric
arithmetic on a hand-made trace, and the modules a run may not load."""

import json
import math
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import checks, guard, spec, timing, trace, yardstick

BENCH = spec.benchmark_json()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", p) and not p.startswith("/") and ".." not in p.split("/")
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p.rstrip("/") + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    configs, cells = BENCH["configs"], BENCH["workloads"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (configs, cells, metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in configs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(spec.REPO, c["file"]))
    assert len({c["file"] for c in configs}) == len(configs)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _one_line(w["why"]) and NAME.match(w["traffic"])
        assert w["config"] in {c["name"] for c in configs}
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    assert {w["config"] for w in cells} == {c["name"] for c in configs}
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _one_line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_every_cell_loads_its_files_by_name():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        kind = spec.kind_module(cell.traffic)
        for fn in ("setup", "step", "work", "release", "numbers", "control_numbers"):
            assert callable(getattr(kind, fn))
        assert cell.limits, f"{w['name']} has no limits file"
        assert cell.precision["dtype"] in yardstick.PEAK_FLOPS
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.reader(m["name"]).read)


def _hand_trace():
    """Two steps, 100 us each (host spans); device: kernel A 0-30, copy 40-50, kernel B 45-60 in
    step 1, the v4s forward 120-150 and 150-170 in step 2; host ops open over 60-100 and 170-200."""
    ev = [dict(ph="X", cat="user_annotation", name="bench.step", ts=0, dur=100, pid=1, tid=1),
          dict(ph="X", cat="user_annotation", name="bench.step", ts=100, dur=100, pid=1, tid=1),
          dict(ph="X", cat="kernel", name="void kernelA<float>(int)", ts=0, dur=30, pid=0, tid=7),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=40, dur=10, pid=0, tid=7),
          dict(ph="X", cat="kernel", name="kernelB", ts=45, dur=15, pid=0, tid=7),
          dict(ph="X", cat="kernel", name="(anonymous namespace)::decode_jvp_v4s_tc(...)", ts=120, dur=30, pid=0,
               tid=7),
          dict(ph="X", cat="kernel", name="decode_jvp_v4s_kernel<float>", ts=150, dur=20, pid=0, tid=7),
          dict(ph="X", cat="cpu_op", name="aten::mm", ts=55, dur=50, pid=1, tid=1),
          dict(ph="X", cat="cpu_op", name="aten::add", ts=165, dur=35, pid=1, tid=1)]
    return ev


def test_trace_reduction_on_a_hand_made_trace():
    ev = _hand_trace()
    r = trace.device_summary(ev, ["decode_jvp_v4s"], window_s=200e-6, steps=2)
    assert r["steps"] == 2 and r["launches"] == 5
    assert r["window_s"] == 200e-6 and math.isclose(r["busy_s"], 100e-6)
    fam = r["families"]["decode_jvp_v4s"]
    assert fam["launches"] == 2 and math.isclose(fam["seconds"], 50e-6)
    assert math.isclose(dict(r["device_ops"])["kernelA"], 30e-6)
    assert math.isclose(dict(r["device_ops"])["decode_jvp_v4s_tc"], 30e-6)
    idle = dict(trace.idle_by_host(ev))  # gaps 30-40, 60-120, 170-200, named at their middles
    assert math.isclose(idle[trace.NO_HOST_OP], 10e-6)
    assert math.isclose(idle["aten::mm"], 60e-6) and math.isclose(idle["aten::add"], 30e-6)


def _run(unit, trace_summary=None, dtype="bfloat16"):
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs", "dpn_ncep_bf16.json"))["config"]
    win = timing.Window(seconds=2.0, units=10 * 24576.0, attempted=10, failed=0,
                        times_ms=[float(i) for i in range(1, 21)])
    work = dict(unit=unit, per_step=24576, model_flops=1e12, kernels={"decode_jvp_v4s": [20480, 4096]})
    return SimpleNamespace(setup_s=12.5, window=win, work=work, dtype=dtype, config=cfg, trace=trace_summary,
                           peak_flops=yardstick.peak_flops(dtype))


def test_metric_arithmetic():
    run = _run("points", dict(window_s=0.5, busy_s=0.125, launches=4000, steps=2,
                              families={"decode_jvp_v4s": dict(seconds=0.002, launches=4)}))
    assert spec.reader("train_points_per_s").read(run) == 24576 * 10 / 2.0
    assert spec.reader("frames_per_s").read(run) is None
    assert spec.reader("setup_s").read(run) == 12.5
    assert spec.reader("train_step_p95_ms").read(run) == 19.0  # nearest rank of 1..20
    assert spec.reader("points_per_s.train_host").read(run) == 24576 * 10 / 2.0
    assert math.isclose(spec.reader("mfu.train").read(run), 100 * 10 * 1e12 / 2.0 / 989e12)
    assert spec.reader("mfu.infer").read(run) is None
    assert math.isclose(spec.reader("device_idle.train").read(run), 100 * (1 - (0.125 / 2) / (2.0 / 10)))
    assert spec.reader("launches_per_step.train").read(run) == 2000.0
    least = 2 * yardstick.least_kernel_seconds(run.config, "decode_jvp_v4s", [20480, 4096], "bfloat16")
    assert math.isclose(spec.reader("decode_jvp_v4s_roofline").read(run), 100 * least / 0.002)
    assert spec.reader("decode_bwd_v4s_roofline").read(run) is None  # no launch in the trace


def test_batch_gap_reads_missing_and_moved_points():
    want = [dict(margin=torch.tensor([[0.5, 1.0], [0.25, -2.0]]), inter=torch.tensor([[0.75]]))]
    assert checks.batch_gap([{k: v.clone() for k, v in want[0].items()}], want) == 0.0
    moved = [dict(margin=torch.tensor([[0.5, 1.0], [0.5, -2.0]]), inter=torch.tensor([[0.75]]))]
    assert checks.batch_gap(moved, want) == 0.25
    half = [dict(margin=want[0]["margin"][:1], inter=want[0]["inter"])]
    assert checks.batch_gap(half, want) == 2.0  # the missing point compared as zeros
    assert checks.batch_gap([], want) == float("inf")


def test_yardstick_counts():
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs", "dpn_ncep_bf16.json"))["config"]
    assert yardstick.jvp_v4s_point_macs(cfg) == 6 * 409_600
    assert yardstick.bwd_v4s_point_macs(cfg) == 6 * 1_081_344
    assert math.isclose(2 * yardstick.primal_point_macs(cfg) * 37265 / 1e9, 73.56, rel_tol=1e-3)
    flops, nbytes = yardstick.kernel_launch(cfg, "decode_jvp_v4s", 20480, "bfloat16")
    assert math.isclose(flops, 100.7e9, rel_tol=1e-3) and 15e6 < nbytes < 30e6
    assert yardstick.least_seconds(flops, nbytes, "bfloat16") == flops / 989e12
    assert math.isclose(yardstick.least_seconds(67e12, 0, "float32"), 1.0)
    assert timing.p95([5.0]) == 5.0 and timing.p95(list(range(1, 101))) == 95


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["deepphysinet_tpu_torch", "deepphysinet_tpu_torch.ops", "jaxtyping",
                                   "flaxen"]) == []
    assert guard.forbidden_loaded(["deepphysinet_tpu.ops", "jax", "jaxlib.xla", "flax.linen"]) == [
        "deepphysinet_tpu.ops", "flax.linen", "jax", "jaxlib.xla"]


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=spec.REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": spec.REPO})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_loads_no_jax_and_the_reference_nothing_of_the_port():
    loads = ("import benchmark.lib.harness, benchmark.control, benchmark.lib.faults\n"
             "from benchmark.lib import spec\n"
             "b = spec.benchmark_json()\n"
             "[spec.kind_module(spec.cell(w['name']).traffic) for w in b['workloads']]\n"
             "[spec.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
             "import deepphysinet_tpu_torch.train.device_sampling, deepphysinet_tpu_torch.inference.runner\n")
    assert guard.forbidden_loaded(_modules_after(loads)) == []
    ref = _modules_after("import benchmark.reference.train, benchmark.reference.infer")
    assert [m for m in ref if guard.top_level(m) == "deepphysinet_tpu_torch"] == []
    assert guard.forbidden_loaded(ref) == []


@pytest.mark.parametrize("path", ["reference/model.py", "reference/train.py", "reference/infer.py",
                                  "reference/sampler.py", "reference/physics.py", "reference/precision.py"])
def test_reference_sources_name_nothing_of_the_port(path):
    text = open(os.path.join(spec.BENCH_DIR, path)).read()
    assert "deepphysinet_tpu" not in text and "import jax" not in text
