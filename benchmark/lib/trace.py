"""The traced stretches: ``torch.profiler`` over a few steady units, and their reduction.

Two stretches follow the window, each after a few units of the tracer's own warm-up:

* the device stretch traces CUDA activity alone, so that the host runs as fast as untraced.  Its
  ``window_s`` is the host's clock from the dispatch of its first kept unit to a synchronize after
  its last (every unit ends with its result on the host, so all its device work lies inside);
  ``busy_s`` the union of its kernels, copies and fills; ``launches`` their number over ``steps``
  kept units; ``families``, for each kernel name family asked for, the device seconds and launches
  of the kernels whose name contains it; ``device_ops`` the ten names of most device time;
* the host stretch traces CPU activity too, which slows the host, and gives ``idle_gaps``: the
  device's idle time inside the ``bench.step`` spans, each gap named by the innermost host
  operation open at its middle, summed by name, the ten largest.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, Iterable, List, Mapping, Optional

from benchmark.lib.timing import STEP_SPAN

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NO_HOST_OP = "(host outside any traced operation)"


def record(step, warmup: int, active: int, path: str, cpu: bool):
    """Run ``step`` warmup + active times under the profiler (CUDA activity, and CPU activity with
    ``cpu``); export its trace to ``path``.  Returns (work, failures, host seconds) of the kept units."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    work, failed, t0 = 0.0, 0, None
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts, schedule=schedule(wait=0, warmup=warmup, active=active, repeat=1)) as prof:
        for i in range(warmup + active):
            if i == warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            with record_function(STEP_SPAN):
                w, ok = step()
            if i >= warmup:
                work += w if ok else 0.0
                failed += 0 if ok else 1
            prof.step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return work, failed, seconds


def events_of(path: str) -> List[Mapping]:
    with open(path) as fp:
        data = json.load(fp)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(intervals: Iterable) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity, template arguments and
    parameter list."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    for ch in "<(":
        s = s.split(ch, 1)[0]
    return s[:120]


def _host_labels(host: List[Mapping], times: List[float]) -> List[Optional[str]]:
    """For each time (sorted), the innermost host event open at it, over all threads."""
    host = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    stacks: Dict = collections.defaultdict(list)
    out, i = [], 0
    for t in times:
        while i < len(host) and host[i]["ts"] <= t:
            e = host[i]
            st = stacks[(e.get("pid"), e.get("tid"))]
            while st and st[-1]["ts"] + st[-1]["dur"] <= e["ts"]:
                st.pop()
            st.append(e)
            i += 1
        best = None
        for st in stacks.values():
            while st and st[-1]["ts"] + st[-1]["dur"] <= t:
                st.pop()
            if st and (best is None or st[-1]["ts"] > best["ts"]):
                best = st[-1]
        out.append(best["name"] if best is not None else None)
    return out


def device_summary(events: List[Mapping], families: Iterable[str], window_s: float, steps: int) -> Dict:
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in device)
    fam = {}
    for f in families:
        hits = [e for e in device if e.get("cat") == "kernel" and f in e["name"]]
        fam[f] = dict(seconds=sum(e["dur"] for e in hits) * 1e-6, launches=len(hits))
    by_name = collections.Counter()
    for e in device:
        by_name[short_name(e["name"])] += e["dur"]
    return dict(window_s=window_s, busy_s=sum(b - a for a, b in busy) * 1e-6, launches=len(device), steps=steps,
                families=fam, device_ops=[[n, d * 1e-6] for n, d in by_name.most_common(10)])


def idle_by_host(events: List[Mapping]) -> List[List]:
    """The device's idle time inside the step spans, by the host operation open at each gap's middle."""
    spans = _union((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == STEP_SPAN)
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS)
    gaps = []
    for a, b in spans:
        last = a
        for c, d in busy:
            if d <= a or c >= b:
                continue
            if c > last:
                gaps.append((last, c - last))
            last = max(last, d)
        if b > last:
            gaps.append((last, b - last))
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("name") != STEP_SPAN
            and not str(e.get("name", "")).startswith("ProfilerStep")]
    gaps.sort()
    labels = _host_labels(host, [t + d / 2 for t, d in gaps])
    idle = collections.Counter()
    for (_, d), lab in zip(gaps, labels):
        idle[lab or NO_HOST_OP] += d
    return [[n, d * 1e-6] for n, d in idle.most_common(10)]
