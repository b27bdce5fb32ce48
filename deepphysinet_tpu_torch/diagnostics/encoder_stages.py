"""Time the fused encoder kernel of the tree it runs in by stage, on one card.

Builds of ``csrc/encoder.cu`` that drop one stage's units and keep every barrier are timed on the
device alone (median of five runs of twenty launches queued behind a sleeping kernel) in turns
with the kernel itself; a stage's time is the full kernel's less the build without it.  A source
with ``DPN_ENCODER_SKIP`` (the tensor-core body's stages A, B, C) is built with it; an older one
(the CUDA-core body alone: q/k/v, attention, rows) has its unit calls switched off in a copy.
``chip_smoke.py`` reads the split of its own tree through ``start_builds`` and ``stage_split``.
Run alone it times flagship width (287 tokens, d_model 256, 8 heads of 32, d_ff 256, 4 layers) with
seeded random weights, bf16.  It imports the port from the working directory, so the same file
times any tree; compare two trees in one call (here the parent's checkout in ``parent/``):

    (cd parent && python3 ../deepphysinet_tpu_torch/diagnostics/encoder_stages.py parent)
    python3 deepphysinet_tpu_torch/diagnostics/encoder_stages.py change

Prints one line: ``[encoder stages] LABEL {variant: [ms, ms], ...} stages {stage: ms, ...}``.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

# the tensor-core body's variants: DPN_ENCODER_SKIP values
SKIPS = {"A: layer 0's q, k, v": 1, "B: attention, 4 layers": 2, "C: rows, 4 layers (with layers 1-3's q, k, v)": 3,
         "none: the launch and the grid barriers": 4}
# the CUDA-core body's unit calls, each switched off in its variant's copy
OLD_UNITS = {"q/k/v": ("qkv_unit<T>(a, layer",), "attention": ("attention_unit<T>(a, u",),
             "rows": ("rows_unit<T>(a, layer",)}


def start_builds(cuda_build, source: str) -> dict:
    """nvcc of each variant of ``source``, started in the background: variant -> (library, process)."""
    src = os.path.join(cuda_build.CSRC_DIR, source)
    text = open(src).read()
    work = os.path.join(cuda_build.BUILD_DIR, "encoder_stages")
    os.makedirs(work, exist_ok=True)
    jobs = {}
    if "DPN_ENCODER_SKIP" in text:
        for name, k in SKIPS.items():
            jobs[name] = (f"skip{k}", [f"-DDPN_ENCODER_SKIP={k}"], src)
    else:
        for i, name in enumerate((*OLD_UNITS, "none: the launch and the grid barriers")):
            body = text
            for call in (sum(OLD_UNITS.values(), ()) if name not in OLD_UNITS else OLD_UNITS[name]):
                if call not in body:
                    raise RuntimeError(f"{call!r} not found in {source}")
                body = body.replace(call, "if (false) " + call)
            path = os.path.join(cuda_build.CSRC_DIR, f"_stages{i}.cu")  # beside the headers it includes
            with open(path, "w") as f:
                f.write(body)
            jobs[name] = (f"old{i}", [], path)
    builds = {}
    for name, (stem, flags, path) in jobs.items():
        so = os.path.join(work, stem + ".so")
        builds[name] = (so, subprocess.Popen([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so, path],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return builds


def load_builds(builds: dict, ek, kernel_lib) -> dict:
    """variant -> library, its C signatures declared as ``kernel_lib``'s."""
    libs = {}
    for name, (so, proc) in builds.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the encoder's variant {name!r}: {out[-2000:]}")
        lib = ctypes.CDLL(so)
        for fn in ("dpn_encoder", "dpn_encoder_shared_bytes", "dpn_encoder_route"):
            if hasattr(kernel_lib, fn):
                getattr(lib, fn).argtypes = getattr(kernel_lib, fn).argtypes
                getattr(lib, fn).restype = getattr(kernel_lib, fn).restype
        libs[name] = lib
    return libs


def device_ms(fn, iters: int = 20) -> float:
    """Median ms per call of five runs of ``iters`` calls queued behind a sleeping kernel."""
    fn()
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(iters * 2e5))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


def stage_split(ek, libs: dict, call):
    """(runs, stages): ``call()`` timed twice with the kernel's library and with each variant's in
    turns (``ek._library`` swapped); a stage is the kernel's median less its variant's, the variant
    that drops every unit is its own time."""
    kernel_lib = ek._library
    runs = {"kernel": [], **{name: [] for name in libs}}
    try:
        for _ in range(2):
            for name in runs:
                ek._library = kernel_lib if name == "kernel" else (lambda lib=libs[name]: lib)
                runs[name].append(device_ms(call))
    finally:
        ek._library = kernel_lib
    full = statistics.median(runs["kernel"])
    return runs, {name: statistics.median(v) if name.startswith("none") else full - statistics.median(v)
                  for name, v in runs.items() if name != "kernel"}


def main() -> int:
    if not torch.cuda.is_available():
        print("encoder_stages: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())  # the tree to time: its package, not this file's
    from deepphysinet_tpu_torch.ops import cuda_build, encoder_kernel as ek

    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    builds = start_builds(cuda_build, ek.SOURCE)
    cuda_build.build_libraries([ek.SOURCE])
    libs = load_builds(builds, ek, ek._library())
    seq, d, heads, e, f, c, n_layers = 287, 256, 8, 32, 256, 256, 4
    dev, g = torch.device("cuda"), torch.Generator().manual_seed(3)

    def r(*shape, scale=0.06):
        return (torch.randn(*shape, generator=g) * scale).to(dev)

    w = ek.cast_encoder_weights(ek.EncoderKernelWeights(
        wq=r(n_layers, heads, d, e), bq=r(n_layers, heads, e), wk=r(n_layers, heads, d, e), bk=r(n_layers, heads, e),
        wv=r(n_layers, heads, d, e), bv=r(n_layers, heads, e), wo=r(n_layers, heads, e, d), bo=r(n_layers, d),
        ln1s=1 + r(n_layers, d), ln1b=r(n_layers, d), w1=r(n_layers, d, f), b1=r(n_layers, f), w2=r(n_layers, f, d),
        b2=r(n_layers, d), ln2s=1 + r(n_layers, d), ln2b=r(n_layers, d), lns=1 + r(d), lnb=r(d), wproj=r(d, c),
        bproj=r(c)), torch.bfloat16)
    x = r(seq, d, scale=1.0)
    # the packed tiles once, as encode_fused makes them for a batch (a tree without them: none)
    extra = (ek.pack_encoder_weights(w),) if hasattr(ek, "pack_encoder_weights") else ()
    runs, stages = stage_split(ek, libs, lambda: ek.fused_encoder_forward(w, x, "gelu", torch.bfloat16, *extra))
    print(f"[encoder stages] {label} {json.dumps({k: [round(t, 4) for t in v] for k, v in runs.items()})} stages "
          f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}  ({torch.cuda.get_device_name(0)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
