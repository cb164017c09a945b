"""Measure variants of the multi-tensor SGD update kernel on the card: the
kernel of ``csrc/update.cu`` built as shipped and as text-edited
variants, each held bit for bit to ``plain_sgd_update_many`` and timed on
the fused step's tables.

    python -m znicz_tpu_torch.update_probe [--out DIR]

Variants (a text edit of update.cu each; the probe fails if the text it
edits is gone):

- ``shipped``: the kernel as built for the paths;
- ``streaming``: the 16-byte loads and stores as ``__ldcs``/``__stcs``
  (evict-first: the update's bytes are read and written once a step);
- ``ldg``: the 16-byte loads through the read-only path (``__ldg``);
- ``vecs2``, ``vecs4``, ``vecs8``: 2, 4 or 8 float4s a thread and array
  (chunks of 2048, 4096 or 8192 elements a block) instead of 1.

Tables, with the fused step's constants in its reverse layer order:
MNIST's four tensors, the unit graph's call for MNIST's first layer (W
and b), AlexNet fc6's weight alone and AlexNet's 16 tensors.
Each variant is one ``nvcc`` of update.cu into ``DIR`` (default
``build/update_probe`` in the package), all started together with
``-Xptxas -v`` (registers and spills are printed).  Rows are JSON lines:
device ms per call from a CUDA-graph replay, variants timed in turns (in
order, then in reverse).  Needs a CUDA card and ``nvcc``; it is a
measurement, on no path."""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from pathlib import Path

import torch

from . import cuda_build
from .ops import update

#: variant → [(text of update.cu, its replacement)]
VARIANTS = {
    "shipped": [],
    "streaming": [("{ return *p; }", "{ return __ldcs(p); }"),
                  ("{ *p = x; }", "{ __stcs(p, x); }")],
    "ldg": [("{ return *p; }", "{ return __ldg(p); }")],
    "vecs2": [("constexpr int kVecs = 1;", "constexpr int kVecs = 2;")],
    "vecs4": [("constexpr int kVecs = 1;", "constexpr int kVecs = 4;")],
    "vecs8": [("constexpr int kVecs = 1;", "constexpr int kVecs = 8;")],
}
_ALEXNET_WEIGHTS = [(11, 11, 3, 96), (5, 5, 96, 256), (3, 3, 256, 384),
                    (3, 3, 384, 384), (3, 3, 384, 256), (9216, 4096),
                    (4096, 4096), (4096, 1000)]
#: case → [(shape, hypers)] in one call
CASES = {
    "mnist_table": [((100, 10), (0.03, 0.0, 0.0, 0.9)),
                     ((10,), (0.03, 0.0, 0.0, 0.9)),
                     ((784, 100), (0.03, 0.0, 0.0, 0.9)),
                     ((100,), (0.03, 0.0, 0.0, 0.9))],
    "mnist_layer1": [((784, 100), (0.03, 0.0, 0.0, 0.9)),
                     ((100,), (0.03, 0.0, 0.0, 0.9))],
    "alexnet_fc6": [((9216, 4096), (0.01, 5e-4, 0.0, 0.9))],
    "alexnet_table": [(s, (0.01, 5e-4 if s is w else 0.0, 0.0, 0.9))
                      for w in reversed(_ALEXNET_WEIGHTS)
                      for s in (w, w[-1:])],
}


def edited(variant: str, text: str) -> str:
    """update.cu's ``text`` with ``variant``'s edits."""
    for old, new in VARIANTS[variant]:
        if old not in text:
            raise RuntimeError(f"{variant}: update.cu no longer holds the "
                               f"text this variant edits")
        text = text.replace(old, new)
    return text


def build(out: Path) -> tuple[dict, dict]:
    """({variant: ctypes entry point}, {variant: ptxas report}), one nvcc
    each, all started together."""
    procs = {}
    for name in VARIANTS:
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC_DIR, src)
        path = src / "update.cu"
        path.write_text(edited(name, path.read_text()))
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(src / "update.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n"
                               f"{logs[name]}")
        fn = getattr(ctypes.CDLL(str(out / name / "update.so")),
                     "znicz_sgd_update_many_f32")
        fn.argtypes, fn.restype = update._ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns, logs


def registers(ptxas: str) -> dict:
    """{registers, spill bytes} of the kernel in a ``-Xptxas -v`` report."""
    regs = re.findall(r"Used (\d+) registers", ptxas)
    spills = re.findall(r"(\d+) bytes spill stores", ptxas)
    return {"registers": int(regs[-1]) if regs else None,
            "spill_bytes": int(spills[-1]) if spills else None}


def _device_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(cuda_build.BUILD_DIR
                                         / "update_probe"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("update_probe: no CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    fns, logs = build(out)
    device = torch.cuda.get_device_name(0)
    rows = [{"device": device, "variant": name, **registers(log)}
            for name, log in logs.items()]
    for row in rows:
        print(json.dumps(row), flush=True)
    gen = torch.Generator().manual_seed(0)
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for case, table in CASES.items():
        entries = []
        for shape, hypers in table:
            w = torch.randn(shape, generator=gen)
            w[torch.rand(shape, generator=gen) < 0.25] = 0.0
            g, v = (torch.randn(shape, generator=gen) * s
                    for s in (0.1, 0.01))
            entries.append((w.cuda(), g.cuda(), v.cuda(),
                            update.fused_constants(hypers)))
        want = update.plain_sgd_update_many(entries)
        numel = sum(w.numel() for w, _, _, _ in entries)
        for turn, name in enumerate(order):
            outs = update.empty_outputs(entries)

            def call(fn=fns[name], outs=outs):
                update.launch_many(fn, entries, outs)
            call()
            torch.cuda.synchronize()
            equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for got, ref in zip(outs, want)
                        for a, b in zip(got, ref))
            ms = _device_ms(call, 10 if numel > 1 << 20 else 200)
            row = {"device": device, "case": case, "variant": name,
                   "turn": turn, "numel": numel, "bit_equal": equal,
                   "ms": ms, "bytes_per_s": 20 * numel / ms * 1e3}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del outs
        del entries, want
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
