"""Measure variants of the elementwise activation kernels on the card: the
kernels of ``csrc/activation.cu`` built as shipped and as text-edited
variants, each held bit for bit to the shipped build and timed at the
paths' shapes.

    python -m znicz_tpu_torch.act_probe [--out DIR]

Variants (a text edit of activation.cu each; the probe fails if the text
it edits is gone):

- ``shipped``: the kernels as built for the paths;
- ``vecs1``, ``vecs2``, ``vecs4``: 1, 2 or 4 float4s a thread and input
  (chunks of 1024, 2048 or 4096 elements a block), whatever the shipped
  count is;
- ``streaming``: every load and store as ``__ldcs``/``__stcs``
  (evict-first: each byte is read or written once a call).

Cases: strict ReLU forward and backward at AlexNet's conv1 output
(128, 55, 55, 96) and conv2's (128, 27, 27, 256), the scaled tanh at
CIFAR's conv1 output (100, 32, 32, 32) and at the unit graph's
(100, 100).  Each variant is one ``nvcc`` of activation.cu into ``DIR``
(default ``build/act_probe`` in the package), all started together with
``-Xptxas -v`` (registers and spills are printed).  Rows are JSON lines:
device ms per call from a CUDA-graph replay, variants timed in turns (in
order, then in reverse), with the bytes a second the call moved.  Needs a
CUDA card and ``nvcc``; it is a measurement, on no path."""

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
from .ops import activations

_VECS = r"constexpr int kVecs = \d+;"
#: variant → [(pattern in activation.cu, its replacement)]
VARIANTS = {
    "shipped": [],
    "vecs1": [(_VECS, "constexpr int kVecs = 1;")],
    "vecs2": [(_VECS, "constexpr int kVecs = 2;")],
    "vecs4": [(_VECS, "constexpr int kVecs = 4;")],
    "streaming": [(r"\{ return \*p; \}", "{ return __ldcs(p); }"),
                  (r"\{ \*p = v; \}", "{ __stcs(p, v); }")],
}
#: case → (activation, shape)
CASES = {
    "alexnet_conv1_relu": ("strict_relu", (128, 55, 55, 96)),
    "alexnet_conv2_relu": ("strict_relu", (128, 27, 27, 256)),
    "cifar_conv1_tanh": ("tanh", (100, 32, 32, 32)),
    "unit_tanh": ("tanh", (100, 100)),
}


def edited(variant: str, text: str) -> str:
    """activation.cu's ``text`` with ``variant``'s edits."""
    for old, new in VARIANTS[variant]:
        text, count = re.subn(old, new, text)
        if count == 0:
            raise RuntimeError(f"{variant}: activation.cu no longer holds "
                               f"the text this variant edits")
    return text


def build(out: Path) -> tuple[dict, dict]:
    """({variant: (forward, backward) ctypes entry points}, {variant:
    ptxas report}), one nvcc each, all started together."""
    procs = {}
    for name in VARIANTS:
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC_DIR, src)
        path = src / "activation.cu"
        path.write_text(edited(name, path.read_text()))
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-o", str(src / "activation.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, logs = {}, {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n"
                               f"{logs[name]}")
        lib = ctypes.CDLL(str(out / name / "activation.so"))
        pair = []
        for entry, argtypes in (("znicz_act_fwd_f32",
                                 activations._FWD_ARGTYPES),
                                ("znicz_act_bwd_f32",
                                 activations._BWD_ARGTYPES)):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            pair.append(fn)
        fns[name] = tuple(pair)
    return fns, logs


def registers(ptxas: str) -> dict:
    """{kernel: registers} of the strict ReLU and tanh kernels in a
    ``-Xptxas -v`` report (mangled names carry the activation id and the
    vector width as template arguments), and the largest spill."""
    regs, kernel = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            t = re.search(r"(act_(?:fwd|bwd)_kernel)ILi(\d)ELi(\d)E", kernel)
            if t and t.group(2) in ("1", "2"):
                regs[f"{t.group(1)}<{t.group(2)},{t.group(3)}>"] = int(
                    m.group(1))
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                         ptxas)]
    return {"registers": regs, "spill_bytes": max(spills, default=None)}


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
    ap.add_argument("--out", default=str(cuda_build.BUILD_DIR / "act_probe"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("act_probe: no CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    fns, logs = build(out)
    device = torch.cuda.get_device_name(0)
    rows = [{"device": device, "variant": name, **registers(log)}
            for name, log in logs.items()]
    for row in rows:
        print(json.dumps(row), flush=True)
    gen = torch.Generator().manual_seed(0)
    consts = activations.tanhlog_constants()
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for case, (act, shape) in CASES.items():
        x = (torch.randn(shape, generator=gen) * 2).cuda()
        e = torch.randn(shape, generator=gen).cuda()
        n, c, aid = x.numel(), shape[-1], activations.ACT_IDS[act]
        y, dx = torch.empty_like(x), torch.empty_like(x)
        want = None
        for turn, name in enumerate(order):
            fwd, bwd = fns[name]

            def call_fwd(fwd=fwd):
                cuda_build.launch(fwd, x.device, x.data_ptr(), y.data_ptr(),
                                  n, c, aid, *consts)

            def call_bwd(bwd=bwd):
                cuda_build.launch(bwd, x.device, e.data_ptr(), y.data_ptr(),
                                  None, dx.data_ptr(), n, c, aid, *consts)
            call_fwd()
            call_bwd()
            torch.cuda.synchronize()
            got = (y.clone(), dx.clone())
            want = want or got
            equal = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                        for a, b in zip(got, want))
            iters = 20 if n > 1 << 20 else 200
            for what, fn, nbytes in (("fwd", call_fwd, 8 * n),
                                     ("bwd", call_bwd, 12 * n)):
                ms = _device_ms(fn, iters)
                row = {"device": device, "case": case, "activation": act,
                       "shape": list(shape), "pass": what, "variant": name,
                       "turn": turn, "bit_equal_to_shipped": equal,
                       "ms": ms, "bytes_per_s": nbytes / ms * 1e3}
                rows.append(row)
                print(json.dumps(row), flush=True)
        del x, e, y, dx
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
