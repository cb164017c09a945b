"""Locate what bounds the tensor-core conv kernels on the card: the
forward and input gradient of ``csrc/conv_gemm.cu`` built as shipped and
as variants of their tile loop (``csrc/gemm_tc.cuh``), each held to the
plain versions and timed at AlexNet's conv2 and conv4 and CIFAR's conv2.

    python -m znicz_tpu_torch.conv_tc_probe [--out DIR]

Variants (a text edit of gemm_tc.cuh each; the probe fails if the text it
edits is gone):

- ``shipped``: the kernels as built for the paths;
- ``one_product``: one TF32 product a multiply-add (big·big) straight
  into the accumulator, no split and no partials: the loop's rate with a
  third of the MMAs, and one TF32 rounding of each operand, so its
  ``err_ratio`` is far past the tier's tolerance;
- ``no_partials``: the three products chained into the accumulator, as
  the kernels' first version did: the cost and the error of the fresh
  8-deep partials;
- ``one_block``: ``kMinBlocks`` 1: ptxas free to use more registers, one
  block an SM at the wide tiles.

Each variant is one ``nvcc`` of conv_gemm.cu into ``DIR`` (default
``build/conv_tc_probe`` in the package), all started together.  Rows are
JSON lines: device ms per call from a CUDA-graph replay, variants timed in
turns (shipped first, then the others, then in reverse), and the largest
gap to the plain version over the tier's atol (``err_ratio``).  Needs a
CUDA card and ``nvcc``; it is a measurement, on no path."""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
from pathlib import Path

import torch

from . import cuda_build
from .ops import conv

_PARTIALS = """          float part[4];
          mma_tf32_first(part, a_small[i], b0_big, b1_big);
          mma_tf32(part, a_big[i], b0_small, b1_small);
          mma_tf32(part, a_big[i], b0_big, b1_big);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[e];
"""
_CHAINED = """          mma_tf32(acc[i][j], a_small[i], b0_big, b1_big);
          mma_tf32(acc[i][j], a_big[i], b0_small, b1_small);
          mma_tf32(acc[i][j], a_big[i], b0_big, b1_big);
"""
_MIN_BLOCKS = "static constexpr int kMinBlocks = BN >= 96 ? 2 : 1;"
#: variant → (text of gemm_tc.cuh, its replacement)
VARIANTS = {
    "shipped": None,
    "one_product": (_PARTIALS, "          mma_tf32(acc[i][j], a_big[i], "
                               "b0_big, b1_big);\n"),
    "no_partials": (_PARTIALS, _CHAINED),
    "one_block": (_MIN_BLOCKS, "static constexpr int kMinBlocks = 1;"),
}
#: case, x, w, stride, padding (chip_smoke.py's CONV_GEMM_CASES rows)
CASES = [
    ("alexnet_conv2", (128, 27, 27, 96), (5, 5, 96, 256), 1, 2),
    ("alexnet_conv4", (128, 13, 13, 384), (3, 3, 384, 384), 1, 1),
    ("cifar_conv2", (100, 16, 16, 32), (5, 5, 32, 32), 1, 2),
]
ENTRIES = {"fwd": "znicz_conv_fwd_f32", "dgrad": "znicz_conv_dgrad_f32"}


def build(out: Path) -> dict:
    """{variant: {kind: its ctypes entry point}}, one nvcc each."""
    procs = {}
    for name, edit in VARIANTS.items():
        src = out / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC_DIR, src)
        if edit is not None:
            path = src / "gemm_tc.cuh"
            text = path.read_text()
            if edit[0] not in text:
                raise RuntimeError(f"{name}: gemm_tc.cuh no longer holds "
                                   f"the text this variant edits")
            path.write_text(text.replace(edit[0], edit[1]))
        procs[name] = subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
             str(src / "conv_gemm.so"), str(src / "conv_gemm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    fns = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lib = ctypes.CDLL(str(out / name / "conv_gemm.so"))
        fns[name] = {}
        for kind, entry in ENTRIES.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = conv._CONV_ARGTYPES, ctypes.c_int
            fns[name][kind] = fn
    return fns


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
                                         / "conv_tc_probe"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("conv_tc_probe: no CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    fns = build(out)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = []
    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for case, xs, ws, st, pd in CASES:
        kh, kw, c, oc = ws
        x = torch.randn(xs, generator=gen).to(dev)
        w = (torch.randn(ws, generator=gen) / math.sqrt(kh * kw * c)).to(dev)
        y = conv.plain_conv2d_gemm(x, w, st, pd)
        e = torch.randn(tuple(y.shape), generator=gen).to(dev)
        dx = conv.plain_conv2d_grad_input_gemm(e, w, xs, st, pd)
        geo = conv._gemm_geometry(case, xs, ws, st, pd)
        for kind, a, want, n, gathered, r in (
                ("fwd", x, y, oc, c, kh * kw * c),
                ("dgrad", e, dx, c, oc, kh * kw * oc)):
            cfg = conv._tc_config(kind, n, gathered, st)
            got = torch.empty_like(want)
            atol = 1e-5 * math.sqrt(r) * float(a.abs().max() * w.abs().max())
            for turn, name in enumerate(order):
                def call(fn=fns[name][kind]):
                    status = fn(a.data_ptr(), w.data_ptr(), got.data_ptr(),
                                *geo, *cfg,
                                torch.cuda.current_stream().cuda_stream)
                    if status != 0:
                        raise RuntimeError(f"{name} {kind}: CUDA error "
                                           f"{status}")
                call()
                torch.cuda.synchronize()
                row = {"device": torch.cuda.get_device_name(0),
                       "case": case, "kind": kind, "variant": name,
                       "turn": turn, "tile": list(cfg),
                       "err_ratio": float((got - want).abs().max()) / atol,
                       "ms": _device_ms(call, 10)}
                rows.append(row)
                print(json.dumps(row), flush=True)
        del x, w, y, e, dx
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
