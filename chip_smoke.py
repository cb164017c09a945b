#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``znicz_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero without the final ``ok`` line:

1. device  — the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them (also printed raw on a line of its own);
2. build   — every ``znicz_tpu_torch/csrc/*.cu`` compiled with nvcc for
   sm_90a from this checkout (one nvcc per source, started together);
3. kernel  — each kernel's wrapper against its plain PyTorch version on the
   card at the main paths' shapes and a few more (ragged, padded and
   overlapping windows, max-abs, ties, an even LRN window, β ≠ 0.75; for
   the fused LRN→max-pool pair the geometries of tests/test_lrn_pool.py
   and each folded activation; dropout at two ratios and a counter near
   2³²), with the stated tolerances; times of kernel, plain version,
   library call and the byte/flop bound;
4. slice   — the fused MNIST trainer at full width (784→100→10, batch 100,
   50k/10k/10k synthetic split resident on the card) for 2 epochs through
   ``models.mnist.run``, every kernel's launch count reset just before and
   read just after; each count must equal the steps the loop ran;
5. parity  — the same seed for one MNIST epoch on the CPU; epoch-0 losses
   agree within rtol 1e-4 and error counts within 0.1% of each class;
6. cifar slice — the CIFAR-10 conv net at full width (BASELINE config 2,
   batch 100, the 45k/5k/10k synthetic split at 32×32×3 resident on the
   card) for 2 epochs through ``models.cifar.run``, with the launch counts
   reset and read around it as in phase 4;
7. cifar parity — the model's default split (2000/400/400) for one epoch on
   the card and on the CPU; epoch-0 losses agree within rtol 5e-4 (the
   reference's tolerance for conv stacks) and error counts within 1% of
   each class (cuDNN's summation order flips near-ties);
8. alexnet slice — AlexNet at full width (BASELINE config 3: 227×227×3,
   batch 128, 1000 classes, ~62.4 M parameters, the 512/128/128 synthetic
   split resident on the card) for 2 epochs through ``models.alexnet.run``,
   launch counts reset and read around it; it prints the per-layer output
   shapes, the parameter count, resident and peak device bytes and the
   epoch timings;
9. alexnet parity — the shrunk AlexNet of tests/test_lrn_pool.py (67×67,
   widths 8-12-8-8-8-24-16, 7 classes, batch 32, dropout kept) on the
   default split for one epoch on the card and on the CPU, held as in 7;
10. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the ``znicz_tpu`` package.  Without a CUDA
device, or outside a checkout of the repository, it fails."""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys
import time

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
#: the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

SEED = 1234
MNIST_SPLIT = {"n_train": 50000, "n_valid": 10000, "n_test": 10000,
               "noise": 0.35}
#: CIFAR-10's real split; the parity run takes the model's default split
CIFAR_SPLIT = {"n_train": 45000, "n_valid": 5000, "n_test": 10000,
               "noise": 0.3, "size": 32}
CIFAR_PARITY_SPLIT = {"n_train": 2000, "n_valid": 400, "n_test": 400,
                      "noise": 0.3, "size": 32}
ALEXNET_SPLIT = {"n_train": 512, "n_valid": 128, "n_test": 128,
                 "noise": 0.4}
#: the shrunk AlexNet of tests/test_lrn_pool.py:245-250, for the parity run
ALEXNET_SHRUNK = {"size": 67, "n_classes": 7, "minibatch_size": 32}
ALEXNET_SHRUNK_WIDTHS = (8, 12, 8, 8, 8, 24, 16)
EPOCHS = 2
ITERS = 200
#: graph-replayed calls for the full-size AlexNet shapes (ms-scale calls)
BIG_ITERS = 10

#: name → (source, the TPU kernel it replaces, ops module, counter)
KERNELS = {
    "softmax_ce": ("znicz_tpu_torch/csrc/softmax_ce.cu",
                   "znicz_tpu/ops/softmax.py:119", "softmax",
                   "softmax_ce_launches"),
    "pool_select": ("znicz_tpu_torch/csrc/pooling.cu",
                    "znicz_tpu/ops/elementwise.py:324", "pooling",
                    "pool_select_launches"),
    "pool_scatter": ("znicz_tpu_torch/csrc/pooling.cu",
                     "znicz_tpu/ops/elementwise.py:355", "pooling",
                     "pool_scatter_launches"),
    "lrn_y": ("znicz_tpu_torch/csrc/lrn.cu",
              "znicz_tpu/ops/elementwise.py:290", "normalization",
              "lrn_y_launches"),
    "gd_lrn_x": ("znicz_tpu_torch/csrc/lrn.cu",
                 "znicz_tpu/ops/elementwise.py:299", "normalization",
                 "gd_lrn_x_launches"),
    "lrn_maxpool": ("znicz_tpu_torch/csrc/lrn_pool.cu",
                    "znicz_tpu/ops/lrn_pool.py:193", "lrn_pool",
                    "lrn_maxpool_launches"),
    "gd_lrn_maxpool": ("znicz_tpu_torch/csrc/lrn_pool.cu",
                       "znicz_tpu/ops/lrn_pool.py:297", "lrn_pool",
                       "gd_lrn_maxpool_launches"),
    "dropout": ("znicz_tpu_torch/csrc/dropout.cu",
                "znicz_tpu/ops/elementwise.py:181", "dropout",
                "dropout_launches"),
}

#: each path's kernels: launches per (train step, eval step)
PATHS = {
    "mnist": {"softmax_ce": (1, 1)},
    "cifar": {"softmax_ce": (1, 1), "pool_select": (1, 1),
              "pool_scatter": (1, 0), "lrn_y": (1, 1), "gd_lrn_x": (1, 0)},
    "alexnet": {"softmax_ce": (1, 1), "pool_select": (1, 1),
                "pool_scatter": (1, 0), "lrn_maxpool": (2, 2),
                "gd_lrn_maxpool": (2, 0), "dropout": (4, 0)},
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _ops(module: str):
    return importlib.import_module(f"znicz_tpu_torch.ops.{module}")


def launch_counts() -> dict:
    return {k: getattr(_ops(m), a) for k, (_, _, m, a) in KERNELS.items()}


def reset_launch_counts() -> None:
    for _, _, m, a in KERNELS.values():
        setattr(_ops(m), a, 0)


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0].strip()
    print(line, flush=True)
    info = {"phase": "device", "name": name, "nvidia_smi": line,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    from znicz_tpu_torch import cuda_build
    t0 = time.monotonic()
    paths = cuda_build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "nvcc": cuda_build.nvcc_path(),
          "libraries": {n: os.path.relpath(p) for n, p in paths.items()}})
    missing = {src for src, _, _, _ in KERNELS.values()} - {
        f"znicz_tpu_torch/csrc/{n}.cu" for n in paths}
    if missing:
        raise AssertionError(f"not built: {sorted(missing)}")


def _time_ms(torch, fn, iters: int = ITERS) -> tuple[float, float]:
    """(device ms per call from a CUDA-graph replay of ``iters`` calls,
    ms per call of an eager loop).  The graph replay shows the device work
    alone; the eager loop adds the host's launch overhead."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / iters
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device_ms, start.elapsed_time(end) / iters


# -- bounds: bytes over the HBM rate vs float operations over the peak -------
def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms: the larger of bytes over the HBM rate and
    float operations over the float32 peak, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def softmax_ce_bound_ms(n: int, c: int) -> tuple[float, str]:
    """logits and labels read once, probs, err and loss written once; about
    6 float operations per element (sub, exp, add, div, sub, compare)."""
    return _bound(n * c * 4 + n * 4 + 2 * n * c * 4 + n * 4, 6 * n * c)


def pool_select_bound_ms(x_numel: int, y_numel: int, taps: int):
    """x read once, y and the int32 slots written once; an |x| and a
    compare per tap of each output."""
    return _bound(x_numel * 4 + 2 * y_numel * 4, 2 * taps * y_numel)


def pool_scatter_bound_ms(x_numel: int, y_numel: int, taps: int):
    """err and the slots read once, dx written once; a compare and an add
    per tap of each window."""
    return _bound(2 * y_numel * 4 + x_numel * 4, 2 * taps * y_numel)


def lrn_y_bound_ms(numel: int, n: int):
    """x read once, y written once; per element n squares and n−1 adds
    for the window, a multiply-add for d, two square roots, a multiply and
    a divide for d^−β, and a multiply for y."""
    return _bound(2 * numel * 4, (2 * n + 6) * numel)


def gd_lrn_x_bound_ms(numel: int, n: int):
    """err and x read once, dx written once; per element d as in the
    forward (2n+1), d^−β (4), q = err·x·(p/d) (3), the window sum of q
    (n−1) and dx (4)."""
    return _bound(3 * numel * 4, (3 * n + 11) * numel)


# -- kernel vs plain version -------------------------------------------------
def _close(torch, case: str, name: str, got, want, rtol, atol) -> float:
    """Max abs error of ``got`` against ``want`` after checking shape,
    dtype, finiteness and the tolerance (integers: exactly equal)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{case}: {name} is {tuple(got.shape)} "
                             f"{got.dtype}, plain {tuple(want.shape)} "
                             f"{want.dtype}")
    if not got.dtype.is_floating_point:
        if not torch.equal(got, want):
            raise AssertionError(f"{case}: {name} differs in "
                                 f"{int((got != want).sum())} elements")
        return 0.0
    if not torch.isfinite(got).all():
        raise AssertionError(f"{case}: {name} is not finite")
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol,
                               msg=lambda m: f"{case} {name}: {m}")
    return float((got - want).abs().max())


def _launch_once(torch, name: str, fn):
    """Call a wrapper once, synchronise, and check its counter moved."""
    before = launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    if launch_counts()[name] != before + 1:
        raise AssertionError(f"{name} launch counter did not advance")
    return out


def _row(torch, name, geo, err, kernel_fn, plain_fn, bound,
         library_ms=None, iters: int = ITERS) -> dict:
    k_ms, k_eager = _time_ms(torch, kernel_fn, iters)
    p_ms, p_eager = _time_ms(torch, plain_fn, iters)
    row = {"phase": "kernel", "name": name, **geo, "max_abs_err": err,
           "kernel_ms": k_ms, "kernel_eager_ms": k_eager, "plain_ms": p_ms,
           "plain_eager_ms": p_eager, "bound_ms": bound[0],
           "bound_by": bound[1], "library_ms": library_ms, "iters": iters}
    emit(row)
    return row


def phase_kernel_softmax(torch) -> list:
    from znicz_tpu_torch.ops import softmax
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    cases = [("mnist_step", 100, 10), ("ragged", 37, 10),
             ("bench_kernel_case", 1024, 1000),
             ("labels_out_of_range", 64, 10), ("alexnet_step", 128, 1000)]
    rows = []
    for case, n, c in cases:
        logits = (torch.randn((n, c), generator=gen) * 3).to(dev)
        labels = torch.randint(0, c, (n,), generator=gen, dtype=torch.int32)
        if case == "labels_out_of_range":
            labels[::3] = -1
            labels[1::3] = c
        labels = labels.to(dev)
        got = _launch_once(torch, "softmax_ce",
                           lambda: softmax.softmax_ce_from_logits(logits,
                                                                  labels))
        want = softmax.plain_softmax_ce_from_logits(logits, labels)
        err = max(_close(torch, case, "probs", got[0], want[0], 1e-5, 1e-6),
                  _close(torch, case, "loss", got[1], want[1], 1e-5, 1e-5),
                  _close(torch, case, "err", got[2], want[2], 1e-5, 1e-6))
        rows.append(_row(
            torch, "softmax_ce", {"case": case, "shape": [n, c]}, err,
            lambda: softmax.softmax_ce_from_logits(logits, labels),
            lambda: softmax.plain_softmax_ce_from_logits(logits, labels),
            softmax_ce_bound_ms(n, c)))
    return rows


#: case, x shape, ksize, stride, padding, max-abs, data
POOL_CASES = [
    ("cifar_step", (100, 32, 32, 32), 2, 2, 0, False, "normal"),
    ("overlap_pad_ragged", (7, 13, 11, 5), 3, 2, 1, False, "normal"),
    ("maxabs", (7, 13, 11, 5), 3, 2, 1, True, "normal"),
    ("ties", (100, 32, 32, 32), 2, 2, 0, False, "ties"),
    ("maxabs_ties_padded", (7, 13, 11, 5), 3, 2, 1, True, "ties"),
    ("alexnet_pool5", (128, 13, 13, 256), 3, 2, 0, False, "normal"),
]


def phase_kernel_pooling(torch) -> dict:
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import pooling
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = {"pool_select": [], "pool_scatter": []}
    for case, shape, k, st, pad, use_abs, data in POOL_CASES:
        if data == "ties":
            # integers in [-2, 2]: most windows tie, and all-zero windows
            # let a padded tap win under max-abs
            x = torch.randint(-2, 3, shape, generator=gen).float().to(dev)
        else:
            x = torch.randn(shape, generator=gen).to(dev)
        fn = pooling.maxabs_pooling if use_abs else pooling.max_pooling
        plain = (pooling.plain_maxabs_pooling if use_abs
                 else pooling.plain_max_pooling)
        y, off = _launch_once(torch, "pool_select",
                              lambda: fn(x, k, st, pad))
        want_y, want_off = plain(x, k, st, pad)
        err_sel = max(_close(torch, case, "offsets", off, want_off, 0, 0),
                      _close(torch, case, "y", y, want_y, 1e-5, 1e-6))
        e = torch.randn(tuple(y.shape), generator=gen).to(dev)
        dx = _launch_once(torch, "pool_scatter",
                          lambda: pooling.gd_max_pooling(e, off, shape, k,
                                                         st, pad))
        err_sca = _close(torch, case, "dx", dx, pooling.plain_gd_max_pooling(
            e, off, shape, k, st, pad), 1e-5, 1e-6)
        geo = {"case": case, "shape": list(shape), "ksize": k, "stride": st,
               "padding": pad, "use_abs": use_abs}
        lib_sel = lib_sca = None
        if case == "cifar_step":
            # yardsticks on NCHW copies, with flat plane indices (another
            # contract than the port's window slots)
            xn = x.permute(0, 3, 1, 2).contiguous()
            en = e.permute(0, 3, 1, 2).contiguous()
            _, idx = F.max_pool2d(xn, k, st, pad, return_indices=True)
            lib_sel = _time_ms(torch, lambda: F.max_pool2d(
                xn, k, st, pad, return_indices=True))[0]
            lib_sca = _time_ms(torch, lambda: F.max_unpool2d(
                en, idx, k, st, pad, output_size=xn.shape[-2:]))[0]
        taps = k * k
        rows["pool_select"].append(_row(
            torch, "pool_select", geo, err_sel, lambda: fn(x, k, st, pad),
            lambda: plain(x, k, st, pad),
            pool_select_bound_ms(x.numel(), y.numel(), taps), lib_sel))
        rows["pool_scatter"].append(_row(
            torch, "pool_scatter", geo, err_sca,
            lambda: pooling.gd_max_pooling(e, off, shape, k, st, pad),
            lambda: pooling.plain_gd_max_pooling(e, off, shape, k, st, pad),
            pool_scatter_bound_ms(x.numel(), y.numel(), taps), lib_sca))
    return rows


#: case, x shape, n, alpha, beta, k
LRN_CASES = [
    ("cifar_step", (100, 16, 16, 32), 5, 1e-4, 0.75, 2.0),
    ("ragged", (7, 13, 11, 5), 5, 1e-4, 0.75, 2.0),
    ("even_n", (7, 4, 3, 7), 4, 1e-3, 0.75, 1.0),
    ("pow_beta", (7, 3, 4, 9), 5, 2e-3, 0.6, 2.0),
    ("c_below_n", (7, 3, 3, 3), 5, 1e-2, 0.75, 2.0),
    ("wide_rows", (2, 3, 5, 300), 5, 1e-4, 0.75, 2.0),
]


def phase_kernel_lrn(torch) -> dict:
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import normalization as lrn
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    rows = {"lrn_y": [], "gd_lrn_x": []}
    for case, shape, n, alpha, beta, kk in LRN_CASES:
        # scaled so that alpha·Σx² moves d well away from k
        x = (torch.randn(shape, generator=gen) * 4).to(dev)
        e = torch.randn(shape, generator=gen).to(dev)
        hp = (n, alpha, beta, kk)
        # bit-equal: the kernels share csrc/lrn_math.cuh's rounding with
        # the fused pair's, and the plain versions round each step too
        y = _launch_once(torch, "lrn_y", lambda: lrn.lrn_y(x, *hp))
        err_f = _close(torch, case, "y", y, lrn.plain_lrn_y(x, *hp), 0, 0)
        dx = _launch_once(torch, "gd_lrn_x", lambda: lrn.gd_lrn_x(e, x, *hp))
        err_b = _close(torch, case, "dx", dx, lrn.plain_gd_lrn_x(e, x, *hp),
                       0, 0)
        geo = {"case": case, "shape": list(shape), "n": n, "alpha": alpha,
               "beta": beta, "k": kk}
        lib = None
        if case == "cifar_step":
            # several kernels inside (square, pad, avg-pool, pow, div); it
            # divides alpha by the window, hence alpha·n
            xn = x.permute(0, 3, 1, 2)
            lib = _time_ms(torch, lambda: F.local_response_norm(
                xn, n, alpha * n, beta, kk))[0]
        rows["lrn_y"].append(_row(
            torch, "lrn_y", geo, err_f, lambda: lrn.lrn_y(x, *hp),
            lambda: lrn.plain_lrn_y(x, *hp), lrn_y_bound_ms(x.numel(), n),
            lib))
        rows["gd_lrn_x"].append(_row(
            torch, "gd_lrn_x", geo, err_b, lambda: lrn.gd_lrn_x(e, x, *hp),
            lambda: lrn.plain_gd_lrn_x(e, x, *hp),
            gd_lrn_x_bound_ms(x.numel(), n)))
    return rows


def lrn_maxpool_bound_ms(x_numel: int, y_numel: int, taps: int, n: int):
    """x read once, pooled values and int32 slots written once; the LRN of
    each x element once (2n+6, as lrn_y) and a compare per tap of each
    output."""
    return _bound(x_numel * 4 + 2 * y_numel * 4,
                  (2 * n + 6) * x_numel + 2 * taps * y_numel)


def gd_lrn_maxpool_bound_ms(x_numel: int, y_numel: int, taps: int, n: int):
    """pooled err, slots and x read once, dx written once; a compare and an
    add per tap of each window, the LRN backward of each x element (3n+11,
    as gd_lrn_x) and the folded derivative (up to 4)."""
    return _bound(2 * y_numel * 4 + 2 * x_numel * 4,
                  2 * taps * y_numel + (3 * n + 15) * x_numel)


def dropout_bound_ms(numel: int):
    """x read once, the output written once; the hash (~14 integer
    operations), a compare and a multiply per element."""
    return _bound(2 * numel * 4, 16 * numel)


#: case, x shape, ksize, stride, max-abs, folded activation, data
LRN_POOL_CASES = [
    ("alexnet_pair1", (128, 55, 55, 96), 3, 2, False, "strict_relu",
     "relu"),
    ("alexnet_pair2", (128, 27, 27, 256), 3, 2, False, "strict_relu",
     "relu"),
    ("odd_w", (2, 9, 9, 8), 3, 2, False, None, "normal"),
    ("even_w", (1, 8, 8, 16), 3, 2, False, None, "normal"),
    ("rect_window", (3, 11, 7, 4), (2, 3), 2, False, None, "normal"),
    ("row_stride_1", (2, 10, 12, 8), 2, (1, 2), False, None, "normal"),
    ("tall_row_stride_3", (2, 13, 9, 8), (4, 2), (3, 2), False, None,
     "normal"),
    ("c96", (1, 15, 15, 96), 3, 2, False, None, "normal"),
    ("c256", (1, 9, 9, 256), 3, 2, False, None, "normal"),
    ("maxabs", (7, 13, 11, 16), 3, 2, True, None, "normal"),
    ("ties", (16, 27, 27, 32), 3, 2, False, "strict_relu", "ties"),
    ("fold_tanh", (16, 27, 27, 32), 3, 2, False, "tanh", "tanh"),
    ("fold_sigmoid", (16, 27, 27, 32), 3, 2, False, "sigmoid", "sigmoid"),
    ("fold_relu", (16, 27, 27, 32), 3, 2, False, "relu", "softplus"),
]


def _lrn_pool_input(torch, shape, data, gen):
    """x as the layer before the pair would give it: a strict-ReLU, tanh,
    sigmoid or smooth-ReLU conv output, or plain normal values (scaled so
    that α·Σx² moves d away from k); "ties": small integers through a
    ReLU, so windows tie and LRN outputs repeat."""
    import torch.nn.functional as F
    if data == "ties":
        return torch.relu(torch.randint(-2, 3, shape, generator=gen).float())
    x = torch.randn(shape, generator=gen) * 4
    return {"relu": torch.relu, "normal": lambda a: a,
            "tanh": lambda a: 1.7159 * torch.tanh(0.6666 * a),
            "sigmoid": torch.sigmoid, "softplus": F.softplus}[data](x)


def phase_kernel_lrn_pool(torch) -> dict:
    """Forward values and offsets exactly equal to the plain version's;
    the backward too, but for the smooth-ReLU fold, whose expf may differ
    from the plain version's exp by an ulp (rtol 1e-6)."""
    import torch.nn.functional as F

    from znicz_tpu_torch.ops import lrn_pool
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 3)
    hp = (5, 1e-4, 0.75, 2.0)
    rows = {"lrn_maxpool": [], "gd_lrn_maxpool": []}
    for case, shape, k, st, use_abs, fold, data in LRN_POOL_CASES:
        x = _lrn_pool_input(torch, shape, data, gen).to(dev)
        y, off = _launch_once(torch, "lrn_maxpool", lambda: (
            lrn_pool.lrn_maxpool(x, *hp, k, st, 0, use_abs)))
        want_y, want_off = lrn_pool.plain_lrn_maxpool(x, *hp, k, st, 0,
                                                      use_abs)
        err_f = max(_close(torch, case, "offsets", off, want_off, 0, 0),
                    _close(torch, case, "y", y, want_y, 0, 0))
        e = (torch.randn(tuple(y.shape), generator=gen) * 0.1).to(dev)
        dx = _launch_once(torch, "gd_lrn_maxpool", lambda: (
            lrn_pool.gd_lrn_maxpool(e, off, x, *hp, k, st, 0, fold)))
        tol = (1e-6, 1e-9) if fold == "relu" else (0, 0)
        err_b = _close(torch, case, "dx", dx, lrn_pool.plain_gd_lrn_maxpool(
            e, off, x, *hp, k, st, 0, fold), *tol)
        geo = {"case": case, "shape": list(shape), "ksize": k, "stride": st,
               "use_abs": use_abs, "fold_act": fold}
        big = case.startswith("alexnet")
        iters = BIG_ITERS if big else ITERS
        lib = None
        if big:
            # two PyTorch calls on an NCHW copy: LRN (it divides alpha by
            # the window, hence alpha·n), then max pool with flat plane
            # indices (another contract than the port's window slots)
            xn = x.permute(0, 3, 1, 2).contiguous()
            lib = _time_ms(torch, lambda: F.max_pool2d(
                F.local_response_norm(xn, hp[0], hp[1] * hp[0], hp[2],
                                      hp[3]), k, st, return_indices=True),
                iters)[0]
        taps = math.prod(k) if isinstance(k, tuple) else k * k
        rows["lrn_maxpool"].append(_row(
            torch, "lrn_maxpool", geo, err_f,
            lambda: lrn_pool.lrn_maxpool(x, *hp, k, st, 0, use_abs),
            lambda: lrn_pool.plain_lrn_maxpool(x, *hp, k, st, 0, use_abs),
            lrn_maxpool_bound_ms(x.numel(), y.numel(), taps, hp[0]), lib,
            iters))
        rows["gd_lrn_maxpool"].append(_row(
            torch, "gd_lrn_maxpool", geo, err_b,
            lambda: lrn_pool.gd_lrn_maxpool(e, off, x, *hp, k, st, 0, fold),
            lambda: lrn_pool.plain_gd_lrn_maxpool(e, off, x, *hp, k, st, 0,
                                                  fold),
            gd_lrn_maxpool_bound_ms(x.numel(), y.numel(), taps, hp[0]),
            None, iters))
    return rows


#: case, shape, ratio, counter (the loader offset keying the mask)
DROPOUT_CASES = [
    ("alexnet_pool5", (128, 6, 6, 256), 0.5, 384),
    ("alexnet_fc6", (128, 4096), 0.5, 384),
    ("ratio_0.3", (128, 4096), 0.3, 512),
    ("counter_near_2^32", (7, 13, 5), 0.5, 2 ** 32 - 1),
]


def phase_kernel_dropout(torch) -> list:
    """The kernel's output exactly equal to the plain mask multiply, with
    the key folded on the host as the fused step folds it."""
    import zlib

    import torch.nn.functional as F

    from znicz_tpu_torch import prng
    from znicz_tpu_torch.ops import dropout, rngbits
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    prng.seed_all(SEED)
    seed = prng.get("dropout").stream_seed
    rows = []
    for case, shape, ratio, ctr in DROPOUT_CASES:
        x = torch.randn(shape, generator=gen).to(dev)
        key = rngbits.fold(seed, zlib.crc32(b"fwd10_dropout"), 1, ctr)
        got = _launch_once(torch, "dropout",
                           lambda: dropout.dropout(x, key, ratio))
        err = _close(torch, case, "out", got,
                     dropout.plain_dropout(x, key, ratio), 0, 0)
        lib = None
        if case.startswith("alexnet"):
            # Philox masks drawn on the card: the same shape of work, not
            # the same masks
            lib = _time_ms(torch, lambda: F.dropout(x, ratio,
                                                    training=True))[0]
        rows.append(_row(
            torch, "dropout", {"case": case, "shape": list(shape),
                               "ratio": ratio, "counter": ctr}, err,
            lambda: dropout.dropout(x, key, ratio),
            lambda: dropout.plain_dropout(x, key, ratio),
            dropout_bound_ms(x.numel()), lib))
    return rows


# -- main paths --------------------------------------------------------------
def expected_steps(split: dict, batch: int, epochs: int) -> list[dict]:
    """Steps ``run_fused`` runs in each epoch: train steps (the head of
    the epoch, plus the previous epoch's deferred last minibatch from
    epoch 1 on) and eval steps (the deferred minibatch's metrics,
    validation, test)."""
    def steps(n):
        return max(1, -(-n // batch))
    n_train = split["n_train"]
    split_at = ((n_train - 1) // batch) * batch
    per = []
    for e in range(epochs):
        evals = steps(n_train - split_at) + sum(
            steps(split[k]) for k in ("n_valid", "n_test") if split[k])
        per.append({"train": split_at // batch + (1 if e > 0 else 0),
                    "eval": evals})
    return per


def expected_launches(path: str, split: dict, batch: int, epochs: int
                      ) -> dict:
    """Launches each kernel must make on a path: its launches per train
    step and per eval step (``PATHS``) times the steps run, and none for a
    kernel off the path."""
    per = expected_steps(split, batch, epochs)
    train = sum(p["train"] for p in per)
    evals = sum(p["eval"] for p in per)
    mult = PATHS[path]
    return {k: (mult[k][0] * train + mult[k][1] * evals if k in mult
                else 0) for k in KERNELS}


def _run(model: str, device: str, epochs: int, split: dict,
         config: dict | None = None):
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    module = importlib.import_module(f"znicz_tpu_torch.models.{model}")
    tree = getattr(root, model)
    tree.synthetic.update(split)
    if config:
        tree.update(config)
    prng.seed_all(SEED)
    return module.run(device=device, fused=True, epochs=epochs)


#: the fused AlexNet's rows and their output shapes at batch 128
ALEXNET_ROWS = [
    ("conv", (55, 55, 96)), ("lrn_pool", (27, 27, 96)),
    ("conv", (27, 27, 256)), ("lrn_pool", (13, 13, 256)),
    ("conv", (13, 13, 384)), ("conv", (13, 13, 384)),
    ("conv", (13, 13, 256)), ("max_pool", (6, 6, 256)),
    ("dropout", (6, 6, 256)), ("fc", (4096,)), ("dropout", (4096,)),
    ("fc", (4096,)), ("fc", (1000,))]


def alexnet_geometry(torch, wf) -> dict:
    """The full-width net's per-row output shapes (one forward of a
    minibatch, after the counted run) and its parameter count, held to
    the classic geometry and 60–63 M parameters."""
    from znicz_tpu_torch.parallel import fused
    n_params = sum(t.numel() for pair in wf.params for t in pair
                   if t is not None)
    if not 60_000_000 < n_params < 63_000_000:
        raise AssertionError(f"alexnet has {n_params} parameters")
    batch = wf.loader.max_minibatch_size
    with torch.no_grad():
        out, caches = fused.forward(wf.spec, wf.spec_rows(wf.params),
                                    wf.loader.original_data[:batch],
                                    want_caches=True)
    rows = [(la.kind, tuple(h.shape)) for la, h in zip(
        wf.spec.layers, [c[0] for c in caches[1:]] + [out])]
    want = [(k, (batch,) + s) for k, s in ALEXNET_ROWS]
    if rows != want:
        raise AssertionError(f"alexnet rows {rows} != {want}")
    return {"n_params": n_params,
            "input_shape": list(wf.loader.original_data.shape[1:]),
            "layer_output_shapes": [[k, list(s)] for k, s in rows]}


def phase_slice(torch, model: str, split: dict, desc: str,
                extra=None) -> dict:
    """Train ``model`` for EPOCHS on the card, every launch count reset
    just before and read just after; each count must equal the steps the
    loop ran times the path's launches per step (zero for a kernel off
    the path).  ``extra(torch, wf)`` adds checks and fields after."""
    from znicz_tpu_torch.config import root
    importlib.import_module(f"znicz_tpu_torch.models.{model}")
    batch = int(getattr(root, model).get("minibatch_size"))
    expected = expected_launches(model, split, batch, EPOCHS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.monotonic()
    wf = _run(model, "cuda", EPOCHS, split)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = launch_counts()
    metrics = wf.decision.epoch_metrics
    if len(metrics) != EPOCHS:
        raise AssertionError(f"expected {EPOCHS} epochs, got {metrics}")
    for m in metrics:
        for k, v in m.items():
            if not math.isfinite(v):
                raise AssertionError(f"non-finite {k} in {m}")
    if not metrics[-1]["train_loss"] < metrics[0]["train_loss"]:
        raise AssertionError(f"{model}: train loss did not fall: {metrics}")
    if counts != expected:
        raise AssertionError(f"{model}: launches {counts} != steps run "
                             f"{expected}")
    for t in (t for pair in wf.params for t in pair if t is not None):
        if t.device.type != "cuda" or not torch.isfinite(t).all():
            raise AssertionError("params left the card or went non-finite")
    data = wf.loader.original_data
    out = {"phase": f"{model}_slice", "model": desc, "split": split,
           "batch": batch, "epochs": EPOCHS, "wall_s": wall_s,
           "launches": counts,
           "expected_steps_per_epoch": expected_steps(split, batch, EPOCHS),
           "resident_data_bytes": data.numel() * data.element_size(),
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "epoch_metrics": metrics, "epoch_timings": wf.epoch_timings}
    if extra is not None:
        out.update(extra(torch, wf))
    emit(out)
    del wf
    torch.cuda.empty_cache()
    return out


def phase_parity(model: str, split: dict, card_epoch0: dict, rtol: float,
                 err_share: float, config: dict | None = None) -> None:
    """Epoch 0 of the same seed on the CPU against the card's: losses
    within ``rtol``, error counts within ``err_share`` of each class."""
    cpu = _run(model, "cpu", 1, split, config).decision.epoch_metrics[0]
    sizes = {"train": split["n_train"], "validation": split["n_valid"],
             "test": split["n_test"]}
    for name, n in sizes.items():
        k = f"{name}_loss"
        if not math.isclose(card_epoch0[k], cpu[k], rel_tol=rtol,
                            abs_tol=0.0):
            raise AssertionError(f"{model} {k}: card {card_epoch0[k]} vs "
                                 f"cpu {cpu[k]}")
        k = f"{name}_n_err"
        if abs(card_epoch0[k] - cpu[k]) > err_share * n:
            raise AssertionError(f"{model} {k}: card {card_epoch0[k]} vs "
                                 f"cpu {cpu[k]}")
    emit({"phase": f"{model}_parity", "split": split,
          "card_epoch0": card_epoch0, "cpu_epoch0": cpu})


def kernels_line(kern: dict, launches: dict) -> dict:
    """One entry per kernel: its numbers at the main path's shape (the
    first case), the launches of the main-path runs, and every case."""
    out = []
    for name, (source, replaces, _, _) in KERNELS.items():
        rows = kern[name]
        main = rows[0]
        by_path = {path: counts[name] for path, counts in launches.items()}
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": main["shape"],
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "kernel_ms": main["kernel_ms"],
            "kernel_eager_ms": main["kernel_eager_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "by_shape": [{k: r[k] for k in ("case", "shape", "kernel_ms",
                                            "plain_ms", "bound_ms",
                                            "max_abs_err")}
                         for r in rows]})
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import znicz_tpu_torch  # noqa: F401  (fails outside a checkout)

    info = phase_device(torch)
    phase_build()
    kern = {"softmax_ce": phase_kernel_softmax(torch),
            **phase_kernel_pooling(torch), **phase_kernel_lrn(torch),
            **phase_kernel_lrn_pool(torch),
            "dropout": phase_kernel_dropout(torch)}
    mnist = phase_slice(torch, "mnist", MNIST_SPLIT, "mnist 784-100-10")
    phase_parity("mnist", MNIST_SPLIT, mnist["epoch_metrics"][0], 1e-4,
                 0.001)
    cifar = phase_slice(torch, "cifar", CIFAR_SPLIT,
                        "cifar conv5x5x32-maxpool2-lrn5-conv5x5x32-"
                        "avgpool2-fc64-softmax10")
    card = _run("cifar", "cuda", 1, CIFAR_PARITY_SPLIT)
    phase_parity("cifar", CIFAR_PARITY_SPLIT, card.decision.epoch_metrics[0],
                 5e-4, 0.01)
    alexnet = phase_slice(torch, "alexnet", ALEXNET_SPLIT,
                          "alexnet 227x227x3 conv11/4x96-lrnpool-conv5x256-"
                          "lrnpool-conv3x384-conv3x384-conv3x256-maxpool3/2-"
                          "dropout-fc4096-dropout-fc4096-softmax1000",
                          alexnet_geometry)
    from znicz_tpu_torch.models import alexnet as alexnet_model
    shrunk = dict(ALEXNET_SHRUNK, layers=alexnet_model.make_layers(
        ALEXNET_SHRUNK["n_classes"], widths=ALEXNET_SHRUNK_WIDTHS))
    card = _run("alexnet", "cuda", 1, ALEXNET_SPLIT, shrunk)
    phase_parity("alexnet", ALEXNET_SPLIT, card.decision.epoch_metrics[0],
                 5e-4, 0.01, shrunk)
    emit(kernels_line(kern, {"mnist": mnist["launches"],
                             "cifar": cifar["launches"],
                             "alexnet": alexnet["launches"]}))
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
