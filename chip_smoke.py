#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``znicz_tpu_torch``) on one
CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits nonzero without the final ``ok`` line:

1. device — the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
   them (also printed raw on a line of its own);
2. build  — every ``znicz_tpu_torch/csrc/*.cu`` compiled with nvcc for
   sm_90a from this checkout (one nvcc per source, started together);
3. kernel — each kernel's wrapper against its plain PyTorch version on the
   card at the main path's shapes and a few more, with the stated
   tolerances; times of kernel, plain version and the byte/flop bound;
4. slice  — the fused MNIST trainer at full width (784→100→10, batch 100,
   50k/10k/10k synthetic split resident on the card) for 2 epochs through
   ``models.mnist.run``, with every kernel's launch count reset just before
   and read just after; the counts must equal the steps the loop ran;
5. parity — the same seed for one epoch on the CPU; epoch-0 losses agree
   within rtol 1e-4 and error counts within 0.1% of each class's size;
6. the ``kernels`` line, then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the ``znicz_tpu`` package.  Without a CUDA
device, or outside a checkout of the repository, it fails."""

from __future__ import annotations

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
EPOCHS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def _time_ms(torch, fn, iters: int) -> tuple[float, float]:
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


def softmax_ce_bound_ms(n: int, c: int) -> tuple[float, str]:
    """Least time for the softmax-CE function on the card: logits and
    labels read once, probs, err and loss written once; about 6 float
    operations per element (sub, exp, add, div, sub, compare) against the
    float32 peak."""
    nbytes = n * c * 4 + n * 4 + 2 * n * c * 4 + n * 4
    ops = 6 * n * c
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel(torch) -> dict:
    from znicz_tpu_torch.ops import softmax
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    cases = [("mnist_step", 100, 10), ("ragged", 37, 10),
             ("bench_kernel_case", 1024, 1000),
             ("labels_out_of_range", 64, 10)]
    rows = []
    for case, n, c in cases:
        logits = (torch.randn((n, c), generator=gen) * 3).to(dev)
        labels = torch.randint(0, c, (n,), generator=gen, dtype=torch.int32)
        if case == "labels_out_of_range":
            labels[::3] = -1
            labels[1::3] = c
        labels = labels.to(dev)
        before = softmax.softmax_ce_launches
        got = softmax.softmax_ce_from_logits(logits, labels)
        torch.cuda.synchronize()
        if softmax.softmax_ce_launches != before + 1:
            raise AssertionError(f"softmax_ce launch counter did not "
                                 f"advance on {case}")
        want = softmax.plain_softmax_ce_from_logits(logits, labels)
        err = 0.0
        for name, g, w, atol, rtol in (
                ("probs", got[0], want[0], 1e-6, 1e-5),
                ("loss", got[1], want[1], 1e-5, 1e-5),
                ("err", got[2], want[2], 1e-6, 1e-5)):
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"{case}: {name} shape/finite check")
            torch.testing.assert_close(g, w, atol=atol, rtol=rtol,
                                       msg=lambda m: f"{case} {name}: {m}")
            err = max(err, float((g - w).abs().max()))
        iters = 200
        k_ms, k_eager = _time_ms(
            torch, lambda: softmax.softmax_ce_from_logits(logits, labels),
            iters)
        p_ms, p_eager = _time_ms(
            torch, lambda: softmax.plain_softmax_ce_from_logits(logits,
                                                                labels),
            iters)
        bound_ms, bound_by = softmax_ce_bound_ms(n, c)
        row = {"phase": "kernel", "name": "softmax_ce", "case": case,
               "shape": [n, c], "max_abs_err": err, "kernel_ms": k_ms,
               "kernel_eager_ms": k_eager, "plain_ms": p_ms,
               "plain_eager_ms": p_eager, "bound_ms": bound_ms,
               "bound_by": bound_by, "iters": iters}
        emit(row)
        rows.append(row)
    return {"softmax_ce": rows}


def expected_softmax_ce_launches(split: dict, batch: int, epochs: int
                                 ) -> list[int]:
    """Launches of the loss head per epoch of ``run_fused``: one per train
    step (the head of the epoch, plus the previous epoch's deferred last
    minibatch from epoch 1 on) and one per eval step (the deferred
    minibatch's metrics, validation, test)."""
    def steps(n):
        return max(1, -(-n // batch))
    n_train = split["n_train"]
    split_at = ((n_train - 1) // batch) * batch
    per = []
    for e in range(epochs):
        train_steps = split_at // batch + (1 if e > 0 else 0)
        eval_steps = steps(n_train - split_at)
        for k in ("n_valid", "n_test"):
            if split[k]:
                eval_steps += steps(split[k])
        per.append(train_steps + eval_steps)
    return per


def _mnist_run(device: str, epochs: int):
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.models import mnist
    prng.seed_all(SEED)
    return mnist.run(device=device, fused=True, epochs=epochs)


def phase_slice(torch) -> tuple[dict, dict]:
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.models import mnist  # noqa: F401  (root.mnist)
    from znicz_tpu_torch.ops import softmax
    root.mnist.synthetic.update(MNIST_SPLIT)
    batch = int(root.mnist.get("minibatch_size"))
    expected = expected_softmax_ce_launches(MNIST_SPLIT, batch, EPOCHS)
    torch.cuda.reset_peak_memory_stats()
    softmax.softmax_ce_launches = 0
    t0 = time.monotonic()
    wf = _mnist_run("cuda", EPOCHS)
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counts = {"softmax_ce": softmax.softmax_ce_launches}
    metrics = wf.decision.epoch_metrics
    if len(metrics) != EPOCHS:
        raise AssertionError(f"expected {EPOCHS} epochs, got {metrics}")
    for m in metrics:
        for k, v in m.items():
            if not math.isfinite(v):
                raise AssertionError(f"non-finite {k} in {m}")
    if not metrics[1]["train_loss"] < metrics[0]["train_loss"]:
        raise AssertionError(f"train loss did not fall: {metrics}")
    if counts["softmax_ce"] != sum(expected):
        raise AssertionError(f"softmax_ce launches {counts['softmax_ce']} "
                             f"!= steps run {sum(expected)} {expected}")
    for w, b in wf.params:
        if w.device.type != "cuda" or not torch.isfinite(w).all():
            raise AssertionError("params left the card or went non-finite")
    out = {"phase": "slice", "model": "mnist 784-100-10",
           "split": MNIST_SPLIT, "batch": batch, "epochs": EPOCHS,
           "wall_s": wall_s, "launches": counts,
           "expected_launches_per_epoch": expected,
           "resident_data_bytes": wf.loader.original_data.numel() * 4,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "epoch_metrics": metrics, "epoch_timings": wf.epoch_timings}
    emit(out)
    return out, counts


def phase_parity(slice_out: dict) -> None:
    cpu = _mnist_run("cpu", 1).decision.epoch_metrics[0]
    gpu = slice_out["epoch_metrics"][0]
    sizes = {"train": MNIST_SPLIT["n_train"],
             "validation": MNIST_SPLIT["n_valid"],
             "test": MNIST_SPLIT["n_test"]}
    for k in ("train_loss", "validation_loss"):
        if not math.isclose(gpu[k], cpu[k], rel_tol=1e-4, abs_tol=0.0):
            raise AssertionError(f"{k}: card {gpu[k]} vs cpu {cpu[k]}")
    for name, n in sizes.items():
        k = f"{name}_n_err"
        # argmax ties can flip under another summation order
        if abs(gpu[k] - cpu[k]) > 0.001 * n:
            raise AssertionError(f"{k}: card {gpu[k]} vs cpu {cpu[k]}")
    emit({"phase": "parity", "card_epoch0": gpu, "cpu_epoch0": cpu})


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
    kern = phase_kernel(torch)
    slice_out, counts = phase_slice(torch)
    phase_parity(slice_out)
    main_row = kern["softmax_ce"][0]
    emit({"kernels": [{
        "name": "softmax_ce", "route": "cuda",
        "source": "znicz_tpu_torch/csrc/softmax_ce.cu",
        "replaces": "znicz_tpu/ops/softmax.py:119",
        "shape": main_row["shape"],
        "launches": counts["softmax_ce"],
        "max_abs_err": max(r["max_abs_err"] for r in kern["softmax_ce"]),
        "ms": main_row["kernel_ms"], "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"], "library_ms": None,
        "by_shape": [{k: r[k] for k in ("case", "shape", "kernel_ms",
                                        "plain_ms", "bound_ms",
                                        "max_abs_err")}
                     for r in kern["softmax_ce"]]}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
