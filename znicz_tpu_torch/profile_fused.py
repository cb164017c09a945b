"""Where the time of a fused train/eval step, or of a unit-graph tick,
goes on the card.

    python -m znicz_tpu_torch.profile_fused
        [--model mnist|cifar|alexnet|mnist_units] [--steps 50] [--out DIR]

Trains the sample at full width on its split resident on the card (MNIST
784→100→10 on 50k/10k/10k and the CIFAR-10 conv net on 45k/5k/10k at
32×32×3, batch 100; AlexNet at 227×227×3 on the reference's 512/128/128
synthetic split, batch 128) for one warm-up epoch, then runs ``--steps``
train steps and as many eval steps (the train set's shuffle, repeated as
often as the steps need) under ``torch.profiler`` and prints one JSON
line: host wall time per step (synchronised), device busy time per step
(the kernels' summed device time), the device's idle share, kernel
launches per step, the kernels that take the most device time, and the
port's own hand-written kernels with their share of the device time.
``--model mnist_units`` profiles the MNIST unit graph instead
(``Workflow.run``, one minibatch a tick, at the same full width and
split): after the epoch's test and validation ticks as warm-up, ``--steps``
train ticks, then (past the rest of the epoch) as many test and
validation ticks of the next epoch; a "step" in its line is a tick.  With ``--out`` the Chrome
traces are written there.  It needs a CUDA card and fails without one."""

from __future__ import annotations

import argparse
import importlib
import json
import time

import numpy as np
import torch

from . import prng
from .config import root
from .loader.base import TRAIN

#: model → (workflow class, the real split at full width)
MODELS = {
    "mnist": ("MnistWorkflow", {"n_train": 50000, "n_valid": 10000,
                                "n_test": 10000, "noise": 0.35}),
    "cifar": ("CifarWorkflow", {"n_train": 45000, "n_valid": 5000,
                                "n_test": 10000, "noise": 0.3, "size": 32}),
    "alexnet": ("AlexNetWorkflow", {"n_train": 512, "n_valid": 128,
                                    "n_test": 128, "noise": 0.4}),
}
#: the unit graph's MNIST at the same width and split
UNIT_MODELS = {"mnist_units": ("mnist", "MnistWorkflow")}
#: the hand-written kernels' names in ``csrc/`` (a name that contains
#: another is listed first, so each kernel is counted once)
PORT_KERNELS = ("softmax_ce_kernel", "row_softmax_kernel",
                "pool_select_kernel", "pool_scatter_kernel",
                "gd_lrn_maxpool_kernel", "lrn_maxpool_kernel",
                "lrn_y_kernel", "gd_lrn_x_kernel", "dropout_kernel",
                "matmul_kernel", "sgd_update_kernel")


def _window(fn, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _fused_steps(args):
    """(batch, train, evaluate): ``--steps`` fused train/eval steps each,
    after a warm-up epoch."""
    cls_name, split = MODELS[args.model]
    module = importlib.import_module(f".models.{args.model}", __package__)
    getattr(root, args.model).synthetic.update(split)
    prng.seed_all(1234)
    wf = getattr(module, cls_name)()
    wf.initialize(device="cuda")
    trainer = wf.run_fused(max_epochs=1)        # warm-up epoch
    loader = wf.loader
    batch = loader.max_minibatch_size
    idx = np.resize(loader.train_permutation(1), args.steps * batch)
    data, target = loader.original_data, loader.original_labels

    def train():
        trainer.train_epoch(data, target, idx, batch, sync=False)

    def evaluate():
        trainer.eval_epoch(data, target, idx, batch, sync=False)
    return batch, train, evaluate


def _unit_ticks(args):
    """(batch, train, evaluate) on the unit graph: each call runs the
    next ``--steps`` ticks of the tick loop — train ticks (GD chain on),
    or evaluation ticks (test and validation, GD skipped) — after
    running on to the next minibatch of that kind."""
    model, cls_name = UNIT_MODELS[args.model]
    module = importlib.import_module(f".models.{model}", __package__)
    getattr(root, model).synthetic.update(MODELS[model][1])
    prng.seed_all(1234)
    wf = getattr(module, cls_name)()
    wf.decision.max_epochs = 1 << 30             # never completes here
    wf.initialize(device="cuda")
    ld = wf.loader
    batch = ld.max_minibatch_size
    per_class = [-(-n // batch) for n in ld.class_lengths]
    if 3 * args.steps > min(per_class[0] + per_class[1], per_class[2]):
        raise ValueError(f"--steps {args.steps}: three windows of each "
                         f"kind must fit in an epoch's {per_class} "
                         f"minibatches")

    def to_next(train: bool):
        while not (ld._pos < len(ld._order)
                   and (ld._order[ld._pos][0] == TRAIN) == train):
            wf.run(max_ticks=1)

    def train():
        to_next(True)
        wf.run(max_ticks=args.steps)

    def evaluate():
        to_next(False)
        wf.run(max_ticks=args.steps)
    return batch, train, evaluate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS) + sorted(UNIT_MODELS),
                    default="mnist")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_fused needs a CUDA card")
    batch, train, evaluate = (_unit_ticks if args.model in UNIT_MODELS
                              else _fused_steps)(args)
    out = {"model": args.model, "steps": args.steps, "batch": batch,
           "device": torch.cuda.get_device_name(0)}
    for name, fn in (("train", train), ("eval", evaluate)):
        fn()                                      # warm the allocator
        wall_ms = _window(fn, args.steps)         # unprofiled
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _window(fn, args.steps)
        if args.out:
            prof.export_chrome_trace(
                f"{args.out}/fused_{args.model}_{name}.json")
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        launches = sum(e.count for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        port = {}
        for e in kernels:
            k = next((k for k in PORT_KERNELS if k in e.key), None)
            if k is not None:
                port[k] = {"us_per_step": e.self_device_time_total
                           / args.steps,
                           "calls_per_step": e.count / args.steps,
                           "share_of_busy": (e.self_device_time_total
                                             / busy_us if busy_us
                                             else None)}
        out[name] = {
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": (busy_us / 1e3 / args.steps
                                        if busy_us else None),
            "device_idle_share": (1.0 - busy_us / 1e3 / args.steps / wall_ms
                                  if busy_us else None),
            "kernels_per_step": launches / args.steps,
            "top_kernels": [{"name": e.key[:80],
                             "us_per_step": e.self_device_time_total
                             / args.steps,
                             "calls_per_step": e.count / args.steps}
                            for e in top],
            "port_kernels": port,
            "port_kernels_share_of_busy": (
                sum(v["us_per_step"] for v in port.values()) * args.steps
                / busy_us if busy_us else None)}
    out["examples_per_sec_train_only"] = batch / (
        out["train"]["wall_ms_per_step"] / 1e3)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
