"""Where the time of a fused train/eval step, or of a unit-graph tick,
goes on the card.

    python -m znicz_tpu_torch.profile_fused
        [--model mnist|cifar|alexnet|autoencoder|mnist_units|cifar_units|
                 autoencoder_units|som] [--steps 50] [--out DIR]

Trains the sample at full width on its split resident on the card (MNIST
784→100→10 and the MNIST conv autoencoder on 50k/10k/10k, the CIFAR-10
conv net on 45k/5k/10k at 32×32×3, batch 100; AlexNet at 227×227×3 on
the reference's 512/128/128 synthetic split, batch 128) for one warm-up
epoch on its fused path, then runs ``--steps``
train steps and as many eval steps (the train set's shuffle, repeated as
often as the steps need) under ``torch.profiler`` and prints one JSON
line: host wall time per step (synchronised), device busy time per step
(the kernels' summed device time), the device's idle share, kernel
launches per step, the kernels that take the most device time, and the
port's own hand-written kernels with their share of the device time.
``--model <sample>_units`` profiles the sample's unit graph instead
(``Workflow.run``, one minibatch a tick, at the same full width and
split): after the epoch's test and validation ticks as warm-up,
``--steps`` train ticks, then (past the rest of the epoch) as many test
and validation ticks of the next epoch; a "step" in its line is a tick.
``--model som`` profiles the fused SOM (BASELINE config 5 at its own
size: 2000 points, an 8×8 sheet, batch 100): train steps only, after a
warm-up epoch.
With ``--out`` the Chrome traces are written there.  It needs a CUDA card
and fails without one."""

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

_MNIST_SPLIT = {"n_train": 50000, "n_valid": 10000, "n_test": 10000,
                "noise": 0.35}
#: model → (workflow class, its config tree, the real split at full width)
MODELS = {
    "mnist": ("MnistWorkflow", "mnist", _MNIST_SPLIT),
    "cifar": ("CifarWorkflow", "cifar",
              {"n_train": 45000, "n_valid": 5000, "n_test": 10000,
               "noise": 0.3, "size": 32}),
    "alexnet": ("AlexNetWorkflow", "alexnet",
                {"n_train": 512, "n_valid": 128, "n_test": 128,
                 "noise": 0.4}),
    "autoencoder": ("MnistAEWorkflow", "mnist_ae", _MNIST_SPLIT),
}
#: the unit graphs, at the same widths and splits
UNIT_MODELS = {"mnist_units": "mnist", "cifar_units": "cifar",
               "autoencoder_units": "autoencoder"}
#: the hand-written kernels' names in ``csrc/`` (a name that contains
#: another is listed first, so each kernel is counted once)
PORT_KERNELS = ("softmax_ce_kernel", "row_softmax_kernel",
                "pool_select_kernel", "pool_scatter_kernel",
                "pool_gather_kernel", "gd_lrn_maxpool_kernel",
                "lrn_maxpool_kernel", "lrn_y_kernel", "gd_lrn_kernel",
                "lrn_kernel", "dropout_kernel", "matmul_kernel",
                "sgd_update_kernel", "dist_argmin_kernel", "act_fwd_kernel",
                "act_bwd_kernel")


def _window(fn, steps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def _workflow(model: str):
    """The sample's workflow at its full-width split, seeded."""
    cls_name, tree, split = MODELS[model]
    module = importlib.import_module(f".models.{model}", __package__)
    getattr(root, tree).synthetic.update(split)
    prng.seed_all(1234)
    return getattr(module, cls_name)()


def _fused_steps(args):
    """(batch, train, evaluate): ``--steps`` fused train/eval steps each,
    after a warm-up epoch."""
    wf = _workflow(args.model)
    wf.initialize(device="cuda")
    trainer = wf.run_fused(max_epochs=1)        # warm-up epoch
    loader = wf.loader
    batch = loader.max_minibatch_size
    idx = np.resize(loader.train_permutation(1), args.steps * batch)
    data = loader.original_data
    target = (loader.original_targets if wf.loss_function == "mse"
              else loader.original_labels)

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
    wf = _workflow(UNIT_MODELS[args.model])
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


def _som_steps(args):
    """(batch, train, None): ``--steps`` fused SOM steps (BASELINE config
    5 at its own size) after a warm-up epoch; the SOM has no evaluation
    step."""
    from .models import kohonen
    prng.seed_all(1234)
    wf = kohonen.KohonenWorkflow()
    wf.initialize(device="cuda")
    trainer = wf.run_fused(max_epochs=1)        # warm-up epoch
    loader = wf.loader
    batch = loader.max_minibatch_size
    idx = np.resize(loader.train_permutation(1), args.steps * batch)
    lr, sigma = wf.trainer.schedules()

    def train():
        trainer.train_epoch(loader.original_data, idx, batch, lr, sigma)
    return batch, train, None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS) + sorted(UNIT_MODELS)
                    + ["som"], default="mnist")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--out", default=None,
                    help="directory for the Chrome traces")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_fused needs a CUDA card")
    batch, train, evaluate = (
        _som_steps if args.model == "som" else _unit_ticks
        if args.model in UNIT_MODELS else _fused_steps)(args)
    out = {"model": args.model, "steps": args.steps, "batch": batch,
           "device": torch.cuda.get_device_name(0)}
    for name, fn in (("train", train), ("eval", evaluate)):
        if fn is None:
            continue
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
