"""CifarWorkflow: the CIFAR-10 conv sample, BASELINE config 2 (port of
``znicz_tpu/models/cifar.py``).

conv 5×5×32 pad 2 tanh → max-pool 2 → LRN(n=5) → conv 5×5×32 pad 2 tanh →
avg-pool 2 → all2all_tanh 64 → softmax 10, momentum SGD, batch 100.  NHWC
samples (32×32×3).  Real CIFAR-10 python batches are read when
``root.common.cifar_dir`` (or ``~/.cache/cifar10``) holds them; otherwise
a deterministic synthetic stand-in (class prototypes plus noise) is drawn
from the ``"cifar_synthetic"`` stream, bit-identical to the JAX package's
for the same seed.

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.cifar [--fused]
[--epochs N] [--device cuda|cpu|numpy]`` — without ``--fused`` it trains
on the unit graph (the reference's default), with it on the fused path.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .. import prng
from ..config import root
from ..loader.fullbatch import FullBatchLoader
from ..standard_workflow import StandardWorkflow, sample_snapshotter_config

root.cifar.setdefaults({
    "minibatch_size": 100,
    "layers": [
        {"type": "conv_tanh",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
         "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "norm", "->": {"n": 5, "alpha": 1e-4, "beta": 0.75}},
        {"type": "conv_tanh",
         "->": {"n_kernels": 32, "kx": 5, "ky": 5, "padding": 2},
         "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
        {"type": "avg_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "all2all_tanh", "->": {"output_sample_shape": 64},
         "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    ],
    "decision": {"max_epochs": 10, "fail_iterations": 50},
    "synthetic": {"n_train": 2000, "n_valid": 400, "n_test": 400,
                  "noise": 0.3, "size": 32},
})


def _find_cifar() -> str | None:
    for cand in (root.common.get("cifar_dir"),
                 os.path.expanduser("~/.cache/cifar10")):
        if cand and os.path.exists(os.path.join(cand, "data_batch_1")):
            return cand
    return None


class CifarLoader(FullBatchLoader):
    """Real CIFAR-10 when available, deterministic synthetic otherwise;
    samples are NHWC float32."""

    def __init__(self, name=None, synthetic_sizes=None, **kwargs):
        kwargs.setdefault("normalization_type", "linear")
        super().__init__(name=name or "cifar_loader", **kwargs)
        self.synthetic_sizes = synthetic_sizes

    def load_data(self) -> None:
        cifar_dir = _find_cifar()
        if cifar_dir:
            self._load_real(cifar_dir)
        else:
            self._load_synthetic()

    def _load_real(self, d: str) -> None:
        def batch(fname):
            with open(os.path.join(d, fname), "rb") as fh:
                raw = pickle.load(fh, encoding="bytes")
            x = raw[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return x.astype(np.float32), np.asarray(raw[b"labels"],
                                                    np.int32)
        train = [batch(f"data_batch_{i}") for i in range(1, 6)]
        te_x, te_y = batch("test_batch")
        tr_x = np.concatenate([b[0] for b in train])
        tr_y = np.concatenate([b[1] for b in train])
        n_valid = 5000
        # order: [test | validation | train] to match class indices
        self.original_data = np.concatenate(
            [te_x, tr_x[:n_valid], tr_x[n_valid:]])
        self.original_labels = np.concatenate(
            [te_y, tr_y[:n_valid], tr_y[n_valid:]])
        self.class_lengths = [len(te_x), n_valid, len(tr_x) - n_valid]

    def _load_synthetic(self) -> None:
        cfg = self.synthetic_sizes or root.cifar.synthetic.to_dict()
        n_test, n_valid, n_train = (cfg["n_test"], cfg["n_valid"],
                                    cfg["n_train"])
        noise, size = cfg.get("noise", 0.3), cfg.get("size", 32)
        gen = prng.get("cifar_synthetic")
        protos = gen.normal(0.0, 1.0, (10, size, size, 3))
        n = n_test + n_valid + n_train
        labels = gen.randint(0, 10, n).astype(np.int32)
        data = (protos[labels]
                + gen.normal(0.0, noise, (n, size, size, 3))).astype(
                    np.float32)
        self.original_data = data
        self.original_labels = labels
        self.class_lengths = [n_test, n_valid, n_train]


class CifarWorkflow(StandardWorkflow):
    """BASELINE config 2: Conv+Pool+LRN+FC."""

    def __init__(self, name="CifarWorkflow", layers=None,
                 decision_config=None, snapshotter_config=None,
                 lr_adjuster_config=None, **kwargs):
        loader = CifarLoader(
            minibatch_size=root.cifar.get("minibatch_size", 100),
            **{k: v for k, v in kwargs.items()
               if k in ("synthetic_sizes",)})
        super().__init__(
            name,
            layers=layers or root.cifar.get("layers") or root.cifar.layers,
            loader=loader,
            loss_function="softmax",
            decision_config=decision_config
            or root.cifar.decision.to_dict(),
            snapshotter_config=sample_snapshotter_config(
                root.cifar, snapshotter_config),
            lr_adjuster_config=lr_adjuster_config)


def run(device=None, epochs: int | None = None, fused: bool = False,
        **kwargs) -> CifarWorkflow:
    """Build, initialize and train on ``device`` (default: the CUDA card,
    raising without one; pass ``device="cpu"`` for the host, ``"numpy"``
    for the golden unit graph).  ``fused=False`` trains on the unit-graph
    tick loop, ``fused=True`` (the CLI's ``--fused``) on the fused path.
    Returns the finished workflow."""
    wf = CifarWorkflow(**kwargs)
    if epochs is not None:
        wf.decision.max_epochs = epochs
    wf.initialize(device=device)
    wf.train(fused=fused, max_epochs=epochs)
    return wf


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="auto",
                        choices=("auto", "cuda", "cpu", "numpy"))
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--fused", action="store_true")
    args = parser.parse_args(argv)
    wf = run(device=args.device, epochs=args.epochs, fused=args.fused)
    for m in wf.decision.epoch_metrics:
        print(m)


if __name__ == "__main__":
    main()
