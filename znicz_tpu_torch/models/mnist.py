"""MnistWorkflow: the canonical MNIST MLP sample (port of
``znicz_tpu/models/mnist.py``).

``All2AllTanh(100) → All2AllSoftmax(10)`` with momentum SGD, batch 100.
Real MNIST IDX files are used when present (``root.common.mnist_dir`` or
``~/.cache/mnist``); otherwise a deterministic synthetic stand-in is
generated from the ``"mnist_synthetic"`` stream — bit-identical to the JAX
package's for the same seed.

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.mnist [--fused]
[--epochs N] [--device cuda|cpu|numpy]`` — without ``--fused`` it trains on
the unit graph (the reference's default), with it on the fused path.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .. import prng
from ..config import root
from ..loader.fullbatch import FullBatchLoader
from ..standard_workflow import StandardWorkflow, sample_snapshotter_config

root.mnist.setdefaults({
    "minibatch_size": 100,
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 100},
         "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
    ],
    "decision": {"max_epochs": 10, "fail_iterations": 50},
    "synthetic": {"n_train": 5000, "n_valid": 1000, "n_test": 1000,
                  "noise": 0.35},
})


def _find_mnist_idx() -> str | None:
    for cand in (root.common.get("mnist_dir"),
                 os.path.expanduser("~/.cache/mnist")):
        if cand and os.path.exists(
                os.path.join(cand, "train-images-idx3-ubyte.gz")):
            return cand
    return None


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        magic, = struct.unpack(">H", fh.read(4)[2:])
        dims = magic & 0xFF
        # IDX: magic(4) then dims×uint32 sizes
        fh.seek(4)
        shape = struct.unpack(f">{dims}I", fh.read(4 * dims))
        return np.frombuffer(fh.read(), np.uint8).reshape(shape)


class MnistLoader(FullBatchLoader):
    """Real MNIST when available, deterministic synthetic otherwise."""

    def __init__(self, name=None, synthetic_sizes=None, **kwargs):
        kwargs.setdefault("normalization_type", "linear")
        super().__init__(name=name or "mnist_loader", **kwargs)
        self.synthetic_sizes = synthetic_sizes

    def load_data(self) -> None:
        mnist_dir = _find_mnist_idx()
        if mnist_dir:
            self._load_real(mnist_dir)
        else:
            self._load_synthetic()

    def _load_real(self, d: str) -> None:
        tr_x = _read_idx(os.path.join(d, "train-images-idx3-ubyte.gz"))
        tr_y = _read_idx(os.path.join(d, "train-labels-idx1-ubyte.gz"))
        te_x = _read_idx(os.path.join(d, "t10k-images-idx3-ubyte.gz"))
        te_y = _read_idx(os.path.join(d, "t10k-labels-idx1-ubyte.gz"))
        # 10k held out for validation on the real 60k set; adapt for
        # smaller drop-in datasets (same idx format, fewer rows)
        n_valid = min(10000, len(tr_x) // 6)
        # order: [test | validation | train] to match class indices
        self.original_data = np.concatenate(
            [te_x, tr_x[:n_valid], tr_x[n_valid:]]).astype(
                np.float32).reshape(-1, 784)
        self.original_labels = np.concatenate(
            [te_y, tr_y[:n_valid], tr_y[n_valid:]]).astype(np.int32)
        self.class_lengths = [len(te_x), n_valid, len(tr_x) - n_valid]

    def _load_synthetic(self) -> None:
        cfg = self.synthetic_sizes or root.mnist.synthetic.to_dict()
        n_test, n_valid, n_train = (cfg["n_test"], cfg["n_valid"],
                                    cfg["n_train"])
        noise = cfg.get("noise", 0.35)
        gen = prng.get("mnist_synthetic")
        protos = gen.normal(0.0, 1.0, (10, 784))
        n = n_test + n_valid + n_train
        labels = gen.randint(0, 10, n).astype(np.int32)
        data = (protos[labels]
                + gen.normal(0.0, noise, (n, 784))).astype(np.float32)
        self.original_data = data
        self.original_labels = labels
        self.class_lengths = [n_test, n_valid, n_train]


class MnistWorkflow(StandardWorkflow):
    """BASELINE config 1: All2AllTanh → All2AllSoftmax + GD chain."""

    def __init__(self, name="MnistWorkflow", layers=None,
                 decision_config=None, snapshotter_config=None,
                 lr_adjuster_config=None, **kwargs):
        loader = MnistLoader(
            minibatch_size=root.mnist.get("minibatch_size", 100),
            **{k: v for k, v in kwargs.items()
               if k in ("synthetic_sizes",)})
        super().__init__(
            name,
            layers=layers or root.mnist.get("layers") or root.mnist.layers,
            loader=loader,
            loss_function="softmax",
            decision_config=decision_config
            or root.mnist.decision.to_dict(),
            snapshotter_config=sample_snapshotter_config(
                root.mnist, snapshotter_config),
            lr_adjuster_config=lr_adjuster_config)


def run(device=None, epochs: int | None = None, fused: bool = False,
        **kwargs) -> MnistWorkflow:
    """Build, initialize and train on ``device`` (default: the CUDA card,
    raising without one; pass ``device="cpu"`` for the host, ``"numpy"``
    for the golden unit graph).  ``fused=False`` trains on the unit-graph
    tick loop, ``fused=True`` (the CLI's ``--fused``) on the fused path.
    Returns the finished workflow."""
    wf = MnistWorkflow(**kwargs)
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
    if not args.fused:
        print("time table:", wf.time_table()[:6])


if __name__ == "__main__":
    main()
