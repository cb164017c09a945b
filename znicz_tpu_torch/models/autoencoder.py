"""MnistAEWorkflow: the MNIST convolutional autoencoder, BASELINE config 4
(port of ``znicz_tpu/models/autoencoder.py``).

conv 5×5×16 pad 2 → max-pool 2×2 → depooling (tied to the pool's winner
slots) → deconv 5×5 16→1 pad 2, trained with MSE against the input image,
momentum SGD, batch 100.  The images are the MNIST sample's (real IDX
files when present, else the deterministic synthetic stand-in, here at
the autoencoder's own split) as NHWC (28, 28, 1).

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.autoencoder
[--fused] [--epochs N] [--device cuda|cpu|numpy]`` — without ``--fused``
it trains on the unit graph (the reference's default), with it on the
fused path.
"""

from __future__ import annotations

import numpy as np

from ..config import root
from ..loader.fullbatch import FullBatchLoaderMSE
from ..standard_workflow import StandardWorkflow, sample_snapshotter_config
from .mnist import MnistLoader

root.mnist_ae.setdefaults({
    "minibatch_size": 100,
    "layers": [
        # conv-MSE gradients sum over all 28×28 output positions, so the
        # stable lr is ~2 orders below the classifier samples'
        {"type": "conv", "->": {"n_kernels": 16, "kx": 5, "ky": 5,
                                "padding": 2},
         "<-": {"learning_rate": 0.0002, "gradient_moment": 0.9}},
        {"type": "max_pooling", "->": {"kx": 2, "ky": 2}},
        {"type": "depooling", "->": {"tie": 1}},
        {"type": "deconv", "->": {"n_kernels": 16, "kx": 5, "ky": 5,
                                  "padding": 2, "n_channels": 1},
         "<-": {"learning_rate": 0.0002, "gradient_moment": 0.9}},
    ],
    "decision": {"max_epochs": 10, "fail_iterations": 50},
    "synthetic": {"n_train": 2000, "n_valid": 400, "n_test": 400,
                  "noise": 0.35},
})


class MnistAELoader(FullBatchLoaderMSE, MnistLoader):
    """MNIST images as NHWC (28, 28, 1); the target is the input (the
    FullBatchLoaderMSE default)."""

    def load_data(self) -> None:
        MnistLoader.load_data(self)
        self.original_data = np.asarray(
            self.original_data, np.float32).reshape(-1, 28, 28, 1)


class MnistAEWorkflow(StandardWorkflow):
    """BASELINE config 4: conv/pool encoder, depool/deconv decoder, MSE."""

    def __init__(self, name="MnistAEWorkflow", layers=None,
                 decision_config=None, snapshotter_config=None,
                 lr_adjuster_config=None, **kwargs):
        loader = MnistAELoader(
            minibatch_size=root.mnist_ae.get("minibatch_size", 100),
            synthetic_sizes=kwargs.get("synthetic_sizes")
            or root.mnist_ae.synthetic.to_dict())
        super().__init__(
            name,
            layers=layers or root.mnist_ae.get("layers")
            or root.mnist_ae.layers,
            loader=loader,
            loss_function="mse",
            decision_config=decision_config
            or root.mnist_ae.decision.to_dict(),
            snapshotter_config=sample_snapshotter_config(
                root.mnist_ae, snapshotter_config),
            lr_adjuster_config=lr_adjuster_config)


def run(device=None, epochs: int | None = None, fused: bool = False,
        **kwargs) -> MnistAEWorkflow:
    """Build, initialize and train on ``device`` (default: the CUDA card,
    raising without one; pass ``device="cpu"`` for the host, ``"numpy"``
    for the golden unit graph).  ``fused=False`` trains on the unit-graph
    tick loop, ``fused=True`` (the CLI's ``--fused``) on the fused path.
    Returns the finished workflow."""
    wf = MnistAEWorkflow(**kwargs)
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
