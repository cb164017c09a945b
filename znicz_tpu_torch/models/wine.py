"""WineWorkflow: the Wine tabular-classification sample (port of
``znicz_tpu/models/wine.py``).

The UCI Wine dataset (178 samples, 13 chemical features, 3 cultivars)
through a tiny MLP, tanh hidden layer and softmax, behind the mean and
dispersion normalizer.  The loader reads the classic ``wine.data`` CSV
when present (``root.common.wine_path`` or ``~/.cache/wine.data``) and
otherwise a deterministic synthetic stand-in with the real geometry (13
features of very different scales, 3 classes) drawn from the
``"wine_synthetic"`` stream, bit-identical to the JAX package's for the
same seed.

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.wine [--fused]
[--epochs N] [--device cuda|cpu|numpy]``
"""

from __future__ import annotations

import os

import numpy as np

from .. import prng
from ..config import root
from ..loader.fullbatch import FullBatchLoader
from ..standard_workflow import StandardWorkflow, sample_snapshotter_config

root.wine.setdefaults({
    "minibatch_size": 30,
    "layers": [
        {"type": "all2all_tanh", "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
        {"type": "softmax", "->": {"output_sample_shape": 3},
         "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
    ],
    "decision": {"max_epochs": 40, "fail_iterations": 20},
    "synthetic": {"n_train": 118, "n_valid": 30, "n_test": 30,
                  "noise": 0.5},
})


def _find_wine_csv() -> str | None:
    for cand in (root.common.get("wine_path"),
                 os.path.expanduser("~/.cache/wine.data")):
        if cand and os.path.exists(cand):
            return cand
    return None


class WineLoader(FullBatchLoader):
    """UCI wine.data CSV (label first, 13 features) when available, the
    deterministic synthetic stand-in with the same geometry otherwise."""

    FEATURES, CLASSES = 13, 3

    def __init__(self, name=None, synthetic_sizes=None, **kwargs):
        # the features span very different scales (proline ~1000s, hue
        # ~1): the mean/dispersion normalizer is essential
        kwargs.setdefault("normalization_type", "mean_disp")
        super().__init__(name=name or "wine_loader", **kwargs)
        self.synthetic_sizes = synthetic_sizes

    def load_data(self) -> None:
        path = _find_wine_csv()
        if path:
            self._load_real(path)
        else:
            self._load_synthetic()

    def _load_real(self, path: str) -> None:
        raw = np.loadtxt(path, delimiter=",", dtype=np.float32)
        labels = raw[:, 0].astype(np.int32) - 1       # 1..3 → 0..2
        data = raw[:, 1:]
        # deterministic shuffle, then the [test | valid | train] split
        order = prng.get("wine_split").permutation(len(raw))
        data, labels = data[order], labels[order]
        n = len(raw)
        n_test = n_valid = max(1, n // 6)
        self.original_data = np.ascontiguousarray(data)
        self.original_labels = np.ascontiguousarray(labels)
        self.class_lengths = [n_test, n_valid, n - n_test - n_valid]

    def _load_synthetic(self) -> None:
        cfg = self.synthetic_sizes or root.wine.synthetic.to_dict()
        n_test, n_valid, n_train = (cfg["n_test"], cfg["n_valid"],
                                    cfg["n_train"])
        noise = cfg.get("noise", 0.5)
        gen = prng.get("wine_synthetic")
        protos = gen.normal(0.0, 1.0, (self.CLASSES, self.FEATURES))
        n = n_test + n_valid + n_train
        labels = gen.randint(0, self.CLASSES, n).astype(np.int32)
        data = (protos[labels] + gen.normal(0.0, noise,
                                            (n, self.FEATURES)))
        # the real dataset's heterogeneous feature scales, so the
        # normalizer has work to do
        scales = 10.0 ** gen.uniform(-1.0, 3.0, (1, self.FEATURES))
        self.original_data = (data * scales).astype(np.float32)
        self.original_labels = labels
        self.class_lengths = [n_test, n_valid, n_train]


class WineWorkflow(StandardWorkflow):
    """13-feature MLP: tanh hidden layer, softmax."""

    def __init__(self, name="WineWorkflow", layers=None,
                 decision_config=None, snapshotter_config=None,
                 lr_adjuster_config=None, **kwargs):
        loader = WineLoader(
            minibatch_size=root.wine.get("minibatch_size", 30),
            **{k: v for k, v in kwargs.items()
               if k in ("synthetic_sizes",)})
        super().__init__(
            name,
            layers=layers or root.wine.get("layers"),
            loader=loader,
            loss_function="softmax",
            decision_config=decision_config
            or root.wine.decision.to_dict(),
            snapshotter_config=sample_snapshotter_config(
                root.wine, snapshotter_config),
            lr_adjuster_config=lr_adjuster_config)


def run(device=None, epochs: int | None = None, fused: bool = False,
        **kwargs) -> WineWorkflow:
    """Build, initialize and train on ``device`` (default: the CUDA card,
    raising without one; pass ``device="cpu"`` for the host, ``"numpy"``
    for the golden unit graph).  ``fused=False`` trains on the unit-graph
    tick loop, ``fused=True`` (the CLI's ``--fused``) on the fused path.
    Returns the finished workflow."""
    wf = WineWorkflow(**kwargs)
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
