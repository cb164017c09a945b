"""AlexNetWorkflow: the ImageNet AlexNet sample, BASELINE config 3 (port of
``znicz_tpu/models/alexnet.py``).

The 2012 geometry over 227×227×3 NHWC inputs: conv 11×11/4·96 → LRN →
max-pool 3/2 → conv 5×5·256 pad 2 → LRN → max-pool 3/2 → conv 3×3·384 →
conv 3×3·384 → conv 3×3·256 → max-pool 3/2 → dropout → fc 4096 → dropout
→ fc 4096 → softmax 1000, strict-ReLU activations, momentum SGD with
weight decay, batch 128; about 62.4 M parameters.  The fused step merges
each LRN with the pool after it and folds the conv's ReLU derivative into
the pair's backward (``parallel/fused.py`` ``_merge_lrn_pool``); the unit
graph runs one unit a layer, its LRN and pool units apart and its dropout
units on the counter-RNG kernel.

With ``data_dir`` (or ``root.alexnet.data_dir``) it trains from a
directory tree of images bigger than device memory, the reference's
on-the-fly ImageNet pipeline (``make_imagenet_loader``): ``train/``,
``valid/`` and ``test/`` subtrees of class directories, decoded per
minibatch at ``decode_size``² in a thread pool, random ``size``² crops and
mirrors at train time and center crops at eval, made on the card inside
the fused step (``StreamTrainer``).  Without it, ImageNet not being in the
repository, a seeded synthetic stand-in with the real tensor geometry
(per-class 8×8 prototypes upsampled, plus noise) is drawn from the
``"imagenet_synthetic"`` stream, bit-identical to the JAX package's for
the same seed.  Shapes and class count shrink through ``root.alexnet``
for tests.

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.alexnet --fused
[--epochs N] [--device cuda|cpu]`` (without ``--fused``: the unit graph)
"""

from __future__ import annotations

import os

import numpy as np

from .. import prng
from ..config import root
from ..loader.augment import RandomCropFlip
from ..loader.fullbatch import FullBatchLoader
from ..loader.streaming import OnTheFlyImageLoader
from ..standard_workflow import StandardWorkflow, sample_snapshotter_config


def make_layers(n_classes: int = 1000, lr: float = 0.01,
                moment: float = 0.9, wd: float = 5e-4,
                widths=(96, 256, 384, 384, 256, 4096, 4096)) -> list:
    """The AlexNet ``layers`` config; ``widths`` shrinks the net for
    tests."""
    gd = {"learning_rate": lr, "gradient_moment": moment,
          "weights_decay": wd}
    c1, c2, c3, c4, c5, f6, f7 = widths
    lrn = {"type": "norm", "->": {"n": 5, "alpha": 1e-4, "beta": 0.75,
                                  "k": 2.0}}
    pool = {"type": "max_pooling", "->": {"kx": 3, "ky": 3, "sliding": 2}}
    return [
        {"type": "conv_str",
         "->": {"n_kernels": c1, "kx": 11, "ky": 11, "sliding": 4},
         "<-": dict(gd)},
        dict(lrn), dict(pool),
        {"type": "conv_str",
         "->": {"n_kernels": c2, "kx": 5, "ky": 5, "padding": 2},
         "<-": dict(gd)},
        dict(lrn), dict(pool),
        {"type": "conv_str",
         "->": {"n_kernels": c3, "kx": 3, "ky": 3, "padding": 1},
         "<-": dict(gd)},
        {"type": "conv_str",
         "->": {"n_kernels": c4, "kx": 3, "ky": 3, "padding": 1},
         "<-": dict(gd)},
        {"type": "conv_str",
         "->": {"n_kernels": c5, "kx": 3, "ky": 3, "padding": 1},
         "<-": dict(gd)},
        dict(pool),
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "all2all_str", "->": {"output_sample_shape": f6},
         "<-": dict(gd)},
        {"type": "dropout", "->": {"dropout_ratio": 0.5}},
        {"type": "all2all_str", "->": {"output_sample_shape": f7},
         "<-": dict(gd)},
        {"type": "softmax", "->": {"output_sample_shape": n_classes},
         "<-": dict(gd)},
    ]


root.alexnet.setdefaults({
    "minibatch_size": 128,
    "size": 227,
    "n_classes": 1000,
    "layers": None,   # default: make_layers(n_classes)
    "decision": {"max_epochs": 10, "fail_iterations": 50},
    "synthetic": {"n_train": 512, "n_valid": 128, "n_test": 128,
                  "noise": 0.4},
    #: a directory tree of images (train/, valid/, test/ of class
    #: directories) for the on-the-fly ImageNet pipeline
    "data_dir": None,
    "decode_size": 256,
})

class ImagenetSyntheticLoader(FullBatchLoader):
    """Seeded synthetic stand-in with ImageNet tensor geometry: per-class
    prototypes plus noise at (size, size, 3) NHWC."""

    def __init__(self, name=None, size=227, n_classes=1000,
                 synthetic_sizes=None, **kwargs):
        kwargs.setdefault("normalization_type", "linear")
        super().__init__(name=name or "imagenet_loader", **kwargs)
        self.size = int(size)
        self.n_classes = int(n_classes)
        self.synthetic_sizes = synthetic_sizes

    def load_data(self) -> None:
        cfg = self.synthetic_sizes or root.alexnet.synthetic.to_dict()
        n_test, n_valid, n_train = (cfg["n_test"], cfg["n_valid"],
                                    cfg["n_train"])
        noise, s = cfg.get("noise", 0.4), self.size
        gen = prng.get("imagenet_synthetic")
        n = n_test + n_valid + n_train
        labels = gen.randint(0, self.n_classes, n).astype(np.int32)
        # low-res per-class prototypes, upsampled per sample (the draw
        # order of the reference, so the data is bit-identical)
        protos = gen.normal(0.0, 1.0, (self.n_classes, 8, 8, 3))
        rep = s // 8 + 1
        data = np.empty((n, s, s, 3), np.float32)
        for i in range(n):
            up = protos[labels[i]].repeat(rep, axis=0).repeat(rep, axis=1)
            data[i] = up[:s, :s, :] + gen.normal(0.0, noise, (s, s, 3))
        self.original_data = data
        self.original_labels = labels
        self.class_lengths = [n_test, n_valid, n_train]


def make_imagenet_loader(data_dir: str, size: int = 227,
                         decode_size: int = 256,
                         minibatch_size: int = 128):
    """The on-the-fly ImageNet pipeline: a disk tree bigger than device
    memory, decoded at ``decode_size``² in a thread pool, with counter-RNG
    random ``size``² crops and mirrors at train time (center crops at
    eval), streamed to the card by the prefetcher."""
    splits = {}
    for split, key in (("train", "train_paths"),
                       ("valid", "validation_paths"),
                       ("test", "test_paths")):
        p = os.path.join(data_dir, split)
        if os.path.isdir(p):
            splits[key] = [p]
    if "train_paths" not in splits:
        raise ValueError(f"{data_dir}: no train/ subtree")
    return OnTheFlyImageLoader(
        size=(decode_size, decode_size),
        augment=RandomCropFlip((size, size)),
        minibatch_size=minibatch_size, **splits)


class AlexNetWorkflow(StandardWorkflow):
    """BASELINE config 3: the ImageNet AlexNet training workflow."""

    def __init__(self, name="AlexNetWorkflow", layers=None,
                 decision_config=None, snapshotter_config=None,
                 lr_adjuster_config=None, data_dir=None, **kwargs):
        data_dir = data_dir or root.alexnet.get("data_dir")
        if data_dir:
            loader = make_imagenet_loader(
                data_dir,
                size=root.alexnet.get("size", 227),
                decode_size=root.alexnet.get("decode_size", 256),
                minibatch_size=root.alexnet.get("minibatch_size", 128))
        else:
            loader = ImagenetSyntheticLoader(
                minibatch_size=root.alexnet.get("minibatch_size", 128),
                size=root.alexnet.get("size", 227),
                n_classes=root.alexnet.get("n_classes", 1000),
                synthetic_sizes=kwargs.get("synthetic_sizes"))
        super().__init__(
            name,
            layers=layers or root.alexnet.get("layers")
            or make_layers(root.alexnet.get("n_classes", 1000)),
            loader=loader,
            loss_function="softmax",
            decision_config=decision_config
            or root.alexnet.decision.to_dict(),
            snapshotter_config=sample_snapshotter_config(
                root.alexnet, snapshotter_config),
            lr_adjuster_config=lr_adjuster_config)


def run(device=None, epochs: int | None = None, fused: bool = True,
        mesh=None, **kwargs) -> AlexNetWorkflow:
    """Build, initialize and train on ``device`` (default: the CUDA card,
    raising without one; pass ``device="cpu"`` for the host, ``"numpy"``
    for the golden unit graph).  ``fused=True`` (the default, as the
    reference's) trains on the fused path, ``fused=False`` on the unit
    graph; ``mesh`` (a ``parallel.mesh.Mesh`` or a (dp, tp) shape) lays
    the fused step over the run's ranks.  Returns the finished
    workflow."""
    wf = AlexNetWorkflow(**kwargs)
    if epochs is not None:
        wf.decision.max_epochs = epochs
    wf.initialize(device=device)
    wf.train(fused=fused, mesh=mesh, max_epochs=epochs)
    return wf


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="auto",
                        choices=("auto", "cuda", "cpu", "numpy"))
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--unit-graph", action="store_true",
                        help="the per-unit tick loop instead of the fused "
                             "step")
    args = parser.parse_args(argv)
    wf = run(device=args.device, epochs=args.epochs,
             fused=not args.unit_graph)
    for m in wf.decision.epoch_metrics:
        print(m)


if __name__ == "__main__":
    main()
