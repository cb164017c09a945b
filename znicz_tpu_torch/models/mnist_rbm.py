"""MnistRBMWorkflow: greedy stacked-RBM pretraining and a sigmoid-MLP
fine-tune (port of ``znicz_tpu/models/mnist_rbm.py``).

Each RBM of the stack (784→256→64 by default) trains by CD-1 through
``parallel.rbm.FusedRBMTrainer`` (on the card each step a replay of one
CUDA graph), each level on the previous level's hidden probabilities;
the (W, hbias) pairs then initialize an ``all2all_sigmoid`` MLP with a
softmax head, fine-tuned by the ordinary ``StandardWorkflow`` gradient
chain: the unit graph by default, as the reference's ``run(fused=False)``
does, or the fused path.

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.mnist_rbm
[--fused] [--epochs N] [--device cuda|cpu|numpy]``; the module's own
``main`` also takes ``--no-pretrain``.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from .. import prng
from ..config import root
from ..standard_workflow import StandardWorkflow, sample_snapshotter_config
from .mnist import MnistLoader

root.mnist_rbm.setdefaults({
    "minibatch_size": 100,
    "hidden": [256, 64],            # stacked RBM sizes (784→256→64)
    # CD needs enough epochs to learn features: an undertrained RBM hands
    # the MLP a smaller-than-random init, and too high a learning rate
    # collapses the hidden biases
    "pretrain": {"epochs": 10, "learning_rate": 0.1, "momentum": 0.5,
                 "weights_decay": 2e-4},
    "layers": None,                 # derived from `hidden` when None
    "decision": {"max_epochs": 6, "fail_iterations": 20},
    "synthetic": {"n_train": 5000, "n_valid": 1000, "n_test": 1000,
                  "noise": 0.35},
})


def _mlp_layers(hidden) -> list:
    # the sigmoid's derivative tops out at 0.25 a layer (tanh's at 1), so
    # the working learning rate is well above the tanh sample's 0.03
    layers = [{"type": "all2all_sigmoid",
               "->": {"output_sample_shape": h},
               "<-": {"learning_rate": 0.5, "gradient_moment": 0.9}}
              for h in hidden]
    layers.append({"type": "softmax", "->": {"output_sample_shape": 10},
                   "<-": {"learning_rate": 0.5, "gradient_moment": 0.9}})
    return layers


def pretrain_stack(data, hidden, *, epochs=3, learning_rate=0.1,
                   momentum=0.5, weights_decay=2e-4, batch=100, device=None,
                   trainers=None) -> list:
    """Greedy layer-wise CD-1 pretraining on ``device`` (default: the CUDA
    card, raising without one); returns [(W, hbias), …] as numpy arrays.

    ``data`` (numpy or a tensor) rows are the visible units; each level
    trains on the previous level's hidden probabilities.  Binary RBMs
    model probabilities, so the data is min-max scaled into [0, 1] for
    level 0 and the affine map folded back into level 0's returned
    weights, exactly as the reference folds it: the installed layer then
    gives the pretrained hidden probabilities on the unscaled inputs the
    MLP is fed.  ``trainers``, a list, receives each level's
    ``FusedRBMTrainer`` (the caller reads their epoch timings, host
    syncs and graphs)."""
    if device is None:
        from ..backends import resolve
        device = resolve(None)
    gen = prng.get("rbm")
    v = torch.as_tensor(data).to(device, torch.float32)
    v = v.reshape(len(v), -1)
    lo, hi = np.float32(v.min().item()), np.float32(v.max().item())
    # the reference's float32 arithmetic of the two constants
    a, b = 1.0 / ((hi - lo) or 1.0), -lo / ((hi - lo) or 1.0)
    a, b = np.float32(a), np.float32(b)
    v = v * float(a) + float(b)
    from ..parallel.rbm import FusedRBMTrainer
    from ..ops import rbm as rbm_ops
    out = []
    for level, n_hidden in enumerate(hidden):
        n_visible = v.shape[1]
        w0 = gen.normal(0.0, 0.01, (n_visible, n_hidden))
        tr = FusedRBMTrainer(
            w0, np.zeros(n_visible, np.float32),
            np.zeros(n_hidden, np.float32), seed=gen.stream_seed,
            unit_id=zlib.crc32(f"rbm_pre{level}".encode()),
            learning_rate=learning_rate, momentum=momentum,
            weights_decay=weights_decay, device=device)
        if trainers is not None:
            trainers.append(tr)
        idx = np.arange(len(v))
        for epoch in range(epochs):
            tr.train_epoch(v, idx, batch, epoch)
        w = tr.params[0].cpu().numpy()
        hb = tr.params[2].cpu().numpy()
        if level == 0:
            # σ((a·x+b)·W + c) = σ(x·(a·W) + (c + b·ΣᵢWᵢ)), exact
            hb = hb + b * w.sum(axis=0)
            w = a * w
        out.append((w, hb))
        # the next level trains on this level's hidden probabilities
        with torch.no_grad():
            v = rbm_ops.hidden_probs(v, tr.params[0], tr.params[2])
    return out


class MnistRBMWorkflow(StandardWorkflow):
    """A sigmoid MLP whose hidden layers take RBM-pretrained weights."""

    def __init__(self, name="MnistRBMWorkflow", layers=None,
                 decision_config=None, snapshotter_config=None,
                 lr_adjuster_config=None, **kwargs):
        loader = MnistLoader(
            minibatch_size=root.mnist_rbm.get("minibatch_size", 100),
            synthetic_sizes=kwargs.get("synthetic_sizes")
            or root.mnist_rbm.synthetic.to_dict())
        super().__init__(
            name,
            layers=layers or root.mnist_rbm.get("layers")
            or _mlp_layers(root.mnist_rbm.get("hidden", [256, 64])),
            loader=loader,
            loss_function="softmax",
            decision_config=decision_config
            or root.mnist_rbm.decision.to_dict(),
            snapshotter_config=sample_snapshotter_config(
                root.mnist_rbm, snapshotter_config),
            lr_adjuster_config=lr_adjuster_config)
        #: the last ``pretrain``'s ``FusedRBMTrainer`` a level
        self.pretrain_trainers: list = []

    def install_pretrained(self, stack) -> None:
        """Copy pretrained (W, hbias) pairs into the hidden layers'
        Vectors (after ``initialize()``)."""
        for unit, (w, hb) in zip(self.forwards, stack):
            if unit.weights.mem.shape != w.shape:
                raise ValueError(f"{unit.name}: pretrained {w.shape} vs "
                                 f"layer {unit.weights.mem.shape}")
            unit.weights.mem = np.asarray(w, np.float32)
            unit.bias.mem = np.asarray(hb, np.float32)

    def pretrain(self) -> list:
        """The stack of ``root.mnist_rbm.hidden`` pretrained on the TRAIN
        split only (the data is laid out [test | valid | train], and CD
        must not see the evaluation rows), on the workflow's device (the
        host's torch device for the numpy device); returns it, its
        trainers kept in ``pretrain_trainers``."""
        cfg = root.mnist_rbm.pretrain.to_dict()
        ld = self.loader
        n_eval = sum(ld.class_lengths[:2])
        data = ld.original_data
        device = (self.device.torch_device if self.device.is_torch
                  else "cpu")
        self.pretrain_trainers = []
        return pretrain_stack(
            data[n_eval:], root.mnist_rbm.get("hidden", [256, 64]),
            epochs=cfg.get("epochs", 3),
            learning_rate=cfg.get("learning_rate", 0.1),
            momentum=cfg.get("momentum", 0.5),
            weights_decay=cfg.get("weights_decay", 2e-4),
            batch=ld.max_minibatch_size, device=device,
            trainers=self.pretrain_trainers)


def run(device=None, epochs: int | None = None, pretrain: bool = True,
        fused: bool = False, **kwargs) -> MnistRBMWorkflow:
    """Pretrain the stack (optional), install it and fine-tune on
    ``device`` (default: the CUDA card, raising without one; ``"cpu"`` for
    the host, ``"numpy"`` for the golden unit graph, its pretraining on
    the host's torch); returns the finished workflow."""
    wf = MnistRBMWorkflow(**kwargs)
    if epochs is not None:
        wf.decision.max_epochs = epochs
    wf.initialize(device=device)
    if pretrain:
        wf.install_pretrained(wf.pretrain())
    wf.train(fused=fused, max_epochs=epochs)
    return wf


def main(argv: list[str] | None = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="auto",
                        choices=("auto", "cuda", "cpu", "numpy"))
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--fused", action="store_true")
    parser.add_argument("--no-pretrain", action="store_true")
    args = parser.parse_args(argv)
    wf = run(device=args.device, epochs=args.epochs, fused=args.fused,
             pretrain=not args.no_pretrain)
    for m in wf.decision.epoch_metrics:
        print(m)


if __name__ == "__main__":
    main()
