"""KohonenWorkflow: the self-organizing-map sample, BASELINE config 5 (port
of ``znicz_tpu/models/kohonen.py``).

loader → KohonenForward (winner-take-all) → KohonenTrainer (neighborhood
pull) → KohonenDecision (weight-change stop), one minibatch a tick, with no
gradient chain.  The data are 2-D points from a seeded mixture of gaussian
clusters drawn from the ``"kohonen_synthetic"`` stream, bit-identical to
the JAX package's for the same seed; after training the 8×8 neuron sheet
unfolds over the clusters and the quantization error drops.

``run(fused=False)`` (the default) trains on the unit graph;
``run(fused=True)`` (the CLI's ``--fused``) runs ``run_fused``, whole
epochs on the device through ``parallel/som.py``, whose steps find their
winners with the hand-written distance→argmin kernel on the card.

Run:  ``python -m znicz_tpu_torch znicz_tpu_torch.models.kohonen [--fused]
[--epochs N] [--device cuda|cpu|numpy]``
"""

from __future__ import annotations

import time

import numpy as np

from .. import prng
from ..accelerated_units import AcceleratedWorkflow
from ..config import root
from ..loader.base import TRAIN
from ..loader.fullbatch import FullBatchLoader
from ..logger import MetricsWriter
from ..nn.kohonen import (KohonenDecision, KohonenForward, KohonenTrainer,
                          make_train_only_gate)
from ..ops import kohonen as som_ops

root.kohonen.setdefaults({
    "minibatch_size": 100,
    "shape": (8, 8),
    "learning_rate": 0.5,
    "decision": {"max_epochs": 30, "epsilon": 1e-4},
    "synthetic": {"n_train": 2000, "n_clusters": 5, "noise": 0.08},
})


def _mesh_shape(ms):
    """``root.common.mesh_shape`` as a tuple: a ``"dp[,tp]"`` string (the
    launcher's ``--mesh``) or a sequence; None when unset or unreadable."""
    if isinstance(ms, str):
        try:
            parts = [int(p) for p in ms.split(",") if p.strip()]
        except ValueError:
            return None
        return (parts[0], parts[1] if len(parts) > 1 else 1) \
            if 1 <= len(parts) <= 2 else None
    return None if ms is None else tuple(ms)


class SOMLoader(FullBatchLoader):
    """Seeded 2-D gaussian-cluster mixture; train set only."""

    def load_data(self) -> None:
        cfg = root.kohonen.synthetic.to_dict()
        gen = prng.get("kohonen_synthetic")
        k, n = cfg["n_clusters"], cfg["n_train"]
        centers = gen.uniform(-1.0, 1.0, (k, 2))
        which = gen.randint(0, k, n)
        pts = centers[which] + gen.normal(0.0, cfg["noise"], (n, 2))
        self.original_data = pts.astype(np.float32)
        self.original_labels = which.astype(np.int32)
        self.class_lengths = [0, 0, n]


class KohonenWorkflow(AcceleratedWorkflow):
    """BASELINE config 5: the SOM minibatch loop."""

    def __init__(self, workflow=None, name="KohonenWorkflow", shape=None,
                 decision_config=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.metrics_writer = MetricsWriter()
        shape = shape or root.kohonen.shape
        self.loader = SOMLoader(
            self, minibatch_size=root.kohonen.get("minibatch_size", 100))
        self.loader.link_from(self.start_point)
        self.forward = KohonenForward(self, name="kohonen_forward",
                                      shape=shape)
        self.forward.link_attrs(self.loader, ("input", "minibatch_data"))
        self.forward.link_from(self.loader)
        self.trainer = KohonenTrainer(
            self, name="kohonen_trainer",
            learning_rate=root.kohonen.get("learning_rate", 0.5))
        self.trainer.setup_from_forward(self.forward)
        self.trainer.link_from(self.forward)
        cfg = decision_config or root.kohonen.decision.to_dict()
        self.decision = KohonenDecision(self, name="decision", **cfg)
        self.decision.link_loader(self.loader)
        self.decision.link_trainer(self.trainer)
        self.decision.link_from(self.trainer)
        self.trainer.gate_skip = make_train_only_gate(self.loader,
                                                      self.decision)
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete
        self.loader.link_from(self.decision)   # the minibatch loop's edge

    def quantization_error(self) -> float:
        x = self.loader.original_data.cpu().numpy()
        return som_ops.np_quantization_error(x.reshape(len(x), -1),
                                             self.forward.weights.mem)

    # -- the fused path -------------------------------------------------------
    def run_fused(self, max_epochs: int | None = None):
        """Whole epochs on the device (``parallel.som``), the Decision's stop
        logic on the host between epochs; the same shuffle stream as the
        unit graph.  Returns the FusedSOMTrainer."""
        from ..parallel.som import FusedSOMTrainer

        if not self.initialized:
            raise RuntimeError("initialize() first")
        if not self.device.is_torch:
            raise ValueError("the fused path trains on a torch device (cuda "
                             "or cpu); the numpy device runs the unit graph")
        ms = _mesh_shape(root.common.get("mesh_shape"))
        if ms is not None and ms != (1, 1):
            # the SOM has no mesh path: a --mesh must not pass silently
            self.warning("the kohonen SOM fused path has no mesh support; "
                         "--mesh is ignored and training runs on one "
                         "device")
        tr = FusedSOMTrainer(self.forward.weights.mem, self.forward.shape,
                             device=self.device.torch_device)
        loader, decision = self.loader, self.decision
        data = loader.original_data
        epochs = max_epochs or decision.max_epochs or 30
        batch = loader.max_minibatch_size
        first = True
        for epoch in range(loader.epoch_number, epochs):
            t0 = time.monotonic()
            loader.epoch_number = epoch
            if not first:   # initialize() built epoch 0's plan
                loader._build_epoch_plan()
            first = False
            lr, sigma = self.trainer.schedules()
            perm = loader._shuffled[TRAIN]
            syncs = tr.host_syncs
            diff = tr.train_epoch(data, perm, batch, lr, sigma)
            wall = time.monotonic() - t0
            decision.epoch_metrics.append(
                {"epoch": epoch, "weights_diff": diff})
            self.metrics_writer.write(kind="epoch", epoch=epoch,
                                      weights_diff=diff)
            self.epoch_timings.append({
                "epoch": epoch, "wall_s": wall,
                "steps": len(perm) // batch,
                "train_examples_per_sec": (len(perm) // batch) * batch
                / wall if wall > 0 else None,
                "host_syncs": tr.host_syncs - syncs})
            if diff < decision.epsilon:
                break
        decision.complete.set(True)
        tr.write_back(self.forward)
        return tr


def run(device=None, epochs: int | None = None, fused: bool = False,
        **kwargs) -> KohonenWorkflow:
    """Build, initialize and train on ``device`` (default: the CUDA card,
    raising without one; ``"cpu"`` for the host, ``"numpy"`` for the
    golden unit graph); ``fused=True`` trains through :meth:`run_fused`.
    Returns the finished workflow."""
    wf = KohonenWorkflow(**kwargs)
    if epochs is not None:
        wf.decision.max_epochs = epochs
    wf.initialize(device=device)
    if fused:
        wf.run_fused()
    else:
        wf.run()
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
    for m in wf.decision.epoch_metrics[-5:]:
        print(m)
    print("quantization error:", wf.quantization_error())


if __name__ == "__main__":
    main()
