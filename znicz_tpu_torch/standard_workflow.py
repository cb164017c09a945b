"""StandardWorkflow: declarative model assembly and the fused training loop
(port of ``znicz_tpu/standard_workflow.py``).

A ``layers=[{"type": ..., "->": {...}, "<-": {...}}, ...]`` config becomes
a ``ModelSpec`` plus ``(w, b)`` parameters and zero velocities, filled from
the ``"weights"`` stream exactly as the reference's units fill them, so the
same seed gives the same initial weights in both packages.  There is no
unit graph yet (ROADMAP.md queue 1 item 4): ``train(fused=True)`` runs
``run_fused``, the port of the reference's ``_run_fused_body`` for a
resident loader, and ``train(fused=False)`` raises."""

from __future__ import annotations

import time

import numpy as np
import torch

from . import backends, prng
from .loader.base import CLASS_NAMES, TEST, TRAIN, VALID
from .nn.decision import DecisionGD, DecisionMSE
from .parallel import fused
from .parallel.fused import FusedTrainer, LayerSpec, ModelSpec

#: StandardWorkflow layer type → activation of the fc layer.  The last
#: layer of a softmax model keeps "linear": its softmax is fused with CE.
FC_TYPES = {"all2all": "linear", "all2all_tanh": "tanh",
            "all2all_relu": "relu", "all2all_str": "strict_relu",
            "all2all_sigmoid": "sigmoid", "softmax": "linear"}

_UNIT_GRAPH = "ROADMAP.md queue 1 item 4 (core engine: the unit graph)"


def _fill(gen, shape: tuple[int, ...], filling: str,
          stddev: float | None) -> np.ndarray:
    """The reference's ``Forward._fill`` (nn/nn_units.py): uniform ±stddev
    (default 1/sqrt(fan_in)), gaussian or constant, from ``gen``."""
    fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
    stddev = stddev if stddev is not None else 1.0 / max(
        np.sqrt(fan_in), 1.0)
    if filling == "uniform":
        return gen.uniform(-stddev, stddev, shape)
    if filling == "gaussian":
        return gen.normal(0.0, stddev, shape)
    if filling == "constant":
        return np.full(shape, stddev, np.float32)
    raise ValueError(f"unknown filling {filling!r}")


def _gd_hypers(cfg: dict) -> tuple[tuple, tuple]:
    """(hypers, hypers_bias) from a layer's ``"<-"`` dict with the defaults
    of the reference's ``GradientDescentBase.__init__``."""
    lr = cfg.get("learning_rate", 0.01)
    mom = cfg.get("gradient_moment", 0.0)
    lr_b = cfg.get("learning_rate_bias")
    mom_b = cfg.get("gradient_moment_bias")
    hypers = (lr, cfg.get("weights_decay", 0.0), cfg.get("l1_vs_l2", 0.0),
              mom)
    hypers_bias = (lr if lr_b is None else lr_b,
                   cfg.get("weights_decay_bias", 0.0),
                   cfg.get("l1_vs_l2_bias", 0.0),
                   mom if mom_b is None else mom_b)
    unknown = set(cfg) - {"learning_rate", "learning_rate_bias",
                          "weights_decay", "weights_decay_bias", "l1_vs_l2",
                          "l1_vs_l2_bias", "gradient_moment",
                          "gradient_moment_bias"}
    if unknown:
        raise NotImplementedError(
            f"gradient options {sorted(unknown)} are not ported yet "
            f"({_UNIT_GRAPH})")
    return hypers, hypers_bias


class StandardWorkflow:
    """One-call assembly of a fc model trained on the fused path."""

    def __init__(self, name=None, layers=None, loader=None,
                 loss_function="softmax", decision_config=None,
                 snapshotter_config=None, lr_adjuster_config=None):
        if snapshotter_config is not None:
            raise NotImplementedError(
                "snapshots are not ported yet (" + _UNIT_GRAPH + ")")
        if lr_adjuster_config is not None:
            raise NotImplementedError(
                "learning-rate adjusters are not ported yet ("
                + _UNIT_GRAPH + ")")
        if loss_function not in ("softmax", "mse"):
            raise ValueError(loss_function)
        self.name = name or type(self).__name__
        self.layers_config = list(layers or [])
        self.loss_function = loss_function
        self.loader = loader
        decision_config = (decision_config.to_dict()
                           if hasattr(decision_config, "to_dict")
                           else dict(decision_config or {}))
        cls = DecisionGD if loss_function == "softmax" else DecisionMSE
        self.decision = cls(**decision_config)
        self.device: torch.device | None = None
        self.spec: ModelSpec | None = None
        self.params: list = []
        self.vels: list = []
        #: per-epoch throughput of run_fused: train_examples_per_sec and
        #: train_step_time_ms (kept out of the metrics dicts so those stay
        #: comparable with the reference)
        self.epoch_timings: list[dict] = []
        self.initialized = False

    def initialize(self, device=None) -> None:
        """Load the data onto ``device`` (default: CUDA, raising without
        it) and build spec, params and velocities."""
        self.device = backends.resolve(device)
        self.loader.initialize(self.device)
        self._build_model()
        self.initialized = True

    def _build_model(self) -> None:
        gen = prng.get("weights")
        n_in = int(np.prod(self.loader.original_data.shape[1:]))
        layers, params, vels = [], [], []
        for i, spec in enumerate(self.layers_config):
            ltype = spec["type"]
            if ltype not in FC_TYPES:
                raise NotImplementedError(
                    f"layer type {ltype!r} is not ported to znicz_tpu_torch "
                    f"yet (ROADMAP.md queue 1 item 5 for the conv stack, "
                    f"{_UNIT_GRAPH} for the rest); ported: "
                    f"{sorted(FC_TYPES)}")
            if ltype == "softmax" and i != len(self.layers_config) - 1:
                raise NotImplementedError(
                    "a softmax layer must be the last layer")
            fwd = dict(spec.get("->", {}))
            out = fwd.pop("output_sample_shape", None)
            if out is None:
                raise ValueError("output_sample_shape is required")
            fwd.pop("output_samples_number", None)   # reference alias
            neurons = int(np.prod(out))
            include_bias = fwd.pop("include_bias", True)
            w_fill = fwd.pop("weights_filling", "uniform")
            w_std = fwd.pop("weights_stddev", None)
            b_fill = fwd.pop("bias_filling", "uniform")
            b_std = fwd.pop("bias_stddev", None)
            if fwd:
                raise NotImplementedError(
                    f"layer options {sorted(fwd)} are not ported yet "
                    f"({_UNIT_GRAPH})")
            # Forward.create_weights: W, then (when there is a bias) a draw
            # of the bias shape that the default uniform fill discards for
            # zeros — the draw still advances the stream
            w = _fill(gen, (n_in, neurons), w_fill, w_std)
            b = None
            if include_bias:
                b = _fill(gen, (neurons,), b_fill,
                          b_std if b_std is not None else 0.0)
                if b_fill == "uniform" and b_std is None:
                    b = np.zeros((neurons,), np.float32)
            hypers, hypers_bias = _gd_hypers(dict(spec.get("<-", {})))
            layers.append(LayerSpec(kind="fc", activation=FC_TYPES[ltype],
                                    include_bias=include_bias,
                                    hypers=hypers, hypers_bias=hypers_bias))
            dev = self.device
            params.append((torch.from_numpy(w).to(dev),
                           None if b is None else torch.from_numpy(b).to(dev)))
            vels.append((torch.zeros(w.shape, device=dev),
                         None if b is None
                         else torch.zeros(b.shape, device=dev)))
            n_in = neurons
        self.spec = ModelSpec(tuple(layers), self.loss_function)
        self.params, self.vels = params, vels

    # -- training ------------------------------------------------------------
    def train(self, fused: bool = False, mesh=None, mesh_shape=None,
              max_epochs: int | None = None,
              compute_dtype: str | None = None,
              storage_dtype: str | None = None):
        """``fused=True`` runs :meth:`run_fused`; the unit-graph tick loop
        (``fused=False``) is not ported yet and raises.  The dtypes default
        from ``root.common.compute_dtype``/``storage_dtype``."""
        from .config import root
        if not fused:
            raise NotImplementedError(
                "the unit-graph tick loop (train(fused=False)) is not "
                f"ported yet ({_UNIT_GRAPH}); pass fused=True")
        if mesh is not None or mesh_shape is not None \
                or root.common.get("mesh_shape") is not None:
            raise NotImplementedError(
                "mesh-sharded training is not ported yet (ROADMAP.md "
                "queue 1 item 9, parallelism)")
        if compute_dtype is None:
            compute_dtype = root.common.get("compute_dtype")
        if storage_dtype is None:
            storage_dtype = root.common.get("storage_dtype")
        return self.run_fused(max_epochs=max_epochs,
                              compute_dtype=compute_dtype,
                              storage_dtype=storage_dtype)

    def run_fused(self, max_epochs: int | None = None,
                  compute_dtype: str | None = None,
                  storage_dtype: str | None = None) -> FusedTrainer:
        """Train on the fused path: whole epochs on the device, with the
        decision's improvement/stop logic between epochs on the host.
        Returns the FusedTrainer; its params are written back into
        ``self.params``/``self.vels``."""
        import dataclasses

        from .config import root
        if not self.initialized:
            raise RuntimeError("initialize() first")
        if int(root.common.get("accum_steps") or 1) != 1:
            raise NotImplementedError(
                "gradient accumulation is not ported yet (ROADMAP.md "
                "queue 1 item 3, remaining)")
        spec = self.spec
        if compute_dtype is not None:
            spec = dataclasses.replace(spec, compute_dtype=compute_dtype)
        if storage_dtype is not None:
            spec = dataclasses.replace(spec, storage_dtype=storage_dtype)
        trainer = FusedTrainer(workflow=self, spec=spec, params=self.params,
                               vels=self.vels, device=self.device)
        loader, decision = self.loader, self.decision
        data = loader.original_data
        target = (loader.original_targets if self.loss_function == "mse"
                  else loader.original_labels)
        bounds = np.cumsum([0] + list(loader.class_lengths))
        cls_idx = {k: np.arange(bounds[k], bounds[k + 1])
                   for k in (TEST, VALID, TRAIN)}
        batch = loader.max_minibatch_size
        # an explicit 0 means "stop after the first evaluation"; only None
        # falls through to the decision's limit
        epochs = max_epochs if max_epochs is not None \
            else decision.max_epochs
        if epochs is None:
            epochs = 10
        first = True
        # Unit-graph parity for the stop tick: in the tick where Decision
        # sets ``complete`` the GD units are gate-skipped, so the LAST train
        # minibatch of the final epoch never updates weights.  The fused
        # loop reproduces this by deferring each epoch's last minibatch
        # update until it knows training continues.
        pending = None
        for epoch in range(loader.epoch_number, epochs):
            t_epoch0 = time.monotonic()
            loader.epoch_number = epoch
            if not first:   # initialize() already built epoch 0's plan
                loader._build_epoch_plan()
            first = False
            perm = loader._shuffled[TRAIN]
            n_train = len(cls_idx[TRAIN])
            steps_per_epoch = max(1, -(-n_train // batch))
            if pending is not None:
                trainer.train_epoch(data, target, pending, batch, sync=False)
            split = ((n_train - 1) // batch) * batch
            head, tail = perm[:split], perm[split:]
            # everything below stays on the device until the one readback
            runs = {}
            if len(head):
                runs["head"] = trainer.train_epoch(data, target, head, batch,
                                                   sync=False)
            # the tail minibatch's metrics come from a forward pass over the
            # post-head weights — the weights the unit graph's evaluator saw
            # before the (skipped-or-deferred) update
            runs["tail"] = trainer.eval_epoch(data, target, tail, batch,
                                              sync=False)
            pending = tail
            for k in (VALID, TEST):
                if len(cls_idx[k]):
                    runs[k] = trainer.eval_epoch(data, target, cls_idx[k],
                                                 batch, sync=False)
            host = dict(zip(runs, fused.to_host(*runs.values())))
            tm = host.get("head", {"loss": np.zeros((0,), np.float32),
                                   "n_err": np.zeros((0,), np.int32)})
            metrics = {"epoch": epoch}
            metrics["train_loss"] = float(
                np.concatenate([tm["loss"], host["tail"]["loss"]]).mean())
            metrics["train_n_err"] = int(tm["n_err"].sum()
                                         + host["tail"]["n_err"].sum())
            metrics["train_err_pct"] = 100.0 * metrics["train_n_err"] \
                / max(n_train, 1)
            for k in (VALID, TEST):
                if k not in host:
                    continue
                name = CLASS_NAMES[k]
                metrics[f"{name}_loss"] = float(host[k]["loss"].mean())
                metrics[f"{name}_n_err"] = int(host[k]["n_err"].sum())
                metrics[f"{name}_err_pct"] = (100.0
                                              * metrics[f"{name}_n_err"]
                                              / len(cls_idx[k]))
            if self.loss_function == "mse":
                metrics["train_mse"] = metrics["train_loss"]
                if "validation_loss" in metrics:
                    metrics["validation_mse"] = metrics["validation_loss"]
            decision.epoch_metrics.append(metrics)
            loader.epoch_number = epoch + 1
            epoch_s = time.monotonic() - t_epoch0
            if epoch_s > 0:
                self.epoch_timings.append({
                    "epoch": epoch,
                    "train_examples_per_sec": n_train / epoch_s,
                    "train_step_time_ms": epoch_s / steps_per_epoch * 1e3})
            improved = decision.better_than_best(metrics)
            decision.improved = improved
            decision._fails = 0 if improved else decision._fails + 1
            if decision._fails >= decision.fail_iterations:
                break
        decision.complete = True
        trainer.write_back()
        return trainer
