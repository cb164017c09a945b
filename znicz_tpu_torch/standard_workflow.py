"""StandardWorkflow: declarative model assembly and the fused training loop
(port of ``znicz_tpu/standard_workflow.py``).

A ``layers=[{"type": ..., "->": {...}, "<-": {...}}, ...]`` config becomes
a ``ModelSpec`` plus ``(w, b)`` parameters and zero velocities, filled from
the ``"weights"`` stream exactly as the reference's units fill them, so the
same seed gives the same initial weights in both packages.  ``params`` and
``vels`` keep one pair per configured layer; the spec merges each LRN with
the max pool after it (``fused._merge_lrn_pool``), and its ``unit_index``
maps the spec's rows back to the layers.  There is no
unit graph yet (ROADMAP.md queue 1 item 4): ``train(fused=True)`` runs
``run_fused``, the port of the reference's ``_run_fused_body`` for a
resident loader, and ``train(fused=False)`` raises."""

from __future__ import annotations

import dataclasses
import time
import zlib

import numpy as np
import torch

from . import backends, prng
from .loader.base import CLASS_NAMES, TEST, TRAIN, VALID
from .nn.decision import DecisionGD, DecisionMSE
from .ops.geometry import norm2, out_size
from .parallel import fused
from .parallel.fused import FusedTrainer, LayerSpec, ModelSpec

#: StandardWorkflow layer type → activation of the fc layer.  The last
#: layer of a softmax model keeps "linear": its softmax is fused with CE.
FC_TYPES = {"all2all": "linear", "all2all_tanh": "tanh",
            "all2all_relu": "relu", "all2all_str": "strict_relu",
            "all2all_sigmoid": "sigmoid", "softmax": "linear"}
#: Conv layer type → activation (nn/conv.py).
CONV_TYPES = {"conv": "linear", "conv_tanh": "tanh", "conv_relu": "relu",
              "conv_str": "strict_relu", "conv_sigmoid": "sigmoid"}
#: Pooling layer type → fused kind (nn/pooling.py).
POOL_TYPES = {"max_pooling": "max_pool", "maxabs_pooling": "maxabs_pool",
              "avg_pooling": "avg_pool"}
LRN_TYPES = ("norm", "lrn")
PORTED_TYPES = (*FC_TYPES, *CONV_TYPES, *POOL_TYPES, *LRN_TYPES, "dropout")

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


def _no_options_left(fwd: dict) -> None:
    if fwd:
        raise NotImplementedError(
            f"layer options {sorted(fwd)} are not ported yet ({_UNIT_GRAPH})")


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
    """One-call assembly of a fc or conv model trained on the fused
    path."""

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
        """Spec, params and zero velocities from ``layers_config``; shapes
        propagate per sample in NHWC, and the ``"weights"`` stream is drawn
        in the order the reference's units draw it."""
        gen = prng.get("weights")
        shape = tuple(int(s) for s in self.loader.original_data.shape[1:])
        layers, params, vels = [], [], []
        for i, spec in enumerate(self.layers_config):
            ltype = spec["type"]
            fwd = dict(spec.get("->", {}))
            if ltype in FC_TYPES:
                if ltype == "softmax" and i != len(self.layers_config) - 1:
                    raise NotImplementedError(
                        "a softmax layer must be the last layer")
                kind, act, config, pair, shape = self._fc(ltype, fwd,
                                                          shape, gen)
            elif ltype in CONV_TYPES:
                kind, act, config, pair, shape = self._conv(ltype, fwd,
                                                            shape, gen)
            elif ltype in POOL_TYPES:
                kind, act, pair = POOL_TYPES[ltype], "linear", None
                config, shape = self._pool(ltype, fwd, shape)
            elif ltype in LRN_TYPES:
                kind, act, pair = "lrn", "linear", None
                config = self._lrn(fwd)
            elif ltype == "dropout":
                kind, act, pair = "dropout", "linear", None
                config = self._dropout(i, fwd)
            else:
                raise NotImplementedError(
                    f"layer type {ltype!r} is not ported to znicz_tpu_torch "
                    f"yet (ROADMAP.md queue 1 item 5 for the rest of the "
                    f"conv stack, {_UNIT_GRAPH} for the rest); ported: "
                    f"{sorted(PORTED_TYPES)}")
            _no_options_left(fwd)
            hypers, hypers_bias = _gd_hypers(dict(spec.get("<-", {})))
            layers.append(LayerSpec(
                kind=kind, activation=act,
                include_bias=pair is not None and pair[1] is not None,
                hypers=hypers, hypers_bias=hypers_bias, config=config))
            dev = self.device
            if pair is None:
                params.append((None, None))
                vels.append((None, None))
            else:
                w, b = pair
                params.append((torch.from_numpy(w).to(dev),
                               None if b is None
                               else torch.from_numpy(b).to(dev)))
                vels.append((torch.zeros(w.shape, device=dev),
                             None if b is None
                             else torch.zeros(b.shape, device=dev)))
        layers, _, _, unit_index = fused._merge_lrn_pool(layers, params,
                                                         vels)
        self.spec = ModelSpec(tuple(layers), self.loss_function,
                              unit_index=unit_index)
        self.params, self.vels = params, vels

    @staticmethod
    def _weights(fwd: dict, w_shape, b_shape, gen, w_fill_default):
        """Forward.create_weights: W, then (when there is a bias) a draw of
        the bias shape that the default uniform fill discards for zeros —
        the draw still advances the stream.  Pops the fill options."""
        include_bias = fwd.pop("include_bias", True)
        w_fill = fwd.pop("weights_filling", w_fill_default)
        w_std = fwd.pop("weights_stddev", None)
        b_fill = fwd.pop("bias_filling", "uniform")
        b_std = fwd.pop("bias_stddev", None)
        w = _fill(gen, w_shape, w_fill, w_std)
        b = None
        if include_bias:
            b = _fill(gen, b_shape, b_fill, b_std if b_std is not None
                      else 0.0)
            if b_fill == "uniform" and b_std is None:
                b = np.zeros(b_shape, np.float32)
        return w, b

    def _fc(self, ltype, fwd, shape, gen):
        """All2All: W (n_in, neurons), uniform fill by default →
        (kind, activation, config, (w, b), output sample shape)."""
        out = fwd.pop("output_sample_shape", None)
        if out is None:
            raise ValueError("output_sample_shape is required")
        fwd.pop("output_samples_number", None)   # reference alias
        neurons = int(np.prod(out))
        pair = self._weights(fwd, (int(np.prod(shape)), neurons),
                             (neurons,), gen, "uniform")
        return "fc", FC_TYPES[ltype], (), pair, (neurons,)

    def _conv(self, ltype, fwd, shape, gen):
        """Conv (nn/conv.py): W (ky, kx, C, n_kernels), gaussian fill by
        default with fan-in ky·kx·C; same return as :meth:`_fc`."""
        if len(shape) != 3:
            raise ValueError(f"{ltype}: conv expects NHWC samples, got "
                             f"sample shape {shape}")
        n_kernels, kx = fwd.pop("n_kernels", None), fwd.pop("kx", None)
        if n_kernels is None or kx is None:
            raise ValueError("n_kernels and kx are required")
        n_kernels, kx = int(n_kernels), int(kx)
        ky = fwd.pop("ky", None)
        ky = int(ky if ky is not None else kx)
        sliding = norm2(fwd.pop("sliding", 1))
        padding = norm2(fwd.pop("padding", 0))
        h, w, c = shape
        pair = self._weights(fwd, (ky, kx, c, n_kernels), (n_kernels,), gen,
                             "gaussian")
        return ("conv", CONV_TYPES[ltype],
                (("padding", padding), ("stride", sliding)), pair,
                (out_size(h, ky, sliding[0], padding[0]),
                 out_size(w, kx, sliding[1], padding[1]), n_kernels))

    @staticmethod
    def _pool(ltype, fwd, shape):
        """Pooling (nn/pooling.py): kx/ky window, sliding defaulting to
        the window, padding → (config, output sample shape)."""
        if len(shape) != 3:
            raise ValueError(f"{ltype}: pooling expects NHWC samples, got "
                             f"sample shape {shape}")
        kx = fwd.pop("kx", None)
        if kx is None:
            raise ValueError("kx is required")
        kx = int(kx)
        ky = fwd.pop("ky", None)
        ky = int(ky if ky is not None else kx)
        ksize = (ky, kx)
        sliding = fwd.pop("sliding", None)
        sliding = norm2(sliding) if sliding is not None else ksize
        padding = norm2(fwd.pop("padding", 0))
        h, w, c = shape
        return ((("ksize", ksize), ("padding", padding),
                 ("stride", sliding)),
                (out_size(h, ky, sliding[0], padding[0]),
                 out_size(w, kx, sliding[1], padding[1]), c))

    @staticmethod
    def _lrn(fwd):
        """LRNormalizerForward (nn/normalization.py), reference defaults."""
        cfg = {"n": int(fwd.pop("n", 5)), "alpha": fwd.pop("alpha", 1e-4),
               "beta": fwd.pop("beta", 0.75), "k": fwd.pop("k", 2.0)}
        return tuple(sorted(cfg.items()))

    @staticmethod
    def _dropout(i: int, fwd):
        """DropoutForward (nn/dropout.py): the ratio, the ``"dropout"``
        stream's seed and the crc32 of the unit name the reference gives
        layer i, which key the counter-RNG masks."""
        ratio = float(fwd.pop("dropout_ratio", 0.5))
        return (("ratio", ratio), ("seed", prng.get("dropout").stream_seed),
                ("unit_id", zlib.crc32(f"fwd{i}_dropout".encode())))

    def spec_rows(self, pairs: list) -> list:
        """``pairs`` (one per layer) picked for the spec's rows."""
        return [pairs[u] for u in (self.spec.unit_index
                                   or range(len(self.spec.layers)))]

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
        trainer = FusedTrainer(workflow=self, spec=spec,
                               params=self.spec_rows(self.params),
                               vels=self.spec_rows(self.vels),
                               device=self.device)
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
        # update until it knows training continues; the deferred step keeps
        # its epoch and counter base, so its dropout masks are the ones the
        # unit graph would have drawn.
        pending = None   # (tail indices, epoch, counter base)
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
                trainer.train_epoch(data, target, pending[0], batch,
                                    sync=False, epoch=pending[1],
                                    ctr_base=pending[2])
            split = ((n_train - 1) // batch) * batch
            head, tail = perm[:split], perm[split:]
            # everything below stays on the device until the one readback
            runs = {}
            if len(head):
                runs["head"] = trainer.train_epoch(data, target, head, batch,
                                                   sync=False, epoch=epoch)
            # the tail minibatch's metrics come from a forward pass over the
            # post-head weights — the weights the unit graph's evaluator saw
            # before the (skipped-or-deferred) update
            runs["tail"] = trainer.eval_epoch(data, target, tail, batch,
                                              sync=False)
            pending = (tail, epoch, split)
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
