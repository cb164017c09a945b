"""StandardWorkflow: declarative model assembly, the unit graph and the
fused training loop (port of ``znicz_tpu/standard_workflow.py``).

A ``layers=[{"type": ..., "->": {...}, "<-": {...}}, ...]`` config expands,
through the ``link_loader / link_forwards / link_evaluator /
link_decision / link_gds`` family, to the reference's control graph::

    start → loader → fwd₁ → … → fwdₙ → evaluator → decision
    decision [→ lr_adjust] → gdₙ → … → gd₁ ─(loop back-edge)→ loader
    decision → end_point [gate: ~complete]
    decision, gd₁ → snapshotter

The GD units gate-skip on non-train minibatches and once training is
complete; an ``lr_adjuster_config`` links a ``LearningRateAdjust`` that
rewrites their learning rates before each tick's chain (by epoch or by
train minibatch), which the fused loop turns into per-step learning-rate
scales; ``train(fused=False)`` runs this tick loop (``Workflow.run``),
one minibatch a tick, each unit's ``torch_run`` on the card (or
``numpy_run`` on the numpy device).  The forward units own the weight
Vectors and the GD units the velocities.

The same config is also a ``ModelSpec`` plus ``(w, b)`` parameters and
velocities for ``train(fused=True)`` → ``run_fused``, the port of the
reference's ``_run_fused_body`` for a resident loader (a
``FusedTrainer``) or a streaming one (a ``StreamTrainer``).  ``params`` and
``vels`` keep one pair per configured layer; the spec merges each LRN with
the max pool after it (``fused._merge_lrn_pool``), and its ``unit_index``
maps the spec's rows back to the layers.  Where the unit graph exists,
``run_fused`` reads the units' weights and velocities and writes them
back afterwards, as the reference's ``extract_model``/``write_back`` do;
elsewhere the ``"weights"`` stream is drawn in the order the reference's
units draw it, so the same seed gives the same initial weights in both
packages.  Both paths cover the fc, conv, pooling (stochastic pooling
too), LRN, dropout, standalone activation (``activation_<name>``),
depooling and deconv layers with a softmax or an MSE loss.  The cutter
and the mergers, and the GD units' ``accumulate_gradient`` and
``apply_gradient`` options, train on the unit graph only: the
reference's fused path refuses them, and so does this one
(``fused_missing``).  On the card every
non-linear activation of either path, standalone or built into an fc,
conv or deconv layer, launches the elementwise kernels
(``ops.activations``).
``"tie"`` in a layer's ``"->"`` options names the
earlier layer a decoder unit ties to: a depooling layer to the max pool
whose winner slots it reads, a deconv to the conv whose weights it
shares.

A ``snapshotter_config`` (the samples default it from
``root.<name>.snapshotter``, :func:`sample_snapshotter_config`) links a
``SnapshotterToFile``; ``run_fused`` saves through the same unit between
epochs, with the deferred tail update applied first unless the epoch is
the last.  ``run_fused`` also takes device checkpoints
(``parallel.checkpoint.TrainerCheckpointer``, ``checkpoint_dir``), a
``torch.profiler`` trace or a window of it every N epochs, and writes one
timeline row an epoch (``telemetry.flightrecorder``) and the training
gauges of ``telemetry.registry.REGISTRY``."""

from __future__ import annotations

import contextlib
import dataclasses
import time
import zlib

import numpy as np
import torch

from . import prng
from .accelerated_units import AcceleratedWorkflow
from .loader.base import CLASS_NAMES, TEST, TRAIN, VALID
from .loader.streaming import StreamingLoader
from .mutable import DerivedBool
from .nn import (activation, all2all, conv, cutter, deconv, depooling,
                 dropout, gd, gd_conv, gd_deconv, gd_pooling, nn_units,
                 normalization, pooling)
from .nn.decision import DecisionGD, DecisionMSE
from .nn.evaluator import EvaluatorMSE, EvaluatorSoftmax
from .nn.lr_adjust import LearningRateAdjust
from .ops.deconv import deconv_out_size
from .ops.geometry import norm2, out_size
from .parallel import fused
from .parallel.fused import FusedTrainer, LayerSpec, ModelSpec
from .parallel.stream import StreamTrainer
from .snapshotter import SnapshotterToFile
from .telemetry import flightrecorder as _flightrecorder
from .telemetry import profiler as _profiler
from .telemetry.registry import REGISTRY

#: StandardWorkflow layer type → activation of the fc layer.  The last
#: layer of a softmax model keeps "linear": its softmax is fused with CE.
FC_TYPES = {"all2all": "linear", "all2all_tanh": "tanh",
            "all2all_relu": "relu", "all2all_str": "strict_relu",
            "all2all_sigmoid": "sigmoid", "softmax": "linear"}
#: Conv layer type → activation (nn/conv.py).
CONV_TYPES = {"conv": "linear", "conv_tanh": "tanh", "conv_relu": "relu",
              "conv_str": "strict_relu", "conv_sigmoid": "sigmoid"}
#: Deconv layer type → activation (nn/deconv.py).
DECONV_TYPES = {"deconv": "linear", "deconv_tanh": "tanh",
                "deconv_sigmoid": "sigmoid"}
#: Pooling layer type → fused kind (nn/pooling.py).
POOL_TYPES = {"max_pooling": "max_pool", "maxabs_pooling": "maxabs_pool",
              "avg_pooling": "avg_pool",
              "stochastic_pooling": "stochastic_pool",
              "stochastic_abs_pooling": "stochastic_abs_pool"}
LRN_TYPES = ("norm", "lrn")
#: Glue layer types (nn/cutter.py): the unit graph runs them, the fused
#: path refuses them, as the reference's ``extract_model`` does
GLUE_TYPES = {"cutter": "Cutter", "channel_merger": "ChannelMerger",
              "sum_merger": "EltwiseSumMerger"}

_UNIT_GRAPH = "ROADMAP.md queue 1 item 4 (core engine: the unit graph)"
#: the GD options that keep a model on the unit graph
GD_SCHEDULE_OPTIONS = ("accumulate_gradient", "apply_gradient")


def _build_registries():
    """Layer type → Forward / GradientDescent unit class, from the
    classes' ``MAPPING``."""
    from .nn.nn_units import Forward, GradientDescentBase
    fwd_map, gd_map = {}, {}
    for mod in (all2all, gd, conv, gd_conv, pooling, gd_pooling,
                normalization, depooling, deconv, gd_deconv, dropout,
                activation, cutter):
        for obj in vars(mod).values():
            if isinstance(obj, type) and issubclass(obj, Forward):
                fwd_map.update(dict.fromkeys(obj.MAPPING, obj))
            if isinstance(obj, type) \
                    and issubclass(obj, GradientDescentBase):
                gd_map.update(dict.fromkeys(obj.MAPPING, obj))
    return fwd_map, gd_map


FWD_MAP, GD_MAP = _build_registries()
#: Standalone activation layer type (``activation_<name>``,
#: nn/activation.py) → activation; the fused path runs them as its
#: ``activation`` kind.
ACTIVATION_TYPES = {t: cls.ACTIVATION.name for t, cls in FWD_MAP.items()
                    if issubclass(cls, activation.ActivationForward)}
PORTED_TYPES = (*FC_TYPES, *CONV_TYPES, *POOL_TYPES, *LRN_TYPES, "dropout",
                "depooling", *DECONV_TYPES, *ACTIVATION_TYPES, *GLUE_TYPES)


def _no_options_left(fwd: dict) -> None:
    if fwd:
        raise NotImplementedError(
            f"layer options {sorted(fwd)} are not ported yet ({_UNIT_GRAPH})")


def _gd_hypers(cfg: dict) -> tuple[tuple, tuple]:
    """(hypers, hypers_bias) from a layer's ``"<-"`` dict with the defaults
    of the reference's ``GradientDescentBase.__init__``; the schedule
    options (``GD_SCHEDULE_OPTIONS``) go to the GD units only."""
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
                          "gradient_moment_bias", *GD_SCHEDULE_OPTIONS}
    if unknown:
        raise NotImplementedError(
            f"gradient options {sorted(unknown)} are not ported yet "
            f"({_UNIT_GRAPH})")
    return hypers, hypers_bias


class StandardWorkflow(AcceleratedWorkflow):
    """One-call assembly of a model: its unit graph and its fused-path
    spec."""

    def __init__(self, name=None, layers=None, loader=None,
                 loss_function="softmax", decision_config=None,
                 snapshotter_config=None, lr_adjuster_config=None,
                 workflow=None):
        super().__init__(workflow, name or type(self).__name__)
        if loss_function not in ("softmax", "mse"):
            raise ValueError(loss_function)
        self.layers_config = list(layers or [])
        self.loss_function = loss_function
        self.forwards: list = []
        self.gds: list = []
        #: the LearningRateAdjust unit of ``lr_adjuster_config`` (None:
        #: the configured rates throughout)
        self.lr_adjuster = None
        #: the SnapshotterToFile of ``snapshotter_config`` (None: no
        #: snapshots)
        self.snapshotter = None
        #: why ``train(fused=False)`` cannot run this model (None: it can)
        self.unit_graph_missing: str | None = None
        #: why ``train(fused=True)`` cannot (``spec`` is then None)
        self.fused_missing: str | None = None
        self.spec: ModelSpec | None = None
        #: the fused rows before the LRN→pool merge, one a layer (the merge
        #: under another ``ZNICZ_TPU_LRN_POOL`` routing starts from them)
        self.layer_specs: tuple = ()
        self.params: list = []
        self.vels: list = []
        if loader is not None:
            # configs may arrive as Config subtrees (the samples default
            # them from root.<name>.*)
            def as_dict(c):
                return c.to_dict() if hasattr(c, "to_dict") else c
            self.create_workflow(loader, as_dict(decision_config) or {},
                                 as_dict(snapshotter_config),
                                 as_dict(lr_adjuster_config))

    # -- link_* family (reference API) -------------------------------------------
    def create_workflow(self, loader, decision_config: dict,
                        snapshotter_config: dict | None = None,
                        lr_adjuster_config: dict | None = None) -> None:
        """Link the unit graph, or (for a model it does not cover yet) the
        loader and a free-standing decision, adjuster and snapshotter for
        the fused loop."""
        self.link_loader(loader)
        self.unit_graph_missing = self._unit_graph_gap()
        if self.unit_graph_missing is not None:
            cls = DecisionGD if self.loss_function == "softmax" \
                else DecisionMSE
            self.decision = cls(self, name="decision", **decision_config)
            if lr_adjuster_config is not None:
                self.lr_adjuster = LearningRateAdjust(self,
                                                      **lr_adjuster_config)
            if snapshotter_config is not None:
                self.snapshotter = SnapshotterToFile(self,
                                                     **snapshotter_config)
            return
        self.link_forwards()
        self.link_evaluator()
        self.link_decision(**decision_config)
        if lr_adjuster_config is not None:
            self.link_lr_adjuster(**lr_adjuster_config)
        self.link_gds()
        if snapshotter_config is not None:
            self.link_snapshotter(**snapshotter_config)

    def _unit_graph_gap(self) -> str | None:
        for spec in self.layers_config:
            if spec["type"] not in FWD_MAP:
                return (f"unknown layer type {spec['type']!r}; known: "
                        f"{sorted(FWD_MAP)}")
        if not self.layers_config:
            return "the model has no layers"
        return None

    def link_loader(self, loader) -> None:
        self.loader = loader
        self.add_unit(loader)
        loader.link_from(self.start_point)

    def link_forwards(self) -> None:
        prev = self.loader
        for i, spec in enumerate(self.layers_config):
            ltype = spec["type"]
            kwargs = dict(spec.get("->", {}))
            tie = kwargs.pop("tie", None)
            unit = FWD_MAP[ltype](self, name=f"fwd{i}_{ltype}", **kwargs)
            if tie is not None:
                # the same Vector objects as the tied unit's (link_attrs):
                # a copy would silently untie them
                unit.tie(self.forwards[tie])
            if prev is self.loader:
                unit.link_attrs(self.loader, ("input", "minibatch_data"))
            else:
                unit.link_attrs(prev, ("input", "output"))
            unit.link_from(prev)
            self.forwards.append(unit)
            prev = unit

    def link_evaluator(self) -> None:
        last = self.forwards[-1]
        if self.loss_function == "softmax":
            ev = EvaluatorSoftmax(self, name="evaluator")
            ev.link_attrs(last, "output", "max_idx")
            ev.link_attrs(self.loader, ("labels", "minibatch_labels"))
        else:
            ev = EvaluatorMSE(self, name="evaluator")
            ev.link_attrs(last, "output")
            ev.link_attrs(self.loader, ("target", "minibatch_targets"))
        ev.link_loader(self.loader)
        ev.link_from(last)
        self.evaluator = ev

    def link_decision(self, **config) -> None:
        cls = DecisionGD if self.loss_function == "softmax" else DecisionMSE
        self.decision = cls(self, name="decision", **config)
        self.decision.link_loader(self.loader)
        self.decision.link_evaluator(self.evaluator)
        self.decision.link_from(self.evaluator)
        self.end_point.link_from(self.decision)
        self.end_point.gate_block = ~self.decision.complete

    def link_lr_adjuster(self, **config) -> None:
        """A LearningRateAdjust between the decision and the GD chain (call
        before :meth:`link_gds`), skipped once the decision completes."""
        self.lr_adjuster = LearningRateAdjust(self, **config)
        self.lr_adjuster.link_from(self.decision)
        self.lr_adjuster.gate_skip = DerivedBool(
            lambda: bool(self.decision.complete), ())

    def link_gds(self) -> None:
        """Mirrored gradient chain, last layer first, from the adjuster
        where there is one; the last one closes the minibatch loop back to
        the loader."""
        prev = self.lr_adjuster if self.lr_adjuster is not None \
            else self.decision
        loader, decision = self.loader, self.decision
        # skip backprop on valid/test minibatches and once training is
        # complete (so the final weights equal the last snapshot)
        train_only = DerivedBool(
            lambda: loader.minibatch_class != TRAIN
            or bool(decision.complete), ())
        for i in reversed(range(len(self.forwards))):
            spec = self.layers_config[i]
            unit = GD_MAP[spec["type"]](
                self, name=f"gd{i}_{spec['type']}", need_err_input=(i > 0),
                **dict(spec.get("<-", {})))
            unit.setup_from_forward(self.forwards[i])
            if not self.gds:
                unit.link_attrs(self.evaluator, "err_output")
            else:
                unit.link_attrs(prev, ("err_output", "err_input"))
            unit.link_from(prev)
            unit.gate_skip = train_only
            self.gds.insert(0, unit)
            prev = unit
        if self.lr_adjuster is not None:
            self.lr_adjuster.link_gds(self.gds)
        self.loader.link_from(self.gds[0])

    def link_snapshotter(self, **config) -> None:
        """A SnapshotterToFile after the decision, as the reference links
        it, and after the GD chain's last unit: the epoch's last tick
        saves once its update is applied, so a resume continues the
        continuous run (``snapshotter.py``)."""
        self.snapshotter = SnapshotterToFile(self, **config)
        self.snapshotter.link_from(self.decision, *self.gds[:1])

    # -- lifecycle ---------------------------------------------------------------
    def initialize(self, device=None, **kwargs) -> None:
        """Bind the units to ``device`` (default: CUDA, raising without
        it; ``"cpu"``, or ``"numpy"`` for the golden unit graph), which
        loads the data and fills the weights, then build the fused path's
        spec, params and velocities."""
        super().initialize(device, **kwargs)
        self._build_model()

    def _build_model(self) -> None:
        """Spec, params and velocities from ``layers_config``; shapes
        propagate per sample in NHWC.  Layers with a unit take its
        weights; the others draw from the ``"weights"`` stream in the
        order the reference's units draw it."""
        gen = prng.get("weights")
        # shapes[i]: the input sample shape of layer i
        shapes = [_sample_shape(self.loader)]
        layers, params = [], []
        refusal = None   # why the fused path cannot run this model
        for i, spec in enumerate(self.layers_config):
            ltype = spec["type"]
            fwd = dict(spec.get("->", {}))
            unit = self.forwards[i] if self.forwards else None
            shape = shapes[-1]
            if ltype in FC_TYPES:
                if ltype == "softmax" and i != len(self.layers_config) - 1:
                    raise NotImplementedError(
                        "a softmax layer must be the last layer")
                kind, act, config, pair, shape = self._fc(ltype, fwd, shape,
                                                          gen, unit)
            elif ltype in CONV_TYPES:
                kind, act, config, pair, shape = self._conv(ltype, fwd,
                                                            shape, gen, unit)
            elif ltype in DECONV_TYPES:
                kind, act, config, pair, shape = self._deconv(
                    ltype, fwd, shapes, layers, params, gen, unit)
            elif ltype in POOL_TYPES:
                kind, act, pair = POOL_TYPES[ltype], "linear", None
                config, shape = self._pool(ltype, fwd, shape)
                if kind.startswith("stochastic"):
                    config = self._stochastic(i, ltype, config)
            elif ltype == "depooling":
                kind, act, pair = "depooling", "linear", None
                config, shape = self._depooling(i, fwd, shapes, layers)
            elif ltype in LRN_TYPES:
                kind, act, pair = "lrn", "linear", None
                config = self._lrn(fwd)
            elif ltype == "dropout":
                kind, act, pair = "dropout", "linear", None
                config = self._dropout(i, fwd)
            elif ltype in ACTIVATION_TYPES:
                kind, act, pair = "activation", ACTIVATION_TYPES[ltype], None
                config = ()
            elif ltype in GLUE_TYPES:
                # a placeholder row: the spec is never built (refusal)
                kind, act, pair, config = ltype, "linear", None, ()
                shape = self._glue(ltype, fwd, shape, unit)
                refusal = refusal or (f"fused path does not support "
                                      f"{GLUE_TYPES[ltype]}")
            else:
                raise ValueError(f"unknown layer type {ltype!r}; known: "
                                 f"{sorted(PORTED_TYPES)}")
            _no_options_left(fwd)
            back = dict(spec.get("<-", {}))
            hypers, hypers_bias = _gd_hypers(back)
            if back.get("accumulate_gradient", False) \
                    or not back.get("apply_gradient", True):
                # the reference's extract_model refuses them the same way
                refusal = refusal or (
                    f"gd{i}_{ltype}: accumulate_gradient/apply_gradient "
                    f"schedules need the unit-graph path (train(fused="
                    f"False)); for fused accumulation clear those unit "
                    f"flags and set root.common.accum_steps — a per-unit "
                    f"schedule has no fused form")
            layers.append(LayerSpec(
                kind=kind, activation=act,
                include_bias=pair is not None and pair[1] is not None,
                hypers=hypers, hypers_bias=hypers_bias, config=config))
            params.append(pair)
            shapes.append(shape)
        dev = self.device.torch_device

        def put(a):   # a copy: a unit's host weights must not alias it
            return None if a is None else torch.tensor(
                np.asarray(a, np.float32), device=dev)
        self.params = [(None, None) if p is None else (put(p[0]), put(p[1]))
                       for p in params]
        self.vels = [tuple(None if t is None else torch.zeros_like(t)
                           for t in p) for p in self.params]
        for i, la in enumerate(layers):
            if la.kind == "deconv" and "tie" in la.cfg:
                # its own velocity, shaped like the shared encoder W
                self.vels[i] = (torch.zeros_like(
                    self.params[la.cfg["tie"]][0]), self.vels[i][1])
        if refusal is not None:
            if self.unit_graph_missing is not None:
                raise NotImplementedError(refusal)
            self.spec, self.fused_missing = None, refusal
            return
        self.layer_specs = tuple(layers)
        layers, _, _, unit_index = fused._merge_lrn_pool(layers, self.params,
                                                         self.vels)
        try:
            self.spec = ModelSpec(tuple(layers), self.loss_function,
                                  unit_index=unit_index)
        except NotImplementedError as e:
            if self.unit_graph_missing is not None:
                raise
            # the unit graph runs what the fused path refuses (a tied
            # deconv above a trainable layer): refuse only run_fused
            self.spec, self.fused_missing = None, str(e)

    def _params_from_units(self) -> None:
        """params/vels ← the unit graph's weight and velocity Vectors.  A
        tied deconv's row holds no W (the conv's row has it), only its
        own velocity."""
        for i, (f, g) in enumerate(zip(self.forwards, self.gds)):
            own_w = bool(f.weights) and getattr(f, "conv_unit", None) is None
            self.params[i] = (f.weights.devmem if own_w else None,
                              f.bias.devmem if f.include_bias else None)
            self.vels[i] = (
                g.velocity_weights.devmem if g.velocity_weights else None,
                g.velocity_bias.devmem if f.include_bias else None)

    def _params_to_units(self) -> None:
        """The unit graph's Vectors ← params/vels (after the fused loop)."""
        for i, (f, g) in enumerate(zip(self.forwards, self.gds)):
            (w, b), (vw, vb) = self.params[i], self.vels[i]
            if w is not None:
                f.weights.devmem = w
            if vw is not None:
                g.velocity_weights.devmem = vw
            if f.include_bias:
                f.bias.devmem, g.velocity_bias.devmem = b, vb

    @staticmethod
    def _weights(fwd: dict, w_shape, b_shape, gen, w_fill_default,
                 unit=None, bias_default=True):
        """Pops the fill options; (W, b or None) from ``unit`` when the
        layer has one (it filled them), else drawn by
        ``nn_units.create_weights``."""
        opts = {"include_bias": fwd.pop("include_bias", bias_default),
                "weights_filling": fwd.pop("weights_filling",
                                           w_fill_default),
                "weights_stddev": fwd.pop("weights_stddev", None),
                "bias_filling": fwd.pop("bias_filling", "uniform"),
                "bias_stddev": fwd.pop("bias_stddev", None)}
        if unit is not None:
            return (unit.weights.mem,
                    unit.bias.mem if unit.include_bias else None)
        return nn_units.create_weights(gen, w_shape, b_shape, **opts)

    def _fc(self, ltype, fwd, shape, gen, unit):
        """All2All: W (n_in, neurons), uniform fill by default (the unit's
        weights on the unit graph) → (kind, activation, config, (w, b),
        output sample shape)."""
        out = fwd.pop("output_sample_shape", None)
        if out is None:
            raise ValueError("output_sample_shape is required")
        fwd.pop("output_samples_number", None)   # reference alias
        neurons = int(np.prod(out))
        pair = self._weights(fwd, (int(np.prod(shape)), neurons),
                             (neurons,), gen, "uniform", unit)
        return "fc", FC_TYPES[ltype], (), pair, (neurons,)

    @staticmethod
    def _window(fwd, sliding_default):
        """Pops kx/ky, sliding and padding → (ky, kx), sliding, padding."""
        kx = fwd.pop("kx", None)
        if kx is None:
            raise ValueError("kx is required")
        kx = int(kx)
        ky = fwd.pop("ky", None)
        ky = int(ky if ky is not None else kx)
        sliding = fwd.pop("sliding", None)
        sliding = norm2(sliding if sliding is not None
                        else sliding_default or (ky, kx))
        return (ky, kx), sliding, norm2(fwd.pop("padding", 0))

    def _conv(self, ltype, fwd, shape, gen, unit):
        """Conv (nn/conv.py): W (ky, kx, C, n_kernels), gaussian fill by
        default with fan-in ky·kx·C; same return as :meth:`_fc`."""
        if len(shape) != 3:
            raise ValueError(f"{ltype}: conv expects NHWC samples, got "
                             f"sample shape {shape}")
        n_kernels = fwd.pop("n_kernels", None)
        if n_kernels is None:
            raise ValueError("n_kernels and kx are required")
        n_kernels = int(n_kernels)
        (ky, kx), sliding, padding = self._window(fwd, 1)
        h, w, c = shape
        pair = self._weights(fwd, (ky, kx, c, n_kernels), (n_kernels,), gen,
                             "gaussian", unit)
        return ("conv", CONV_TYPES[ltype],
                (("padding", padding), ("stride", sliding)), pair,
                (out_size(h, ky, sliding[0], padding[0]),
                 out_size(w, kx, sliding[1], padding[1]), n_kernels))

    def _deconv(self, ltype, fwd, shapes, layers, params, gen, unit):
        """Deconv (nn/deconv.py): W (ky, kx, n_channels, n_kernels) in the
        paired conv's layout.  Tied (``"tie"``: an earlier conv layer) it
        takes the conv's geometry and has no W of its own; untied it is
        gaussian-filled with stddev 1/√(ky·kx·n_kernels).  Bias off by
        default.  Same return as :meth:`_fc`."""
        shape = shapes[-1]
        if len(shape) != 3:
            raise ValueError(f"{ltype}: deconv expects NHWC samples, got "
                             f"sample shape {shape}")
        tie = fwd.pop("tie", None)
        n_channels = fwd.pop("n_channels", None)
        config = {}
        if tie is not None:
            if not 0 <= tie < len(layers) or layers[tie].kind != "conv":
                raise ValueError(f"{ltype}: tie={tie} must name an earlier "
                                 f"conv layer")
            # the tied conv's geometry wins, as Deconv.tie sets it
            for k in ("n_kernels", "kx", "ky", "sliding", "padding"):
                fwd.pop(k, None)
            ky, kx, c, n_kernels = params[tie][0].shape
            if n_channels is None:
                n_channels = c
            sliding, padding = layers[tie].cfg["stride"],                 layers[tie].cfg["padding"]
            include_bias = fwd.pop("include_bias", False)
            for k in ("weights_filling", "weights_stddev"):
                fwd.pop(k, None)
            bias_opts = {"bias_filling": fwd.pop("bias_filling", "uniform"),
                         "bias_stddev": fwd.pop("bias_stddev", None)}
            b = None
            if include_bias:
                b = (unit.bias.mem if unit is not None else
                     nn_units.fill_bias(gen, (int(n_channels),),
                                        **bias_opts))
            pair = (None, b)
            config["tie"] = tie
        else:
            n_kernels = fwd.pop("n_kernels", None)
            if n_kernels is None or n_channels is None:
                raise ValueError("n_kernels, kx and n_channels are required "
                                 "for an untied deconv")
            n_kernels = int(n_kernels)
            (ky, kx), sliding, padding = self._window(fwd, 1)
            if fwd.get("weights_stddev") is None:
                fwd["weights_stddev"] = 1.0 / np.sqrt(ky * kx * n_kernels)
            pair = self._weights(fwd, (ky, kx, int(n_channels), n_kernels),
                                 (int(n_channels),), gen, "gaussian", unit,
                                 bias_default=False)
        if shape[2] != n_kernels:
            raise ValueError(f"{ltype}: input has {shape[2]} channels, "
                             f"n_kernels={n_kernels}")
        h, w, _ = shape
        config.update(padding=padding, stride=sliding)
        return ("deconv", DECONV_TYPES[ltype], tuple(sorted(config.items())),
                pair, (deconv_out_size(h, ky, sliding[0], padding[0]),
                       deconv_out_size(w, kx, sliding[1], padding[1]),
                       int(n_channels)))

    @staticmethod
    def _depooling(i, fwd, shapes, layers):
        """Depooling (nn/depooling.py) tied to an earlier max pool: its
        window and the pool's input shape → (config, output shape)."""
        tie = fwd.pop("tie", None)
        if tie is None or not 0 <= tie < i \
                or layers[tie].kind not in fused.OFFSET_KINDS:
            raise ValueError(f"depooling: tie={tie} must name an earlier "
                             f"pooling layer that records winner slots")
        return (tuple(sorted(dict(layers[tie].cfg, tie=tie).items())),
                shapes[tie])

    def _pool(self, ltype, fwd, shape):
        """Pooling (nn/pooling.py): kx/ky window, sliding defaulting to
        the window, padding → (config, output sample shape)."""
        if len(shape) != 3:
            raise ValueError(f"{ltype}: pooling expects NHWC samples, got "
                             f"sample shape {shape}")
        ksize, sliding, padding = self._window(fwd, None)
        h, w, c = shape
        return ((("ksize", ksize), ("padding", padding),
                 ("stride", sliding)),
                (out_size(h, ksize[0], sliding[0], padding[0]),
                 out_size(w, ksize[1], sliding[1], padding[1]), c))

    @staticmethod
    def _stochastic(i: int, ltype: str, config: tuple) -> tuple:
        """A stochastic pool's config with the ``"pooling"`` stream's seed
        and the crc32 of the unit name the reference gives layer i, which
        key its draws (the reference's ``extract_model``)."""
        return tuple(sorted(dict(
            config, seed=prng.get("pooling").stream_seed,
            unit_id=zlib.crc32(f"fwd{i}_{ltype}".encode())).items()))

    @staticmethod
    def _glue(ltype, fwd, shape, unit):
        """The output sample shape of a cutter (``padding`` = left, top,
        right, bottom crop margins) or of a merger (its unit's, which
        ``link_inputs`` wired)."""
        if ltype == "cutter":
            le, to, ri, bo = (int(p) for p in fwd.pop("padding"))
            h, w, c = shape
            return (h - to - bo, w - le - ri, c)
        if unit is None:
            raise ValueError(f"{ltype}: a merger needs its unit graph "
                             f"(link_inputs)")
        return tuple(unit.output.shape[1:])

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
              storage_dtype: str | None = None,
              profile_dir: str | None = None,
              profile_every: int | None = None,
              checkpoint_dir: str | None = None,
              checkpoint_every: int | None = None,
              checkpointer=None,
              timeline_jsonl: str | None = None):
        """``fused=False`` runs the unit-graph tick loop (:meth:`run`,
        one minibatch a tick); ``fused=True`` runs :meth:`run_fused`.  The
        dtypes of the fused path default from
        ``root.common.compute_dtype``/``storage_dtype``, the profile from
        ``$ZNICZ_PROFILE_DIR``/``$ZNICZ_PROFILE_EVERY`` and the timeline
        from ``$ZNICZ_TIMELINE_JSONL``.  The tick loop computes in float32,
        as the reference's does, and warns that the timeline and the
        device checkpoints are the fused path's (its snapshotter saves)."""
        from .config import root
        if mesh is not None or mesh_shape is not None \
                or root.common.get("mesh_shape") is not None:
            raise NotImplementedError(
                "mesh-sharded training is not ported yet (ROADMAP.md "
                "queue 1 item 9, parallelism)")
        if timeline_jsonl is None:
            timeline_jsonl = _flightrecorder.timeline_path_from_env()
        if not fused:
            if self.unit_graph_missing is not None:
                raise NotImplementedError(
                    "train(fused=False): " + self.unit_graph_missing)
            if timeline_jsonl is not None:
                self.warning("the per-step timeline (timeline_jsonl) is a "
                             "fused-path feature; the tick loop records "
                             "nothing there")
            if checkpoint_dir is not None or checkpointer is not None:
                self.warning("device checkpoints (checkpoint_dir/"
                             "checkpointer) are a fused-path feature; "
                             "the tick loop keeps its snapshotter")
            if max_epochs is not None:
                self.decision.max_epochs = max_epochs
            self.run()
            return None
        if compute_dtype is None:
            compute_dtype = root.common.get("compute_dtype")
        if storage_dtype is None:
            storage_dtype = root.common.get("storage_dtype")
        if profile_dir is None:
            profile_dir = _profiler.dir_from_env()
        if profile_every is None:
            profile_every = _profiler.every_from_env()
        return self.run_fused(max_epochs=max_epochs,
                              compute_dtype=compute_dtype,
                              storage_dtype=storage_dtype,
                              profile_dir=profile_dir,
                              profile_every=profile_every,
                              checkpoint_dir=checkpoint_dir,
                              checkpoint_every=checkpoint_every,
                              checkpointer=checkpointer,
                              timeline_jsonl=timeline_jsonl)

    def run_fused(self, max_epochs: int | None = None,
                  compute_dtype: str | None = None,
                  storage_dtype: str | None = None,
                  profile_dir: str | None = None,
                  profile_every: int | None = None,
                  checkpoint_dir: str | None = None,
                  checkpoint_every: int | None = None,
                  checkpointer=None,
                  timeline_jsonl: str | None = None,
                  mse_target: str | None = None,
                  step_callback=None) -> FusedTrainer:
        """Train on the fused path: whole epochs on the device, with the
        decision's improvement/stop logic between epochs on the host, the
        adjuster's schedule as per-step learning-rate scales and
        ``root.common.accum_steps`` as the trainer's gradient
        accumulation.  Returns the FusedTrainer; copies of its params are
        written back into ``self.params``/``self.vels``.

        Between epochs: the snapshotter's cadence
        (``SnapshotterBase.epoch_end``) and, with ``checkpoint_dir`` (a
        checkpointer owned and closed here) or ``checkpointer`` (the
        caller's, waited for), an asynchronous device checkpoint every
        ``checkpoint_every`` epochs (default 1) and at the end.
        ``profile_dir`` traces the whole run (``torch.profiler``); with
        ``profile_every=N`` a one-epoch window every N epochs instead.
        ``timeline_jsonl`` appends one JSON row an epoch with its wall /
        device / host split.

        A ``StreamingLoader`` trains through a :class:`StreamTrainer`
        (minibatches streamed from disk, the same steps): an MSE head
        regresses ``mse_target`` (default: a float label block if the
        loader has one, else the input), a loader's augment policy with a
        ``device_apply`` crops on the device, and ``step_callback(epoch,
        step)`` runs after each streamed train step."""
        if not self.initialized:
            raise RuntimeError("initialize() first")
        if not self.device.is_torch:
            raise ValueError("the fused path trains on a torch device "
                             "(cuda or cpu); the numpy device runs the unit "
                             "graph (train(fused=False))")
        if self.spec is None:
            raise NotImplementedError(self.fused_missing)
        dev = self.device.torch_device
        hook = None
        ctx = contextlib.nullcontext()
        if profile_dir is not None and profile_every:
            hook = _profiler.StepTraceHook(profile_dir,
                                           every=int(profile_every),
                                           device=dev)
        elif profile_dir is not None:
            ctx = _profiler.trace(profile_dir, dev)
        try:
            with ctx:
                return self._run_fused_body(
                    max_epochs, compute_dtype, storage_dtype, hook,
                    checkpoint_dir, checkpoint_every, checkpointer,
                    timeline_jsonl, mse_target, step_callback)
        finally:
            if hook is not None:
                hook.close()

    def _run_fused_body(self, max_epochs, compute_dtype, storage_dtype,
                        profile_hook, checkpoint_dir, checkpoint_every,
                        checkpointer, timeline_jsonl, mse_target=None,
                        step_callback=None) -> FusedTrainer:
        from .config import root
        spec = self.spec
        if compute_dtype is not None:
            spec = dataclasses.replace(spec, compute_dtype=compute_dtype)
        if storage_dtype is not None:
            spec = dataclasses.replace(spec, storage_dtype=storage_dtype)
        if self.forwards:
            self._params_from_units()
        kwargs = dict(workflow=self, spec=spec,
                      params=self.spec_rows(self.params),
                      vels=self.spec_rows(self.vels),
                      device=self.device.torch_device,
                      accum_steps=int(root.common.get("accum_steps") or 1))
        loader = self.loader
        if isinstance(loader, StreamingLoader):
            if mse_target is None:
                # a float label block is the regression target (denoising
                # shards); int labels mean reconstruct the input
                mse_target = ("labels" if self.loss_function == "mse"
                              and np.dtype(loader.label_dtype).kind == "f"
                              else "input")
            trainer = StreamTrainer(
                loader=loader, mse_target=mse_target,
                step_callback=step_callback,
                # the crop rides the step on the card; a policy without a
                # device twin keeps the host crop in the prefetcher
                device_augment=hasattr(getattr(loader, "augment", None),
                                       "device_apply"), **kwargs)
        else:
            trainer = FusedTrainer(**kwargs)
        timeline = (_flightrecorder.TimelineWriter(timeline_jsonl)
                    if timeline_jsonl else None)
        ckpt, own_ckpt = checkpointer, False
        if ckpt is None and checkpoint_dir is not None:
            from .parallel.checkpoint import TrainerCheckpointer
            ckpt, own_ckpt = TrainerCheckpointer(checkpoint_dir), True
        try:
            self._epochs(trainer, max_epochs, profile_hook, timeline, ckpt,
                         max(1, int(checkpoint_every or 1)))
        finally:
            if timeline is not None:
                timeline.close()
            if ckpt is not None:
                # flush the writes in flight (each manifest commits as its
                # bytes land); a borrowed checkpointer stays open
                if own_ckpt:
                    ckpt.close()
                else:
                    ckpt.wait()
        return trainer

    def _epochs(self, trainer, max_epochs, profile_hook, timeline, ckpt,
                ckpt_every: int) -> None:
        """The fused epoch loop of :meth:`run_fused`."""
        loader, decision = self.loader, self.decision
        if isinstance(loader, StreamingLoader):
            data = target = None        # the StreamTrainer reads the loader
        else:
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
        adj = self.lr_adjuster
        gauges = _train_gauges()
        # host-vs-device split: the wall time inside the trainer's calls
        # and the epoch's one readback counts as device time, the rest of
        # the epoch (shuffle, metrics, decision, saves) as host time
        dev_acc = [0.0]

        def on_device(fn, *a, **kw):
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                dev_acc[0] += time.monotonic() - t0

        first = True
        # Unit-graph parity for the stop tick: in the tick where Decision
        # sets ``complete`` the GD units are gate-skipped, so the LAST train
        # minibatch of the final epoch never updates weights.  The fused
        # loop reproduces this by deferring each epoch's last minibatch
        # update until it knows training continues; the deferred step keeps
        # its epoch, counter base and learning-rate scales, so its dropout
        # masks and rates are the ones the unit graph would have used.
        pending = None   # (tail indices, epoch, counter base, lr_scale,
        #                   lr_scale_bias)

        def run_pending():
            on_device(trainer.train_epoch, data, target, pending[0], batch,
                      sync=False, epoch=pending[1], ctr_base=pending[2],
                      lr_scale=pending[3], lr_scale_bias=pending[4])

        for epoch in range(loader.epoch_number, epochs):
            if profile_hook is not None:
                profile_hook.on_step(epoch)
            t_epoch0 = time.monotonic()
            dev0 = dev_acc[0]
            loader.epoch_number = epoch
            if not first:   # initialize() already built epoch 0's plan
                loader._build_epoch_plan()
            first = False
            perm = loader._shuffled[TRAIN]
            n_train = len(cls_idx[TRAIN])
            steps_per_epoch = max(1, -(-n_train // batch))
            scale, tail_scale = _lr_scales(adj, "policy", epoch,
                                           steps_per_epoch)
            scale_b, tail_scale_b = _lr_scales(adj, "bias_policy", epoch,
                                               steps_per_epoch)
            if pending is not None:
                run_pending()
            split = ((n_train - 1) // batch) * batch
            head, tail = perm[:split], perm[split:]
            # everything below stays on the device until the one readback
            runs = {}
            if len(head):
                runs["head"] = on_device(
                    trainer.train_epoch, data, target, head, batch,
                    sync=False, epoch=epoch, lr_scale=scale,
                    lr_scale_bias=scale_b)
            # the tail minibatch's metrics come from a forward pass over the
            # post-head weights — the weights the unit graph's evaluator saw
            # before the (skipped-or-deferred) update
            runs["tail"] = on_device(trainer.eval_epoch, data, target, tail,
                                     batch, sync=False)
            pending = (tail, epoch, split, tail_scale, tail_scale_b)
            for k in (VALID, TEST):
                if len(cls_idx[k]):
                    runs[k] = on_device(trainer.eval_epoch, data, target,
                                        cls_idx[k], batch, sync=False)
            host = dict(zip(runs, on_device(fused.to_host, *runs.values())))
            metrics = self._epoch_metrics(epoch, host, cls_idx)
            decision.epoch_metrics.append(metrics)
            loader.epoch_number = epoch + 1
            epoch_s = time.monotonic() - t_epoch0
            device_s = dev_acc[0] - dev0
            host_s = max(0.0, epoch_s - device_s)
            if epoch_s > 0:
                self.epoch_timings.append({
                    "epoch": epoch,
                    "train_examples_per_sec": n_train / epoch_s,
                    "train_step_time_ms": epoch_s / steps_per_epoch * 1e3})
                gauges["step_ms"].set(epoch_s / steps_per_epoch * 1e3)
                gauges["eps"].set(n_train / epoch_s)
                gauges["device_ms"].set(device_s * 1e3)
                gauges["host_ms"].set(host_s * 1e3)
            gauges["epoch"].set(epoch)
            step_row = {"epoch": epoch, "steps": steps_per_epoch,
                        "examples": n_train,
                        "wall_ms": round(epoch_s * 1e3, 3),
                        "device_ms": round(device_s * 1e3, 3),
                        "host_ms": round(host_s * 1e3, 3),
                        "examples_per_sec": (round(n_train / epoch_s, 1)
                                             if epoch_s > 0 else None)}
            _flightrecorder.RECORDER.record(
                "train_step", duration_ms=epoch_s * 1e3, **step_row)
            if timeline is not None:
                timeline.write({"at": time.time(), **step_row})
            if adj is not None:
                # the unit graph's iteration counter, current for a later
                # tick-path run of this workflow and for snapshots
                adj._minibatches = (epoch + 1) * steps_per_epoch
            improved = decision.better_than_best(metrics)
            decision.improved.set(improved)
            decision._fails = 0 if improved else decision._fails + 1
            # A mid-run snapshot or checkpoint must hold this epoch's
            # deferred tail update (a continuous run applies it at the next
            # epoch's start; a resumed one starts with nothing pending).  On
            # the final epoch the stop tick skips that update, so it stays
            # pending and the save equals the unit graph's final one.
            is_final = (epoch == epochs - 1
                        or decision._fails >= decision.fail_iterations)

            def sync_weights():
                nonlocal pending
                if not is_final and pending is not None:
                    run_pending()
                    pending = None
                trainer.write_back()
                if self.forwards:
                    self._params_to_units()

            if self.snapshotter is not None:
                self.snapshotter.epoch_end(improved,
                                           before_save=sync_weights)
            if ckpt is not None and ((epoch + 1) % ckpt_every == 0
                                     or is_final):
                sync_weights()
                ckpt.save(trainer, epoch, block=False)
            if decision._fails >= decision.fail_iterations:
                break
        decision.complete.set(True)
        trainer.write_back()
        if self.forwards:
            self._params_to_units()

    def _epoch_metrics(self, epoch: int, host: dict, cls_idx: dict) -> dict:
        """The epoch's metrics dict from the readback of its runs (the
        train head's and tail's, validation's and test's)."""
        n_train = len(cls_idx[TRAIN])
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
            metrics[f"{name}_err_pct"] = (100.0 * metrics[f"{name}_n_err"]
                                          / len(cls_idx[k]))
        if self.loss_function == "mse":
            metrics["train_mse"] = metrics["train_loss"]
            if "validation_loss" in metrics:
                metrics["validation_mse"] = metrics["validation_loss"]
        return metrics


def _sample_shape(loader) -> tuple:
    """The per-sample input shape the model sees: a streaming loader's
    (post-augmentation) ``sample_shape``, else the resident data's."""
    if isinstance(loader, StreamingLoader):
        return tuple(int(s) for s in loader.sample_shape)
    return tuple(int(s) for s in loader.original_data.shape[1:])


def _train_gauges() -> dict:
    """The training gauges of ``REGISTRY`` (the reference's names and
    meanings), by short name."""
    return {
        "step_ms": REGISTRY.gauge(
            "train_step_time_ms",
            "mean per-minibatch wall time over the last epoch, "
            "milliseconds (fused loop: epoch wall / steps)"),
        "eps": REGISTRY.gauge(
            "train_examples_per_sec",
            "training examples consumed per second over the last epoch"),
        "epoch": REGISTRY.gauge("train_epoch",
                                "last completed training epoch index"),
        "device_ms": REGISTRY.gauge(
            "train_device_ms",
            "wall time of the last epoch spent inside the trainer's calls "
            "and its one readback; dispatch is asynchronous here, so the "
            "calls return once their steps are queued and most of the "
            "device's time shows up as the readback's wait (the first "
            "epoch also carries each step variant's eager run and CUDA "
            "graph capture)"),
        "host_ms": REGISTRY.gauge(
            "train_host_ms",
            "wall time of the last epoch NOT inside the trainer's calls "
            "(loader shuffle, metrics, decision, snapshots and checkpoint "
            "copies) — host-dominated epochs are a pipeline problem")}


def sample_snapshotter_config(tree, explicit):
    """The defaulting rule every sample uses for its snapshotter: an
    explicit argument (even ``{}`` = all defaults) wins; otherwise the
    sample's config tree (``root.<name>.snapshotter``, reachable from
    config files and ``--set``) provides it."""
    return explicit if explicit is not None else tree.get("snapshotter")


def _lr_scales(adj, which: str, epoch: int, steps_per_epoch: int):
    """(head scales, tail scale) of the adjuster's ``which`` policy for
    one epoch, the iterations counted as ``LearningRateAdjust`` counts
    them on the tick path: the epoch's one scale, or (``by_epoch`` False)
    one per train minibatch — the head's as a float32 array, the deferred
    tail's alone.  (1.0, 1.0) without an adjuster; (None, None) for a
    bias policy that is the weights' (the bias scales follow them)."""
    if adj is None:
        return (1.0, 1.0) if which == "policy" else (None, None)
    policy = getattr(adj, which)
    if which == "bias_policy" and policy is adj.policy:
        return None, None
    if adj.by_epoch:
        s = policy.scale(epoch)
        return s, s
    base = epoch * steps_per_epoch
    head = np.asarray([policy.scale(base + i)
                       for i in range(steps_per_epoch - 1)], np.float32)
    return head, policy.scale(base + steps_per_epoch - 1)
