"""Fused train step on torch tensors (port of
``znicz_tpu/parallel/fused.py``).

The same math as the reference's jitted step — forward chain, softmax-CE
(or MSE) head, hand-written backward chain and momentum SGD update — as
plain functions over a list of ``(w, b)`` tensors, the update written over
the parameters and velocities in place.  ``FusedTrainer`` runs an epoch
over minibatches gathered on the device from the resident dataset: on the
card each step is a replay of a CUDA graph (``parallel.capture``), the
counterpart of the reference's jitted ``lax.scan``, with the step's
indices, mask and learning-rate scales read from a plan copied in once a
call; elsewhere, and for a spec with dropout, the same step functions run
one by one.  Per-step metrics stay in device tensors until the caller
reads them, so an epoch needs one host sync.  ``accum_steps`` sums the
gradients of consecutive steps before one update, and ``lr_scale``
multiplies the learning rates per step (the LR adjusters' schedules).

The port covers every kind of the reference's fused path: ``fc``,
standalone ``activation``, ``conv``, ``max_pool``, ``maxabs_pool``,
``avg_pool``, ``stochastic_pool``, ``stochastic_abs_pool``, ``lrn``, the
merged LRN→max-pool pair ``lrn_pool``, ``dropout``, ``depooling`` (tied by
``tie`` to the pool whose winner slots it scatters through) and ``deconv``
(tied or not to an encoder conv's weights).

Dropout and the stochastic pools draw from the counter RNG keyed by
(stream seed, unit id, epoch, counter), the counter being the loader's
sample offset after the step, so the masks and picks equal the
reference's bit for bit.  Dropout's key is folded on the host and handed
to the kernel; a stochastic pool folds its key from the epoch and counter
where they live: Python ints on an uncaptured step, the plan row's device
words on a captured one (``rngbits.fold_t``), so a replayed graph draws
each step's own bits.

Under a mesh (``parallel/mesh.py``: a ``torch.distributed`` process group of
dp·tp ranks) each rank runs ``forward``/``backward`` on its share with a
:class:`StepShard`: its rows of the global minibatch (the loss and error
normalized by the global mask sum), and with tp > 1 the Megatron layout of
``mesh.plan_tp_sharding`` — a split-output layer leaves its output sharded
on the last axis, a split-input layer all-reduces its partial output over
the model row, cross-channel layers (LRN, the LRN→pool pair, the loss head)
gather the channels first, and the backward mirrors each of these.
Dropout and the stochastic pools draw a shard's bits at its elements of
the global tensor (``rngbits.flat_index``), as the reference's mesh step
draws them over the global batch."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import activations, conv as conv_ops, deconv as deconv_ops
from ..ops import dropout as drop_ops
from ..ops import lrn_pool as lrn_pool_ops
from ..ops import normalization as lrn_ops
from ..ops import pooling as pool_ops
from ..ops import rngbits
from ..ops import softmax as softmax_ops
from ..ops import tuning
from ..ops import update as update_ops
from . import mesh as mesh_lib

#: Layer kinds with trainable parameters.
PARAM_KINDS = ("fc", "conv", "deconv")

#: The kinds of the fused step (every kind of the reference's).
STOCHASTIC_KINDS = ("stochastic_pool", "stochastic_abs_pool")
PORTED_KINDS = ("fc", "activation", "conv", "max_pool", "maxabs_pool",
                "avg_pool", *STOCHASTIC_KINDS, "lrn", "lrn_pool", "dropout",
                "deconv", "depooling")
#: Kinds a depooling layer may tie to (they record winner slots).
OFFSET_KINDS = ("max_pool", "maxabs_pool", "lrn_pool", *STOCHASTIC_KINDS)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str                     # PORTED_KINDS
    activation: str               # activations.BY_NAME key; last fc layer
    include_bias: bool            # of a softmax model keeps "linear"
    hypers: tuple                 # (lr, weights_decay, l1_vs_l2, momentum)
    hypers_bias: tuple
    config: tuple = ()            # static kind-specific kv pairs (sorted)

    @property
    def cfg(self) -> dict:
        return dict(self.config)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    layers: tuple[LayerSpec, ...]
    loss: str                     # "softmax" | "mse"
    #: dtype of the matmul operands (products accumulate in float32)
    compute_dtype: str = "float32"
    #: dtype activations are stored in between layers (and so in the
    #: backward caches): float32, bfloat16 or float16; the last layer's
    #: output, every error and every gradient stay float32, and each
    #: kernel that reads a stored activation computes in float32 and
    #: rounds once where it stores one
    storage_dtype: str = "float32"
    #: per-spec-row index into the workflow's layers (write-back map): the
    #: lrn_pool merge makes spec rows fewer than layers; () means identity
    unit_index: tuple = ()

    def __post_init__(self):
        for layer in self.layers:
            if layer.kind not in PORTED_KINDS:
                raise ValueError(f"unknown layer kind {layer.kind!r}")
        if self.loss not in ("softmax", "mse"):
            raise ValueError(f"unknown loss {self.loss!r}")
        torch_dtype(self.compute_dtype)
        torch_dtype(self.storage_dtype)
        # the softmax-CE head consumes 2D logits and backward() hands the
        # last layer a pre-activation error — only well-defined for a
        # final fc layer; the MSE head accepts any output shape
        if (self.loss == "softmax" and self.layers
                and self.layers[-1].kind != "fc"):
            raise NotImplementedError(
                f"the fused softmax path requires a final fc layer (got "
                f"{self.layers[-1].kind!r})")
        for i, layer in enumerate(self.layers):
            _check_tie(self.layers, i)
        for layer in self.layers:
            act = activations.BY_NAME[layer.activation]
            if layer.kind == "lrn_pool":
                activations.fold_id(layer.cfg.get("fold_act"))
            if act.needs_input and layer.kind in PARAM_KINDS:
                # fc caches only the layer *input*, not the pre-activation
                # tensor these derivatives need
                raise NotImplementedError(
                    f"activation {layer.activation!r} fused into a "
                    f"{layer.kind} layer needs its pre-activation input "
                    f"for the backward pass; insert it as a standalone "
                    f"'activation' layer instead")

    def act(self, i: int):
        return activations.BY_NAME[self.layers[i].activation]


def _check_tie(layers, i: int) -> None:
    """A depooling row must tie to an earlier pool that records winner
    slots.  A tied deconv must tie to an earlier conv and, as in the
    reference's ``extract_model``, carry no bias and have no trainable
    layer below the tied conv: the unit graph propagates err below it
    through the weights the deconv's update already changed, which a
    step computing every gradient from the pre-update weights cannot
    reproduce (the unit graph runs those nets)."""
    layer = layers[i]
    tie = layer.cfg.get("tie")
    if layer.kind == "depooling":
        if tie is None or not 0 <= tie < i \
                or layers[tie].kind not in OFFSET_KINDS:
            raise ValueError(f"depooling row {i} must tie to an earlier "
                             f"{'/'.join(OFFSET_KINDS)} row, got tie={tie}")
    elif layer.kind == "deconv" and tie is not None:
        if not 0 <= tie < i or layers[tie].kind != "conv":
            raise ValueError(f"deconv row {i} must tie to an earlier conv "
                             f"row, got tie={tie}")
        if layer.include_bias or any(la.kind in PARAM_KINDS
                                     for la in layers[:tie]):
            raise NotImplementedError(
                f"deconv row {i} tied to conv row {tie} with a bias or a "
                f"trainable layer below the conv: the reference's fused "
                f"path refuses it too (znicz_tpu/parallel/fused.py), so "
                f"this one does; train it on the unit graph (fused=False)")


def _rnd(a: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``a`` rounded to ``cdt`` and back to float32 (a no-op for float32):
    the reference's ``a.astype(cdt)`` operand of a float32-accumulated
    product.  Products of bf16/f16 values are exact in float32, so the
    float32 product of the rounded operands is the reference's result."""
    return a.to(cdt).float()


def _mm(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """float32 product of operands rounded to ``cdt`` — the reference's
    ``jnp.dot(a.astype(cdt), b.astype(cdt), preferred_element_type=f32)``."""
    return torch.matmul(_rnd(a, cdt), _rnd(b, cdt))


def _merge_lrn_pool(layers, params, vels):
    """Collapse each (lrn, max_pool|maxabs_pool) pair whose pool is
    ``lrn_pool.fusable`` into one ``lrn_pool`` row under the routing of
    ``ZNICZ_TPU_LRN_POOL`` (``ops/tuning.py``, read here, as the
    reference's ``_merge_lrn_pool`` reads it):

    - ``split``: no merge (the layers as given);
    - ``nofold``: the merge alone;
    - ``fused1`` (the port's default): the merge, and the preceding conv's
      y-only activation derivative folded into the pair's backward
      (``fold_act`` on the pair, ``act_folded`` on the conv);
    - ``fused2``: ``fused1``, and a folded pair's conv emits the pair's
      column-parity halves (``split_out``) and takes the pair's gradient
      back as halves (``emit_split`` on the pair).

    ``tie`` indices are remapped.  Returns (layers, params, vels,
    unit_index), the last mapping each row to its original layer (the
    write-back map)."""
    identity = tuple(range(len(layers)))
    if not tuning.lrn_pool_merge():
        return layers, params, vels, identity
    out_l, out_p, out_v, src, idx_map = [], [], [], [], {}
    i = 0
    while i < len(layers):
        la = layers[i]
        pool = layers[i + 1] if i + 1 < len(layers) else None
        if (la.kind == "lrn" and pool is not None
                and pool.kind in ("max_pool", "maxabs_pool")
                and lrn_pool_ops.fusable(pool.cfg["ksize"],
                                         pool.cfg["stride"],
                                         pool.cfg["padding"])):
            cfg = dict(la.config)
            cfg.update(pool.config)
            cfg["use_abs"] = pool.kind == "maxabs_pool"
            prev = out_l[-1] if out_l else None
            if (prev is not None and prev.kind in ("conv", "deconv")
                    and tuning.lrn_pool_act_fold()
                    and prev.activation != "linear"
                    and not activations.BY_NAME[prev.activation]
                    .needs_input):
                cfg["fold_act"] = prev.activation
                prev_cfg = dict(prev.config, act_folded=True)
                if prev.kind == "conv" and tuning.lrn_pool_split_conv():
                    prev_cfg["split_out"] = True
                    cfg["emit_split"] = True
                out_l[-1] = dataclasses.replace(
                    prev, config=tuple(sorted(prev_cfg.items())))
            idx_map[i] = idx_map[i + 1] = len(out_l)
            out_l.append(LayerSpec(
                kind="lrn_pool", activation="linear", include_bias=False,
                hypers=la.hypers, hypers_bias=la.hypers_bias,
                config=tuple(sorted(cfg.items()))))
            out_p.append((None, None))
            out_v.append((None, None))
            src.append(i)                 # paramless: index is nominal
            i += 2
        else:
            idx_map[i] = len(out_l)
            out_l.append(la)
            out_p.append(params[i])
            out_v.append(vels[i])
            src.append(i)
            i += 1
    if len(out_l) == len(layers):
        return layers, params, vels, identity
    remapped = []
    for la in out_l:
        if "tie" in la.cfg:
            cfg = dict(la.cfg, tie=idx_map[la.cfg["tie"]])
            la = dataclasses.replace(la, config=tuple(sorted(cfg.items())))
        remapped.append(la)
    return remapped, out_p, out_v, tuple(src)


def dropout_key(cfg: dict, epoch: int, ctr: int) -> int:
    """The u32 key of a dropout layer's mask at (epoch, counter)."""
    return rngbits.fold(cfg["seed"], cfg["unit_id"], epoch, ctr)


def forward(spec: ModelSpec, params, x, *, want_caches: bool,
            train: bool = False, epoch=0, ctr=0, shard=None):
    """(net output before the loss, caches).  For softmax loss the last
    layer's output is the *logits*; ``caches[i]`` = (layer input, aux),
    aux being the pool winner offsets of a max, stochastic or merged
    LRN→max pool and None elsewhere (the LRN backward recomputes its
    denominator from the cached input; dropout regenerates its mask).
    A ``split_out`` conv hands the pair after it its output as the
    column-parity halves (xe, xo), which the pair caches as its input.
    ``epoch``/``ctr`` key the dropout masks and the stochastic pools'
    draws when ``train`` (ints, or for the pools one-element integer
    tensors on the device); eval is dropout-free and pools
    deterministically.  ``shard`` (a :class:`StepShard`) runs a mesh
    rank's part: x its rows, params its slices, the collectives of the
    layout in place, the output whole; each cache then also holds the
    layer's own output (``y``), which the next layer may see gathered or
    sliced."""
    cdt = torch_dtype(spec.compute_dtype)
    sdt = torch_dtype(spec.storage_dtype)
    h = x
    caches = []
    # every row's winner slots and input shape, which a depooling row tied
    # to it reads
    auxes, in_shapes = [], []
    n = len(spec.layers)
    for i, (layer, (w, b)) in enumerate(zip(spec.layers, params)):
        if shard is not None:
            h = shard.before(i, h)
        x_in, aux = h, None
        if isinstance(h, tuple):   # a split-out conv's halves: the logical
            b_, h_, we, c_ = h[0].shape            # shape for the ties
            in_shapes.append((b_, h_, we + h[1].shape[2], c_))
        else:
            in_shapes.append(tuple(h.shape))
        cfg = layer.cfg
        is_last = i == n - 1
        if layer.kind == "fc":
            pre = _mm(h.reshape(h.shape[0], -1), w, cdt)
            if shard is not None:
                pre, b = shard.partial(i, pre), shard.bias(i, b)
            if b is not None:
                pre = pre + b
            if is_last and spec.loss == "softmax":
                h = pre                   # logits; softmax fused with CE
            else:
                h = activations.apply_fwd(spec.act(i), pre)
        elif layer.kind == "conv" and cfg.get("split_out"):
            # the fused2 routing: the conv emits the pair's halves
            halves = conv_ops.conv2d_split(_rnd(h, cdt), _rnd(w, cdt),
                                           cfg["stride"], cfg["padding"])
            if shard is not None:
                halves, b = shard.partial(i, halves), shard.bias(i, b)
            h = tuple(activations.apply_fwd(
                spec.act(i), half if b is None else half + b)
                for half in halves)
        elif layer.kind == "conv":
            pre = conv_ops.conv2d(_rnd(h, cdt), _rnd(w, cdt), cfg["stride"],
                                  cfg["padding"])
            if shard is not None:
                pre, b = shard.partial(i, pre), shard.bias(i, b)
            if b is not None:
                pre = pre + b
            h = activations.apply_fwd(spec.act(i), pre)
        elif layer.kind == "deconv":
            wt = w if w is not None else params[cfg["tie"]][0]
            pre = deconv_ops.deconv2d(_rnd(h, cdt), _rnd(wt, cdt),
                                      cfg["stride"], cfg["padding"])
            if b is not None:
                pre = pre + b
            h = activations.apply_fwd(spec.act(i), pre)
        elif layer.kind == "depooling":
            aux = auxes[cfg["tie"]]
            h = pool_ops.depooling(h, aux, in_shapes[cfg["tie"]],
                                   cfg["ksize"], cfg["stride"],
                                   cfg["padding"])
        elif layer.kind == "max_pool":
            h, aux = pool_ops.max_pooling(h, cfg["ksize"], cfg["stride"],
                                          cfg["padding"])
        elif layer.kind == "maxabs_pool":
            h, aux = pool_ops.maxabs_pooling(h, cfg["ksize"],
                                             cfg["stride"], cfg["padding"])
        elif layer.kind == "avg_pool":
            h = pool_ops.avg_pooling(h, cfg["ksize"], cfg["stride"],
                                     cfg["padding"])
        elif layer.kind in STOCHASTIC_KINDS:
            u = None
            if train:
                shape = pool_ops.pool_out_shape(h.shape, cfg["ksize"],
                                                cfg["stride"], cfg["padding"])
                u = pool_ops.stochastic_uniform(
                    cfg["seed"], (cfg["unit_id"], epoch, ctr), shape,
                    h.device, None if shard is None
                    else shard.index(i, shape))
            h, aux = pool_ops.stochastic_pooling(
                h, cfg["ksize"], cfg["stride"], cfg["padding"], u,
                use_abs=layer.kind == "stochastic_abs_pool",
                deterministic=not train)
        elif layer.kind == "lrn":
            h = lrn_ops.lrn_y(h, cfg["n"], cfg["alpha"], cfg["beta"],
                              cfg["k"])
        elif layer.kind == "lrn_pool" and isinstance(h, tuple):
            h, aux = lrn_pool_ops.lrn_maxpool_split(
                *h, cfg["n"], cfg["alpha"], cfg["beta"], cfg["k"],
                cfg["ksize"], cfg["stride"], cfg["padding"], cfg["use_abs"])
        elif layer.kind == "lrn_pool":
            h, aux = lrn_pool_ops.lrn_maxpool(
                h, cfg["n"], cfg["alpha"], cfg["beta"], cfg["k"],
                cfg["ksize"], cfg["stride"], cfg["padding"], cfg["use_abs"])
        elif layer.kind == "dropout":
            if train:
                h = drop_ops.dropout(h, dropout_key(cfg, epoch, ctr),
                                     cfg["ratio"], None if shard is None
                                     else shard.index(i, h.shape))
        elif layer.kind == "activation":
            h = activations.apply_fwd(spec.act(i), h)
        else:   # ModelSpec refuses unported kinds
            raise NotImplementedError(layer.kind)
        if sdt != torch.float32 and not is_last:
            # storage cast between layers: the next layer's input (and its
            # backward cache) live in sdt; the last layer's output stays
            # f32 so the loss head and its error are full precision
            h = (tuple(t.to(sdt) for t in h) if isinstance(h, tuple)
                 else h.to(sdt))
        auxes.append(aux)
        if want_caches:
            caches.append((x_in, aux) if shard is None else (x_in, aux, h))
    if shard is not None:
        h = shard.after_last(h)
    return h, caches


def _loss_and_err(spec: ModelSpec, out, target, mask, bs=None):
    """(mean loss, err w.r.t. last pre-activation, n_err); ``mask`` is a
    per-row 0/1 vector zeroing the wrap-padded tail of a short final
    minibatch, so metrics and gradients count each sample once.  ``bs``
    (a mesh rank's rows of a global minibatch): the global mask sum the
    means divide by, so the ranks' losses and gradients sum to the
    whole's."""
    if bs is None:
        bs = torch.clamp(torch.sum(mask), min=1.0)
    if spec.loss == "softmax":
        probs, loss, err = softmax_ops.softmax_ce_from_logits(out, target)
        n_err = torch.sum((torch.argmax(probs, dim=1) != target) * mask)
        return (torch.sum(loss * mask) / bs, err * mask[:, None] / bs,
                n_err.to(torch.int32))
    mask_b = mask.reshape((-1,) + (1,) * (out.dim() - 1))
    diff = (out - target.reshape(out.shape)) * mask_b
    feats = int(np.prod(out.shape[1:]))
    loss = torch.sum(diff * diff) / (bs * feats)
    # err w.r.t. the activated output, scaled 1/batch (EvaluatorMSE);
    # grad_minibatch folds it through the last activation
    return loss, diff / bs, torch.zeros((), dtype=torch.int32,
                                        device=out.device)


def backward(spec: ModelSpec, params, caches, out, err, epoch=0, ctr=0,
             shard=None):
    """Hand-written gradient chain (same math as the GD* units).  ``err``
    on entry: w.r.t. the last layer's pre-activation.  ``epoch``/``ctr``
    regenerate the training forward's dropout masks.  ``shard``: the
    mesh rank's part (:func:`forward`); a split-output layer's bias
    gradient comes back whole with zeros outside the rank's slice."""
    cdt = torch_dtype(spec.compute_dtype)
    grads = [None] * len(spec.layers)
    n = len(spec.layers)
    for i in reversed(range(n)):
        layer = spec.layers[i]
        w, b = params[i]
        x_in, aux = caches[i][:2]
        if shard is None:
            y_i = caches[i + 1][0] if i < n - 1 else out
        else:
            y_i = caches[i][2]
            err = shard.back_after(i, err, y_i)
        cfg = layer.cfg
        if layer.kind in PARAM_KINDS:
            # act_folded: the merged lrn_pool above applied this
            # derivative in its kernel already (and handed a split_out
            # conv its err as the halves)
            err_pre = err if i == n - 1 or cfg.get("act_folded") else \
                activations.apply_bwd(spec.act(i), err.reshape(y_i.shape),
                                      y_i)
        if layer.kind == "fc":
            x2 = x_in.reshape(x_in.shape[0], -1)
            err2 = err_pre.reshape(x2.shape[0], -1)
            gw = _mm(x2.t(), err2, cdt)
            gb = torch.sum(err2, dim=0) if b is not None else None
            err = _mm(err2, w.t(), cdt).reshape(x_in.shape)
            grads[i] = (gw, gb)
        elif layer.kind == "conv" and cfg.get("split_out"):
            ee, eo = (_rnd(e, cdt) for e in err_pre)
            gw = conv_ops.conv2d_grad_weights_split(
                _rnd(x_in, cdt), ee, eo, w.shape, cfg["stride"],
                cfg["padding"])
            gb = (torch.sum(err_pre[0], dim=(0, 1, 2))
                  + torch.sum(err_pre[1], dim=(0, 1, 2))
                  if b is not None else None)
            err = None if i == 0 else conv_ops.conv2d_grad_input_split(
                ee, eo, _rnd(w, cdt), x_in.shape, cfg["stride"],
                cfg["padding"])
            grads[i] = (gw, gb)
        elif layer.kind == "conv":
            gw = conv_ops.conv2d_grad_weights(
                _rnd(x_in, cdt), _rnd(err_pre, cdt), w.shape, cfg["stride"],
                cfg["padding"])
            gb = (torch.sum(err_pre, dim=(0, 1, 2)) if b is not None
                  else None)
            # the first layer's input error is never read: skip its conv
            err = None if i == 0 else conv_ops.conv2d_grad_input(
                _rnd(err_pre, cdt), _rnd(w, cdt), x_in.shape, cfg["stride"],
                cfg["padding"])
            grads[i] = (gw, gb)
        elif layer.kind == "deconv":
            # a tied deconv's gradient is shaped like the encoder's W
            wt = w if w is not None else params[cfg["tie"]][0]
            gw = deconv_ops.deconv2d_grad_weights(
                _rnd(err_pre, cdt), _rnd(x_in, cdt), tuple(wt.shape),
                cfg["stride"], cfg["padding"])
            gb = (torch.sum(err_pre, dim=(0, 1, 2)) if b is not None
                  else None)
            err = None if i == 0 else deconv_ops.deconv2d_grad_input(
                _rnd(err_pre, cdt), _rnd(wt, cdt), cfg["stride"],
                cfg["padding"])
            grads[i] = (gw, gb)
        elif layer.kind == "depooling":
            err = pool_ops.gd_depooling(err.reshape(y_i.shape), aux,
                                        cfg["ksize"], cfg["stride"],
                                        cfg["padding"])
        elif layer.kind in ("max_pool", "maxabs_pool", *STOCHASTIC_KINDS):
            err = pool_ops.gd_max_pooling(
                err.reshape(y_i.shape), aux, x_in.shape, cfg["ksize"],
                cfg["stride"], cfg["padding"])
        elif layer.kind == "avg_pool":
            err = pool_ops.gd_avg_pooling(
                err.reshape(y_i.shape), x_in.shape, cfg["ksize"],
                cfg["stride"], cfg["padding"])
        elif layer.kind == "lrn":
            err = lrn_ops.gd_lrn_x(err.reshape(y_i.shape), x_in, cfg["n"],
                                   cfg["alpha"], cfg["beta"], cfg["k"])
        elif layer.kind == "lrn_pool" and isinstance(x_in, tuple):
            err = lrn_pool_ops.gd_lrn_maxpool_split(
                err.reshape(y_i.shape), aux, *x_in, cfg["n"], cfg["alpha"],
                cfg["beta"], cfg["k"], cfg["ksize"], cfg["stride"],
                cfg["padding"], cfg.get("fold_act"),
                return_split=bool(cfg.get("emit_split")))
        elif layer.kind == "lrn_pool":
            err = lrn_pool_ops.gd_lrn_maxpool(
                err.reshape(y_i.shape), aux, x_in, cfg["n"], cfg["alpha"],
                cfg["beta"], cfg["k"], cfg["ksize"], cfg["stride"],
                cfg["padding"], cfg.get("fold_act"))
        elif layer.kind == "dropout":
            err = drop_ops.dropout(err.reshape(x_in.shape).contiguous(),
                                   dropout_key(cfg, epoch, ctr), cfg["ratio"],
                                   None if shard is None
                                   else shard.index(i, x_in.shape))
        elif layer.kind == "activation":
            err = activations.apply_bwd(spec.act(i), err.reshape(y_i.shape),
                                        y_i, x_in)
        else:   # ModelSpec refuses unported kinds
            raise NotImplementedError(layer.kind)
        if shard is not None and grads[i] is not None:
            grads[i], err = shard.back_param(i, grads[i], err)
    return grads


def apply_updates(spec: ModelSpec, params, vels, grads, lr_scale=None,
                  lr_scale_bias=None, many=None):
    """Momentum SGD with decay, layers in REVERSE order (the GD chain's
    execution order): reg = wd·((1−l1)·w + ½·l1·sign w),
    v′ = mom·v − (lr·s)·(g + reg), w′ = w + v′, written over the
    parameters and velocities in place (the reference donates them), every
    W and b of the step in one ``many`` call (default
    ``ops.update.sgd_update_many``: one kernel launch on the card) with the
    fused step's constants.  ``lr_scale`` (s of the weights) and
    ``lr_scale_bias`` (of the biases; default: ``lr_scale``) are
    one-element float32 tensors on the parameters' device, which the
    kernel reads there, or None for 1.  A tied deconv updates the encoder
    conv's W (``params[tie]``) with its own velocity, before the conv's own
    update reads W for its decay term, as the unit graph's two GD units
    do: a W that a call already updates starts the next call, which reads
    the new W.  Returns ``(params, vels)``, the lists given."""
    many = many or update_ops.sgd_update_many
    if lr_scale_bias is None:
        lr_scale_bias = lr_scale
    entries, pending = [], set()   # the pending call, and the rows whose W
    #                                it updates

    def call():
        many(entries, inplace=True)
        entries.clear()
        pending.clear()

    for i in reversed(range(len(spec.layers))):
        layer, grad = spec.layers[i], grads[i]
        if grad is None:
            continue
        tgt = layer.cfg.get("tie", i) if layer.kind == "deconv" else i
        if tgt in pending:
            call()
        (vw, vb), (gw, gb) = vels[i], grad
        entries.append((params[tgt][0], gw, vw,
                        update_ops.fused_constants(layer.hypers), lr_scale))
        pending.add(tgt)
        b = params[i][1]
        if b is not None:
            entries.append((b, gb, vb,
                            update_ops.fused_constants(layer.hypers_bias),
                            lr_scale_bias))
    if entries:
        call()
    return params, vels


def _ones(x):
    return torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)


def grad_minibatch(spec: ModelSpec, params, x, target, mask=None,
                   epoch=0, ctr=0, shard=None, bs=None):
    """(grads, metrics) of one minibatch — train_minibatch without the
    update, the building block gradient accumulation composes.  With
    ``shard`` (and ``bs``, the global mask sum) a mesh rank's share: its
    gradients and metrics are its part of the sums over the ranks."""
    if mask is None:
        mask = _ones(x)
    out, caches = forward(spec, params, x, want_caches=True, train=True,
                          epoch=epoch, ctr=ctr, shard=shard)
    loss, err, n_err = _loss_and_err(spec, out, target, mask, bs)
    last = len(spec.layers) - 1
    if spec.loss == "mse" and spec.layers[last].kind in PARAM_KINDS:
        # backward() expects pre-activation err at a param layer
        err = activations.apply_bwd(spec.act(last), err, out)
    grads = backward(spec, params, caches, out, err, epoch=epoch, ctr=ctr,
                     shard=shard)
    return grads, {"loss": loss, "n_err": n_err}


def grad_zeros(spec: ModelSpec, params):
    """Float32 zeros shaped like backward()'s gradients (a tied deconv's
    like the encoder's W, at the deconv's row; None for rows without):
    the accumulator of ``accum_steps``."""
    zs = []
    for i, layer in enumerate(spec.layers):
        w, b = params[i]
        if layer.kind not in PARAM_KINDS:
            zs.append(None)
            continue
        if w is None:
            w = params[layer.cfg["tie"]][0]
        zs.append(tuple(None if t is None else torch.zeros(
            t.shape, dtype=torch.float32, device=t.device) for t in (w, b)))
    return zs


def train_minibatch(spec: ModelSpec, params, vels, x, target, mask=None,
                    epoch=0, ctr=0, lr_scale=None, lr_scale_bias=None):
    """One step, the update in place; returns (params, vels, metrics)."""
    grads, metrics = grad_minibatch(spec, params, x, target, mask,
                                    epoch=epoch, ctr=ctr)
    apply_updates(spec, params, vels, grads, lr_scale, lr_scale_bias)
    return params, vels, metrics


def eval_minibatch(spec: ModelSpec, params, x, target, mask=None,
                   shard=None, bs=None):
    if mask is None:
        mask = _ones(x)
    out, _ = forward(spec, params, x, want_caches=False, shard=shard)
    loss, _, n_err = _loss_and_err(spec, out, target, mask, bs)
    return {"loss": loss, "n_err": n_err}


def _gather_last(mesh, t, size: int):
    """The whole last axis (``size``) from each model index's contiguous
    share: the share written into zeros, summed over the model row (exact:
    one writer a slot; float32 on the wire, back to t's dtype)."""
    if isinstance(t, tuple):
        return tuple(_gather_last(mesh, u, size) for u in t)
    n = t.shape[-1]
    full = torch.zeros(t.shape[:-1] + (size,), dtype=torch.float32,
                       device=t.device)
    full[..., mesh.model_index * n:(mesh.model_index + 1) * n] = t
    return mesh.all_reduce(full, mesh.model_group).to(t.dtype)


def _slice_last(mesh, t, size: int):
    """This model index's contiguous share of a last axis of ``size``."""
    if isinstance(t, tuple):
        return tuple(_slice_last(mesh, u, size) for u in t)
    sl = mesh_lib.shard_index(size, mesh.tp, mesh.model_index)
    return t[..., sl].contiguous()


def _tp_dims(spec: ModelSpec, params, tp: int) -> list:
    """Each row's weight split dim under ``tp`` (``mesh.plan_tp_sharding``
    over the parameterized rows in order; a tied deconv takes its
    encoder's): the reference's layout."""
    dims, pidx = [None] * len(spec.layers), 0
    for i, (w, _) in enumerate(params):
        if w is not None:
            dims[i], pidx = mesh_lib.plan_tp_sharding(tp, pidx,
                                                      tuple(w.shape))
    for i, layer in enumerate(spec.layers):
        if layer.kind == "deconv" and "tie" in layer.cfg:
            dims[i] = dims[layer.cfg["tie"]]
    return dims


class StepShard:
    """One mesh rank's part of a train or eval step: which rows of the
    global minibatch it holds, and under tp > 1 the role of each layer in
    the Megatron layout and the conversions between layers.

    ``roles[i]``: ``"col"`` (weights split on the last dim: the output
    leaves sharded on its last axis), ``"row"`` (split on dim −2: the
    input comes sharded, the partial output is all-reduced over the model
    row) or None (replicated, or no weights).  ``pre[i]``: what happens to
    layer i's input first — ``"gather"`` (the whole last axis, for a
    col/replicated layer or a cross-channel one: LRN, the LRN→pool pair),
    ``"slice"`` (a row conv's channel share of a whole input) or
    ``"flat"`` (a row fc's share of a whole input's flattened features).
    ``state[i]``: the whole size of layer i's sharded last axis at its
    input, None when whole.  A row fc after a channel-sharded image takes
    the rows of its weights that those channels feed (NHWC flattening puts
    each pixel's channels together), so no gather is needed there.

    Built by :meth:`FusedTrainer` from the spec and the whole weights; the
    same object serves every step of the trainer."""

    def __init__(self, mesh, spec: ModelSpec, params):
        self.mesh = mesh
        tp, m = mesh.tp, mesh.model_index
        n = len(spec.layers)
        dims = _tp_dims(spec, params, tp)
        self.roles, self.pre = [None] * n, [None] * n
        self.state = [None] * n
        #: the whole last-axis size a "gather" before row i restores
        self.gathered = [None] * n
        #: (dim, index tensor) of each row's weight share (None: whole)
        self.select = [None] * n
        state, image = None, False        # the activation's shard, 4-D
        for i, layer in enumerate(spec.layers):
            kind, w = layer.kind, params[i][0]
            if tp > 1 and kind in ("deconv", "depooling"):
                raise NotImplementedError(
                    f"row {i}: a {kind} layer under tensor parallelism is "
                    "not ported (ROADMAP.md queue 1 item 9's remainder); "
                    "train it with tp = 1")
            dim = dims[i] if kind in ("fc", "conv") else None
            if dim == -1:
                if state is not None:
                    self.pre[i], self.gathered[i] = "gather", state
                    state = None
                self.roles[i] = "col"
                self.select[i] = (w.dim() - 1, self._range(w.shape[-1]))
                self.state[i] = state
                state, image = int(w.shape[-1]), kind == "conv"
                continue
            if dim == -2:
                rows = int(w.shape[-2])
                if kind == "conv":
                    if state is None:
                        self.pre[i] = "slice"
                    elif state != rows:
                        raise ValueError(f"row {i}: {state} channels in, "
                                         f"{rows} expected")
                    index = self._range(rows)
                elif state is not None and image:
                    # the pixel-major flattening of a channel share
                    k, px = state // tp, rows // state
                    index = (torch.arange(px)[:, None] * state + m * k
                             + torch.arange(k)[None, :]).reshape(-1)
                else:
                    if state is None:
                        self.pre[i] = "flat"
                    index = self._range(rows)
                self.roles[i], self.select[i] = "row", (w.dim() - 2, index)
                self.state[i], state = state, None
                continue
            if state is not None and (kind in ("fc", "conv", "lrn",
                                               "lrn_pool")):
                self.pre[i], self.gathered[i] = "gather", state
                state = None
            self.state[i] = state
        #: the last layer's output comes sharded: gather it for the loss
        self.final = state
        self._sizes = [None] * n    # whole last-axis sizes seen at runtime

    def _range(self, size: int) -> torch.Tensor:
        sl = mesh_lib.shard_index(size, self.mesh.tp, self.mesh.model_index)
        return torch.arange(sl.start, sl.stop)

    def take(self, i: int, t):
        """This rank's share of row i's weight (or velocity) ``t``."""
        if t is None or self.select[i] is None:
            return t
        dim, index = self.select[i]
        return t.index_select(dim, index.to(t.device)).contiguous()

    def give(self, i: int, t, whole_shape):
        """The whole weight from each rank's share ``t`` (every rank of the
        model row calls it)."""
        if t is None or self.select[i] is None:
            return t
        dim, index = self.select[i]
        full = torch.zeros(tuple(whole_shape), dtype=t.dtype,
                           device=t.device)
        full.index_copy_(dim, index.to(t.device), t)
        return self.mesh.all_reduce(full, self.mesh.model_group)

    # -- forward ------------------------------------------------------------
    def before(self, i: int, h):
        op, mesh = self.pre[i], self.mesh
        if op is None:
            return h
        if op == "gather":
            return _gather_last(mesh, h, self.gathered[i])
        size = (h[0] if isinstance(h, tuple) else h).shape[-1]
        if op == "slice":
            self._sizes[i] = size
            return _slice_last(mesh, h, size)
        flat = h.reshape(h.shape[0], -1)        # "flat"
        self._sizes[i] = tuple(h.shape)
        return _slice_last(mesh, flat, flat.shape[1])

    def partial(self, i: int, t):
        """A row layer's partial output summed over the model row."""
        if self.roles[i] != "row":
            return t
        if isinstance(t, tuple):
            return tuple(self.mesh.all_reduce(u, self.mesh.model_group)
                         for u in t)
        return self.mesh.all_reduce(t, self.mesh.model_group)

    def bias(self, i: int, b):
        """A col layer's share of its (whole, replicated) bias."""
        if b is None or self.roles[i] != "col":
            return b
        return b[self.select[i][1].to(b.device)]

    def index(self, i: int, shape) -> tuple:
        """``rngbits.flat_index``'s (base, width, row, col) of a tensor of
        ``shape`` at row i's input or output (dropout, the stochastic
        pools): the rank's rows of the global batch, its channels of the
        whole last axis."""
        mesh, b = self.mesh, int(shape[0])
        if self.state[i] is None:
            feat = int(np.prod(shape[1:]))
            return (mesh.data_index * b * feat, feat, feat, 0)
        size, k = self.state[i], int(shape[-1])
        feat = int(np.prod(shape[1:-1])) * size
        return (mesh.data_index * b * feat, k, size, mesh.model_index * k)

    def after_last(self, h):
        if self.final is None:
            return h
        return _gather_last(self.mesh, h, self.final)

    # -- backward -----------------------------------------------------------
    def back_after(self, i: int, err, y):
        """err w.r.t. row i's own output from err w.r.t. what the next row
        (or the loss) saw: the adjoint of the conversion in between."""
        mesh = self.mesh
        last = i == len(self.pre) - 1
        op = ("gather" if self.final is not None else None) if last \
            else self.pre[i + 1]
        if op is None:
            return err
        if op == "gather":
            size = self.final if last else self.gathered[i + 1]
            if isinstance(err, tuple):
                return _slice_last(mesh, err, size)
            ref = y[0] if isinstance(y, tuple) else y
            return _slice_last(mesh, err.reshape(ref.shape[:-1] + (size,)),
                               size)
        if op == "slice":
            return _gather_last(mesh, err, self._sizes[i + 1])
        shape = self._sizes[i + 1]                          # "flat"
        flat = err.reshape(err.shape[0], -1)
        return _gather_last(mesh, flat, int(np.prod(shape[1:]))
                            ).reshape(shape)

    def back_param(self, i: int, grad, err):
        """A col layer's bias gradient whole (zeros outside its share) and
        its partial input error summed over the model row."""
        if self.roles[i] != "col":
            return grad, err
        gw, gb = grad
        if gb is not None:
            full = torch.zeros(gb.shape[0] * self.mesh.tp, dtype=gb.dtype,
                               device=gb.device)
            full[self.select[i][1].to(gb.device)] = gb
            gb = full
        if err is not None:
            err = self.partial_sum(err)
        return (gw, gb), err

    def partial_sum(self, t):
        if isinstance(t, tuple):
            return tuple(self.partial_sum(u) for u in t)
        return self.mesh.all_reduce(t.contiguous(), self.mesh.model_group)


def to_host(*results: dict) -> list[dict]:
    """Device metric dicts → numpy, with ONE device→host copy for all of
    them (the epoch's single sync)."""
    keys = [(i, k) for i, r in enumerate(results) for k in sorted(r)]
    flat = torch.cat([results[i][k].reshape(-1).to(torch.float64)
                      for i, k in keys]).cpu().numpy()
    out: list[dict] = [{} for _ in results]
    pos = 0
    for i, k in keys:
        t = results[i][k]
        size = t.numel()
        dtype = np.int32 if k == "n_err" else np.float32
        out[i][k] = flat[pos:pos + size].astype(dtype).reshape(t.shape)
        pos += size
    return out


class FusedTrainer:
    """Owns device-resident params and velocities and runs whole epochs.

    ``params``/``vels``: lists of ``(w, b)`` tensors (``None`` for
    parameter-less layers or no bias), copied to ``device`` (default:
    CUDA, raising without it); the trainer updates its copies in place.
    ``workflow`` receives copies of them on :meth:`write_back`.

    ``accum_steps=k`` sums the gradients of ``k`` consecutive steps into
    float32 accumulators (``acc + g`` from zeros, the reference's order)
    and applies the sum, unscaled, every ``k``-th step and at the call's
    last step, at that step's learning-rate scale (the unit graph's
    accumulate_gradient with a deferred apply).

    On the card every step is replayed from a CUDA graph (``capture``,
    default: wherever the spec allows it; :attr:`captured` says whether it
    does and :attr:`uncaptured_reason` why not): one train and one eval
    step per batch size, dataset, conv tier and conv1 route, and with
    ``k > 1`` an accumulating train step and one that also applies, which
    the host picks per step as the reference's ``lax.cond`` does.  A captured train
    step reads its epoch and counter from its plan row, so a stochastic
    pool draws that step's bits on every replay.  A spec with a dropout
    layer runs the same step functions uncaptured, its mask key folded on
    the host each step (the device word the dropout kernel would read is
    ROADMAP.md queue 1 item 3); so does the CPU.

    ``augment`` (a ``loader.augment.RandomCropFlip`` or any policy with its
    ``device_apply``) crops and mirrors each train minibatch on the device
    from a resident dataset kept at decode size, keyed by (epoch, global
    row) as the streaming loaders' host crops are, and center-crops eval
    minibatches.  A captured step reads its rows and epoch from its plan
    row, so each replay crops afresh.

    ``mesh`` (a ``mesh.Mesh``, or a (dp, tp) shape for
    ``mesh.resolve_mesh``; (1, 1) is the meshless path): the trainer runs
    on the rank's device and holds the resident dataset whole, as the
    reference replicates it (a ``distributed.RowShard`` is gathered once).
    Each step takes the rank's rows [d·b/dp, (d+1)·b/dp) of the global
    minibatch (b must divide by dp), normalizes by the global mask sum,
    and all-reduces its gradients over the data column in one flat bucket
    (a split-output layer's whole-bias gradients, zero outside each
    share, in a second one over every rank) before the update, which every
    replica applies alike.  The metrics are summed over the data column
    once a call.  Under tp > 1 each rank holds its share of the weights
    (:class:`StepShard`); ``gather_params`` rebuilds them whole.  Mesh
    steps run uncaptured."""

    def __init__(self, workflow=None, spec: ModelSpec | None = None,
                 params=None, vels=None, device=None, mesh=None,
                 accum_steps: int = 1, augment=None,
                 capture: bool | None = None):
        if augment is not None and not hasattr(augment, "device_apply"):
            raise TypeError(f"augment needs a policy with device_apply (a "
                            f"loader.augment.RandomCropFlip), got "
                            f"{type(augment).__name__}")
        if not isinstance(accum_steps, int) or isinstance(
                accum_steps, bool) or accum_steps < 1:
            raise ValueError(f"accum_steps must be a positive int, got "
                             f"{accum_steps!r}")
        if device is None:
            from ..backends import resolve
            device = resolve(None)
        if mesh is not None:
            mesh = mesh_lib.resolve_mesh(mesh, site="train", device=device)
        #: the rank's mesh (None: one device)
        self.mesh = mesh
        self.spec = spec
        self.workflow = workflow
        self.device = torch.device(device) if mesh is None else mesh.device
        self.accum_steps = accum_steps
        #: the device crop of each minibatch (None: the rows as gathered)
        self.augment = augment
        #: an MSE step whose target is its (cropped) input
        self._x_is_target = False

        def put(pairs):   # copies: the trainer updates them in place
            return [tuple(None if t is None else
                          torch.as_tensor(t).to(self.device,
                                                copy=True).contiguous()
                          for t in pair) for pair in pairs]
        self.params = put(params)
        self.vels = put(vels)
        #: the rank's part of each step (None without a mesh)
        self.shard = None
        if mesh is not None:
            self.shard = StepShard(mesh, spec, self.params)
            self._whole = [tuple(None if t is None else tuple(t.shape)
                                 for t in pair) for pair in self.params]
            self.params = [(self.shard.take(i, w), b)
                           for i, (w, b) in enumerate(self.params)]
            self.vels = [(self.shard.take(i, w), b)
                         for i, (w, b) in enumerate(self.vels)]
        #: _place memo: id(source) -> (source, the whole dataset)
        self._placed: dict = {}
        #: why the steps run uncaptured (None: they replay CUDA graphs)
        self.uncaptured_reason = self._uncaptured(capture)
        if capture and self.uncaptured_reason is not None:
            raise ValueError(f"capture=True: {self.uncaptured_reason}")
        #: the next epoch number train_epoch keys dropout with when the
        #: caller passes none, so repeated calls never reuse masks
        self._auto_epoch = 0
        #: accum_steps > 1: the gradient sums, zero between groups
        self._acc = (grad_zeros(spec, self.params) if accum_steps > 1
                     else None)
        self._plans: dict = {}          # graph key → capture.StepPlan

    def _uncaptured(self, capture) -> str | None:
        if capture is False:
            return "capture=False"
        if self.mesh is not None:
            return (f"a mesh step's collectives run from the host "
                    f"({self.mesh.backend}; gloo stages a CUDA tensor "
                    f"through host memory): capturing NCCL collectives in "
                    f"CUDA graphs is a ROADMAP.md follow-up")
        if self.device.type != "cuda":
            return f"the {self.device.type} runs the step functions directly"
        if any(la.kind == "dropout" for la in self.spec.layers):
            return ("a dropout layer's mask key is folded on the host each "
                    "step (ROADMAP.md queue 1 item 3: the key read from a "
                    "device word)")
        return None

    @property
    def captured(self) -> bool:
        """Whether train and eval steps replay CUDA graphs."""
        return self.uncaptured_reason is None

    @staticmethod
    def _idx_matrix(indices: np.ndarray, batch: int, ctr_base: int = 0
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(steps, batch) int32 indices + 0/1 mask + per-step counter.
        The final short batch wraps around to a full one; the mask zeroes
        the padded tail so metrics and gradients count each sample once.
        The counter is the loader's sample offset after each step
        (``ctr_base`` = samples already consumed this epoch by earlier
        calls); it keys the dropout masks as the unit graph's loader
        offset does."""
        n = len(indices)
        steps = max(1, -(-n // batch))
        padded = np.resize(indices, steps * batch)
        mask = np.zeros(steps * batch, np.float32)
        mask[:n] = 1.0
        ctrs = (ctr_base + np.minimum((np.arange(steps) + 1) * batch, n)
                ).astype(np.uint32)
        return (padded.reshape(steps, batch).astype(np.int32),
                mask.reshape(steps, batch), ctrs)

    @staticmethod
    def _step_scales(lr_scale, lr_scale_bias, n_steps: int):
        """Per-step (weight, bias) learning-rate multipliers, float32, from
        scalar or per-step schedules (the bias's default: the weights')."""
        scales = np.broadcast_to(np.asarray(lr_scale, np.float32),
                                 (n_steps,))
        scales_b = scales if lr_scale_bias is None else np.broadcast_to(
            np.asarray(lr_scale_bias, np.float32), (n_steps,))
        return scales, scales_b

    def _applies(self, s: int, n_steps: int) -> bool:
        """Whether step ``s`` of a call updates the parameters."""
        return (self.accum_steps == 1 or (s + 1) % self.accum_steps == 0
                or s + 1 == n_steps)

    def _train_step(self, x, t, mask, s_w, s_b, epoch, ctr,
                    apply: bool, bs=None) -> dict:
        """One train step on the trainer's buffers (in place): with
        ``accum_steps`` 1 ``train_minibatch``, else the gradients added to
        the sums, which ``apply`` applies at (s_w, s_b) and zeroes.  Under
        a mesh the gradients (or sums) are all-reduced before the update;
        ``bs`` is the global minibatch's mask sum."""
        spec = self.spec
        if self.accum_steps == 1 and self.shard is None:
            return train_minibatch(spec, self.params, self.vels, x, t, mask,
                                   epoch=epoch, ctr=ctr, lr_scale=s_w,
                                   lr_scale_bias=s_b)[2]
        grads, metrics = grad_minibatch(spec, self.params, x, t, mask,
                                        epoch=epoch, ctr=ctr,
                                        shard=self.shard, bs=bs)
        if self.accum_steps == 1:
            self._reduce(grads)
            apply_updates(spec, self.params, self.vels, grads, s_w, s_b)
            return metrics
        accs = [a for pair in self._acc if pair for a in pair
                if a is not None]
        if accs:
            torch._foreach_add_(accs, [g for pair in grads if pair
                                       for g in pair if g is not None])
        if apply:
            if self.shard is not None:
                self._reduce(self._acc)
            apply_updates(spec, self.params, self.vels, self._acc, s_w, s_b)
            if accs:
                torch._foreach_zero_(accs)
        return metrics

    def _reduce(self, grads) -> None:
        """Sum a mesh step's gradients over the ranks, in place: one flat
        bucket over the data column (weight shares, and gradients that are
        alike across the model row), and the col layers' whole-bias
        gradients (zero outside each share) over every rank."""
        mesh, roles = self.mesh, self.shard.roles
        column, every = [], []
        for i, g in enumerate(grads):
            if g is None:
                continue
            gw, gb = g
            column.append(gw)
            if gb is not None:
                (every if roles[i] == "col" else column).append(gb)
        world = torch.distributed.group.WORLD if mesh.tp > 1 else None
        for group, ts in ((mesh.data_group, column), (world, every)):
            if group is None or not ts:
                continue
            bucket = torch.cat([t.reshape(-1) for t in ts])
            mesh.all_reduce(bucket, group, "grad")
            pos = 0
            for t in ts:
                t.copy_(bucket[pos:pos + t.numel()].view(t.shape))
                pos += t.numel()

    def _plan(self, kind: str, data, target, batch: int, n_steps: int):
        """The StepPlan of ``kind`` ("train" or "eval") at ``batch`` over
        ``data``/``target`` on the current conv tier and conv1 route (a
        graph reads them by address and runs the convs it was captured
        with)."""
        from . import capture
        key = (kind, batch, data.data_ptr(), tuple(data.shape), data.dtype,
               target.data_ptr(), tuple(target.shape), target.dtype,
               conv_ops.gemm_tier(), tuning.conv_s2d())
        plan = self._plans.get(key)
        if plan is None:
            if len(self._plans) >= 8:      # a few datasets and tiers
                self._plans.pop(next(iter(self._plans)))
            plan = self._plans[key] = capture.StepPlan(
                self.device, 2 * batch + 4 + (batch if self.augment else 0),
                max(n_steps, -(-data.shape[0] // batch) + 1),
                {"loss": torch.float32, "n_err": torch.int32})
        return plan

    @staticmethod
    def _rows(idx, mask, scales=None, scales_b=None, epoch: int = 0,
              ctrs=None, aug_rows=None) -> np.ndarray:
        """The plan rows: indices, mask bits, the weight and bias scales'
        bits, then the epoch's and the step's counter's bits as uint32,
        which key the stochastic pools' draws (zeros for an eval step), and
        with ``aug_rows`` the global rows that key each minibatch's crops."""
        n = idx.shape[0]
        cols = [idx, mask.view(np.int32)]
        for sc in (scales, scales_b):
            cols.append(np.zeros((n, 1), np.int32) if sc is None else
                        np.ascontiguousarray(sc, np.float32)
                        .view(np.int32).reshape(n, 1))
        cols.append(np.full((n, 1), int(epoch) & 0xFFFF_FFFF,
                            np.uint32).view(np.int32))
        cols.append(np.zeros((n, 1), np.int32) if ctrs is None else
                    np.ascontiguousarray(ctrs, np.uint32)
                    .view(np.int32).reshape(n, 1))
        if aug_rows is not None:
            cols.append(np.asarray(aug_rows, np.int32))
        return np.concatenate(cols, axis=1)

    def _inputs(self, data, target, i, rows, epoch, train: bool):
        """A step's (x, t): rows ``i`` of ``data``/``target``, x cropped by
        the augment policy at (``epoch``, global ``rows``) (center crops for
        eval), and t the cropped x where the step regresses its input."""
        x = data.index_select(0, i)
        if self.augment is not None:
            x = self.augment.device_apply(x, rows, epoch, train=train)
        t = x if self._x_is_target else target.index_select(0, i)
        return x, t

    def _run_captured(self, kind: str, data, target, idx, mask, scales=None,
                      scales_b=None, epoch: int = 0, ctrs=None,
                      aug_rows=None, feed=None) -> dict:
        """Each step replayed from its variant's graph.  ``aug_rows``: the
        global rows of each step where ``idx`` indexes something else (a
        streaming trainer's device ring); ``feed``: an object whose
        ``before(s)``/``after(s)`` run around step ``s`` (the ring's copy
        waits and releases)."""
        batch = idx.shape[1]
        n = idx.shape[0]
        plan = self._plan(kind, data, target, batch, n)
        if self.augment is not None and aug_rows is None:
            aug_rows = idx
        plan.load(self._rows(idx, mask, scales, scales_b, epoch, ctrs,
                             aug_rows if self.augment is not None else None))

        def step(variant: str):
            row = plan.row()
            i = row[:batch]
            m = row[batch:2 * batch].view(torch.float32)
            # the epoch and counter as device words: a replay folds the
            # stochastic pools' keys and the crops' from this step's row
            ep = row[2 * batch + 2:2 * batch + 3]
            x, t = self._inputs(data, target, i, row[2 * batch + 4:], ep,
                                variant != "eval")
            if variant == "eval":
                ms = eval_minibatch(self.spec, self.params, x, t, m)
            else:
                sc = row[2 * batch:2 * batch + 2].view(torch.float32)
                ms = self._train_step(x, t, m, sc[0:1], sc[1:2], ep,
                                      row[2 * batch + 3:2 * batch + 4],
                                      variant != "accumulate")
            plan.put("loss", ms["loss"])
            plan.put("n_err", ms["n_err"])
            plan.advance()

        for s in range(n):
            variant = ("eval" if kind == "eval" else "train"
                       if self._applies(s, n) else "accumulate")
            if feed is not None:
                feed.before(s)
            plan.run(variant, functools.partial(step, variant))
            if feed is not None:
                feed.after(s)
        return plan.take(n)

    def _share(self, idx, mask, aug_rows=None):
        """A mesh rank's columns [d·b/dp, (d+1)·b/dp) of each step's rows
        and mask (and of ``aug_rows``), with each step's global mask sum
        (None without a mesh, and the arrays as given)."""
        if self.mesh is None:
            return idx, mask, aug_rows, None
        dp, d = self.mesh.dp, self.mesh.data_index
        b = idx.shape[1]
        if b % dp:
            raise ValueError(f"minibatch {b} does not split over the mesh's "
                             f"{dp} data indices")
        cols = slice(d * (b // dp), (d + 1) * (b // dp))
        bs = np.maximum(mask.sum(axis=1), 1.0).astype(np.float32)
        return (np.ascontiguousarray(idx[:, cols]),
                np.ascontiguousarray(mask[:, cols]),
                None if aug_rows is None
                else np.ascontiguousarray(np.asarray(aug_rows)[:, cols]), bs)

    def _place(self, a):
        """The whole dataset on this rank: a ``distributed.RowShard`` is
        gathered from every process once (memoized on the source, which the
        memo holds so an id() cannot alias another); anything else as
        given."""
        from .distributed import RowShard, gather_rows
        if not isinstance(a, RowShard):
            return a
        hit = self._placed.get(id(a))
        if hit is not None and hit[0] is a:
            return hit[1]
        placed = gather_rows(a, self.mesh)
        while len(self._placed) >= 8:
            self._placed.pop(next(iter(self._placed)))
        self._placed[id(a)] = (a, placed)
        return placed

    def _run_eager(self, kind: str, data, target, idx, mask, scales=None,
                   scales_b=None, epoch: int = 0, ctrs=None, aug_rows=None,
                   feed=None, bs=None) -> dict:
        """The same steps run one by one (a mesh, a spec with dropout, the
        CPU); ``bs``: a mesh rank's global mask sums a step."""
        n = idx.shape[0]
        idx_t = torch.from_numpy(idx).to(self.device, torch.int64)
        rows_t = idx_t if aug_rows is None else torch.from_numpy(
            np.asarray(aug_rows)).to(self.device, torch.int64)
        mask_t = torch.from_numpy(mask).to(self.device)
        if kind != "eval":
            sc = torch.from_numpy(np.stack([scales, scales_b], 1)).to(
                self.device)
        losses, n_errs = [], []
        for s in range(n):
            if feed is not None:
                feed.before(s)
            x, t = self._inputs(data, target, idx_t[s], rows_t[s],
                                int(epoch), kind != "eval")
            b_s = None if bs is None else float(bs[s])
            if kind == "eval":
                m = eval_minibatch(self.spec, self.params, x, t, mask_t[s],
                                   shard=self.shard, bs=b_s)
            else:
                m = self._train_step(x, t, mask_t[s], sc[s, 0:1],
                                     sc[s, 1:2], int(epoch), int(ctrs[s]),
                                     self._applies(s, n), bs=b_s)
            if feed is not None:
                feed.after(s)
            losses.append(m["loss"])
            n_errs.append(m["n_err"])
        ms = {"loss": torch.stack(losses), "n_err": torch.stack(n_errs)}
        if self.mesh is not None:
            # each rank's share of the sums; the model row computes alike
            for v in ms.values():
                self.mesh.all_reduce(v, self.mesh.data_group, "metrics")
        return ms

    @torch.no_grad()
    def train_epoch(self, data, target, indices, batch: int,
                    sync: bool = True, epoch: int | None = None,
                    ctr_base: int = 0, lr_scale=1.0,
                    lr_scale_bias=None) -> dict:
        """Train over ``indices`` in minibatches of ``batch``.  Returns
        per-step ``{"loss", "n_err"}``: numpy with ``sync``, else device
        tensors (no host sync).  ``epoch`` keys the dropout masks (by
        default one more than the last call's); ``ctr_base`` is the count
        of this epoch's samples consumed before ``indices``.
        ``lr_scale`` multiplies every weight's learning rate, a scalar or
        one value per step (a per-minibatch schedule); ``lr_scale_bias``
        the biases' (default: ``lr_scale``).  With ``accum_steps`` > 1 a
        trailing partial group applies at the call's last step."""
        if epoch is None:
            epoch = self._auto_epoch
        self._auto_epoch = epoch + 1
        idx, mask, ctrs = self._idx_matrix(np.asarray(indices), batch,
                                           ctr_base)
        scales, scales_b = self._step_scales(lr_scale, lr_scale_bias,
                                             idx.shape[0])
        if self.mesh is not None:
            idx, mask, _, bs = self._share(idx, mask)
            ms = self._run_eager("train", self._place(data),
                                 self._place(target), idx, mask, scales,
                                 scales_b, epoch, ctrs, bs=bs)
        else:
            run = self._run_captured if self.captured else self._run_eager
            ms = run("train", data, target, idx, mask, scales, scales_b,
                     epoch, ctrs)
        return to_host(ms)[0] if sync else ms

    @torch.no_grad()
    def eval_epoch(self, data, target, indices, batch: int,
                   sync: bool = True) -> dict:
        idx, mask, _ = self._idx_matrix(np.asarray(indices), batch)
        if self.mesh is not None:
            idx, mask, _, bs = self._share(idx, mask)
            ms = self._run_eager("eval", self._place(data),
                                 self._place(target), idx, mask, bs=bs)
        else:
            run = self._run_captured if self.captured else self._run_eager
            ms = run("eval", data, target, idx, mask)
        return to_host(ms)[0] if sync else ms

    @torch.no_grad()
    def gather_params(self) -> tuple[list, list]:
        """(params, vels) whole, on the trainer's device: the trainer's own
        tensors without a model axis, else each rank's shares gathered
        over its model row (every rank of the row calls it)."""
        if self.shard is None or self.mesh.tp == 1:
            return self.params, self.vels
        shard = self.shard

        def whole(pairs):
            return [tuple(shard.give(i, t, shape) if k == 0 else t
                          for k, (t, shape) in enumerate(zip(pair,
                                                             self._whole[i])))
                    for i, pair in enumerate(pairs)]
        return whole(self.params), whole(self.vels)

    def write_back(self) -> None:
        """Install copies of the trained params and velocities into the
        workflow's per-layer lists (the trainer's own buffers change under
        its next step), each spec row at ``spec.unit_index`` (the merge
        makes rows fewer than layers, so a positional copy would land
        weights on the wrong layers)."""
        if self.workflow is None:
            return
        umap = self.spec.unit_index or tuple(range(len(self.params)))
        params, vels = self.gather_params()

        def copies(pair):
            return tuple(None if t is None else t.clone() for t in pair)
        for row, u in enumerate(umap):
            self.workflow.params[u] = copies(params[row])
            self.workflow.vels[u] = copies(vels[row])
