"""Fused train step on torch tensors (port of
``znicz_tpu/parallel/fused.py``).

The same math as the reference's jitted step — forward chain, softmax-CE
(or MSE) head, hand-written backward chain and momentum SGD update — as
plain functions over a list of ``(w, b)`` tensors.  ``FusedTrainer`` runs
an epoch as a Python loop over minibatches gathered on the device from the
resident dataset; per-step metrics stay in device tensors until the caller
reads them, so an epoch needs one host sync.

The port covers the kinds of the MNIST, CIFAR, AlexNet and autoencoder
slices: ``fc``, standalone ``activation``, ``conv``, ``max_pool``,
``maxabs_pool``, ``avg_pool``, ``lrn``, the merged LRN→max-pool pair
``lrn_pool``, ``dropout``, ``depooling`` (tied by ``tie`` to the max pool
whose winner slots it scatters through) and ``deconv`` (tied or not to an
encoder conv's weights).  Every other kind raises ``NotImplementedError``
naming the ROADMAP.md item that ports it.

Dropout draws from the counter RNG keyed by (stream seed, unit id, epoch,
counter), the counter being the loader's sample offset after the step;
the key is folded on the host and handed to the kernel, so the masks equal
the reference's bit for bit and cost no device sync."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import activations, conv as conv_ops, deconv as deconv_ops
from ..ops import dropout as drop_ops
from ..ops import lrn_pool as lrn_pool_ops
from ..ops import normalization as lrn_ops
from ..ops import pooling as pool_ops
from ..ops import rngbits
from ..ops import softmax as softmax_ops

#: Layer kinds with trainable parameters.
PARAM_KINDS = ("fc", "conv", "deconv")

#: Kinds this port runs, and the ROADMAP.md item for each one it doesn't.
PORTED_KINDS = ("fc", "activation", "conv", "max_pool", "maxabs_pool",
                "avg_pool", "lrn", "lrn_pool", "dropout", "deconv",
                "depooling")
_ROADMAP_ITEM = {
    "stochastic_pool": "queue 1 item 5a (stochastic pooling)",
    "stochastic_abs_pool": "queue 1 item 5a (stochastic pooling)",
}
#: Kinds whose kernels take float32 only: a narrower storage dtype between
#: layers is refused rather than run at another precision.
_F32_KERNEL_KINDS = ("max_pool", "maxabs_pool", "lrn", "lrn_pool",
                     "dropout", "depooling")
#: Kinds a depooling layer may tie to (they record winner slots).
_OFFSET_KINDS = ("max_pool", "maxabs_pool", "lrn_pool")

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
    kind: str                     # PORTED_KINDS; see _ROADMAP_ITEM for
    #                               the others
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
    #: backward caches); the last layer's output stays float32
    storage_dtype: str = "float32"
    #: per-spec-row index into the workflow's layers (write-back map): the
    #: lrn_pool merge makes spec rows fewer than layers; () means identity
    unit_index: tuple = ()

    def __post_init__(self):
        for layer in self.layers:
            if layer.kind not in PORTED_KINDS:
                item = _ROADMAP_ITEM.get(layer.kind)
                if item is None:
                    raise ValueError(f"unknown layer kind {layer.kind!r}")
                raise NotImplementedError(
                    f"layer kind {layer.kind!r} is not ported to "
                    f"znicz_tpu_torch yet (ROADMAP.md {item})")
        if self.loss not in ("softmax", "mse"):
            raise ValueError(f"unknown loss {self.loss!r}")
        torch_dtype(self.compute_dtype)
        torch_dtype(self.storage_dtype)
        if self.storage_dtype != "float32" and any(
                la.kind in _F32_KERNEL_KINDS for la in self.layers):
            raise NotImplementedError(
                f"storage_dtype {self.storage_dtype!r} through the pool and "
                f"LRN kernels (float32 only) is not ported yet (ROADMAP.md "
                f"queue 1 item 5, narrow storage through the conv stack)")
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
                or layers[tie].kind not in _OFFSET_KINDS:
            raise ValueError(f"depooling row {i} must tie to an earlier "
                             f"{'/'.join(_OFFSET_KINDS)} row, got tie={tie}")
    elif layer.kind == "deconv" and tie is not None:
        if not 0 <= tie < i or layers[tie].kind != "conv":
            raise ValueError(f"deconv row {i} must tie to an earlier conv "
                             f"row, got tie={tie}")
        if layer.include_bias or any(la.kind in PARAM_KINDS
                                     for la in layers[:tie]):
            raise NotImplementedError(
                f"deconv row {i} tied to conv row {tie} with a bias or a "
                f"trainable layer below the conv: the fused path refuses "
                f"it, as the reference's does (ROADMAP.md queue 1 item 6); "
                f"train it on the unit graph (fused=False)")


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
    ``lrn_pool.fusable`` into one ``lrn_pool`` row (the reference's
    ``_merge_lrn_pool`` under its ``fused1`` routing), and fold the
    preceding conv's y-only activation derivative into the pair's backward
    (``fold_act`` on the pair, ``act_folded`` on the conv).  ``tie``
    indices are remapped.  Returns (layers, params, vels, unit_index), the
    last mapping each row to its original layer (the write-back map).

    The reference's default ``fused2`` routing also makes the two convs
    emit column-parity halves (``split_out``/``emit_split``), a layout
    device for Mosaic's lack of strided loads; the port's kernels read x
    unsplit, so it never sets those."""
    identity = tuple(range(len(layers)))
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
                    and prev.activation != "linear"
                    and not activations.BY_NAME[prev.activation]
                    .needs_input):
                cfg["fold_act"] = prev.activation
                out_l[-1] = dataclasses.replace(prev, config=tuple(sorted(
                    dict(prev.config, act_folded=True).items())))
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
            train: bool = False, epoch: int = 0, ctr: int = 0):
    """(net output before the loss, caches).  For softmax loss the last
    layer's output is the *logits*; ``caches[i]`` = (layer input, aux),
    aux being the pool winner offsets of a max pool or merged LRN→pool and
    None elsewhere (the LRN backward recomputes its denominator from the
    cached input; dropout regenerates its mask).  ``epoch``/``ctr`` key
    the dropout masks when ``train``; eval is dropout-free."""
    cdt = torch_dtype(spec.compute_dtype)
    sdt = torch_dtype(spec.storage_dtype)
    h = x
    caches = []
    # every row's winner slots and input shape, which a depooling row tied
    # to it reads
    auxes, in_shapes = [], []
    n = len(spec.layers)
    for i, (layer, (w, b)) in enumerate(zip(spec.layers, params)):
        x_in, aux = h, None
        in_shapes.append(tuple(h.shape))
        cfg = layer.cfg
        is_last = i == n - 1
        if layer.kind == "fc":
            pre = _mm(h.reshape(h.shape[0], -1), w, cdt)
            if b is not None:
                pre = pre + b
            if is_last and spec.loss == "softmax":
                h = pre                   # logits; softmax fused with CE
            else:
                h = spec.act(i).fwd(pre)
        elif layer.kind == "conv":
            pre = conv_ops.conv2d(_rnd(h, cdt), _rnd(w, cdt), cfg["stride"],
                                  cfg["padding"])
            if b is not None:
                pre = pre + b
            h = spec.act(i).fwd(pre)
        elif layer.kind == "deconv":
            wt = w if w is not None else params[cfg["tie"]][0]
            pre = deconv_ops.deconv2d(_rnd(h, cdt), _rnd(wt, cdt),
                                      cfg["stride"], cfg["padding"])
            if b is not None:
                pre = pre + b
            h = spec.act(i).fwd(pre)
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
        elif layer.kind == "lrn":
            h = lrn_ops.lrn_y(h, cfg["n"], cfg["alpha"], cfg["beta"],
                              cfg["k"])
        elif layer.kind == "lrn_pool":
            h, aux = lrn_pool_ops.lrn_maxpool(
                h, cfg["n"], cfg["alpha"], cfg["beta"], cfg["k"],
                cfg["ksize"], cfg["stride"], cfg["padding"], cfg["use_abs"])
        elif layer.kind == "dropout":
            if train:
                h = drop_ops.dropout(h, dropout_key(cfg, epoch, ctr),
                                     cfg["ratio"])
        elif layer.kind == "activation":
            h = spec.act(i).fwd(h)
        else:   # ModelSpec refuses unported kinds
            raise NotImplementedError(layer.kind)
        if sdt != torch.float32 and not is_last:
            # storage cast between layers: the next layer's input (and its
            # backward cache) live in sdt; the last layer's output stays
            # f32 so the loss head and its error are full precision
            h = h.to(sdt)
        auxes.append(aux)
        if want_caches:
            caches.append((x_in, aux))
    return h, caches


def _loss_and_err(spec: ModelSpec, out, target, mask):
    """(mean loss, err w.r.t. last pre-activation, n_err); ``mask`` is a
    per-row 0/1 vector zeroing the wrap-padded tail of a short final
    minibatch, so metrics and gradients count each sample once."""
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


def backward(spec: ModelSpec, params, caches, out, err, epoch: int = 0,
             ctr: int = 0):
    """Hand-written gradient chain (same math as the GD* units).  ``err``
    on entry: w.r.t. the last layer's pre-activation.  ``epoch``/``ctr``
    regenerate the training forward's dropout masks."""
    cdt = torch_dtype(spec.compute_dtype)
    grads = [None] * len(spec.layers)
    n = len(spec.layers)
    for i in reversed(range(n)):
        layer = spec.layers[i]
        w, b = params[i]
        x_in, aux = caches[i]
        y_i = caches[i + 1][0] if i < n - 1 else out
        cfg = layer.cfg
        if layer.kind in PARAM_KINDS:
            # act_folded: the merged lrn_pool above applied this
            # derivative in its kernel already
            err_pre = err if i == n - 1 or cfg.get("act_folded") else \
                spec.act(i).bwd(err.reshape(y_i.shape), y_i)
        if layer.kind == "fc":
            x2 = x_in.reshape(x_in.shape[0], -1)
            err2 = err_pre.reshape(x2.shape[0], -1)
            gw = _mm(x2.t(), err2, cdt)
            gb = torch.sum(err2, dim=0) if b is not None else None
            err = _mm(err2, w.t(), cdt).reshape(x_in.shape)
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
        elif layer.kind in ("max_pool", "maxabs_pool"):
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
        elif layer.kind == "lrn_pool":
            err = lrn_pool_ops.gd_lrn_maxpool(
                err.reshape(y_i.shape), aux, x_in, cfg["n"], cfg["alpha"],
                cfg["beta"], cfg["k"], cfg["ksize"], cfg["stride"],
                cfg["padding"], cfg.get("fold_act"))
        elif layer.kind == "dropout":
            err = drop_ops.dropout(err.reshape(x_in.shape).contiguous(),
                                   dropout_key(cfg, epoch, ctr), cfg["ratio"])
        elif layer.kind == "activation":
            err = spec.act(i).bwd(err.reshape(y_i.shape), y_i, x_in)
        else:   # ModelSpec refuses unported kinds
            raise NotImplementedError(layer.kind)
    return grads


def apply_updates(spec: ModelSpec, params, vels, grads):
    """Momentum SGD with decay, layers in REVERSE order (the GD chain's
    execution order): reg = wd·((1−l1)·w + ½·l1·sign w),
    v′ = mom·v − lr·(g + reg), w′ = w + v′.  A tied deconv updates the
    encoder conv's W (``params[tie]``) with its own velocity, before the
    conv's own update reads W for its decay term, as the unit graph's two
    GD units do.  Returns new lists.  The reference's per-step
    ``lr_scale`` arrives with the LR adjusters (ROADMAP.md queue 1 item
    4)."""
    cur_w = [p[0] for p in params]
    cur_b = [p[1] for p in params]
    new_v = [list(v) for v in vels]
    for i in reversed(range(len(spec.layers))):
        layer, grad = spec.layers[i], grads[i]
        if grad is None:
            continue
        tgt = layer.cfg.get("tie", i) if layer.kind == "deconv" else i
        w, b = cur_w[tgt], cur_b[i]
        (vw, vb), (gw, gb) = vels[i], grad
        lr, wd, l1, mom = layer.hypers
        reg = wd * ((1.0 - l1) * w + 0.5 * l1 * torch.sign(w))
        vw2 = mom * vw - lr * (gw + reg)
        cur_w[tgt] = w + vw2
        new_v[i][0] = vw2
        if b is not None:
            lrb, wdb, l1b, momb = layer.hypers_bias
            regb = wdb * ((1.0 - l1b) * b + 0.5 * l1b * torch.sign(b))
            vb2 = momb * vb - lrb * (gb + regb)
            cur_b[i] = b + vb2
            new_v[i][1] = vb2
    return (list(zip(cur_w, cur_b)), [tuple(v) for v in new_v])


def _ones(x):
    return torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)


def grad_minibatch(spec: ModelSpec, params, x, target, mask=None,
                   epoch: int = 0, ctr: int = 0):
    """(grads, metrics) of one minibatch — train_minibatch without the
    update."""
    if mask is None:
        mask = _ones(x)
    out, caches = forward(spec, params, x, want_caches=True, train=True,
                          epoch=epoch, ctr=ctr)
    loss, err, n_err = _loss_and_err(spec, out, target, mask)
    last = len(spec.layers) - 1
    if spec.loss == "mse" and spec.layers[last].kind in PARAM_KINDS:
        # backward() expects pre-activation err at a param layer
        err = spec.act(last).bwd(err, out)
    grads = backward(spec, params, caches, out, err, epoch=epoch, ctr=ctr)
    return grads, {"loss": loss, "n_err": n_err}


def train_minibatch(spec: ModelSpec, params, vels, x, target, mask=None,
                    epoch: int = 0, ctr: int = 0):
    grads, metrics = grad_minibatch(spec, params, x, target, mask,
                                    epoch=epoch, ctr=ctr)
    params, vels = apply_updates(spec, params, vels, grads)
    return params, vels, metrics


def eval_minibatch(spec: ModelSpec, params, x, target, mask=None):
    if mask is None:
        mask = _ones(x)
    out, _ = forward(spec, params, x, want_caches=False)
    loss, _, n_err = _loss_and_err(spec, out, target, mask)
    return {"loss": loss, "n_err": n_err}


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
    parameter-less layers or no bias), moved to ``device`` (default:
    CUDA, raising without it).  ``workflow`` receives them on
    :meth:`write_back`."""

    def __init__(self, workflow=None, spec: ModelSpec | None = None,
                 params=None, vels=None, device=None, mesh=None,
                 accum_steps: int = 1, augment=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded training is not ported yet (ROADMAP.md "
                "queue 1 item 9, parallelism)")
        if accum_steps != 1:
            raise NotImplementedError(
                "gradient accumulation (accum_steps > 1) is not ported yet "
                "(ROADMAP.md queue 1 item 3, remaining)")
        if augment is not None:
            raise NotImplementedError(
                "device augmentation is not ported yet (ROADMAP.md queue 1 "
                "item 8, data plane)")
        if device is None:
            from ..backends import resolve
            device = resolve(None)
        self.spec = spec
        self.workflow = workflow
        self.device = torch.device(device)

        def put(pairs):
            return [tuple(None if t is None else
                          torch.as_tensor(t).to(self.device) for t in pair)
                    for pair in pairs]
        self.params = put(params)
        self.vels = put(vels)
        #: the next epoch number train_epoch keys dropout with when the
        #: caller passes none, so repeated calls never reuse masks
        self._auto_epoch = 0

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

    def _plan(self, indices, batch, ctr_base: int = 0):
        """(device indices, device mask, host per-step counters)."""
        idx, mask, ctrs = self._idx_matrix(np.asarray(indices), batch,
                                           ctr_base)
        return (torch.from_numpy(idx).to(self.device, torch.int64),
                torch.from_numpy(mask).to(self.device), ctrs)

    @torch.no_grad()
    def train_epoch(self, data, target, indices, batch: int,
                    sync: bool = True, epoch: int | None = None,
                    ctr_base: int = 0) -> dict:
        """Train over ``indices`` in minibatches of ``batch``.  Returns
        per-step ``{"loss", "n_err"}``: numpy with ``sync``, else device
        tensors (no host sync).  ``epoch`` keys the dropout masks (by
        default one more than the last call's); ``ctr_base`` is the count
        of this epoch's samples consumed before ``indices``."""
        if epoch is None:
            epoch = self._auto_epoch
        self._auto_epoch = epoch + 1
        idx, mask, ctrs = self._plan(indices, batch, ctr_base)
        params, vels = self.params, self.vels
        losses, n_errs = [], []
        for s in range(idx.shape[0]):
            x = data.index_select(0, idx[s])
            t = target.index_select(0, idx[s])
            params, vels, m = train_minibatch(self.spec, params, vels, x, t,
                                              mask[s], epoch=int(epoch),
                                              ctr=int(ctrs[s]))
            losses.append(m["loss"])
            n_errs.append(m["n_err"])
        self.params, self.vels = params, vels
        ms = {"loss": torch.stack(losses), "n_err": torch.stack(n_errs)}
        return to_host(ms)[0] if sync else ms

    @torch.no_grad()
    def eval_epoch(self, data, target, indices, batch: int,
                   sync: bool = True) -> dict:
        idx, mask, _ = self._plan(indices, batch)
        losses, n_errs = [], []
        for s in range(idx.shape[0]):
            m = eval_minibatch(self.spec, self.params,
                               data.index_select(0, idx[s]),
                               target.index_select(0, idx[s]), mask[s])
            losses.append(m["loss"])
            n_errs.append(m["n_err"])
        ms = {"loss": torch.stack(losses), "n_err": torch.stack(n_errs)}
        return to_host(ms)[0] if sync else ms

    def write_back(self) -> None:
        """Install the trained params and velocities into the workflow's
        per-layer lists, each spec row at ``spec.unit_index`` (the merge
        makes rows fewer than layers, so a positional copy would land
        weights on the wrong layers)."""
        if self.workflow is None:
            return
        umap = self.spec.unit_index or tuple(range(len(self.params)))
        for row, u in enumerate(umap):
            self.workflow.params[u] = self.params[row]
            self.workflow.vels[u] = self.vels[row]
