"""Fused train step on torch tensors (port of
``znicz_tpu/parallel/fused.py``).

The same math as the reference's jitted step — forward chain, softmax-CE
(or MSE) head, hand-written backward chain and momentum SGD update — as
plain functions over a list of ``(w, b)`` tensors.  ``FusedTrainer`` runs
an epoch as a Python loop over minibatches gathered on the device from the
resident dataset; per-step metrics stay in device tensors until the caller
reads them, so an epoch needs one host sync.

The port covers the kinds of the fc/MNIST slice: ``fc`` and standalone
``activation`` layers.  Every other kind raises ``NotImplementedError``
naming the ROADMAP.md item that ports it."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import activations, softmax as softmax_ops

#: Layer kinds with trainable parameters.
PARAM_KINDS = ("fc", "conv", "deconv")

#: Kinds this port runs, and the ROADMAP.md item for each one it doesn't.
PORTED_KINDS = ("fc", "activation")
_ROADMAP_ITEM = {
    "conv": "queue 1 item 5 (conv stack)",
    "max_pool": "queue 1 item 5 (conv stack)",
    "maxabs_pool": "queue 1 item 5 (conv stack)",
    "avg_pool": "queue 1 item 5 (conv stack)",
    "stochastic_pool": "queue 1 item 5 (conv stack)",
    "stochastic_abs_pool": "queue 1 item 5 (conv stack)",
    "lrn": "queue 1 item 5 (conv stack)",
    "lrn_pool": "queue 1 item 5 (conv stack)",
    "dropout": "queue 1 item 5 (conv stack)",
    "deconv": "queue 1 item 6 (decoder)",
    "depooling": "queue 1 item 6 (decoder)",
}

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
    kind: str                     # fc | activation (ported); see
    #                               _ROADMAP_ITEM for the others
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
    #: per-spec-row index into the workflow's layers (write-back map);
    #: () means identity
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
        # the softmax-CE head consumes 2D logits and backward() hands the
        # last layer a pre-activation error — only well-defined for a
        # final fc layer; the MSE head accepts any output shape
        if (self.loss == "softmax" and self.layers
                and self.layers[-1].kind != "fc"):
            raise NotImplementedError(
                f"the fused softmax path requires a final fc layer (got "
                f"{self.layers[-1].kind!r})")
        for layer in self.layers:
            act = activations.BY_NAME[layer.activation]
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


def _mm(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """float32 product of operands rounded to ``cdt`` — the reference's
    ``jnp.dot(a.astype(cdt), b.astype(cdt), preferred_element_type=f32)``.
    Products of bf16/f16 values are exact in float32, so upcasting the
    rounded operands gives the same float32-accumulated result (both casts
    are no-ops for float32 operands)."""
    return torch.matmul(a.to(cdt).float(), b.to(cdt).float())


def forward(spec: ModelSpec, params, x, *, want_caches: bool):
    """(net output before the loss, caches).  For softmax loss the last
    layer's output is the *logits*; ``caches[i]`` = (layer input, None)."""
    cdt = torch_dtype(spec.compute_dtype)
    sdt = torch_dtype(spec.storage_dtype)
    h = x
    caches = []
    n = len(spec.layers)
    for i, (layer, (w, b)) in enumerate(zip(spec.layers, params)):
        x_in = h
        is_last = i == n - 1
        if layer.kind == "fc":
            pre = _mm(h.reshape(h.shape[0], -1), w, cdt)
            if b is not None:
                pre = pre + b
            if is_last and spec.loss == "softmax":
                h = pre                   # logits; softmax fused with CE
            else:
                h = spec.act(i).fwd(pre)
        elif layer.kind == "activation":
            h = spec.act(i).fwd(h)
        else:   # ModelSpec refuses unported kinds
            raise NotImplementedError(layer.kind)
        if sdt != torch.float32 and not is_last:
            # storage cast between layers: the next layer's input (and its
            # backward cache) live in sdt; the last layer's output stays
            # f32 so the loss head and its error are full precision
            h = h.to(sdt)
        if want_caches:
            caches.append((x_in, None))
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


def backward(spec: ModelSpec, params, caches, out, err):
    """Hand-written gradient chain (same math as the GD* units).  ``err``
    on entry: w.r.t. the last layer's pre-activation."""
    cdt = torch_dtype(spec.compute_dtype)
    grads = [None] * len(spec.layers)
    n = len(spec.layers)
    for i in reversed(range(n)):
        layer = spec.layers[i]
        w, b = params[i]
        x_in, _ = caches[i]
        y_i = caches[i + 1][0] if i < n - 1 else out
        if layer.kind == "fc":
            err_pre = err if i == n - 1 else spec.act(i).bwd(
                err.reshape(y_i.shape), y_i)
            x2 = x_in.reshape(x_in.shape[0], -1)
            err2 = err_pre.reshape(x2.shape[0], -1)
            gw = _mm(x2.t(), err2, cdt)
            gb = torch.sum(err2, dim=0) if b is not None else None
            err = _mm(err2, w.t(), cdt).reshape(x_in.shape)
            grads[i] = (gw, gb)
        elif layer.kind == "activation":
            err = spec.act(i).bwd(err.reshape(y_i.shape), y_i, x_in)
        else:   # ModelSpec refuses unported kinds
            raise NotImplementedError(layer.kind)
    return grads


def apply_updates(spec: ModelSpec, params, vels, grads):
    """Momentum SGD with decay, layers in REVERSE order (the GD chain's
    execution order): reg = wd·((1−l1)·w + ½·l1·sign w),
    v′ = mom·v − lr·(g + reg), w′ = w + v′.  Returns new lists.  The
    reference's per-step ``lr_scale`` arrives with the LR adjusters
    (ROADMAP.md queue 1 item 4)."""
    new_p = [tuple(p) for p in params]
    new_v = [tuple(v) for v in vels]
    for i in reversed(range(len(spec.layers))):
        layer, grad = spec.layers[i], grads[i]
        if grad is None:
            continue
        (w, b), (vw, vb), (gw, gb) = params[i], vels[i], grad
        lr, wd, l1, mom = layer.hypers
        reg = wd * ((1.0 - l1) * w + 0.5 * l1 * torch.sign(w))
        vw2 = mom * vw - lr * (gw + reg)
        w2, b2, vb2 = w + vw2, b, vb
        if b is not None:
            lrb, wdb, l1b, momb = layer.hypers_bias
            regb = wdb * ((1.0 - l1b) * b + 0.5 * l1b * torch.sign(b))
            vb2 = momb * vb - lrb * (gb + regb)
            b2 = b + vb2
        new_p[i] = (w2, b2)
        new_v[i] = (vw2, vb2)
    return new_p, new_v


def _ones(x):
    return torch.ones((x.shape[0],), dtype=torch.float32, device=x.device)


def grad_minibatch(spec: ModelSpec, params, x, target, mask=None):
    """(grads, metrics) of one minibatch — train_minibatch without the
    update."""
    if mask is None:
        mask = _ones(x)
    out, caches = forward(spec, params, x, want_caches=True)
    loss, err, n_err = _loss_and_err(spec, out, target, mask)
    last = len(spec.layers) - 1
    if spec.loss == "mse" and spec.layers[last].kind in PARAM_KINDS:
        # backward() expects pre-activation err at a param layer
        err = spec.act(last).bwd(err, out)
    grads = backward(spec, params, caches, out, err)
    return grads, {"loss": loss, "n_err": n_err}


def train_minibatch(spec: ModelSpec, params, vels, x, target, mask=None):
    grads, metrics = grad_minibatch(spec, params, x, target, mask)
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

    @staticmethod
    def _idx_matrix(indices: np.ndarray, batch: int, ctr_base: int = 0
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(steps, batch) int32 indices + 0/1 mask + per-step counter.
        The final short batch wraps around to a full one; the mask zeroes
        the padded tail so metrics and gradients count each sample once.
        The counter is the loader's sample offset after each step; it keys
        the reference's stochastic layers (dropout, stochastic pooling),
        which arrive with ROADMAP.md queue 1 item 5."""
        n = len(indices)
        steps = max(1, -(-n // batch))
        padded = np.resize(indices, steps * batch)
        mask = np.zeros(steps * batch, np.float32)
        mask[:n] = 1.0
        ctrs = (ctr_base + np.minimum((np.arange(steps) + 1) * batch, n)
                ).astype(np.uint32)
        return (padded.reshape(steps, batch).astype(np.int32),
                mask.reshape(steps, batch), ctrs)

    def _plan(self, indices, batch):
        idx, mask, _ = self._idx_matrix(np.asarray(indices), batch)
        return (torch.from_numpy(idx).to(self.device, torch.int64),
                torch.from_numpy(mask).to(self.device))

    @torch.no_grad()
    def train_epoch(self, data, target, indices, batch: int,
                    sync: bool = True) -> dict:
        """Train over ``indices`` in minibatches of ``batch``.  Returns
        per-step ``{"loss", "n_err"}``: numpy with ``sync``, else device
        tensors (no host sync)."""
        idx, mask = self._plan(indices, batch)
        params, vels = self.params, self.vels
        losses, n_errs = [], []
        for s in range(idx.shape[0]):
            x = data.index_select(0, idx[s])
            t = target.index_select(0, idx[s])
            params, vels, m = train_minibatch(self.spec, params, vels, x, t,
                                              mask[s])
            losses.append(m["loss"])
            n_errs.append(m["n_err"])
        self.params, self.vels = params, vels
        ms = {"loss": torch.stack(losses), "n_err": torch.stack(n_errs)}
        return to_host(ms)[0] if sync else ms

    @torch.no_grad()
    def eval_epoch(self, data, target, indices, batch: int,
                   sync: bool = True) -> dict:
        idx, mask = self._plan(indices, batch)
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
        """Install the trained params and velocities into the workflow."""
        if self.workflow is not None:
            self.workflow.params = list(self.params)
            self.workflow.vels = list(self.vels)
