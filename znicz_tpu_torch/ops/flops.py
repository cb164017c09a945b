"""Analytic FLOP accounting for fused models (port of
``znicz_tpu/ops/flops.py``).

``model_flops`` walks a ``ModelSpec`` as ``parallel.fused.forward`` does,
tracking shapes with the shared geometry helpers, and counts the FLOPs an
image takes in the forward pass and in a whole training step, with the
reference's conventions:

* one multiply-add = 2 FLOPs;
* a training step on a parameter layer costs 3× its forward product
  (forward, input gradient and weight gradient, each the same GEMM
  shape);
* a layer without parameters (pooling, LRN, dropout, activation) costs
  ~2× its forward in training;
* the update costs ~6 FLOPs a parameter (momentum and L1/L2 decay).

The numbers are the reference's for the same spec; a benchmark divides
them by a measured time and the card's peak for its share of the peak.
Parameters may be numpy arrays or tensors."""

from __future__ import annotations

from .geometry import norm2, out_size


def _conv_out_hw(h, w, kh, kw, stride, padding):
    sy, sx = norm2(stride)
    py, px = norm2(padding)
    return out_size(h, kh, sy, py), out_size(w, kw, sx, px)


def _numel(a) -> int:
    n = 1
    for d in a.shape:
        n *= int(d)
    return n


def model_flops(spec, params, input_shape) -> dict:
    """FLOPs per image for ``spec`` on NHWC ``input_shape`` (without the
    batch dim).  Returns ``{"forward": F, "train_step": T, "params": P}``.
    """
    shape = tuple(input_shape)
    fwd = 0.0
    train = 0.0
    n_params = 0
    for layer, (w, b) in zip(spec.layers, params):
        cfg = layer.cfg
        if layer.kind == "fc":
            n_in = 1
            for d in shape:
                n_in *= d
            n_out = w.shape[1]
            f = 2.0 * n_in * n_out + (n_out if b is not None else 0)
            fwd += f
            train += 3.0 * f
            shape = (n_out,)
        elif layer.kind in ("conv", "deconv"):
            # weight-tied deconv: shared W lives at the encoder's index
            # (counted once in n_params, at the conv's own row)
            wt = w if w is not None else params[cfg["tie"]][0]
            kh, kw = wt.shape[0], wt.shape[1]
            c_in, c_out = wt.shape[2], wt.shape[3]
            if layer.kind == "conv":
                oh, ow = _conv_out_hw(shape[0], shape[1], kh, kw,
                                      cfg["stride"], cfg["padding"])
            else:
                # transposed conv: output extent inverts the conv formula
                sy, sx = norm2(cfg["stride"])
                py, px = norm2(cfg["padding"])
                oh = (shape[0] - 1) * sy + kh - 2 * py
                ow = (shape[1] - 1) * sx + kw - 2 * px
            # deconv weights are (KH, KW, C_out, C_in) — its output
            # channel count is axis 2, not 3 (conv: axis 3)
            out_c = c_out if layer.kind == "conv" else c_in
            f = 2.0 * kh * kw * c_in * c_out * oh * ow \
                + (oh * ow * out_c if b is not None else 0)
            fwd += f
            train += 3.0 * f
            shape = (oh, ow, out_c)
        elif layer.kind in ("max_pool", "maxabs_pool", "avg_pool",
                            "stochastic_pool", "stochastic_abs_pool"):
            kh, kw = norm2(cfg["ksize"])
            oh, ow = _conv_out_hw(shape[0], shape[1], kh, kw,
                                  cfg["stride"], cfg["padding"])
            c = shape[2]
            f = float(kh * kw * oh * ow * c)     # one compare/add per tap
            fwd += f
            train += 2.0 * f
            shape = (oh, ow, c)
        elif layer.kind == "depooling":
            f = 2.0 * shape[0] * shape[1] * shape[2]
            fwd += f
            train += 2.0 * f
            # output shape = tied pooling input; unknown here without the
            # tie chain — depooling appears only in decoders where the
            # following deconv re-reads its own weight shape, so keep the
            # spatial dims by upsampling with the stride factor.
            sy, sx = norm2(cfg["stride"])
            shape = (shape[0] * sy, shape[1] * sx, shape[2])
        elif layer.kind == "lrn":
            n_el = shape[0] * shape[1] * shape[2]
            f = 2.0 * cfg["n"] * n_el + 6.0 * n_el
            fwd += f
            train += 2.0 * f
        elif layer.kind == "lrn_pool":
            # fused pair: LRN work on the input extent + pool compares
            n_el = shape[0] * shape[1] * shape[2]
            f = 2.0 * cfg["n"] * n_el + 6.0 * n_el
            kh, kw = norm2(cfg["ksize"])
            oh, ow = _conv_out_hw(shape[0], shape[1], kh, kw,
                                  cfg["stride"], cfg["padding"])
            c = shape[2]
            f += float(kh * kw * oh * ow * c)
            fwd += f
            train += 2.0 * f
            shape = (oh, ow, c)
        elif layer.kind in ("dropout", "activation"):
            n_el = 1
            for d in shape:
                n_el *= d
            f = 4.0 * n_el
            fwd += f
            train += 2.0 * f
        else:  # unknown glue — count nothing rather than guess
            pass
        if w is not None:
            n_params += _numel(w) + (_numel(b) if b is not None else 0)
    if spec.loss == "softmax" and len(shape) == 1:
        fwd += 5.0 * shape[0]
        train += 10.0 * shape[0]
    train += 6.0 * n_params        # fused SGD+momentum update
    return {"forward": fwd, "train_step": train, "params": n_params}
