"""Restricted Boltzmann machine ops: CD-1 contrastive divergence (port of
``znicz_tpu/ops/rbm.py``).

One CD-1 step is three products (v₀→h₀, h₀→v₁, v₁→h₁) and two outer
products for the weight gradient, with the hidden states drawn from the
counter RNG (``ops.rngbits``), so every tier samples the same states for
the same (seed, counters); the negative phase is mean-field (visible
probabilities, not samples), the standard Hinton recipe.  The reference
runs these outside any Pallas kernel, as float32 XLA dots at
``Precision.HIGHEST``: here ``torch.matmul`` in float32 with TF32 off
(the package turns it off on import).  The torch functions take tensors on
either device; counters may be device tensors (a captured step's epoch
and counter), folded there.  The ``np_*`` functions are the numpy goldens
the numpy device runs."""

from __future__ import annotations

import numpy as np
import torch

from . import rngbits


# -- torch ------------------------------------------------------------------
def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def sample_bernoulli(p: torch.Tensor, seed: int, counters) -> torch.Tensor:
    """0/1 float32 sample of probabilities ``p`` from the counter RNG:
    the same draws as the reference's on every tier."""
    return (rngbits.uniforms(seed, counters, p.shape, p.device) < p).to(
        torch.float32)


def hidden_probs(v, w, hbias):
    """P(h=1|v) = σ(vW + c); v (B, V), w (V, H)."""
    return _sigmoid(torch.matmul(v, w) + hbias)


def visible_probs(h, w, vbias):
    """P(v=1|h) = σ(hWᵀ + b)."""
    return _sigmoid(torch.matmul(h, w.t()) + vbias)


def cd1_grads(w, vbias, hbias, v0, seed: int, counters):
    """CD-1 statistics over minibatch ``v0`` (B, V): (gw, gvb, ghb, the
    reconstruction's mean squared error).  The positive phase takes h₀'s
    probabilities for its statistics and a sampled h₀ to drive the
    reconstruction."""
    b = v0.shape[0]
    h0p = hidden_probs(v0, w, hbias)
    h0s = sample_bernoulli(h0p, seed, counters)
    v1 = visible_probs(h0s, w, vbias)
    h1p = hidden_probs(v1, w, hbias)
    gw = (torch.matmul(v0.t(), h0p) - torch.matmul(v1.t(), h1p)) / b
    gvb = (v0 - v1).mean(dim=0)
    ghb = (h0p - h1p).mean(dim=0)
    recon = ((v0 - v1) ** 2).mean()
    return gw, gvb, ghb, recon


def cd1_step(w, vbias, hbias, v0, lr: float, seed: int, counters):
    """One plain CD-1 update (no momentum or decay): (w', vbias', hbias',
    reconstruction mse)."""
    gw, gvb, ghb, recon = cd1_grads(w, vbias, hbias, v0, seed, counters)
    return w + lr * gw, vbias + lr * gvb, hbias + lr * ghb, recon


def cd1_momentum_step(params, vels, v0, lr, momentum, weights_decay,
                      seed: int, counters):
    """CD-1 with momentum and L2 weight decay on the weights only::

        vel ← m·vel + lr·(g − λ·w);   par ← par + vel

    ``params``/``vels`` are (w, vbias, hbias) triples; returns (params',
    vels', reconstruction mse)."""
    w, vbias, hbias = params
    vw, vvb, vhb = vels
    gw, gvb, ghb, recon = cd1_grads(w, vbias, hbias, v0, seed, counters)
    vw2 = momentum * vw + lr * (gw - weights_decay * w)
    vvb2 = momentum * vvb + lr * gvb
    vhb2 = momentum * vhb + lr * ghb
    return ((w + vw2, vbias + vvb2, hbias + vhb2), (vw2, vvb2, vhb2),
            recon)


# -- numpy goldens ------------------------------------------------------------
def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def np_sample_bernoulli(p, seed: int, counters):
    u = rngbits.uniforms(seed, counters, p.shape).numpy()
    return (u < p).astype(np.float32)


def np_hidden_probs(v, w, hbias):
    return _np_sigmoid(v @ w + hbias)


def np_visible_probs(h, w, vbias):
    return _np_sigmoid(h @ w.T + vbias)


def np_cd1_grads(w, vbias, hbias, v0, seed: int, counters):
    b = v0.shape[0]
    h0p = np_hidden_probs(v0, w, hbias)
    h0s = np_sample_bernoulli(h0p, seed, counters)
    v1 = np_visible_probs(h0s, w, vbias)
    h1p = np_hidden_probs(v1, w, hbias)
    gw = (v0.T @ h0p - v1.T @ h1p) / b
    return (gw, (v0 - v1).mean(axis=0), (h0p - h1p).mean(axis=0),
            ((v0 - v1) ** 2).mean())


def np_cd1_step(w, vbias, hbias, v0, lr, seed: int, counters):
    gw, gvb, ghb, recon = np_cd1_grads(w, vbias, hbias, v0, seed, counters)
    return w + lr * gw, vbias + lr * gvb, hbias + lr * ghb, recon


def np_cd1_momentum_step(params, vels, v0, lr, momentum, weights_decay,
                         seed: int, counters):
    w, vbias, hbias = params
    vw, vvb, vhb = vels
    gw, gvb, ghb, recon = np_cd1_grads(w, vbias, hbias, v0, seed, counters)
    vw2 = momentum * vw + lr * (gw - weights_decay * w)
    vvb2 = momentum * vvb + lr * gvb
    vhb2 = momentum * vhb + lr * ghb
    return ((w + vw2, vbias + vvb2, hbias + vhb2), (vw2, vvb2, vhb2),
            recon)
