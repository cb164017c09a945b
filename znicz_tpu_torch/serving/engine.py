"""Forward-only inference engine with a shape-bucketed executable cache
(port of ``znicz_tpu/serving/engine.py``).

A ``.znn`` file (``export.py``) is served through :func:`torch_forward`,
the counterpart of the reference's ``jax_forward``: each layer kind runs
the port's own ops, so on a CUDA tensor the activations, the row softmax,
max pooling, LRN and depooling launch the hand-written kernels
(``act_fwd``, ``row_softmax``, ``pool_select``, ``lrn_y``,
``pool_scatter``; the convs run cuDNN, or the implicit-GEMM kernels under
``ZNICZ_TPU_CONV=pallas``); on a CPU tensor the same calls take the plain
versions.

Shape bucketing: requests are padded up to a fixed bucket ladder
(default 1/8/32/128) and each ``(generation, bucket, sample shape, dtype,
device)`` key holds one executable in a bounded LRU; oversized batches
chunk through the largest bucket.  On the card an executable is a CUDA
graph of the forward with static input and output buffers: its first
call runs the forward once eagerly on a side stream and then captures it
(``parallel.capture``), under one process-wide capture lock and with
``capture_error_mode="thread_local"`` so other threads keep serving; a
call copies the padded batch in, replays and copies the output out, under
the key's lock.  The launch counts a capture records are added again on
every replay.  On the host (``backend="cpu"``) an entry is the eager
forward, with the same LRU, hits, misses and evictions.

Backends: ``"cuda"`` (the default; raises without a card), ``"cpu"``
(torch on the host, as the tests ask) and ``"native"`` (the C++ engine of
``export.NativeEngine``).  The reference's ``"auto"``, which lands on the
host when no accelerator initialises, has no counterpart: the port never
moves to the CPU unasked.

Resilience (``resilience``): every device forward runs at the
``engine.forward`` fault site, transient failures retry under a
:class:`~znicz_tpu_torch.resilience.RetryPolicy`, and a
:class:`~znicz_tpu_torch.resilience.CircuitBreaker` guards the device
path — after K consecutive forward failures it opens and ``predict``
degrades to the native CPU engine, or raises ``EngineUnavailable`` when
that cannot load.  Only what :func:`engine_transient` calls transient
takes that road, and it judges an error by where it comes from: a fault
injected at the ``engine.forward`` site, or a per-attempt timeout.
Whatever the forward raises of its own (a kernel that does not build,
load or launch, a CUDA error) is never retried and raises to the
caller, so the fallback never hides the kernels.

Durability (``durability``): the artifact is verified on load, and
weights are generation-tracked: :meth:`ServingEngine.reload` verifies and
canaries a new artifact and swaps it atomically, rolling back on any
failure while the previous generation keeps serving.

Unlike the reference's executables, a CUDA graph holds the addresses of
its generation's weights, so evicting a generation's weights
(``release_weights``) also drops that generation's graphs; the next
page-in captures them again (compile cause ``fallback``).
"""

from __future__ import annotations

import collections
import functools
import logging
import os
import tempfile
import threading
import time
import weakref

import numpy as np
import torch

from .. import durability
from ..export import ZnnLayer, read_znn
from ..resilience import faults, overload
from ..resilience.breaker import CircuitBreaker, EngineUnavailable
from ..resilience.retry import (AttemptTimeout, RetryPolicy,
                                default_transient)
from ..telemetry import compilestats, tracing
from ..telemetry.registry import REGISTRY

#: default pad-to-bucket ladder for request batch sizes
DEFAULT_BUCKETS = (1, 8, 32, 128)

#: int8 serving parity tolerances: the quantized forward must match
#: the fp32 engine on the verification batch within these bounds or
#: the generation serves fp32 (counted)
QUANT_RTOL = 5e-2
QUANT_ATOL = 5e-2

#: the least rows and the row/column multiple ``torch._int_mm`` takes on
#: the card (it refuses 16 rows or fewer and K or N not a multiple of 8);
#: the int8 fc pads with zeros to them, which leaves the product exact
INT_MM_MIN_ROWS = 32
INT_MM_MULTIPLE = 8

BACKENDS = ("cuda", "cpu", "native")

_reloads = REGISTRY.counter(
    "model_reloads_total",
    "hot-reload attempts, by outcome (ok | verify_failed | "
    "canary_failed | load_failed)")
_generation = REGISTRY.gauge(
    "model_generation",
    "generation number of the model currently serving (bumps on every "
    "successful hot reload; last engine to swap wins in a "
    "multi-engine process)")
_quant_fallbacks = REGISTRY.counter(
    "quantize_fallback_total",
    "int8 quantized-serving builds that fell back to fp32, by reason "
    "(unsupported = no quantizable fc chain or the native backend | "
    "tolerance = verification batch breached the parity tolerances | "
    "error = the quantized build/verify raised)")

class ReloadInProgress(RuntimeError):
    """A hot reload is already running — reloads are single-flight."""


class CanaryFailed(RuntimeError):
    """The candidate generation's canary forward produced a wrong
    shape, non-finite values, or raised — the swap is aborted and the
    previous generation keeps serving."""


#: the fault site of the device forward, whose injected faults are the
#: only errors of the forward that may be transient
FORWARD_SITE = "engine.forward"


class _ForwardError(BaseException):
    """Carries an error that the forward itself raised past the retry
    policy, which catches only ``Exception``, so that no policy retries
    it; ``predict`` raises :attr:`error` again to its caller."""

    def __init__(self, error: Exception):
        super().__init__(error)
        self.error = error


def engine_transient(exc: BaseException) -> bool:
    """The engine's retry classifier, by where the error comes from: only
    a fault injected at the ``engine.forward`` site (and that
    :func:`default_transient` calls transient) and a per-attempt
    timeout.  Whatever the forward raises of its own — a kernel that does
    not build, load or launch, a CUDA error, a device mismatch — is
    deterministic: retrying it, and serving the request from the native
    engine instead, would hide the kernel."""
    if isinstance(exc, AttemptTimeout):
        return True
    return getattr(exc, "fault_site", None) == FORWARD_SITE \
        and default_transient(exc)


class _Generation:
    """One loaded model generation: verified artifact path + parsed
    layers + their single device-resident parameter copy + the native
    CPU engine bound to the SAME artifact.  Immutable once published
    to the engine — a hot reload installs a NEW instance, and
    in-flight predicts finish on whichever generation they grabbed
    (including the degraded fallback leg: feats, layers, and the
    native model all come from one generation, so a mid-request swap
    can never mix two models)."""

    def __init__(self, number: int, path: str, layers,
                 device: torch.device):
        self.number = number
        self.path = path
        self.layers = layers
        #: where the weights are materialized (the engine's device)
        self.device = device
        #: per-layer int8 weight copies — ``None`` (fp32 serving) or a
        #: list aligned with ``layers`` whose quantized entries are
        #: ``(wq int8, scale f32 per-output-channel)`` and the rest
        #: ``None``.  Set by the engine AFTER verification against the
        #: fp32 forward, before the first ``params()`` call, so every
        #: bucket executable of this generation sees one consistent
        #: parameter layout.
        self.qlayers = None
        self._lock = threading.Lock()
        self._dev_params = None
        self._released = False        # evicted at least once before
        self.pageins = 0              # materializations (under _lock)
        #: pagein observer ``(cause, duration_ms)`` — the engine wires
        #: its own accounting hook here; fired AFTER the lock drops
        self.on_pagein = None
        self._native = None
        self._native_failed = False   # fallback tried and unavailable
        #: (cache key, executable) built by the reload canary — seeded
        #: into the engine's LRU only if this generation swaps in, so a
        #: (possibly failing) reload never evicts the LIVE generation's
        #: executables
        self.warmed: tuple | None = None

    def _materialize(self):
        """Materialize the weights on the device if absent,
        single-flight under the generation lock: a second caller racing
        the same page-in parks on the lock and adopts the first caller's
        copy — never a double device allocation.  Returns
        ``(dev_params, pagein_info | None)`` where the info tuple is
        non-None iff THIS call did the materialization."""
        with self._lock:
            paged = None
            if self._dev_params is None:
                t0 = time.monotonic()
                ql = self.qlayers or [None] * len(self.layers)
                params = []
                for la, q in zip(self.layers, ql):
                    if q is not None:
                        # quantized layer: the int8 copy + per-channel
                        # scale ride as a 3-tuple; torch_forward keys
                        # the int8 product off the third element
                        wq, scale = q
                        params.append((_to_device(wq, self.device),
                                       _to_device(la.b, self.device),
                                       _to_device(scale, self.device)))
                    else:
                        params.append((_to_device(la.w, self.device),
                                       _to_device(la.b, self.device)))
                self._dev_params = params
                self.pageins += 1
                paged = ("evicted" if self._released else "cold",
                         (time.monotonic() - t0) * 1e3)
            return self._dev_params, paged

    def _fire_pagein(self, paged) -> None:
        # outside the generation lock: the observer chain may take its
        # own lock — holding this one across foreign code is how
        # lock-order cycles are born
        if paged is not None and self.on_pagein is not None:
            self.on_pagein(*paged)

    def params(self):
        """The weights, device-resident ONCE per generation and passed
        to every bucket executable — N cached executables must not mean
        N copies of the model.  Materialization is lazy AND revocable:
        :meth:`release_params` drops the device copy and the next call
        here pages it back in from the retained host layers —
        byte-identical, because the host arrays never moved."""
        dev, paged = self._materialize()
        self._fire_pagein(paged)
        return dev

    def ensure(self) -> bool:
        """Page the weights in if evicted; True iff THIS call did the
        materialization."""
        _dev, paged = self._materialize()
        self._fire_pagein(paged)
        return paged is not None

    def release_params(self) -> bool:
        """Drop the device-resident weight copy.  The parsed host layers
        stay, so the next :meth:`params` call re-materializes the SAME
        bytes (at other addresses: the engine drops this generation's
        CUDA graphs with it).  True when a copy was actually
        resident."""
        with self._lock:
            had = self._dev_params is not None
            if had:
                self._dev_params = None
                self._released = True
            return had

    def params_resident(self) -> bool:
        with self._lock:
            return self._dev_params is not None

    def adopt_native(self, native) -> None:
        """Install an eagerly-loaded native model (backend="native"
        startup/reload, where a load failure must raise loudly instead
        of degrading)."""
        with self._lock:
            self._native = native

    def native_model(self):
        """This generation's CPU fallback model, lazily loaded from
        ITS OWN artifact path; None when the host cannot build/load
        the native engine (the degraded path is then 503, not a
        crash)."""
        with self._lock:
            if self._native is not None:
                return self._native
            if self._native_failed:
                return None
        try:
            from ..export import NativeEngine
            native = NativeEngine().load(self.path)
        except Exception:
            with self._lock:
                self._native_failed = True
            return None
        with self._lock:
            if self._native is None:
                self._native = native
            return self._native


def _to_device(a, device):
    """A host array as a tensor on ``device`` (None stays None)."""
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# deliberate local twins of ops/geometry.out_size and
# ops/deconv.deconv_out_size (as the reference keeps them): output_features
# is pure arithmetic, so the native fallback can size its output buffer
# without touching torch.
def _conv_out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def _deconv_out(size: int, k: int, s: int, p: int) -> int:
    return s * (size - 1) + k - 2 * p


def output_features(layers: list[ZnnLayer], sample_shape) -> int:
    """Flat output feature count of the forward chain for one sample of
    ``sample_shape`` ((F,) or (H, W, C)) — pure arithmetic, so the
    native fallback can size its output buffer too."""
    shape = tuple(int(d) for d in sample_shape)
    pool_in = {}       # export-stream index -> the pool's input (h, w)
    for li, lay in enumerate(layers):
        p = lay.p
        if lay.kind == "fc":
            feats = int(np.prod(shape))
            if feats != p[0]:
                raise ValueError(f"layer {li}: fc expects {p[0]} "
                                 f"features, chain carries {feats}")
            shape = (p[1],)
        elif lay.kind == "conv":
            h, w, _ = shape
            shape = (_conv_out(h, p[0], p[4], p[6]),
                     _conv_out(w, p[1], p[5], p[7]), p[3])
        elif lay.kind in ("max_pool", "avg_pool"):
            h, w, c = shape
            pool_in[li] = (h, w)
            shape = (_conv_out(h, p[0], p[4], p[6]),
                     _conv_out(w, p[1], p[5], p[7]), c)
        elif lay.kind == "deconv":
            h, w, _ = shape
            shape = (_deconv_out(h, p[0], p[4], p[6]),
                     _deconv_out(w, p[1], p[5], p[7]), p[2])
        elif lay.kind == "depool":
            # both engines emit the tied pool's RECORDED input extent,
            # which differs from the deconv formula whenever the pool
            # window didn't divide its input evenly
            h, w = pool_in[p[2]]
            shape = (h, w, shape[2])
        elif lay.kind == "kohonen":
            shape = (p[0],)
        # lrn / activation / dropout / softmax keep their shape
    return int(np.prod(shape))


def accepts_shape(layers: list[ZnnLayer], sample_shape) -> bool:
    """Whether the chain takes one sample of ``sample_shape``: the first
    layer's input (an fc's or a kohonen head's width, a conv's rank and
    channels) and the chain's arithmetic (:func:`output_features`).  The
    census warm-up drops the shapes it refuses: in a zoo the census holds
    every model's shapes, and clients send junk."""
    shape = tuple(int(d) for d in sample_shape)
    first = layers[0]
    if first.kind == "kohonen" and int(np.prod(shape)) != first.p[1]:
        return False
    if first.kind == "conv" and (len(shape) != 3
                                 or shape[2] != first.p[2]):
        return False
    try:
        output_features(layers, shape)
    except ValueError:
        return False
    return True


def _weak(method):
    """``method`` called through a weak reference to its object.  The
    engine hands its hooks to what it owns (its generations, its cache's
    first-call wrappers); a bound method there would close a cycle that
    keeps a dropped engine, and its CUDA graphs, alive until a
    collection."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        fn = ref()
        if fn is not None:
            fn(*args)
    return call


def _int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 product of int8 ``xq`` (M, K) and ``wq`` (K, N).  On the card
    ``torch._int_mm``, with the rows padded with zeros to at least
    :data:`INT_MM_MIN_ROWS` and K and N to multiples of
    :data:`INT_MM_MULTIPLE` (zeros add nothing, so the product is exact);
    on the host the int32 product."""
    if xq.device.type != "cuda":
        return torch.matmul(xq.to(torch.int32), wq.to(torch.int32))
    m, k = xq.shape
    n = wq.shape[1]
    mpad = max(INT_MM_MIN_ROWS, m)
    kpad = -(-k // INT_MM_MULTIPLE) * INT_MM_MULTIPLE
    npad = -(-n // INT_MM_MULTIPLE) * INT_MM_MULTIPLE
    if (mpad, kpad) != (m, k):
        xq = torch.nn.functional.pad(xq, (0, kpad - k, 0, mpad - m))
    if (kpad, npad) != (k, n):
        wq = torch.nn.functional.pad(wq, (0, npad - n, 0, kpad - k))
    return torch._int_mm(xq.contiguous(), wq.contiguous())[:m, :n]


def torch_forward(layers: list[ZnnLayer], x: torch.Tensor, params=None):
    """The .znn forward chain in the port's ops → (B, out_features)
    float32, on ``x``'s device.

    Mirrors ``native/znicz_infer.cpp`` and the reference's
    ``jax_forward`` layer for layer: dropout is the inference identity,
    depooling replays the tied max-pool's winner offsets, the kohonen head
    emits negated squared distances.  The fc products are
    ``torch.matmul`` (TF32 stays off); the activations, the softmax, max
    pooling, LRN and depooling are the kernel wrappers of ``ops``, which
    take their plain versions on a CPU tensor.

    ``params`` (list of per-layer (w, b) tensors on ``x``'s device, e.g.
    a generation's resident copy) lets every bucket executable share one
    device copy; None takes the layers' own arrays.  LRN's three
    hyperparameters always come from the static layer.

    Int8 serving: an fc layer whose params entry is a 3-tuple ``(wq int8,
    b, scale)`` takes the quantized path — the activations are quantized
    per row against their own absmax (symmetric, like the
    per-output-channel weight quantization), the int8×int8 product
    accumulates in int32 (:func:`_int8_product`), and the product of the
    two scales dequantizes the result."""
    from ..ops import activations, conv as conv_ops
    from ..ops import deconv as deconv_ops
    from ..ops import normalization as lrn_ops
    from ..ops import pooling as pool_ops
    from ..ops import softmax as softmax_ops

    def act(name, y):
        return activations.apply_fwd(activations.BY_NAME[name], y)

    h = x
    pool_ctx = {}        # layer index -> (offsets, input shape, geometry)
    for li, lay in enumerate(layers):
        p = lay.p
        entry = (params[li] if params is not None
                 else (_to_device(lay.w, x.device),
                       _to_device(lay.b, x.device)))
        w, b = entry[0], entry[1]
        qscale = entry[2] if len(entry) > 2 else None
        if lay.kind == "fc":
            h2 = h.reshape(h.shape[0], -1)
            if h2.shape[1] != p[0]:
                raise ValueError(f"layer {li}: fc expects {p[0]} "
                                 f"features, got {h2.shape[1]}")
            if qscale is not None:
                # rows quantize dynamically against their own absmax (a
                # zero row keeps scale 1 — 0/0 must not NaN the batch);
                # the per-output-channel weight scale pairs with it to
                # dequantize the accumulator
                amax = torch.amax(torch.abs(h2), dim=1, keepdim=True)
                sx = torch.where(amax > 0, amax / 127.0,
                                 torch.ones_like(amax))
                xq = torch.clamp(torch.round(h2 / sx), -127,
                                 127).to(torch.int8)
                acc = _int8_product(xq, w).to(torch.float32)
                pre = acc * (sx * qscale[None, :])
            else:
                pre = torch.matmul(h2, w)
            if b is not None:
                pre = pre + b
            h = act(lay.activation, pre)
        elif lay.kind == "conv":
            y = conv_ops.conv2d(h, w, (p[4], p[5]), (p[6], p[7]))
            if b is not None:
                y = y + b
            h = act(lay.activation, y)
        elif lay.kind == "max_pool":
            xin = h.contiguous()
            y, off = pool_ops.max_pooling(
                xin, (p[0], p[1]), (p[4], p[5]), (p[6], p[7]))
            pool_ctx[li] = (off, tuple(xin.shape),
                            ((p[0], p[1]), (p[4], p[5]), (p[6], p[7])))
            h = y
        elif lay.kind == "avg_pool":
            h = pool_ops.avg_pooling(
                h, (p[0], p[1]), (p[4], p[5]), (p[6], p[7]))
        elif lay.kind == "lrn":
            alpha, beta, k = (float(v) for v in lay.w)
            h = lrn_ops.lrn_y(h.contiguous(), p[0], alpha, beta, k)
        elif lay.kind == "activation":
            h = act(lay.activation, h)
        elif lay.kind == "dropout":
            pass                        # inverted dropout: eval identity
        elif lay.kind == "softmax":
            # over axis 1, as the reference's jax.nn.softmax(h, axis=1)
            rows = h.movedim(1, -1)
            probs, _ = softmax_ops.softmax(
                rows.reshape(-1, h.shape[1]).contiguous())
            h = probs.reshape(rows.shape).movedim(-1, 1)
        elif lay.kind == "deconv":
            y = deconv_ops.deconv2d(h, w, (p[4], p[5]), (p[6], p[7]))
            if b is not None:
                y = y + b
            h = act(lay.activation, y)
        elif lay.kind == "depool":
            off, in_shape, geom = pool_ctx[p[2]]
            h = pool_ops.depooling(
                h.contiguous(), off, (h.shape[0],) + tuple(in_shape[1:]),
                *geom)
        elif lay.kind == "kohonen":
            h2 = h.reshape(h.shape[0], -1)
            d = ((h2[:, None, :] - w[None, :, :]) ** 2).sum(-1)
            h = -d
        else:
            raise NotImplementedError(
                f"serving does not cover layer kind {lay.kind!r}")
    return h.reshape(h.shape[0], -1)


def quantize_layers(layers: list[ZnnLayer]) -> tuple[list, int]:
    """Symmetric per-output-channel int8 copies of the fc weights.

    Returns ``(qlayers, n)`` where ``qlayers`` aligns with ``layers``
    (``(wq, scale)`` for each quantized fc layer, ``None`` elsewhere)
    and ``n`` counts quantized layers.  Only fc weights quantize — the
    FC-heavy families are where the bytes are; conv/LRN/pool/kohonen
    layers keep fp32 (a kohonen head's squared-distance arithmetic is
    not a matmul, and the conv chains fail the parity verification on
    the wrong side of the tolerance for no byte win)."""
    q, n = [], 0
    for lay in layers:
        w = lay.w
        if lay.kind == "fc" and w is not None \
                and getattr(w, "ndim", 0) == 2:
            scale = np.max(np.abs(w), axis=0) / 127.0
            # an all-zero output channel keeps scale 1: 0/0 would NaN
            # the whole dequantization for a column that is exactly 0
            scale = np.where(scale > 0.0, scale, 1.0).astype(np.float32)
            wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
            q.append((wq, scale))
            n += 1
        else:
            q.append(None)
    return q, n


class _EagerForward:
    """A host cache entry: the eager forward of one key (the CPU
    backend's executable)."""

    def __init__(self, layers, device: torch.device):
        self.layers = layers
        self.device = device

    def __call__(self, params, x: np.ndarray) -> np.ndarray:
        y = torch_forward(self.layers, torch.from_numpy(x).to(self.device),
                          params)
        return np.array(y.cpu().numpy())       # never a view of the input


class _GraphForward:
    """A card cache entry: a CUDA graph of the forward at one bucket and
    sample shape, with a static input and a static output tensor.

    Its first call copies the batch in, runs the forward once eagerly on
    a side stream and captures it there (``parallel.capture.capture``,
    one capture at a time in the process, ``thread_local`` error mode);
    every call then replays the graph under the entry's lock and copies
    the output out before the lock drops (the next replay overwrites
    it).  The graph keeps the weights it was captured with alive, so an
    entry still in a caller's hands when its generation's weights are
    released keeps serving the same bytes."""

    def __init__(self, layers, device: torch.device):
        self.layers = layers
        self.device = device
        self.lock = threading.Lock()
        self.graph = None
        self.static_x = self.static_y = None
        #: the weights the graph reads
        self.params = None

    def _capture(self, params) -> None:
        from ..parallel import capture

        def forward():
            self.static_y = torch_forward(self.layers, self.static_x,
                                          params)
        self.graph = capture.capture(forward, torch.cuda.Stream(self.device),
                                     None)
        self.params = params

    def __call__(self, params, x: np.ndarray) -> np.ndarray:
        with self.lock:
            if self.static_x is None:
                self.static_x = torch.empty(x.shape, dtype=torch.float32,
                                            device=self.device)
            self.static_x.copy_(torch.from_numpy(x))
            if self.graph is None:
                self._capture(params)
            self.graph.replay()
            return self.static_y.cpu().numpy()


class ServingEngine:
    """Load a ``.znn`` file or a live trained workflow and serve its
    forward pass with bucketed batching.

    ``predict(x)`` accepts (B, F) or (B, H, W, C) float arrays, pads B
    up to the smallest covering bucket (chunking batches larger than
    the top bucket), runs the bucket's executable (a CUDA graph on the
    card), and returns the un-padded (B, out_features) float32 result.
    """

    def __init__(self, model, *, backend: str = "cuda",
                 buckets=DEFAULT_BUCKETS, cache_size: int = 8,
                 retry: RetryPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 tp: int = 1, quantize: str = "none"):
        if not buckets or list(buckets) != sorted(set(int(b)
                                                      for b in buckets)):
            raise ValueError(f"buckets must be unique ascending ints, "
                             f"got {buckets!r}")
        if not isinstance(tp, int) or isinstance(tp, bool) or tp < 1:
            raise ValueError(f"tp must be a positive int, got {tp!r}")
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', "
                             f"got {quantize!r}")
        if quantize != "none" and tp > 1:
            raise ValueError("quantize cannot combine with tensor-"
                             "parallel serving (tp > 1)")
        if tp > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp > 1) is not ported yet: it "
                "comes with the port's parallelism (ROADMAP.md queue 1 "
                "item 9)")
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; known: "
                             f"{', '.join(BACKENDS)}")
        if backend == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine serves on the CUDA card by default and "
                "this host has none; pass backend=\"cpu\" to serve with "
                "torch on the host (or backend=\"native\")")
        self.quantize = quantize
        self.buckets = tuple(int(b) for b in buckets)
        self.cache_size = int(cache_size)
        self.backend = backend
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if backend == "cuda" else torch.device("cpu"))
        self._tmpdir = None
        if isinstance(model, (str, os.PathLike)):
            path = os.fspath(model)
        else:                 # live workflow: one format serves both
            from ..export import export_workflow
            self._tmpdir = tempfile.TemporaryDirectory(
                prefix="znicz_serve_")
            path = os.path.join(self._tmpdir.name, "model.znn")
            export_workflow(model, path)
        # verify-on-load: a truncated/bit-flipped artifact must refuse
        # to serve HERE, as a typed error at startup — not as a shape
        # crash under traffic
        durability.verify_or_heal(path)
        layers = read_znn(path)
        #: residency hook ``(cause, duration_ms)`` — fired on every
        #: weight page-in of whichever generation is serving
        self.on_pagein = None
        #: cost-attribution hook ``(duration_ms)`` — fired after every
        #: forward with its measured wall time
        self.on_device_time = None
        self._gen = _Generation(1, path, layers, self.device)
        self._gen.on_pagein = _weak(self._note_pagein)
        if backend == "native":
            from ..export import NativeEngine
            self._gen.adopt_native(NativeEngine().load(path))
        # transient errors retry briefly; K consecutive exhausted retries
        # trip the breaker and predict degrades.  The device path's own
        # errors are deterministic (engine_transient)
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=3, base_delay_s=0.02, max_delay_s=0.25,
            retryable=engine_transient)
        self.breaker = breaker if breaker is not None else \
            CircuitBreaker(failure_threshold=5, cooldown_s=10.0)
        self._lock = threading.Lock()
        self._cache = collections.OrderedDict()   # key -> executable
        self._stats = collections.Counter()       # bucket executables
        #: generation-independent (bucket, shape, dtype, device) keys
        #: whose executable COMPLETED a first call — classifies a
        #: request-path build as "new_bucket" (never built) vs
        #: "fallback" (built before: LRU eviction, a weight release or a
        #: generation swap re-exposed a cold key); bounded, since shape
        #: keys derive from client-controlled request shapes
        self._compiled_shapes: set = set()
        self._compiled_shapes_cap = 4096
        #: hot-reload bookkeeping: single-flight + last outcome; the
        #: sample shape of live traffic feeds the canary
        self._reload_lock = threading.Lock()
        self.last_reload: dict | None = None
        self._last_sample_shape: tuple | None = None
        # int8 build rides construction, after the stats/locks exist
        # and BEFORE any params() materialization
        self._try_quantize(self._gen)
        _generation.set(1)

    # -- int8 quantized serving -------------------------------------------
    def _try_quantize(self, gen: _Generation) -> None:
        """Build and VERIFY ``gen``'s int8 weight copy (engine
        ``quantize="int8"``): quantize the fc layers, run a seeded
        verification batch through the fp32 and quantized forwards
        eagerly on the engine's device, and publish ``gen.qlayers`` only
        when the outputs agree within :data:`QUANT_RTOL` /
        :data:`QUANT_ATOL`.  Any breach — no fc chain, the native
        backend, tolerance, a raise — falls back to fp32 for this
        generation and counts ``quantize_fallback_total{reason}``."""
        if self.quantize != "int8":
            return
        reason = None
        try:
            qlayers, n = quantize_layers(gen.layers)
        except Exception:
            qlayers, n = None, 0
        first = gen.layers[0]
        if qlayers is None:
            reason = "error"
        elif self.backend == "native" or n == 0 or first.kind != "fc":
            # non-fc-first chains (conv H×W underivable from the kernel
            # alone) cannot build a verification batch — and a model
            # with nothing to quantize has no int8 path
            reason = "unsupported"
        else:
            # the verification forwards run on the engine's device, so
            # what they raise is the forward's own and reaches the
            # caller: a kernel's fault is never an fp32 fallback
            shape = (int(first.p[0]),)
            rng = np.random.default_rng(0)       # deterministic batch
            x = torch.from_numpy(rng.standard_normal(
                (self.buckets[0],) + shape).astype(np.float32)
            ).to(self.device)
            y32 = torch_forward(gen.layers, x).cpu().numpy()
            host = [((_to_device(q[0], self.device),
                      _to_device(la.b, self.device),
                      _to_device(q[1], self.device)) if q is not None
                     else (_to_device(la.w, self.device),
                           _to_device(la.b, self.device)))
                    for la, q in zip(gen.layers, qlayers)]
            yq = torch_forward(gen.layers, x, host).cpu().numpy()
            if np.allclose(yq, y32, rtol=QUANT_RTOL, atol=QUANT_ATOL):
                gen.qlayers = qlayers
            else:
                reason = "tolerance"
        if reason is not None:
            with self._lock:
                self._stats["quantize_fallbacks"] += 1
            _quant_fallbacks.inc(reason=reason)

    def quantized_active(self) -> bool:
        """Whether the CURRENT serving generation holds a verified
        int8 weight copy (False on fp32 fallback or quantize='none')."""
        return self._current().qlayers is not None

    # -- weight residency -------------------------------------------------
    def _note_pagein(self, cause: str, dt_ms: float) -> None:
        """Every generation's pagein observer: count it and forward to
        the residency hook (if any)."""
        with self._lock:
            self._stats["weight_pageins"] += 1
        cb = self.on_pagein
        if cb is not None:
            cb(cause, dt_ms)

    # -- device-time cost attribution -------------------------------------
    def _note_device_time(self, dt_ms: float) -> None:
        """One forward's measured wall time (the copy out of the output
        is its fence, so this is copy in + replay + copy out — retry
        backoff sleeps and injected latency are outside the
        measurement).  Accumulated into ``device_ms_total`` and
        forwarded to the cost hook."""
        with self._lock:
            self._stats["device_ms_total"] += dt_ms
        cb = self.on_device_time
        if cb is not None:
            cb(dt_ms)

    def device_ms_total(self) -> float:
        """Measured milliseconds this engine has spent across every
        forward."""
        with self._lock:
            return float(self._stats["device_ms_total"])

    def weight_nbytes(self) -> int:
        """Host-side byte size of the serving generation's parameters
        — the device-resident copy costs the same (fp32 both sides)."""
        return sum((0 if la.w is None else la.w.nbytes)
                   + (0 if la.b is None else la.b.nbytes)
                   for la in self._current().layers)

    def weights_resident(self) -> bool:
        """Whether the serving generation currently holds its device
        weight copy (native backend: never — nothing to page)."""
        return self.backend != "native" \
            and self._current().params_resident()

    def resident_weight_bytes(self) -> int:
        """Bytes actually resident right now — 0 when evicted (or on
        the native backend)."""
        return self.weight_nbytes() if self.weights_resident() else 0

    def release_weights(self) -> int:
        """Evict the device weight copy; returns the bytes freed (0 when
        nothing was resident or on the native backend).  The
        generation's graphs go with it (they read the released
        addresses); the next forward pages the weights in and captures
        again (cause ``fallback``).  In-flight forwards finish on the
        graph and weights they hold."""
        if self.backend == "native":
            return 0
        gen = self._current()
        if not gen.release_params():
            return 0
        with self._lock:
            self._stats["weight_releases"] += 1
            # a CUDA graph holds the addresses of the weights it was
            # captured with
            for key in [k for k in self._cache if k[0] == gen.number]:
                del self._cache[key]
        return self.weight_nbytes()

    def ensure_weights(self) -> bool:
        """Page the serving generation's weights in if evicted; True
        iff this call did the materialization."""
        if self.backend == "native":
            return False
        return self._current().ensure()

    # -- generation access ------------------------------------------------
    def _current(self) -> _Generation:
        """The generation currently serving (locked read: reload swaps
        it).  Callers grab it once per request and use that object
        throughout — a mid-request swap must never mix two models'
        layers and params."""
        with self._lock:
            return self._gen

    @property
    def layers(self) -> list[ZnnLayer]:
        return self._current().layers

    @property
    def path(self) -> str:
        return self._current().path

    @property
    def generation(self) -> int:
        return self._current().number

    # -- executable cache -------------------------------------------------
    def _device_key(self) -> str:
        key = f"{self.device.type}:{self.device.index or 0}"
        # an int8 and an fp32 engine build different programs for one
        # shape
        if self.quantize != "none":
            key = f"{key}:q-{self.quantize}"
        return key

    def _shape_key(self, bucket, sample_shape, dtype) -> tuple:
        """The generation-independent part of an executable-cache key
        — the ONE place the key layout lives.  The full cache key is
        ``(gen.number,) + _shape_key(...)``."""
        return (int(bucket), tuple(sample_shape), str(dtype),
                self._device_key())

    def _new_executable(self, gen: _Generation):
        """A fresh executable of ``gen``'s forward: a CUDA graph on the
        card (captured at its first call), the eager forward on the
        host."""
        if self.device.type == "cuda":
            return _GraphForward(gen.layers, self.device)
        return _EagerForward(gen.layers, self.device)

    def _executable(self, gen: _Generation, bucket: int, sample_shape,
                    dtype, cause: str | None = None):
        """The executable for one cache key, LRU-managed.  Keys carry the
        generation number (and the swap clears the cache anyway): a
        stale executable from a previous generation must never serve.

        Compile accounting: every miss builds a fresh executable whose
        first invocation (on the card the eager run, the capture and the
        first replay) is timed into
        ``compile_time_ms{site="serving.engine"}``; ``cause`` defaults
        to the request-path classification (``new_bucket`` for a shape
        key never built, ``fallback`` for a rebuild after eviction, a
        weight release or a generation swap) — warmup passes ``cold``."""
        shape_key = self._shape_key(bucket, sample_shape, dtype)
        key = (gen.number,) + shape_key
        with self._lock:
            fn = self._cache.get(key)
            if fn is not None:
                self._cache.move_to_end(key)
                self._stats["cache_hits"] += 1
                compilestats.record_cache("serving.engine", hit=True)
                return fn
            self._stats["cache_misses"] += 1
            compilestats.record_cache("serving.engine", hit=False)
            if cause is None:
                cause = ("fallback" if shape_key in self._compiled_shapes
                         else "new_bucket")
            fn = compilestats.first_call_timed(
                self._new_executable(gen), site="serving.engine",
                cause=cause, on_first=functools.partial(
                    _weak(self._mark_compiled), shape_key))
            if gen is self._gen:
                # only the CURRENT generation may occupy cache slots: an
                # in-flight request pinned to a just-retired generation
                # would otherwise re-insert a key the reload prune
                # already removed
                self._cache[key] = fn
                while len(self._cache) > self.cache_size:
                    self._cache.popitem(last=False)
                    self._stats["cache_evictions"] += 1
            return fn

    def _mark_compiled(self, shape_key) -> None:
        """A shape key's executable finished its first successful call
        (the FirstCallTimed hook — fires outside the engine lock)."""
        with self._lock:
            self._mark_compiled_locked(shape_key)
            # on the card each build is one CUDA graph capture
            self._stats["builds"] += 1

    def _mark_compiled_locked(self, shape_key) -> None:
        if len(self._compiled_shapes) < self._compiled_shapes_cap:
            self._compiled_shapes.add(shape_key)

    def bucket_for(self, b: int) -> int:
        for bucket in self.buckets:
            if b <= bucket:
                return bucket
        return self.buckets[-1]

    def warmup(self, sample_shape, dtype=np.float32,
               buckets=None) -> int:
        """Build the bucket executables for ``sample_shape`` (on the card
        capture their graphs) BEFORE traffic arrives, off the request
        path — the builds record ``compiles_total{site="serving.engine",
        cause="cold"}`` instead of ambushing the first request of each
        batch size.  Returns the number of executables built (0 on the
        native backend, which has nothing to build)."""
        if self.backend == "native":
            return 0
        shape = tuple(int(d) for d in sample_shape)
        gen = self._current()
        built = 0
        for bucket in (buckets if buckets is not None else self.buckets):
            key = (gen.number,) + self._shape_key(bucket, shape,
                                                  np.dtype(dtype))
            with self._lock:
                if key in self._cache:
                    continue            # already warm: nothing to build
            fn = self._executable(gen, int(bucket), shape,
                                  np.dtype(dtype), cause="cold")
            x = np.zeros((int(bucket),) + shape, np.dtype(dtype))
            # build NOW — an un-invoked executable would still pay its
            # build on the first request
            fn(gen.params(), x)
            built += 1
        return built

    def warmup_from_census(self, recorder=None, top: int = 4,
                           fallback_shape=None) -> int:
        """Census-driven warmup: build the bucket ladder for the sample
        shapes live traffic ACTUALLY sent — the flight recorder's
        request records carry each request's shape, so a reload can
        build what the operator could only guess at with
        ``--warmup-shape``.  The ``top`` most frequent shapes warm
        (shape cardinality is client-controlled; warming every shape
        ever probed would build without bound); with no census yet
        (fresh process, no traffic) ``fallback_shape`` warms instead —
        the operator guess remains the bootstrap.  Shapes the model
        refuses (:func:`accepts_shape`) are dropped first; whatever else
        a build raises reaches the caller.  Returns executables built (0
        on the native backend, which has nothing to build)."""
        if self.backend == "native":
            return 0
        from ..telemetry import flightrecorder
        rec = recorder if recorder is not None else flightrecorder.RECORDER
        # the warm set must FIT the LRU: warming top*len(buckets)
        # executables into a smaller cache would evict its own entries
        # — and the reload-seeded canary executable, whose slot stays
        # reserved here — re-exposing the very request-path builds
        # this exists to prevent.  With cache_size <= len(buckets)
        # even ONE shape overflows, so census warming skips entirely
        # (the warning below names the knob)
        fit = (self.cache_size - 1) // len(self.buckets)
        top = min(max(0, int(top)), max(0, fit))
        # the census holds every shape clients sent to the process: in a
        # zoo the other models' shapes, and junk the model refuses with a
        # 400 — neither may take a build attempt or a slot of the cap
        layers = self._current().layers
        census = [(s, n) for s, n in rec.shape_census()
                  if accepts_shape(layers, s)]
        shapes = [s for s, _ in census[:top]]
        if len(census) > top:
            # never a silent cap: a dropped shape's traffic will pay
            # request-path builds after the next swap — tell the
            # operator which, and what knob fixes it
            logging.getLogger("ServingEngine").warning(
                "census warmup: %d observed shape(s) beyond the "
                "cache-fit cap of %d not warmed (%s...); raise "
                "--cache-size to cover them",
                len(census) - top, top,
                [list(s) for s, _ in census[top:top + 3]])
        if not shapes and fallback_shape is not None:
            # the OPERATOR's shape fails loud: a --warmup-shape typo
            # must error at startup, not silently warm nothing and
            # hand every first request a build spike
            return self.warmup(tuple(int(d) for d in fallback_shape))
        # a shape the model accepts builds or raises: a kernel's build or
        # launch error, or the card's, reaches the caller
        return sum(self.warmup(s) for s in shapes)

    # -- degraded path ----------------------------------------------------
    def _fallback_predict(self, x: np.ndarray, gen: _Generation,
                          cause=None) -> np.ndarray:
        """Serve ``x`` on the native CPU engine, or raise
        ``EngineUnavailable`` (→ 503 + Retry-After).  Feats AND the
        native model both come from the request's pinned generation."""
        feats = output_features(gen.layers, x.shape[1:])
        native = gen.native_model()
        if native is None:
            raise EngineUnavailable(
                f"{self.backend} engine unavailable "
                f"({cause or 'circuit open'}) and the native CPU "
                f"fallback could not load",
                retry_after=self.breaker.retry_after())
        with self._lock:
            self._stats["fallback_calls"] += 1
            self._stats["rows_in"] += len(x)
        try:
            with tracing.span("engine.forward", backend="fallback",
                              rows=int(len(x))) as sp:
                t0 = time.monotonic()
                y = native.infer(x, feats)
                dt_ms = (time.monotonic() - t0) * 1e3
                sp.attrs["device_ms"] = round(dt_ms, 3)
            self._note_device_time(dt_ms)
            return y
        except Exception as e:
            raise EngineUnavailable(
                f"native fallback failed: {e!r}",
                retry_after=self.breaker.retry_after())

    def _forward_once(self, fn, gen: _Generation, padded: np.ndarray,
                      dev_acc: list | None = None) -> np.ndarray:
        try:
            faults.inject(FORWARD_SITE)
        except Exception as e:
            e.fault_site = FORWARD_SITE       # what engine_transient reads
            raise
        # measure AFTER the fault site: injected latency is chaos, not
        # device time, and must not pollute the cost attribution
        t0 = time.monotonic()
        try:
            y = fn(gen.params(), padded)
        except Exception as e:
            raise _ForwardError(e) from None
        dt_ms = (time.monotonic() - t0) * 1e3
        if dev_acc is not None:
            dev_acc[0] += dt_ms
        self._note_device_time(dt_ms)
        return y

    def _count_retry(self, attempt, exc) -> None:
        with self._lock:
            self._stats["retries"] += 1

    # -- prediction -------------------------------------------------------
    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        if x.ndim < 2:
            raise ValueError(f"expected a batched input, got {x.shape}")
        if len(x) == 0:
            raise ValueError("empty batch")
        # deadline hop "forward": a batch whose every rider's budget
        # already ran out must not burn a device slot
        overload.check_deadline("forward")
        # one generation per request: a hot reload mid-request must
        # never mix two models' layers/params
        with self._lock:
            gen = self._gen
            self._last_sample_shape = tuple(int(d) for d in x.shape[1:])
        if self.backend == "native":
            feats = output_features(gen.layers, x.shape[1:])
            native = gen.native_model()
            with self._lock:
                self._stats["forward_calls"] += 1
                self._stats["rows_in"] += len(x)
            with tracing.span("engine.forward", backend="native",
                              rows=int(len(x))) as sp:
                t0 = time.monotonic()
                y = native.infer(x, feats)
                dt_ms = (time.monotonic() - t0) * 1e3
                sp.attrs["device_ms"] = round(dt_ms, 3)
            self._note_device_time(dt_ms)
            return y
        if not self.breaker.allow():
            return self._fallback_predict(x, gen)
        top = self.buckets[-1]
        outs = []
        try:
            for start in range(0, len(x), top):
                chunk = x[start:start + top]
                bucket = self.bucket_for(len(chunk))
                if len(chunk) < bucket:
                    pad = np.zeros(
                        (bucket - len(chunk),) + chunk.shape[1:],
                        np.float32)
                    padded = np.concatenate([chunk, pad])
                else:
                    padded = chunk
                fn = self._executable(gen, bucket, chunk.shape[1:],
                                      chunk.dtype)
                # the span carries the chunk's measured time, accumulated
                # per CALL (not as a delta of the engine-global total)
                dev_acc = [0.0]
                with tracing.span("engine.forward", backend=self.backend,
                                  bucket=bucket,
                                  rows=int(len(chunk))) as sp:
                    try:
                        y = self.retry.call(self._forward_once, fn, gen,
                                            padded, dev_acc,
                                            on_retry=self._count_retry)
                    except _ForwardError as e:
                        raise e.error from None
                    sp.attrs["device_ms"] = round(dev_acc[0], 3)
                with self._lock:
                    self._stats["forward_calls"] += 1
                    self._stats["rows_in"] += len(chunk)
                    self._stats["padded_rows"] += bucket - len(chunk)
                outs.append(y[:len(chunk)])
        except Exception as e:
            if not (engine_transient(e) and self.retry.retryable(e)):
                # deterministic error (bad geometry, anything the forward
                # raised of its own): free any probe slot and surface it
                # — never the native fallback
                self.breaker.abandon()
                raise
            with self._lock:
                self._stats["forward_failures"] += 1
            self.breaker.record_failure()
            return self._fallback_predict(x, gen, cause=e)
        self.breaker.record_success()
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    # -- hot reload -------------------------------------------------------
    def _canary_shape(self, layers) -> tuple | None:
        """Sample shape for the canary batch: live traffic's last seen
        shape when any, else derived from the first layer for flat
        models (fc/kohonen carry their input width; a conv chain's
        H×W cannot be recovered from kernels alone)."""
        with self._lock:
            if self._last_sample_shape is not None:
                return self._last_sample_shape
        first = layers[0]
        if first.kind == "fc":
            return (first.p[0],)
        if first.kind == "kohonen":
            return (first.p[1],)
        return None

    def _canary(self, gen: _Generation, native) -> str:
        """Run the candidate generation forward on a bucketed dummy
        batch BEFORE it may serve: a model that raises, returns the
        wrong feature count, or emits non-finite values must be
        rejected while the old generation still holds the traffic.
        Returns ``"ok"`` or ``"skipped"`` (shape underivable and no
        traffic seen yet); raises :class:`CanaryFailed`."""
        shape = self._canary_shape(gen.layers)
        if shape is None:
            return "skipped"
        bucket = self.buckets[0]
        x = np.zeros((bucket,) + tuple(shape), np.float32)
        try:
            feats = output_features(gen.layers, shape)
            if self.backend == "native":
                y = native.infer(x, feats)
            else:
                # built candidate-locally (NOT via _executable: an insert
                # into the shared LRU could evict a LIVE generation's
                # executable even when this reload rolls back); a
                # successful swap seeds it into the cache
                fn = self._new_executable(gen)
                with compilestats.timed("serving.canary", "reload"):
                    y = fn(gen.params(), x)
                gen.warmed = ((gen.number,)
                              + self._shape_key(bucket, shape, x.dtype),
                              fn)
        except Exception as e:
            raise CanaryFailed(f"canary forward raised: {e!r}") from e
        if y.shape != (bucket, feats):
            raise CanaryFailed(f"canary produced shape {y.shape}, "
                               f"expected {(bucket, feats)}")
        if not np.isfinite(y).all():
            raise CanaryFailed("canary produced non-finite outputs")
        return "ok"

    def reload(self, path: str | None = None, *,
               canary: bool = True) -> dict:
        """Zero-downtime hot reload: verify → parse → canary → atomic
        swap under the engine lock.  ``path=None`` re-reads the current
        artifact path (picking up newly exported weights in place).

        Any failure (verify, parse, canary) ROLLS BACK: nothing is
        swapped, the previous generation keeps serving, and the outcome
        lands in :attr:`last_reload` / ``model_reloads_total{outcome}``.
        Single-flight; a concurrent attempt raises
        :class:`ReloadInProgress`.  After a successful swap the canary's
        executable is seeded and :meth:`warmup_from_census` builds the
        bucket ladder of every shape the flight recorder saw served, so
        the requests after the swap capture no graph on their path; a
        warm-up that raises is logged and counted in
        ``warmup_failures``."""
        if not self._reload_lock.acquire(blocking=False):
            raise ReloadInProgress("a hot reload is already running")
        try:
            old = self._current()
            target = os.fspath(path) if path is not None else old.path
            t0 = time.monotonic()
            outcome, error, canary_result = "ok", None, None
            candidate = native = None
            try:
                durability.verify_or_heal(target)
                layers = read_znn(target)
                candidate = _Generation(old.number + 1, target, layers,
                                        self.device)
                # the candidate's first materialization (the canary)
                # must count like any other page-in
                candidate.on_pagein = _weak(self._note_pagein)
                # re-quantize PER GENERATION, verified against the
                # candidate's own fp32 forward
                self._try_quantize(candidate)
                if self.backend == "native":
                    from ..export import NativeEngine
                    native = NativeEngine().load(target)
                    candidate.adopt_native(native)
                if canary:
                    canary_result = self._canary(candidate, native)
            except durability.ArtifactCorrupt as e:
                outcome, error = "verify_failed", str(e)
            except CanaryFailed as e:
                outcome, error = "canary_failed", str(e)
            except Exception as e:
                outcome, error = "load_failed", repr(e)
            with self._lock:
                if outcome == "ok":
                    self._gen = candidate
                    self._stats["reloads"] += 1
                    keep = candidate.number
                else:
                    keep = old.number
                # stale generations' executables must never serve (and
                # must free their memory) — cache keys carry the
                # generation number, so this is just a filter
                for key in [k for k in self._cache if k[0] != keep]:
                    del self._cache[key]
                if outcome == "ok" and candidate.warmed is not None:
                    # seed the canary's build: the first post-swap
                    # request must not pay it a second time
                    key, fn = candidate.warmed
                    self._cache[key] = fn
                    self._mark_compiled_locked(key[1:])
            if outcome == "ok":
                _generation.set(candidate.number)
                # census-driven warmup belongs to the reload itself, not
                # to any one caller: POST /admin/reload, SIGHUP and a
                # direct engine.reload must all leave the new generation
                # warm for the shapes live traffic has been sending —
                # the canary seeded only ONE (shape, bucket) executable.
                # The swap stands if it fails (warm-up is an optimisation),
                # but the failure is logged and counted, never dropped
                try:
                    self.warmup_from_census()
                except Exception:
                    with self._lock:
                        self._stats["warmup_failures"] += 1
                    logging.getLogger("ServingEngine").exception(
                        "census warm-up after the reload to generation "
                        "%d failed", candidate.number)
            record = {"outcome": outcome, "error": error,
                      "path": target, "canary": canary_result,
                      "generation": (candidate.number
                                     if outcome == "ok" else old.number),
                      "duration_ms": (time.monotonic() - t0) * 1e3,
                      "at": time.time()}
            with self._lock:
                self.last_reload = record
            _reloads.inc(outcome=outcome)
            return record
        finally:
            self._reload_lock.release()

    def reload_status(self) -> dict:
        """Generation + last reload outcome."""
        with self._lock:
            return {"model_generation": self._gen.number,
                    "last_reload": dict(self.last_reload)
                    if self.last_reload else None}

    # -- introspection ----------------------------------------------------
    def resilience_state(self) -> str:
        """``ok`` (circuit closed) | ``degraded`` (open, native CPU
        fallback serving) | ``open`` (open and no fallback — requests
        get 503 + Retry-After).  ``degraded`` is only reported once the
        fallback has actually loaded (the lazy load is attempted here if
        no request has triggered it yet)."""
        if self.backend == "native" or self.breaker.state == "closed":
            return "ok"
        return "degraded" if self._current().native_model() is not None \
            else "open"

    def metrics(self) -> dict:
        with self._lock:
            m = dict(self._stats)
            m["cached_executables"] = len(self._cache)
            m["generation"] = self._gen.number
        for k in ("reloads", "cache_hits", "cache_misses",
                  "cache_evictions", "forward_calls", "forward_failures",
                  "fallback_calls", "retries", "weight_pageins",
                  "weight_releases", "quantize_fallbacks", "builds",
                  "warmup_failures"):
            m.setdefault(k, 0)
        m.setdefault("device_ms_total", 0.0)
        m["quantize_mode"] = self.quantize
        m["quantized"] = self.quantized_active()
        m["weight_bytes"] = self.weight_nbytes()
        m["weights_resident"] = self.weights_resident()
        m["backend"] = self.backend
        m["buckets"] = list(self.buckets)
        m["breaker"] = self.breaker.metrics()
        m["resilience_state"] = self.resilience_state()
        return m

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def close(self) -> None:
        """Free the executables (on the card their graphs) and the
        temporary artifact of a live workflow."""
        with self._lock:
            self._cache.clear()
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None
