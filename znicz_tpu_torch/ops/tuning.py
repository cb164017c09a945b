"""The routing levers of the conv path (port of the lever half of
``znicz_tpu/ops/tuning.py``): environment variables read on every call,
as the reference reads them, so one command line routes both packages the
same way and a caller may switch between calls.

* ``ZNICZ_TPU_LRN_POOL`` — how the fused step treats each (LRN, max pool)
  pair whose pool the fused kernels take (``lrn_pool.fusable``):

  - ``split``: no merge; the LRN and the pool run as their own rows;
  - ``nofold``: merged into one ``lrn_pool`` row, the preceding conv's
    activation derivative left to its own kernel;
  - ``fused1`` (and the historical ``fused``): merged, and the preceding
    conv's y-only activation derivative folded into the pair's backward;
  - ``fused2``: ``fused1`` with the conv before a folded pair emitting the
    pair's column-parity halves (``split_out``) and the pair handing its
    input gradient back as halves (``emit_split``), so neither direction
    ever holds the interleaved tensor.

  **The port's unset default is ``fused1``, where the reference's is
  ``fused2``** — a deliberate divergence.  The reference flipped its
  default because on the TPU the pair forward's split pass over the conv
  output cost a sweep; the port's pair kernels read x unsplit, so that
  pass never existed on the card.  An explicit ``fused2`` runs the
  whole phase-2 path, and a spec converted from the reference keeps its
  ``split_out``/``emit_split`` keys and runs them.
* ``ZNICZ_TPU_CONV1=s2d`` — a tiny-C strided conv (AlexNet's conv1) and
  its weight gradient by space-to-depth (``ops/conv.py`` ``conv2d_s2d``).
* ``ZNICZ_TPU_CONV=pallas`` — the conv family on the implicit-GEMM kernels
  (``ops/conv.py``), the reference's ``force_pallas_conv``."""

from __future__ import annotations

import os


def _lrn_pool() -> str | None:
    return os.environ.get("ZNICZ_TPU_LRN_POOL")


def lrn_pool_merge() -> bool:
    """Whether the fused step merges (LRN, max pool) pairs into one
    ``lrn_pool`` row (everything but ``split``)."""
    return _lrn_pool() != "split"


def lrn_pool_act_fold() -> bool:
    """Whether the merge also folds the preceding conv's activation
    derivative into the pair's backward (everything but ``nofold``)."""
    return _lrn_pool() != "nofold"


def lrn_pool_split_conv() -> bool:
    """Whether the conv before a folded pair emits the pair's column-parity
    halves and takes the pair's split gradient back: an explicit
    ``fused2`` only (the reference's unset default; the port's is
    ``fused1``, module docstring)."""
    return _lrn_pool() == "fused2"


def conv_s2d() -> bool:
    """Whether ``ZNICZ_TPU_CONV1=s2d`` routes tiny-C strided convs (and
    their weight gradients) through the space-to-depth formulation."""
    return os.environ.get("ZNICZ_TPU_CONV1") == "s2d"


def force_pallas_conv() -> bool:
    """Whether ``ZNICZ_TPU_CONV=pallas`` routes the conv family to the
    implicit-GEMM kernels.  The reference also asks ``use_pallas()`` (a
    TPU, or interpret mode); the port's kernels run on every card, so the
    variable alone decides."""
    return os.environ.get("ZNICZ_TPU_CONV") == "pallas"


def resolved_routing() -> dict:
    """The routing the port actually runs, whichever value came from the
    environment and whichever from a default: ``LRN_POOL`` (split, nofold,
    fused1 or fused2), ``CONV1`` (s2d or direct) and ``CONV`` (pallas: the
    implicit-GEMM kernels; xla: the default tier, cuDNN on the card, under
    the reference's name).  The reference's TPU-only keys ``PALLAS`` (its
    kill switch of the Pallas tier) and ``MXU`` (the matrix unit's operand
    type) have no meaning on the card and are left out: every kernel of
    the port is always on, and its products keep float32 operands."""
    return {
        "LRN_POOL": ("split" if not lrn_pool_merge() else
                     "nofold" if not lrn_pool_act_fold() else
                     "fused2" if lrn_pool_split_conv() else "fused1"),
        "CONV1": "s2d" if conv_s2d() else "direct",
        "CONV": "pallas" if force_pallas_conv() else "xla",
    }
