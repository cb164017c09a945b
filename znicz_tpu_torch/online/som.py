"""Kohonen online mode: the SOM served-and-trained on one stream.

The paper's Kohonen units are explicitly *online* learners — the
original VELES workflow pulled the codebook toward every sample as it
streamed past.  This module makes that the reference workload of the
live-data loop: a served SOM head (``kohonen`` ``.znn`` layer, the
winner's negated squared distances on ``/predict``) whose weights keep
adapting to replayed serving traffic, with the same bless/refuse gate
and candidate export as the gradient trainer.

Math parity: every update IS the batch trainer's numpy update —
:func:`znicz_tpu_torch.ops.kohonen.np_som_update` on
:func:`~znicz_tpu_torch.ops.kohonen.np_forward`'s winners, with the
:class:`~znicz_tpu_torch.nn.kohonen.KohonenTrainer` schedules
(``lr(r) = lr₀·exp(−r/τ)``, ``σ(r) = max(σ₀·exp(−r/τ), σ_min)``, the
round counter standing in for the epoch counter) — pinned by the
parity tests: the same stream through :class:`OnlineSom` and through the
batch math — or through the reference's ``OnlineSom`` — lands on
bit-identical float32 weights.  It runs on the host, as the reference's
does.

Blessing judges the SOM's own quality metric: **quantization error**
on the held-back slice (mean distance from each held-back sample to
its winner) must not regress beyond tolerance vs the blessed codebook.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..export import KIND, _commit_znn, _pack_layer, _write_header
from ..export import read_znn
from ..ops import kohonen as som_ops
from ..telemetry.registry import REGISTRY
from .replay import ReplayReader, records_to_arrays

log = logging.getLogger("online.som")

_som_rounds = REGISTRY.counter(
    "online_som_rounds_total",
    "Kohonen online-mode rounds driven to an outcome (blessed | "
    "refused = held-back quantization error regressed | starved = "
    "replay window too cold) — the SOM twin of online_rounds_total")
_som_qe = REGISTRY.gauge(
    "online_som_quantization_error",
    "held-back-slice quantization error of the blessed SOM codebook "
    "(mean sample→winner distance; the bless bar for the next round)")


def read_som_znn(path: str) -> np.ndarray:
    """The ``(units, features)`` float32 codebook of a kohonen-head
    ``.znn`` (raises for any other layer chain)."""
    layers = read_znn(path)
    if len(layers) != 1 or layers[0].kind != "kohonen":
        raise ValueError(f"{path!r} is not a kohonen-head .znn "
                         f"({[lay.kind for lay in layers]})")
    return np.asarray(layers[0].w, np.float32)


def export_som_znn(weights: np.ndarray, path: str, *,
                   commit: bool = True) -> str:
    """The kohonen head back to ``.znn`` — atomic commit (manifest)
    for candidate dirs, raw bytes for a controller-owned tmp path."""
    w = np.ascontiguousarray(weights, np.float32)
    target = path + ".tmp" if commit else path
    with open(target, "wb") as fh:
        _write_header(fh, 1)
        _pack_layer(fh, KIND["kohonen"], 0, list(w.shape), w)
    return _commit_znn(path) if commit else path


class OnlineSom:
    """Served SOM codebook adapting to replayed traffic in bounded
    rounds (bless/refuse on held-back quantization error)."""

    def __init__(self, model_path: str, capture_dir: str, *,
                 candidates_dir: str,
                 grid_shape: tuple | None = None,
                 learning_rate: float = 0.3, sigma0: float | None = None,
                 sigma_min: float = 0.5, decay_rounds: float = 20.0,
                 round_samples: int = 64, min_round_samples: int = 8,
                 holdback_every: int = 8, eval_max: int = 256,
                 tol: float = 0.10, abs_tol: float = 1e-5,
                 seed: int = 0, poll_timeout_s: float = 5.0,
                 model: str | None = None, window: int = 4096):
        self.model_path = os.fspath(model_path)
        self.weights = read_som_znn(self.model_path)
        n_units = self.weights.shape[0]
        if grid_shape is None:
            grid_shape = (1, n_units)        # a 1-D sheet by default:
            # the .znn container carries (units, features) only — an
            # exported SOM's 2-D grid shape is the trainer's config
        if int(grid_shape[0]) * int(grid_shape[1]) != n_units:
            raise ValueError(f"grid {grid_shape} does not tile "
                             f"{n_units} units")
        self.grid_shape = (int(grid_shape[0]), int(grid_shape[1]))
        self._coords = som_ops.grid_coords(*self.grid_shape)
        self.learning_rate = float(learning_rate)
        self.sigma0 = (float(sigma0) if sigma0 is not None
                       else max(self.grid_shape) / 2.0)
        self.sigma_min = float(sigma_min)
        self.decay_rounds = float(decay_rounds)
        self.reader = ReplayReader(capture_dir, seed=seed,
                                   window=window, model=model)
        self.candidates_dir = os.path.abspath(candidates_dir)
        os.makedirs(self.candidates_dir, exist_ok=True)
        self.round_samples = int(round_samples)
        self.min_round_samples = int(min_round_samples)
        self.holdback_every = int(holdback_every)
        self.eval_max = int(eval_max)
        self.tol = float(tol)
        self.abs_tol = float(abs_tol)
        self.poll_timeout_s = float(poll_timeout_s)
        self._eval_x = np.zeros((0, 0), np.float32)
        self._blessed = self.weights.copy()
        self.round_no = 0            # the schedules' epoch stand-in
        self.step = 0
        self.rounds = {"blessed": 0, "refused": 0, "starved": 0}
        self.last_outcome: str | None = None
        self.last_qe: float | None = None

    # -- the batch trainer's schedules, round-for-epoch --------------------
    def schedules(self) -> tuple[float, float]:
        decay = np.exp(-self.round_no / self.decay_rounds)
        return (self.learning_rate * decay,
                max(self.sigma0 * decay, self.sigma_min))

    def apply_batch(self, x: np.ndarray) -> float:
        """One neighborhood-decayed pull toward batch ``x`` — exactly
        the batch trainer's numpy step (``som_update`` on the forward
        winners, float32 cast after), so the parity contract is
        bit-for-bit.  Returns mean |Δw|."""
        x = np.ascontiguousarray(x, np.float32).reshape(len(x), -1)
        lr, sigma = self.schedules()
        win, _d = som_ops.np_forward(x, self.weights)
        w, diff = som_ops.np_som_update(self.weights, x, win,
                                        self._coords, lr, sigma)
        self.weights = w.astype(np.float32)
        return float(diff)

    def _qe(self, w: np.ndarray) -> float | None:
        if len(self._eval_x) == 0:
            return None
        return som_ops.np_quantization_error(self._eval_x, w)

    # -- one round ---------------------------------------------------------
    def run_round(self) -> dict:
        """Gather → adapt → judge held-back quantization error →
        bless (candidate export) or refuse (codebook reverts)."""
        records = self.reader.take(self.round_samples,
                                   timeout_s=self.poll_timeout_s)
        if len(records) < self.min_round_samples:
            self.rounds["starved"] += 1
            self.last_outcome = "starved"
            _som_rounds.inc(outcome="starved")
            return {"outcome": "starved", "gathered": len(records),
                    "needed": self.min_round_samples}
        x, _y = records_to_arrays(records)
        x = x.reshape(len(x), -1)
        hold = np.zeros(len(x), bool)
        hold[::self.holdback_every] = True
        self._extend_eval(x[hold])
        qe_blessed = self._qe(self._blessed)
        diff = self.apply_batch(x[~hold])
        self.round_no += 1
        qe_cand = self._qe(self.weights)
        self.last_qe = qe_cand
        refused_why = None
        if qe_cand is None:
            refused_why = "no held-back slice to judge against"
        elif not np.isfinite(qe_cand):
            refused_why = f"non-finite quantization error ({qe_cand})"
        elif qe_blessed is not None and qe_cand \
                > qe_blessed * (1.0 + self.tol) + self.abs_tol:
            refused_why = (f"held-back quantization error regressed: "
                           f"{qe_cand:.6f} vs blessed "
                           f"{qe_blessed:.6f} (tol {self.tol:g})")
        if refused_why is not None:
            self.weights = self._blessed.copy()
            self.rounds["refused"] += 1
            self.last_outcome = "refused"
            _som_rounds.inc(outcome="refused")
            log.warning("SOM round refused: %s", refused_why)
            return {"outcome": "refused", "why": refused_why,
                    "qe": qe_cand, "qe_blessed": qe_blessed,
                    "weights_diff": diff}
        self._blessed = self.weights.copy()
        _som_qe.set(qe_cand)
        self.step += 1
        candidate = os.path.join(self.candidates_dir,
                                 f"som-{self.step:06d}.znn")
        export_som_znn(self.weights, candidate, commit=True)
        self.rounds["blessed"] += 1
        self.last_outcome = "blessed"
        _som_rounds.inc(outcome="blessed")
        return {"outcome": "blessed", "step": self.step,
                "qe": qe_cand, "qe_blessed": qe_blessed,
                "weights_diff": diff, "candidate": candidate}

    def _extend_eval(self, x: np.ndarray) -> None:
        if len(x) == 0:
            return
        if self._eval_x.size == 0:
            self._eval_x = x
        else:
            self._eval_x = np.concatenate([self._eval_x, x])
        if len(self._eval_x) > self.eval_max:
            self._eval_x = self._eval_x[-self.eval_max:]

    def status(self) -> dict:
        return {"step": self.step, "round": self.round_no,
                "rounds": dict(self.rounds),
                "last_outcome": self.last_outcome,
                "last_qe": self.last_qe,
                "eval_rows": int(len(self._eval_x)),
                "replay": self.reader.status()}
