"""The continual trainer: replayed traffic → blessed checkpoints →
candidates.

``python -m znicz_tpu_torch online-train`` runs this next to a serving
process: warm-start from the artifact the fleet is serving, fine-tune
on replayed capture-log traffic in **bounded rounds** on the card (the
port's :class:`~znicz_tpu_torch.parallel.fused.FusedTrainer`, its steps
replayed from CUDA graphs), judge every round against a held-back slice,
and commit only *blessed* results — through the
:class:`~znicz_tpu_torch.parallel.checkpoint.TrainerCheckpointer`
manifest protocol (so
:class:`~znicz_tpu_torch.promotion.sources.CheckpointSource` sees them)
and as atomically-committed candidate ``.znn`` files (so the stock
``promote`` CLI's ``DirectorySource`` → canary → SLO watch picks them up
with **zero new promotion code**).

A round's lifecycle::

    gather (bounded poll of the replay window)
      ├─ too cold ───────────────▶ "starved"  (no training, no block)
      └─ train K epochs on the round window (labels = served argmax)
           └─ evaluate candidate vs the CURRENT blessed params on the
              held-back slice (same slice, same batch — a fair race)
                ├─ regression beyond tolerance, or non-finite
                │     ─▶ "refused": params revert to the blessed
                │        snapshot (poison must not compound) and
                │        nothing is exported
                └─ within tolerance ─▶ "blessed": checkpoint step
                   (durability manifest = the bless mark) + candidate
                   export

The tolerance judgment is relative — candidate loss may not exceed
``blessed loss × (1 + tol) + abs_tol`` on the held-back slice — the
same delta-not-absolute stance as the BASELINE convergence contracts.

Two rules keep the trainer's CUDA graphs valid and few:

* a captured step reads its parameters by address, so the blessed
  snapshot is restored by ``copy_`` into the trainer's own tensors
  (never by rebinding ``trainer.params``, which would leave the graphs
  training tensors nothing reads);
* a graph is keyed on its dataset's address and shape, so a round's
  rows are copied into one resident buffer of ``round_samples`` rows
  (grown to the next multiple where multi-row requests overflow it)
  and the held-back slice into one of ``eval_max`` rows, padded as the
  reference pads it: one train graph and one eval graph for the
  trainer's whole life.

The round results and :meth:`OnlineTrainer.status` carry the
reference's keys plus the port's own measurements (:data:`PORT_KEYS`).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from .. import export as export_mod
from ..export import ACT, KIND, _commit_znn, _pack_layer, _write_header
from ..parallel.fused import FusedTrainer, LayerSpec, ModelSpec
from ..telemetry.registry import REGISTRY
from .replay import ReplayReader, records_to_arrays

log = logging.getLogger("online")

#: keys of a round's result and of status() that the reference has not:
#: the round's wall and train time (host clock around synchronised
#: work), its train steps, and the trainer's captured graphs and steps
PORT_KEYS = ("wall_ms", "train_ms", "train_steps", "eval_steps", "graphs")

_rounds = REGISTRY.counter(
    "online_rounds_total",
    "continual-training rounds driven to an outcome (blessed = "
    "checkpoint + candidate committed | refused = held-back eval "
    "regressed beyond tolerance, params reverted | starved = the "
    "replay window was too cold to train, degraded honestly)")
_eval_g = REGISTRY.gauge(
    "online_eval_loss",
    "held-back-slice loss of the most recent round's candidate "
    "(compare against online_blessed_eval_loss to see the margin the "
    "bless judgment had)")
_blessed_g = REGISTRY.gauge(
    "online_blessed_eval_loss",
    "held-back-slice loss of the currently blessed params — the bar "
    "a round's candidate must stay within tolerance of")
_steps_g = REGISTRY.gauge(
    "online_blessed_step",
    "step number of the most recent blessed continual-training "
    "checkpoint (0 until the first bless)")


def _host(t):
    """A parameter as a host numpy array (None stays None)."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def spec_from_znn(path: str, *, lr: float = 0.05,
                  momentum: float = 0.9
                  ) -> tuple[ModelSpec, list, list]:
    """Warm start: read a served ``.znn`` fc chain back into a fused
    :class:`ModelSpec` + params (+ zero velocities), as numpy arrays.

    Covers the fc families (fc layers, optional trailing softmax —
    loss becomes softmax-CE; without one, MSE).  Kohonen heads are the
    other online mode (:mod:`znicz_tpu_torch.online.som`); conv chains
    stay offline-trained and raise here.
    """
    layers = export_mod.read_znn(path)
    softmax_head = bool(layers) and layers[-1].kind == "softmax"
    chain = layers[:-1] if softmax_head else layers
    if not chain or any(lay.kind != "fc" for lay in chain):
        kinds = [lay.kind for lay in layers]
        raise ValueError(
            f"online fine-tune covers fc chains (optional softmax "
            f"head); {path!r} is {kinds} — kohonen heads train via "
            f"online.som, everything else stays offline")
    spec_layers, params, vels = [], [], []
    for lay in chain:
        w = np.asarray(lay.w, np.float32)
        b = (np.asarray(lay.b, np.float32)
             if lay.b is not None else None)
        spec_layers.append(LayerSpec(
            kind="fc", activation=lay.activation,
            include_bias=b is not None,
            hypers=(lr, 0.0, 0.0, momentum),
            hypers_bias=(lr, 0.0, 0.0, momentum)))
        params.append((w, b))
        vels.append((np.zeros_like(w),
                     np.zeros_like(b) if b is not None else None))
    spec = ModelSpec(tuple(spec_layers),
                     loss="softmax" if softmax_head else "mse")
    return spec, params, vels


def export_fc_znn(spec: ModelSpec, params, path: str, *,
                  commit: bool = True) -> str:
    """Write fc params (tensors on any device, or numpy) back to the
    ``.znn`` container (the exact inverse of :func:`spec_from_znn`).
    ``commit=True`` takes the atomic publish path (tmp + rename +
    manifest — what a candidates directory wants); ``commit=False``
    writes raw bytes at ``path`` (what
    :meth:`CheckpointSource.materialize`'s tmp contract wants — the
    promotion controller owns the commit there)."""
    target = path + ".tmp" if commit else path
    n = len(spec.layers) + (1 if spec.loss == "softmax" else 0)
    with open(target, "wb") as fh:
        _write_header(fh, n)
        for lay, (w, b) in zip(spec.layers, params):
            w = np.asarray(_host(w), np.float32)
            bb = None if b is None else np.asarray(_host(b), np.float32)
            _pack_layer(fh, KIND["fc"], ACT[lay.activation],
                        [w.shape[0], w.shape[1]], w, bb)
        if spec.loss == "softmax":
            _pack_layer(fh, KIND["softmax"], 0, [])
    return _commit_znn(path) if commit else path


class OnlineTrainer:
    """Bounded-round continual fine-tuning of an fc ``.znn`` on
    replayed capture traffic (see the module docstring for the round
    lifecycle).  ``device``: where the trainer runs (default: the CUDA
    card, raising without one; ``"cpu"`` runs the kernels' plain
    versions)."""

    def __init__(self, model_path: str, capture_dir: str, *,
                 candidates_dir: str | None = None,
                 checkpoint_dir: str | None = None,
                 lr: float = 0.05, momentum: float = 0.9,
                 batch: int = 16, round_samples: int = 128,
                 min_round_samples: int = 32,
                 epochs_per_round: int = 2,
                 holdback_every: int = 8, eval_max: int = 256,
                 tol: float = 0.10, abs_tol: float = 1e-4,
                 seed: int = 0, poll_timeout_s: float = 5.0,
                 model: str | None = None, window: int = 4096,
                 device=None):
        if candidates_dir is None and checkpoint_dir is None:
            raise ValueError("pass candidates_dir and/or "
                             "checkpoint_dir — a trainer whose blessed "
                             "rounds go nowhere closes no loop")
        if holdback_every < 2:
            raise ValueError(f"holdback_every must be >= 2, got "
                             f"{holdback_every}")
        self.model_path = os.fspath(model_path)
        self.spec, params, vels = spec_from_znn(self.model_path, lr=lr,
                                                momentum=momentum)
        self.trainer = FusedTrainer(spec=self.spec, params=params,
                                    vels=vels, device=device)
        self.device = self.trainer.device
        self.reader = ReplayReader(capture_dir, seed=seed,
                                   window=window, model=model)
        self.candidates_dir = (os.path.abspath(candidates_dir)
                               if candidates_dir else None)
        if self.candidates_dir:
            os.makedirs(self.candidates_dir, exist_ok=True)
        self.checkpoint_dir = (os.path.abspath(checkpoint_dir)
                               if checkpoint_dir else None)
        self._checkpointer = None
        self.batch = int(batch)
        self.round_samples = int(round_samples)
        self.min_round_samples = max(int(min_round_samples),
                                     holdback_every)
        self.epochs_per_round = int(epochs_per_round)
        self.holdback_every = int(holdback_every)
        self.eval_max = int(eval_max)
        self.tol = float(tol)
        self.abs_tol = float(abs_tol)
        self.poll_timeout_s = float(poll_timeout_s)
        self._rng = np.random.default_rng(seed)
        #: the held-back slice (never trained on), capped FIFO
        self._eval_x = np.zeros((0, 0), np.float32)
        self._eval_t = np.zeros((0,), np.int32)
        #: the resident device buffers the graphs read: a round's rows
        #: and the padded held-back slice (made at the first round)
        self._train_buf: tuple | None = None
        self._eval_buf: tuple | None = None
        #: device snapshot of the blessed params/vels — the revert
        #: target for refused rounds and the bar for blessing
        self._blessed = self._state()
        self.step = 0
        self.rounds = {"blessed": 0, "refused": 0, "starved": 0}
        self.last_outcome: str | None = None
        self.last_eval: float | None = None
        self.last_blessed_eval: float | None = None
        self.train_steps = 0
        self.eval_steps = 0

    # -- helpers -----------------------------------------------------------
    def _state(self):
        """Copies of the trainer's (params, vels) on its device."""
        def copy(t):
            return None if t is None else t.detach().clone()
        return [((copy(w), copy(b)), (copy(vw), copy(vb)))
                for (w, b), (vw, vb) in zip(self.trainer.params,
                                            self.trainer.vels)]

    @torch.no_grad()
    def _restore_state(self, snap) -> None:
        """Write ``snap`` into the trainer's own tensors: the captured
        graphs hold their addresses."""
        for (pair, vpair), (p, v) in zip(
                zip(self.trainer.params, self.trainer.vels), snap):
            for dst, src in zip(pair + vpair, p + v):
                if dst is not None:
                    dst.copy_(src)

    def _buffers(self, width: int, rows: int):
        """The resident (x, target) pair of ``rows`` rows for samples of
        ``width`` features: float32 x, int32 labels (softmax) or float32
        targets of the output width (MSE)."""
        x = torch.zeros((rows, width), dtype=torch.float32,
                        device=self.device)
        if self.spec.loss == "softmax":
            t = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        else:
            out = self.trainer.params[-1][0].shape[-1]
            t = torch.zeros((rows, out), dtype=torch.float32,
                            device=self.device)
        return x, t

    @staticmethod
    def _fill(buf, x: np.ndarray, t: np.ndarray) -> None:
        """Copy rows into a resident pair and zero its tail (the
        reference's zero padding)."""
        bx, bt = buf
        n = len(x)
        bx[:n].copy_(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
        bt[:n].copy_(torch.from_numpy(np.ascontiguousarray(
            t).reshape((n,) + tuple(bt.shape[1:]))))
        bx[n:].zero_()
        bt[n:].zero_()

    def _eval_loss(self) -> float | None:
        """Masked-mean loss of the CURRENT trainer params on the
        held-back slice (None while the slice is empty), as one padded
        step of ``eval_max`` rows from the resident eval buffer."""
        n = len(self._eval_x)
        if n == 0:
            return None
        m = self.trainer.eval_epoch(*self._eval_buf, np.arange(n),
                                    self.eval_max)
        self.eval_steps += len(m["loss"])
        return float(np.asarray(m["loss"]).mean())

    def _labels_for(self, y: np.ndarray) -> np.ndarray:
        if self.spec.loss == "softmax":
            return np.argmax(y, axis=1).astype(np.int32)
        return y.astype(np.float32)

    def _checkpoint(self, step: int) -> str | None:
        if self.checkpoint_dir is None:
            return None
        if self._checkpointer is None:
            from ..parallel.checkpoint import TrainerCheckpointer
            self._checkpointer = TrainerCheckpointer(
                self.checkpoint_dir, max_to_keep=5)
        self._checkpointer.save(self.trainer, step, block=True)
        return os.path.join(self.checkpoint_dir, str(step))

    def checkpoint_exporter(self, step_dir: str, tmp_path: str) -> None:
        """The ``CheckpointSource(exporter=...)`` hook: restore one
        blessed step into a scratch trainer and write its fc chain as
        raw ``.znn`` bytes at ``tmp_path`` (the controller owns the
        atomic commit + manifest around it).  The scratch trainer
        reuses ``self.spec`` — the checkpoint's spec fingerprint pins
        layer kinds AND hypers, so a fresh ``spec_from_znn`` with
        different lr would refuse to restore."""
        from ..parallel.checkpoint import restore_trainer
        params = [p for p, _v in self._blessed]
        vels = [v for _p, v in self._blessed]
        scratch = FusedTrainer(spec=self.spec, params=params, vels=vels,
                               device=self.device)
        restore_trainer(scratch, os.path.dirname(step_dir),
                        step=int(os.path.basename(step_dir)))
        export_fc_znn(scratch.spec, scratch.params, tmp_path,
                      commit=False)

    # -- one round ---------------------------------------------------------
    def run_round(self, *, poison_labels: bool = False) -> dict:
        """Gather → train → judge → bless/refuse (module docstring).
        ``poison_labels`` is the chaos drill's hook: it trains the
        round on shuffled labels at an exploded learning rate — a
        genuinely regressed candidate the blessing MUST refuse."""
        t0 = time.perf_counter()
        records = self.reader.take(self.round_samples,
                                   timeout_s=self.poll_timeout_s)
        if len(records) < self.min_round_samples:
            # honest degradation: a cold log trains nothing and blocks
            # nothing — the round reports starved and the caller
            # decides how long to wait for traffic
            self.rounds["starved"] += 1
            self.last_outcome = "starved"
            _rounds.inc(outcome="starved")
            return {"outcome": "starved", "gathered": len(records),
                    "needed": self.min_round_samples}
        x, y = records_to_arrays(records)
        t = self._labels_for(y)
        # the held-back slice: every holdback_every-th gathered row is
        # NEVER trained on; FIFO-capped so eval stays one padded step
        hold = np.zeros(len(x), bool)
        hold[::self.holdback_every] = True
        self._extend_eval(x[hold], t[hold])
        tx, tt = x[~hold], t[~hold]
        blessed_loss = self._judged_blessed_loss()
        lr_scale = 1.0
        if poison_labels:
            tt = tt.copy()
            self._rng.shuffle(tt)
            lr_scale = 50.0
        # one resident train buffer of round_samples rows: only the
        # index list (and so the step count) varies round to round.
        # Multi-row requests make one RECORD expand to many rows, so
        # n_tr can exceed round_samples — grow to the next
        # round_samples multiple (a new buffer, so a new graph) rather
        # than minting a shape per row count
        n_tr = len(tx)
        cap = self.round_samples * max(
            1, -(-n_tr // self.round_samples))
        if self._train_buf is None or self._train_buf[0].shape[0] < cap \
                or self._train_buf[0].shape[1] != tx.shape[1]:
            self._train_buf = self._buffers(tx.shape[1], cap)
        self._fill(self._train_buf, tx, tt)
        t1 = time.perf_counter()
        steps = 0
        for _ in range(self.epochs_per_round):
            m = self.trainer.train_epoch(*self._train_buf,
                                         np.arange(n_tr), self.batch,
                                         sync=True, lr_scale=lr_scale)
            steps += len(m["loss"])
        train_ms = (time.perf_counter() - t1) * 1e3
        self.train_steps += steps
        cand_loss = self._eval_loss()
        self.last_eval = cand_loss
        if cand_loss is not None:
            _eval_g.set(cand_loss)
        refused_why = None
        if cand_loss is None:
            refused_why = "no held-back slice to judge against"
        elif not np.isfinite(cand_loss):
            refused_why = f"non-finite candidate eval ({cand_loss})"
        elif blessed_loss is not None and cand_loss \
                > blessed_loss * (1.0 + self.tol) + self.abs_tol:
            refused_why = (f"held-back eval regressed: "
                           f"{cand_loss:.6f} vs blessed "
                           f"{blessed_loss:.6f} (tol {self.tol:g})")
        timing = {"train_ms": train_ms, "train_steps": steps,
                  "graphs": self.graph_count()}
        if refused_why is not None:
            self._restore_state(self._blessed)
            self.rounds["refused"] += 1
            self.last_outcome = "refused"
            _rounds.inc(outcome="refused")
            log.warning("round refused: %s", refused_why)
            return {"outcome": "refused", "why": refused_why,
                    "eval_loss": cand_loss,
                    "blessed_loss": blessed_loss,
                    "trained": int(n_tr), **timing,
                    "wall_ms": (time.perf_counter() - t0) * 1e3}
        # blessed: snapshot, checkpoint (manifest = the bless mark),
        # export the candidate for the promotion watcher
        self._blessed = self._state()
        self.last_blessed_eval = cand_loss
        _blessed_g.set(cand_loss)
        self.step += 1
        _steps_g.set(self.step)
        step_dir = self._checkpoint(self.step)
        candidate = None
        if self.candidates_dir is not None:
            candidate = os.path.join(self.candidates_dir,
                                     f"online-{self.step:06d}.znn")
            export_fc_znn(self.spec, self.trainer.params, candidate,
                          commit=True)
        self.rounds["blessed"] += 1
        self.last_outcome = "blessed"
        _rounds.inc(outcome="blessed")
        return {"outcome": "blessed", "step": self.step,
                "eval_loss": cand_loss, "blessed_loss": blessed_loss,
                "trained": int(n_tr), "candidate": candidate,
                "checkpoint": step_dir, **timing,
                "wall_ms": (time.perf_counter() - t0) * 1e3}

    def _extend_eval(self, x: np.ndarray, t: np.ndarray) -> None:
        if len(x) == 0:
            return
        if self._eval_x.size == 0:
            self._eval_x, self._eval_t = x, t
        else:
            self._eval_x = np.concatenate([self._eval_x, x])
            self._eval_t = np.concatenate([self._eval_t, t])
        if len(self._eval_x) > self.eval_max:
            self._eval_x = self._eval_x[-self.eval_max:]
            self._eval_t = self._eval_t[-self.eval_max:]
        if self._eval_buf is None \
                or self._eval_buf[0].shape[1] != self._eval_x.shape[1]:
            self._eval_buf = self._buffers(self._eval_x.shape[1],
                                           self.eval_max)
        self._fill(self._eval_buf, self._eval_x, self._eval_t)

    def _judged_blessed_loss(self) -> float | None:
        """The blessed params' loss on the CURRENT held-back slice —
        re-measured each round (the slice grows), on the snapshot, so
        candidate and incumbent race on identical rows."""
        if len(self._eval_x) == 0:
            return None
        live = self._state()
        self._restore_state(self._blessed)
        try:
            loss = self._eval_loss()
        finally:
            self._restore_state(live)
        if loss is not None:
            self.last_blessed_eval = loss
            _blessed_g.set(loss)
        return loss

    # -- introspection / lifecycle ----------------------------------------
    def graph_count(self) -> int:
        """CUDA graphs the trainer has captured (0 off the card)."""
        return sum(len(p.graphs) for p in self.trainer._plans.values())

    def status(self) -> dict:
        return {"step": self.step, "rounds": dict(self.rounds),
                "last_outcome": self.last_outcome,
                "last_eval_loss": self.last_eval,
                "blessed_eval_loss": self.last_blessed_eval,
                "eval_rows": int(len(self._eval_x)),
                "replay": self.reader.status(),
                "train_steps": self.train_steps,
                "eval_steps": self.eval_steps,
                "graphs": self.graph_count()}

    def close(self) -> None:
        if self._checkpointer is not None:
            self._checkpointer.close()
