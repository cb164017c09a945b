"""Learning-rate schedule policies applied to the GD units (port of
``znicz_tpu/nn/lr_adjust.py``).

Iteration or epoch policies — fixed, step, exponential, inverse and
arbitrary — set the ``learning_rate`` (and ``learning_rate_bias``) of the
GD chain.  On the unit graph ``LearningRateAdjust`` rewrites each GD
unit's hyperparameters between ticks; the fused path multiplies
``policy.scale(it)`` into the update as a per-step float32 read from
device memory (``parallel.fused``), so a schedule changes no captured
step."""

from __future__ import annotations

from ..loader.base import TRAIN
from ..units import Unit


class LRPolicy:
    """lr(iteration); ``base_lr`` is the GD unit's configured rate."""

    def __call__(self, base_lr: float, it: int) -> float:
        raise NotImplementedError

    def scale(self, it: int) -> float:
        """lr(it)/lr(0): the multiplier the fused path applies."""
        return self(1.0, it)


class FixedPolicy(LRPolicy):
    def __call__(self, base_lr, it):
        return base_lr


class StepExpPolicy(LRPolicy):
    """lr · γ^⌊it/step⌋ (caffe "step")."""

    def __init__(self, gamma: float = 0.1, step: int = 1):
        self.gamma, self.step = gamma, int(step)

    def __call__(self, base_lr, it):
        return base_lr * self.gamma ** (it // self.step)


class ExpPolicy(LRPolicy):
    """lr · γ^it."""

    def __init__(self, gamma: float = 0.95):
        self.gamma = gamma

    def __call__(self, base_lr, it):
        return base_lr * self.gamma ** it


class InvPolicy(LRPolicy):
    """lr · (1 + γ·it)^−p (caffe "inv")."""

    def __init__(self, gamma: float = 1e-4, power: float = 0.75):
        self.gamma, self.power = gamma, power

    def __call__(self, base_lr, it):
        return base_lr * (1.0 + self.gamma * it) ** (-self.power)


class ArbitraryPolicy(LRPolicy):
    """Piecewise-constant (lr_scale, until_iteration) table; the last
    entry's scale holds forever."""

    def __init__(self, schedule):
        self.schedule = [(float(s), int(u)) for s, u in schedule]

    def __call__(self, base_lr, it):
        for scale, until in self.schedule:
            if it < until:
                return base_lr * scale
        return base_lr * self.schedule[-1][0]


POLICIES = {"fixed": FixedPolicy, "step_exp": StepExpPolicy,
            "exp": ExpPolicy, "inv": InvPolicy,
            "arbitrary": ArbitraryPolicy}


def make_policy(spec) -> LRPolicy:
    """'exp' | ('exp', {...kwargs}) | LRPolicy instance."""
    if isinstance(spec, LRPolicy):
        return spec
    if isinstance(spec, str):
        return POLICIES[spec]()
    name, kwargs = spec
    return POLICIES[name](**kwargs)


class LearningRateAdjust(Unit):
    """Rewrites each linked GD unit's learning rates before its tick.

    ``by_epoch``: the iteration is the loader's epoch (default) or the
    count of train minibatches seen so far."""

    def __init__(self, workflow=None, name=None, policy="fixed",
                 bias_policy=None, by_epoch=True, **kwargs):
        super().__init__(workflow, name or "lr_adjust", **kwargs)
        self.policy = make_policy(policy)
        self.bias_policy = make_policy(bias_policy) if bias_policy \
            else self.policy
        self.by_epoch = by_epoch
        self._gds: list = []
        self._base: list = []
        self._minibatches = 0

    def link_gds(self, gds) -> "LearningRateAdjust":
        self._gds = list(gds)
        self._base = [(g.learning_rate, g.learning_rate_bias)
                      for g in self._gds]
        return self

    def iteration(self) -> int:
        if self.by_epoch:
            loader = getattr(self.workflow, "loader", None)
            return loader.epoch_number if loader is not None else 0
        return self._minibatches

    def run(self) -> None:
        it = self.iteration()
        for g, (lr0, lrb0) in zip(self._gds, self._base):
            g.learning_rate = self.policy(lr0, it)
            g.learning_rate_bias = self.bias_policy(lrb0, it)
        loader = getattr(self.workflow, "loader", None)
        if loader is None or \
                getattr(loader, "minibatch_class", TRAIN) == TRAIN:
            # count only the ticks the gated GD units train on
            self._minibatches += 1
