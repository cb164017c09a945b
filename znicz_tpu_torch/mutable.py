"""Mutable boolean gates for unit-graph control flow (port of
``znicz_tpu/mutable.py``).

``Bool`` objects shared by reference between units act as gates
(``gate_block``, ``gate_skip``); they support assignment-through (``<<=``),
logical composition (``&``, ``|``, ``~``) that stays *live* (re-evaluated
at read time), and on-change callbacks.  The gates live in host Python
between the units' device calls."""

from __future__ import annotations

from typing import Callable


class Bool:
    """A shared, watchable boolean cell."""

    def __init__(self, value: bool = False):
        self._value = bool(value)
        self._watchers: list[Callable[[Bool], None]] = []

    @property
    def value(self) -> bool:
        return self._value

    def set(self, value) -> "Bool":
        value = bool(value)
        if value != self._value:
            self._value = value
            for w in list(self._watchers):
                w(self)
        return self

    def __ilshift__(self, value):  # b <<= True  (reference assignment idiom)
        return self.set(value)

    def on_change(self, fn: Callable[["Bool"], None]) -> None:
        self._watchers.append(fn)

    def __bool__(self) -> bool:
        return self._value

    # live logical composition ---------------------------------------------
    def __invert__(self) -> "DerivedBool":
        return DerivedBool(lambda: not bool(self), (self,))

    def __and__(self, other) -> "DerivedBool":
        return DerivedBool(lambda: bool(self) and bool(other),
                           (self, other))

    def __or__(self, other) -> "DerivedBool":
        return DerivedBool(lambda: bool(self) or bool(other), (self, other))

    def __repr__(self):
        return f"Bool({bool(self)})"


class DerivedBool(Bool):
    """Live view over other Bools; recomputed at every read."""

    def __init__(self, expr: Callable[[], bool], sources: tuple = ()):
        super().__init__(False)
        self._expr = expr
        self._sources = sources
        self._last = self._expr()
        for s in sources:
            if isinstance(s, Bool):   # plain or derived: chains propagate
                s.on_change(lambda _s: self._notify())

    def _notify(self):
        value = self._expr()
        if value == self._last:       # edge-triggered like plain Bool
            return
        self._last = value
        for w in list(self._watchers):
            w(self)

    @property
    def value(self) -> bool:
        return self._expr()

    def set(self, value):
        raise TypeError("DerivedBool is read-only")

    def __ilshift__(self, value):
        raise TypeError("DerivedBool is read-only")

    def __bool__(self) -> bool:
        return self._expr()
