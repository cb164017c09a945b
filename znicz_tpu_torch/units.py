"""Unit graph: dataflow nodes with control-flow gating and attribute links
(port of ``znicz_tpu/units.py``).

``Unit`` with ``link_from`` control edges, ``gate_block`` / ``gate_skip``
predicates, ``link_attrs`` live attribute forwarding and per-unit
wall-clock accumulation in ``run_timed``; every unit carries the
``Distributable`` hooks (``distributable.py``)."""

from __future__ import annotations

import time

from .distributable import Distributable
from .logger import Logger
from .mutable import Bool


class Unit(Logger, Distributable):
    """A dataflow node.

    Control edges (``link_from``) say *when* a unit runs; attribute links
    (``link_attrs``) say what data it sees.  Gates:

    * ``gate_block`` — while True the unit neither runs nor lets control
      flow through it.
    * ``gate_skip`` — while True the unit doesn't run but control passes.
    """

    def __init__(self, workflow=None, name: str | None = None, **kwargs):
        if kwargs:
            raise TypeError(f"{type(self).__name__}: unknown options "
                            f"{sorted(kwargs)}")
        self.__dict__["_links"] = {}
        self.name = name or type(self).__name__
        self.workflow = None
        self.gate_block = Bool(False)
        self.gate_skip = Bool(False)
        self._parents: list[Unit] = []
        self._children: list[Unit] = []
        self.initialized = False
        # tracing: per-unit wall-clock accumulation
        self.run_count = 0
        self.time_spent = 0.0
        if workflow is not None:
            workflow.add_unit(self)

    # -- control edges -------------------------------------------------------
    def link_from(self, *parents: "Unit") -> "Unit":
        for p in parents:
            if p not in self._parents:
                self._parents.append(p)
            if self not in p._children:
                p._children.append(self)
        return self

    # -- attribute links -----------------------------------------------------
    def link_attrs(self, other: "Unit", *attrs) -> "Unit":
        """``u.link_attrs(v, "output", ("input", "output"))`` makes
        ``u.output`` (or ``u.input``) a live view of ``v.output``."""
        for attr in attrs:
            mine, theirs = attr if isinstance(attr, tuple) else (attr, attr)
            self.__dict__.pop(mine, None)
            self._links[mine] = (other, theirs)
        return self

    def __getattr__(self, name: str):
        links = self.__dict__.get("_links", {})
        if name in links:
            other, theirs = links[name]
            return getattr(other, theirs)
        raise AttributeError(
            f"{type(self).__name__}({self.__dict__.get('name')}) "
            f"has no attribute {name!r}")

    def __setattr__(self, name: str, value):
        links = self.__dict__.get("_links", {})
        if name in links:
            other, theirs = links[name]
            setattr(other, theirs, value)
        else:
            self.__dict__[name] = value

    # -- lifecycle -------------------------------------------------------------
    def initialize(self, device=None, **kwargs) -> None:
        """Bind resources.  Subclasses allocate Vectors here."""
        self.device = device
        self.initialized = True

    def run(self) -> None:  # override in subclasses
        pass

    def run_timed(self) -> None:
        start = time.perf_counter()
        self.run()
        self.time_spent += time.perf_counter() - start
        self.run_count += 1

    def stop(self) -> None:
        pass

    def __repr__(self):
        return f"{type(self).__name__}({self.name!r})"


class TrivialUnit(Unit):
    """No-op unit (reference parity; handy as a test fixture)."""


class Container(Unit):
    """A unit that owns other units (reference Container contract)."""

    def __init__(self, workflow=None, name=None, **kwargs):
        super().__init__(workflow, name, **kwargs)
        self.units: list[Unit] = []

    def add_unit(self, unit: Unit) -> None:
        if unit not in self.units:
            self.units.append(unit)
        unit.workflow = self
