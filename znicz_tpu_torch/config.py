"""Attribute-tree global configuration (port of ``znicz_tpu/config.py``).

A process-global ``root`` tree; config files are plain Python executed
against ``root`` and any dotted path can be overridden from the CLI
(``--set mnist.minibatch_size=50``).  This is the port's own tree,
independent of ``znicz_tpu.config.root``."""

from __future__ import annotations

import ast
import json

_MISSING = object()


class Config:
    """A node in the attribute tree.

    Accessing an unknown attribute creates an empty child node, so config
    files can write ``root.a.b.c = 1`` without pre-declaring anything.
    """

    def __init__(self, path: str = "root", **kwargs):
        self.__dict__["_path"] = path
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- tree behaviour ------------------------------------------------------
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        child = Config(f"{self._path}.{name}")
        self.__dict__[name] = child
        return child

    def __setattr__(self, name: str, value):
        if isinstance(value, dict):
            node = self.__dict__.get(name)
            if not isinstance(node, Config):
                node = Config(f"{self._path}.{name}")
                self.__dict__[name] = node
            node.update(value)
        else:
            self.__dict__[name] = value

    def update(self, values: dict) -> "Config":
        """Recursively merge a dict into this node."""
        for k, v in values.items():
            if isinstance(v, dict):
                node = self.__dict__.get(k)
                if not isinstance(node, Config):
                    node = Config(f"{self._path}.{k}")
                    self.__dict__[k] = node
                node.update(v)
            else:
                self.__dict__[k] = v
        return self

    def setdefaults(self, values: dict) -> "Config":
        """Recursively fill only MISSING keys (module-level sample
        defaults): a config file executed before the module import keeps
        its values."""
        for k, v in values.items():
            existing = self.__dict__.get(k, _MISSING)
            if isinstance(v, dict):
                node = existing
                if not isinstance(node, Config):
                    if existing is not _MISSING:
                        continue   # leaf already set by the user
                    node = Config(f"{self._path}.{k}")
                    self.__dict__[k] = node
                node.setdefaults(v)
            elif existing is _MISSING:
                self.__dict__[k] = v
        return self

    # -- access helpers ------------------------------------------------------
    @staticmethod
    def _descend(node, part):
        """One path step: Config attribute, list index, or dict key."""
        if isinstance(node, Config):
            return node.__dict__.get(part, _MISSING)
        if isinstance(node, list):
            try:
                return node[int(part)]
            except (ValueError, IndexError):
                return _MISSING
        if isinstance(node, dict):
            return node.get(part, _MISSING)
        return _MISSING

    def get(self, name: str, default=None):
        """Read a leaf without creating intermediate nodes."""
        node = self
        for part in name.split("."):
            node = self._descend(node, part)
            if node is _MISSING:
                return default
        return default if isinstance(node, Config) and not node.to_dict() \
            else node

    def set_path(self, dotted: str, value):
        """CLI-style override: ``set_path("mnist.minibatch_size", 50)``;
        paths may index into list/dict leaves
        (``mnist.layers.0.<-.learning_rate``)."""
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if isinstance(node, Config):
                node = getattr(node, part)
            elif isinstance(node, list):
                node = node[int(part)]
            else:
                node = node[part]
        last = parts[-1]
        if isinstance(node, Config):
            setattr(node, last, value)
        elif isinstance(node, list):
            node[int(last)] = value
        else:
            node[last] = value

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            out[k] = v.to_dict() if isinstance(v, Config) else v
        return out

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__ and not name.startswith("_")

    def __repr__(self):
        body = json.dumps(self.to_dict(), default=str)
        return f"Config({self._path}: {body})"


#: Process-global configuration tree.
root = Config("root")
root.common.update({
    "precision_type": "float32",
    # mixed-precision knobs read by StandardWorkflow.train(); None keeps the
    # fused path's float32 defaults
    "compute_dtype": None,
    "storage_dtype": None,
    "seed": 1234,
})


def apply_overrides(overrides: list[str], tree: Config = root) -> None:
    """Apply CLI ``path=value`` overrides; values parsed as Python literals."""
    for item in overrides:
        path, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        tree.set_path(path.strip(), value)
