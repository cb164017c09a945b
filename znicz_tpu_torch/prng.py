"""Seeded, stream-addressable randomness (port of ``znicz_tpu/prng.py``).

A process-global registry of named streams (``get(name)``) so every
consumer — weight init, loader shuffles, synthetic data — draws from a
named, reproducible stream.  Each stream's 64-bit seed is derived exactly
as in the JAX package (sha256 of ``f"{seed}:{name}"``, first 8 bytes
little-endian) and feeds the same numpy ``PCG64``, so the host-side draws
are bit-identical to the reference for the same seed.  The JAX key is
replaced by a ``torch.Generator`` per device, seeded from the same stream
seed, for randomness drawn on the torch side.

:func:`state` / :func:`set_state` carry every stream's position in the
reference's JSON form (``bg``, ``stream_seed``, ``fold``), so a
snapshot's ``prng_state`` crosses between the packages both ways; the
port has no key folding and writes ``fold: 0``, and it keeps the states
of the torch generators a stream has made under ``"torch"``, which the
reference ignores."""

from __future__ import annotations

import base64
import hashlib

import numpy as np
import torch


class RandomGenerator:
    """One named random stream: a numpy source plus torch generators."""

    def __init__(self, name: str = "default", seed: int | None = None):
        self.name = name
        self.seed(seed if seed is not None else 1234)

    def seed(self, seed: int) -> None:
        self._seed = int(seed)
        digest = hashlib.sha256(
            f"{self._seed}:{self.name}".encode()).digest()
        self.stream_seed = int.from_bytes(digest[:8], "little")
        self.numpy = np.random.Generator(np.random.PCG64(self.stream_seed))
        self._torch: dict[torch.device, torch.Generator] = {}

    # -- torch side ---------------------------------------------------------
    def torch_generator(self, device="cpu") -> torch.Generator:
        """The stream's ``torch.Generator`` on ``device``, seeded from the
        stream seed the first time it is asked for (reseeding the stream
        drops it).  Its numbers differ from the numpy source's."""
        device = torch.device(device)
        gen = self._torch.get(device)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(self.stream_seed % (2 ** 63))
            self._torch[device] = gen
        return gen

    # -- numpy side (bit-identical to the reference) -------------------------
    def normal(self, loc=0.0, scale=1.0, size=None, dtype=np.float32):
        v = self.numpy.normal(loc, scale, size)
        return dtype(v) if size is None else v.astype(dtype)

    def uniform(self, low=-1.0, high=1.0, size=None, dtype=np.float32):
        v = self.numpy.uniform(low, high, size)
        return dtype(v) if size is None else v.astype(dtype)

    def shuffle(self, arr) -> None:
        self.numpy.shuffle(arr)

    def randint(self, low, high=None, size=None):
        return self.numpy.integers(low, high, size)


_streams: dict[str, RandomGenerator] = {}
_global_seed = 1234


def seed_all(seed: int) -> None:
    """Reseed every existing stream and set the seed for future ones."""
    global _global_seed
    _global_seed = int(seed)
    for gen in _streams.values():
        gen.seed(_global_seed)


def get(name: str = "default") -> RandomGenerator:
    """Named-stream registry (reference ``prng.get()`` contract)."""
    if name not in _streams:
        _streams[name] = RandomGenerator(name, _global_seed)
    return _streams[name]


def state() -> dict:
    """JSON-serializable positions of every stream: the numpy
    bit-generator state, the stream's derived seed, ``fold: 0`` (the
    reference's key-fold count; the port folds no keys) and, under
    ``"torch"``, each torch generator's state by device (base64)."""
    out = {}
    for name, gen in _streams.items():
        entry = {"bg": gen.numpy.bit_generator.state,
                 "stream_seed": gen.stream_seed, "fold": 0}
        if gen._torch:
            entry["torch"] = {
                str(dev): base64.b64encode(
                    g.get_state().numpy().tobytes()).decode()
                for dev, g in gen._torch.items()}
        out[name] = entry
    return out


def set_state(st: dict) -> None:
    """Restore stream positions captured by :func:`state` here or in the
    reference (streams not yet made are made first).  ``fold`` is read
    by the reference only; a stream's torch generators are restored where
    the snapshot holds them and dropped (re-seeded at their next use)
    where it does not."""
    for name, s in st.items():
        gen = get(name)
        gen.numpy.bit_generator.state = s["bg"]
        if "stream_seed" in s:
            gen.stream_seed = int(s["stream_seed"])
        gen._torch = {}
        for dev, blob in s.get("torch", {}).items():
            g = gen.torch_generator(dev)
            g.set_state(torch.frombuffer(bytearray(base64.b64decode(blob)),
                                         dtype=torch.uint8))
