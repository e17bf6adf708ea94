"""Chunk-addressable frame generation on the device.

A cell's trajectory is cut into chunks of ``CHUNK`` frames, and chunk
``k`` comes from a ``torch.Generator`` seeded by ``(seed, system, k)``
alone.  One process, each of several ranks and the reference therefore
make the same frames, in any order and on any of them, without handing
arrays over.  A chunk always draws a whole chunk's numbers, so a chunk
cut short by the end of the trajectory is the prefix of the whole one.

The model of each system lives in ``systems/<name>.py``, found by the
configuration's ``"system"`` key; it provides ``topology(cfg)``,
``shared(cfg, seed, device)`` (what every chunk shares, such as a base
structure) and ``chunk(cfg, shared, gen, device)`` (``CHUNK`` frames,
float32, ``(CHUNK, n_atoms, 3)``) and ``dimensions(cfg)``.
"""

from __future__ import annotations

import hashlib
import importlib

import numpy as np

CHUNK = 512


def stream_seed(seed: int, *key) -> int:
    """A 63-bit generator seed for ``key`` under the run's ``seed``
    (any whole number, negative or wider than 64 bits included)."""
    text = "/".join(str(x) for x in (int(seed),) + key)
    digest = hashlib.blake2b(text.encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def generator(seed: int, *key, device="cpu"):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *key))
    return g


def system_module(cfg: dict):
    return importlib.import_module(f"portbench.systems.{cfg['system']}")


class Frames:
    """The frames of one configuration under one seed, made on
    ``device`` a chunk at a time."""

    def __init__(self, cfg: dict, seed: int, n_frames: int, device):
        import torch

        self.cfg = cfg
        self.seed = int(seed)
        self.n_frames = int(n_frames)
        self.device = torch.device(device)
        self.model = system_module(cfg)
        self.shared = self.model.shared(
            cfg, generator(seed, cfg["system"], "shared",
                           device=self.device.type), self.device)

    @property
    def n_chunks(self) -> int:
        return -(-self.n_frames // CHUNK)

    def chunk(self, k: int):
        """Frames ``[k * CHUNK, min((k + 1) * CHUNK, n_frames))`` as a
        float32 device tensor."""
        if not 0 <= k < self.n_chunks:
            raise IndexError(f"chunk {k} of {self.n_chunks}")
        g = generator(self.seed, self.cfg["system"], "chunk", k,
                      device=self.device.type)
        frames = self.model.chunk(self.cfg, self.shared, g, self.device)
        return frames[:min(CHUNK, self.n_frames - k * CHUNK)]

    def chunks(self):
        """``(first frame, chunk tensor)`` of every chunk, in order."""
        for k in range(self.n_chunks):
            yield k * CHUNK, self.chunk(k)

    def to_host(self) -> np.ndarray:
        """Every frame copied once into one host array
        ``(n_frames, n_atoms, 3)`` float32."""
        import torch

        out = np.empty((self.n_frames, self.cfg["n_atoms"], 3), np.float32)
        for lo, c in self.chunks():
            torch.from_numpy(out[lo:lo + len(c)]).copy_(c)
        return out
