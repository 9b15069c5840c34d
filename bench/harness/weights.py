"""The weights, made on the device from the seed.

Leaves that share a dtype and an initial law lie side by side in one flat
buffer of that dtype, and each such group is drawn in a few large calls:
chunks of ``CHUNK`` values, each from a ``torch.Generator`` on the device
seeded from ``(seed, group, chunk)``, in float32, scaled, and rounded once
to the dtype.  So any leaf's first values can be drawn again alone
(:meth:`Weights.initial`), which is how the check reads each leaf's change
without keeping a copy of the weights beside the program's.

The program gets views of the buffers, in its own tree layout.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import torch

CHUNK = 1 << 26
_ALIGN = 128          # elements between leaf starts (256 bytes in bf16)


def derive(*parts) -> int:
    """A 63-bit generator seed from the run's seed and a tag."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def keystr(path: tuple) -> str:
    """The path as ``torch.utils._pytree.keystr`` writes it."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


class Weights:
    """``leaves``: ``(path, shape, dtype name, init)`` as a reference's
    ``layout`` gives them."""

    def __init__(self, leaves: list, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.leaves = {path: (tuple(shape), dtype, tuple(init))
                       for path, shape, dtype, init in leaves}
        groups: OrderedDict = OrderedDict()
        for path, (shape, dtype, init) in self.leaves.items():
            groups.setdefault((dtype, init), []).append(path)
        self.groups = list(groups.items())
        self.where: dict = {}             # path -> (group index, offset in group)
        self.sizes: dict = {}             # dtype -> elements of its buffer
        self.group_at: list = []          # group index -> (dtype, start, length)
        for g, ((dtype, init), paths) in enumerate(self.groups):
            start = self.sizes.get(dtype, 0)
            off = 0
            for path in paths:
                self.where[path] = (g, off)
                off += -(-_numel(self.leaves[path][0]) // _ALIGN) * _ALIGN
            self.group_at.append((dtype, start, off))
            self.sizes[dtype] = start + off
        self._cache = (None, None)

    def _chunk(self, g: int, j: int) -> torch.Tensor:
        """Chunk ``j`` of group ``g``, in the group's dtype."""
        if self._cache[0] == (g, j):
            return self._cache[1]
        dtype, _, length = self.group_at[g]
        init = self.groups[g][0][1]
        n = min(CHUNK, length - j * CHUNK)
        dt = getattr(torch, dtype)
        if init[0] == "zeros":
            out = torch.zeros(n, dtype=dt, device=self.device)
        else:
            gen = torch.Generator(device=self.device).manual_seed(derive(self.seed, g, j))
            out = torch.randn(n, generator=gen, dtype=torch.float32, device=self.device)
            out = out.mul_(init[1]).to(dt)
        self._cache = ((g, j), out)
        return out

    def make(self) -> dict:
        """The buffers, filled; ``{dtype: flat tensor}``."""
        bufs = {dt: torch.empty(n, dtype=getattr(torch, dt), device=self.device)
                for dt, n in self.sizes.items()}
        for g, (dtype, start, length) in enumerate(self.group_at):
            for j in range(-(-length // CHUNK)):
                c = self._chunk(g, j)
                bufs[dtype][start + j * CHUNK:start + j * CHUNK + c.numel()].copy_(c)
        self.forget()
        return bufs

    def forget(self) -> None:
        """Drop the chunk kept from the last draw."""
        self._cache = (None, None)

    def view(self, bufs: dict, path: tuple) -> torch.Tensor:
        shape, dtype, _ = self.leaves[path]
        g, off = self.where[path]
        start = self.group_at[g][1] + off
        return bufs[dtype][start:start + _numel(shape)].view(shape)

    def initial(self, path: tuple) -> torch.Tensor:
        """The leaf's first values, drawn again."""
        shape, _, _ = self.leaves[path]
        g, off = self.where[path]
        n = _numel(shape)
        parts, pos = [], off
        while pos < off + n:
            j = pos // CHUNK
            c = self._chunk(g, j)
            take = min(off + n, (j + 1) * CHUNK) - pos
            parts.append(c[pos - j * CHUNK:pos - j * CHUNK + take])
            pos += take
        return (parts[0] if len(parts) == 1 else torch.cat(parts)).view(shape)

    def tree(self, bufs: dict) -> dict:
        """The program's parameter tree over views of ``bufs``: nested dicts,
        with a list where a path holds a layer index."""
        root: dict = {}
        for path in self.leaves:
            node = root
            for i, key in enumerate(path[:-1]):
                nxt = path[i + 1]
                if isinstance(key, int):
                    while len(node) <= key:
                        node.append({})
                    node = node[key]
                else:
                    node = node.setdefault(key, [] if isinstance(nxt, int) else {})
            node[path[-1]] = self.view(bufs, path)
        return root

    def flat(self, bufs: dict) -> dict:
        """``{path: view}`` (the reference's form)."""
        return {path: self.view(bufs, path) for path in self.leaves}
