"""Seeded weights, made on the device in a few large draws.

Every random matrix of a model lies in one flat buffer, in the order of
its parameter list.  The buffer is drawn in chunks of ``CHUNK`` values,
chunk ``i`` from a generator seeded with ``chunk_seed(seed, i)``, so any
part of it can be drawn again alone: the harness fills the program's
parameters from the whole buffer, and the reference draws the chunks that
one layer needs, when it needs them.  A matrix is a standard normal times
its scale, drawn and scaled in the dtype it is served in; a 1-D parameter
(a norm's gain or bias) is a constant.

Nothing here imports the program: the names and shapes are the
reference's own (``decoder.param_specs``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: values per draw: 2**28 (1 GiB of fp32, 512 MiB of bf16)
CHUNK = 1 << 28


@dataclass(frozen=True)
class ParamSpec:
    """One parameter: ``init`` is ``"normal"`` (times ``scale``), ``"ones"``
    or ``"zeros"``."""
    name: str
    shape: tuple[int, ...]
    init: str
    scale: float = 1.0

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def chunk_seed(seed: int, i: int) -> int:
    """The generator seed of chunk ``i``: a 64-bit mix of the run's seed
    and the chunk's index."""
    h = (int(seed) * 0x9E3779B97F4A7C15 + (i + 1) * 0xBF58476D1CE4E5B9)
    h &= (1 << 64) - 1
    h ^= h >> 31
    h = (h * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return h ^ (h >> 29)


def draw_chunk(seed: int, i: int, n: int, dtype: torch.dtype,
               device) -> torch.Tensor:
    """Chunk ``i`` of the flat buffer, ``n`` values (``CHUNK`` but for the
    last), standard normals in ``dtype``."""
    g = torch.Generator(device=device).manual_seed(chunk_seed(seed, i))
    return torch.randn(n, generator=g, dtype=dtype, device=device)


def offsets(specs: list[ParamSpec]) -> tuple[dict[str, int], int]:
    """Each random matrix's offset in the flat buffer, and its length."""
    out, n = {}, 0
    for s in specs:
        if s.init == "normal":
            out[s.name] = n
            n += s.numel
    return out, n


def _const(s: ParamSpec, dtype, device) -> torch.Tensor:
    fill = 1.0 if s.init == "ones" else 0.0
    return torch.full(s.shape, fill, dtype=dtype, device=device)


def make_all(specs: list[ParamSpec], seed: int, dtype: torch.dtype, device,
             const_dtype=None) -> dict[str, torch.Tensor]:
    """Every parameter, the matrices as views of one flat buffer drawn in
    ``dtype``, the constants in ``const_dtype(name)`` (default ``dtype``)."""
    offs, total = offsets(specs)
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, (total + CHUNK - 1) // CHUNK):
        lo = i * CHUNK
        hi = min(total, lo + CHUNK)
        flat[lo:hi].copy_(draw_chunk(seed, i, hi - lo, dtype, device))
    out = {}
    for s in specs:
        if s.init == "normal":
            v = flat[offs[s.name]:offs[s.name] + s.numel].view(s.shape)
            v.mul_(s.scale)
            out[s.name] = v
        else:
            dt = const_dtype(s.name) if const_dtype else dtype
            out[s.name] = _const(s, dt, device)
    return out


class Redraw:
    """Draws single parameters again, chunk by chunk, with the last chunk
    kept: walking the parameters in their order draws each chunk once."""

    def __init__(self, specs: list[ParamSpec], seed: int,
                 dtype: torch.dtype, device):
        self.specs = {s.name: s for s in specs}
        self.offs, self.total = offsets(specs)
        self.seed, self.dtype, self.device = seed, dtype, device
        self._chunk: tuple[int, torch.Tensor] | None = None

    def _get_chunk(self, i: int) -> torch.Tensor:
        if self._chunk is None or self._chunk[0] != i:
            self._chunk = None
            n = min(CHUNK, self.total - i * CHUNK)
            self._chunk = (i, draw_chunk(self.seed, i, n, self.dtype,
                                         self.device))
        return self._chunk[1]

    def __call__(self, name: str) -> torch.Tensor:
        """The parameter ``name`` as served, in the draw's dtype."""
        s = self.specs[name]
        if s.init != "normal":
            return _const(s, self.dtype, self.device)
        lo = self.offs[name]
        hi = lo + s.numel
        parts = []
        for i in range(lo // CHUNK, (hi - 1) // CHUNK + 1):
            c = self._get_chunk(i)
            a = max(lo, i * CHUNK) - i * CHUNK
            b = min(hi, (i + 1) * CHUNK) - i * CHUNK
            parts.append(c[a:b])
        v = parts[0].clone() if len(parts) == 1 else torch.cat(parts)
        return v.view(s.shape).mul_(s.scale)
