"""Content-addressed simulation memo — the cache tier under ``core.timing``.

A self-standing copy of the JAX package's ``repro.perf.memo``.

Every consumer of the analytic model (the tune cost oracle, ``api.evaluate``,
the cluster sweeps, the serve engine's autotune) bottoms out in the pure
Python discrete-event simulator (``_ssa_unroll`` → ``_list_schedule`` →
``_simulate_inorder_counts``), and before this layer re-ran it from scratch for
every candidate — even though thousands of candidates share identical
instruction bodies and differ only in block size, island layout, or DVFS
point.  This module provides the two memo tables ``core.timing`` consults:

* ``STREAM_MEMO`` — keyed ``(body, iters, schedule)`` where ``body`` is the
  instruction tuple itself (content-addressed: two independently built but
  identical bodies share one entry).  The stored value is the *contention-
  free* pair ``(cycles, mem_accesses)``; TCDM contention enters the
  simulated total only as the final ``t + mem · stalls_per_access`` term,
  so one cached simulation prices every contention value bit-for-bit.
  ``thread_cycles``'s WINDOW=8 structure means any iteration count needs
  at most two cached entries — a whole block-size ladder touches the
  simulator a constant number of times per body.
* ``TIMING_MEMO`` — per-``CopiftSchedule`` steady-state results, keyed by
  the schedule's content fingerprint plus ``(kind, block, contention, …)``,
  so ``copift_block_timing`` / ``copift_problem_timing`` (and through
  them ``ipc_surface`` and the power models) reuse finished
  ``BlockTiming`` objects across blocks, sweeps and contention deltas.

Memoization is *transparent*: hits return exactly what a cold run would
compute (pinned by the parity tests).  Set ``REPRO_TIMING_MEMO=0`` in the
environment (read at import) to bypass both tables for debugging, or use
:func:`set_enabled` / :func:`memo_disabled` at runtime.

This module imports nothing but the standard library — it sits *below*
``repro_torch.core`` so the timing model can depend on it without cycles.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from contextvars import ContextVar


def _env_enabled(value: str | None = None) -> bool:
    """Parse ``$REPRO_TIMING_MEMO`` (default on; 0/false/no/off disable)."""
    raw = os.environ.get("REPRO_TIMING_MEMO", "1") if value is None else value
    return raw.strip().lower() not in ("0", "false", "no", "off")


#: ContextVar rather than a module global so a ``memo_disabled()`` scope in
#: one thread/context cannot leak into a concurrent measurement in another
#: (the same race the kernel runtime's ContextVar overrides close).
_ENABLED: ContextVar[bool] = ContextVar("repro_torch_timing_memo",
                                        default=_env_enabled())


def enabled() -> bool:
    """Whether the memo tables are consulted in the current context."""
    return _ENABLED.get()


def set_enabled(flag: bool) -> None:
    """Persistently flip the switch for the current context (and contexts
    spawned from it); prefer :func:`memo_disabled` for scoped bypasses."""
    _ENABLED.set(bool(flag))


@contextmanager
def memo_disabled():
    """Scope with the memo bypassed — the cold-cache path, for parity tests
    and the ``perf_bench`` before/after measurement."""
    token = _ENABLED.set(False)
    try:
        yield
    finally:
        _ENABLED.reset(token)


_MISS = object()


class SimMemo:
    """One bounded content-addressed table.

    Plain-dict operations are atomic under the GIL; a lost race costs one
    duplicate simulation, never a wrong answer (values are pure functions
    of their keys).  When the table fills it resets wholesale — simpler
    than LRU bookkeeping on a hot path, and ``max_entries`` is far above
    what any real sweep produces.
    """

    __slots__ = ("name", "max_entries", "_store", "hits", "misses")

    def __init__(self, name: str, max_entries: int = 1 << 18):
        self.name = name
        self.max_entries = max_entries
        self._store: dict = {}
        self.hits = 0
        self.misses = 0

    def lookup(self, key):
        """The cached value, or ``None`` on a miss / with the memo off."""
        if not _ENABLED.get():
            return None
        val = self._store.get(key, _MISS)
        if val is _MISS:
            self.misses += 1
            return None
        self.hits += 1
        return val

    def store(self, key, value):
        """Record ``value`` (a no-op with the memo off); returns it."""
        if _ENABLED.get():
            if len(self._store) >= self.max_entries:
                self._store.clear()
            self._store[key] = value
        return value

    def __len__(self) -> int:
        return len(self._store)

    def clear(self) -> None:
        self._store.clear()
        self.hits = 0
        self.misses = 0

    def stats(self) -> dict:
        """Counters plus derived fields: ``entries`` (live table size) and
        ``hit_rate`` (hits / lookups, 0.0 before any lookup) — the shape the
        ``repro_torch.obs`` metrics registry snapshots at session close."""
        lookups = self.hits + self.misses
        return dict(name=self.name, entries=len(self._store),
                    hits=self.hits, misses=self.misses,
                    hit_rate=(self.hits / lookups) if lookups else 0.0)


#: ``(body_instrs, iters, schedule) -> (cycles, mem_accesses)`` — the
#: contention-free discrete-event result (see module docstring).
STREAM_MEMO = SimMemo("stream")

#: ``(schedule_fingerprint, kind, ...) -> BlockTiming`` — finished
#: steady-state / whole-problem timings per schedule content.
TIMING_MEMO = SimMemo("timing")

_ALL = (STREAM_MEMO, TIMING_MEMO)

#: Clear callables of the subsystem ``lru_cache`` tier sitting *above*
#: these tables (``tune.cost._evaluate``, the ``api.evaluate`` timing and
#: power caches, the contention profiles).  Those caches hold finished
#: results, so ``REPRO_TIMING_MEMO=0`` alone does not re-run a simulation
#: they already serve — subsystems register here so :func:`clear_all`
#: resets the whole pricing stack to a fresh-process state.
_EXTRA_CLEARERS: list = []


def register_cache(clear_fn) -> None:
    """Register a subsystem cache's clear callable (idempotent adds are
    the caller's concern — register once at module import)."""
    _EXTRA_CLEARERS.append(clear_fn)


def clear_all() -> None:
    """Empty the memo tables AND every registered subsystem cache — the
    fresh-process state (e.g. between cold/warm benchmark passes, or
    before re-measuring after instrumenting the simulator)."""
    for m in _ALL:
        m.clear()
    for fn in _EXTRA_CLEARERS:
        fn()


def stats() -> list[dict]:
    return [m.stats() for m in _ALL]
