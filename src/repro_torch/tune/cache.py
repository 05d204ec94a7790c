"""Persistent tuning cache — repeat ``tune()`` calls are free; the port's
copy of the JAX package's ``repro.tune.cache``, with the same JSON schema
and the same ``cache_key`` strings, but its own file.

One JSON file maps content-addressed keys to serialized ``TuneResult``
payloads.  The key covers everything the result is a pure function of:
workload name, problem size, dtype, the architecture config (cores, banks,
DMA width, the full DVFS ladder and nominal point), the objective, the
power cap, and the space's knob/value lists — change any of them and the
entry simply misses, so stale results can't leak across configs.

Location: ``$REPRO_TORCH_TUNE_CACHE`` if set, else
``~/.cache/repro-torch-tune/cache.json``: never the JAX package's file
(``$REPRO_TUNE_CACHE``), so the two packages share no entry.  Writes are atomic
(write-temp-then-rename), so concurrent processes at worst lose an entry,
never corrupt the file; unreadable, truncated or wrong-schema files are
treated as empty rather than fatal, and an unwritable location (e.g.
``$REPRO_TORCH_TUNE_CACHE`` pointing into a read-only mount) degrades the cache
to in-memory-only with one warning instead of failing the ``tune()`` call
— caching accelerates, it never gates.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import warnings

from repro_torch.cluster.topology import ClusterConfig
from repro_torch.tune.space import SearchSpace

SCHEMA_VERSION = 1


def _default_path() -> str:
    env = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro-torch-tune", "cache.json")


def cache_key(workload: str, problem: int, cfg: ClusterConfig,
              objective: str, power_cap_mw: float | None,
              space: SearchSpace, dtype: str = "fp64",
              measure_top_k: int = 0) -> str:
    """Content-addressed key over everything the tune result depends on."""
    doc = dict(
        schema=SCHEMA_VERSION,
        workload=workload, problem=problem, dtype=dtype,
        objective=objective, power_cap_mw=power_cap_mw,
        measure_top_k=measure_top_k,
        arch=dict(
            n_cores=cfg.n_cores, tcdm_banks=cfg.tcdm_banks,
            dma_bytes_per_cycle=cfg.dma_bytes_per_cycle,
            nominal=cfg.nominal.name,
            points=[(p.name, p.freq_ghz, p.vdd)
                    for p in cfg.operating_points]),
        space=dict(
            default=space.default.to_dict(),
            knobs={k.name: list(k.values) for k in space.knobs}),
    )
    blob = json.dumps(doc, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


class TuneCache:
    """Lazy-loading JSON store of tune results."""

    def __init__(self, path: str | os.PathLike | None = None):
        self.path = str(path) if path else _default_path()
        self._data: dict | None = None
        self._memory_only = False     # set when the path proves unwritable

    def _load(self) -> dict:
        if self._data is None:
            try:
                with open(self.path) as f:
                    data = json.load(f)
                if (not isinstance(data, dict)
                        or data.get("schema") != SCHEMA_VERSION
                        or not isinstance(data.get("entries"), dict)):
                    data = None
            except (OSError, ValueError):
                data = None
            self._data = data or {"schema": SCHEMA_VERSION, "entries": {}}
        return self._data

    def __len__(self) -> int:
        return len(self._load()["entries"])

    def get(self, key: str) -> dict | None:
        return self._load()["entries"].get(key)

    def put(self, key: str, payload: dict) -> None:
        data = self._load()
        data["entries"][key] = payload
        self._flush()

    def clear(self) -> None:
        self._data = {"schema": SCHEMA_VERSION, "entries": {}}
        self._flush()

    def _flush(self) -> None:
        """Atomic write-temp-then-rename.  An unwritable location flips the
        cache to memory-only (with one warning) instead of raising: entries
        keep accumulating in-process, ``tune()`` keeps working, nothing
        persists — caching accelerates, it never gates."""
        if self._memory_only:
            return
        d = os.path.dirname(self.path) or "."
        tmp = None
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(prefix=".tune-cache-", dir=d)
            with os.fdopen(fd, "w") as f:
                json.dump(self._data, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException as e:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            if not isinstance(e, OSError):
                raise
            self._memory_only = True
            warnings.warn(f"tune cache at {self.path!r} is not writable "
                          f"({e}); falling back to in-memory caching",
                          RuntimeWarning, stacklevel=3)


_DEFAULT_CACHE: TuneCache | None = None


def default_cache() -> TuneCache:
    """The shared process-wide cache at the default path."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None or _DEFAULT_CACHE.path != _default_path():
        _DEFAULT_CACHE = TuneCache()
    return _DEFAULT_CACHE


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.tune.cache [--warm] [--clear]
# ---------------------------------------------------------------------------

def warm(names: "list[str] | None" = None, *,
         path: "str | os.PathLike | None" = None) -> dict:
    """Pre-price the default plan search for each tunable registry kernel.
    (The JAX package's ``warm`` walks every registry kernel and raises
    ``KeyError`` at the first one without a tunable workload, ``poly_lcg``;
    the port walks the tunable ones.)

    Runs every search through ``Tuner.plan`` itself — the same front
    door, hence byte-identical cache keys — so a later in-process or
    cross-process ``Tuner.plan(name)`` is a pure cache hit
    (``TuneResult.from_cache``).  Returns ``{name: from_cache}`` for the
    warming pass itself (True where the cache was already warm).
    """
    # Lazy: repro_torch.api.tuner imports this module; the CLI direction must
    # not import it at module scope.
    from repro_torch.api import Tuner, specs
    tuner = Tuner(cache=TuneCache(path) if path else None)
    return {name: tuner.plan(name).from_cache
            for name in (names or [s.name for s in specs() if s.tunable])}


def main(argv=None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="inspect / warm the persistent tuning cache")
    ap.add_argument("--path", default=None,
                    help="cache file (default $REPRO_TORCH_TUNE_CACHE or "
                         "~/.cache/repro-torch-tune/cache.json)")
    ap.add_argument("--warm", action="store_true",
                    help="pre-price the default Tuner.plan search for "
                         "every registry kernel")
    ap.add_argument("--kernel", action="append", default=None,
                    help="restrict --warm to this kernel (repeatable)")
    ap.add_argument("--clear", action="store_true",
                    help="empty the cache file")
    args = ap.parse_args(argv)

    store = TuneCache(args.path)
    if args.clear:
        store.clear()
        print(f"tune.cache.cleared,{store.path}")
    if args.warm:
        hits = warm(args.kernel, path=args.path)
        for name, was_warm in sorted(hits.items()):
            print(f"tune.cache.warm,{name},"
                  f"{'hit' if was_warm else 'priced'}")
    print(f"tune.cache,{store.path},{len(store)}_entries")


if __name__ == "__main__":
    main()
