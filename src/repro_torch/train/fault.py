"""Fault tolerance: checkpoint lifecycle, crash-resume, restore onto another
device, straggler detection, as the JAX package's ``repro.train.fault``.

* :class:`CheckpointManager` — numbered checkpoints ``step_%08d.pt`` with
  retention, atomic writes (``checkpoint.py``), async saving and
  ``latest()`` discovery; resume after a kill is ``restore_or_init``.
* :func:`elastic_restore` — restores the latest checkpoint onto a given
  device, or onto a device mesh of another shape: checkpoints store the
  logical tensors, so re-sharding places them by the same rule table
  (``parallel.sharding``), with no file-format coupling.
* :class:`StragglerMonitor` — per-host step-time tracking with a robust
  (median + MAD) slow-host detector and a rebalancing plan, publishing to
  ``repro_torch.obs.metrics``.

States are objects with ``state_dict()`` and ``load_state_dict(arrays)``
(``train_step.TrainState``), as PyTorch's modules and optimizers are.
"""

from __future__ import annotations

import os
import re
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.obs import metrics as _metrics
from repro_torch.train import checkpoint as ckpt


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.saver = ckpt.AsyncSaver() if async_save else None
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.pt")

    def save(self, step: int, tree, meta: dict | None = None) -> str:
        """Save ``tree`` (a flat ``{name: tensor}``) as ``step``.  A tree of
        DTensors is saved as its logical tensors: every rank calls ``save``
        (each DTensor is all-gathered) and rank 0 writes the file."""
        meta = dict(meta or {}, step=step, time=time.time())
        path = self._path(step)
        if any(isinstance(v, DTensor) for v in tree.values()):
            tree = {k: v.full_tensor() if isinstance(v, DTensor) else v
                    for k, v in tree.items()}
            if dist.get_rank() != 0:
                return path
        if self.saver:
            self.saver.submit(path, tree, meta)
        else:
            ckpt.save(path, tree, meta)
        self._gc()
        return path

    def wait(self) -> None:
        if self.saver:
            self.saver.wait()

    def all_steps(self) -> list[int]:
        steps = []
        for fn in os.listdir(self.dir):
            m = re.match(r"step_(\d+)\.pt$", fn)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, device: torch.device | str = "cpu"):
        """returns (arrays, meta) of checkpoint ``step``."""
        return ckpt.load(self._path(step), device)

    def restore_or_init(self, init_fn: Callable[[], Any]):
        """Crash-resume entry point: ``init_fn()`` builds the state, and the
        latest checkpoint, if there is one, is loaded into it.  Returns
        (state, step)."""
        state = init_fn()
        step = self.latest()
        if step is None:
            return state, 0
        arrays, meta = self.restore(step)
        state.load_state_dict(arrays)
        return state, int(meta["step"])

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            try:
                os.remove(self._path(s))
            except OSError:
                pass


def elastic_restore(manager: CheckpointManager,
                    init_fn: Callable[[torch.device], Any],
                    device: torch.device | str, mesh=None, cfg=None):
    """Resume the latest checkpoint onto ``device``: ``init_fn(device)``
    builds the state there and the checkpoint is loaded into it.  With
    ``mesh`` (e.g. after losing a pod: 512 → 256 chips), the state is then
    placed on it by the rule table of ``cfg``
    (``ShardingRules(cfg, mesh)``), which recomputes the ZeRO/TP layout;
    every rank of the mesh calls this.  Returns (state, step)."""
    if mesh is not None and cfg is None:
        raise ValueError("elastic_restore onto a mesh needs the model "
                         "config whose rule table places the state")
    step = manager.latest()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {manager.dir}")
    device = torch.device(device)
    state = init_fn(device)
    arrays, meta = manager.restore(step, device)
    state.load_state_dict(arrays)
    if mesh is not None:
        from repro_torch.parallel.sharding import ShardingRules
        from repro_torch.train.train_step import distribute_train_state
        state = distribute_train_state(state, ShardingRules(cfg, mesh))
    return state, int(meta["step"])


@dataclass
class StragglerMonitor:
    """Median+MAD step-time outlier detection with a rebalance callback.

    A host is flagged only when BOTH hold: modified z-score > ``threshold``
    (robust outlier) and step time > ``min_ratio`` × median (absolute
    margin — tiny MADs on near-identical fleets must not fire)."""
    threshold: float = 3.5            # modified z-score cutoff
    min_ratio: float = 1.5            # and at least 1.5× the median
    window: int = 32
    history: dict[str, list[float]] = field(default_factory=dict)
    events: list[dict] = field(default_factory=list)

    def record(self, host: str, step: int, seconds: float) -> bool:
        """Returns True if ``host`` is currently flagged as a straggler.

        With recording on (``obs.metrics.set_enabled(True)``) each call also
        publishes the host's step time as a
        ``train.straggler.step_seconds.<host>`` gauge and counts detections
        on ``train.straggler.detected``."""
        h = self.history.setdefault(host, [])
        h.append(seconds)
        del h[:-self.window]
        _metrics.set_gauge(f"train.straggler.step_seconds.{host}", seconds)
        latest = {k: v[-1] for k, v in self.history.items() if v}
        if len(latest) >= 2:
            sample = list(latest.values())
        elif len(h) >= 8:
            sample = h[:-1]           # single-host: own history
        else:
            return False
        med = statistics.median(sample)
        mad = statistics.median(abs(v - med) for v in sample) or 1e-9
        z = 0.6745 * (seconds - med) / mad
        if z > self.threshold and seconds > self.min_ratio * med:
            self.events.append(dict(host=host, step=step, z=float(z),
                                    seconds=seconds))
            _metrics.inc("train.straggler.detected")
            _metrics.set_gauge(f"train.straggler.last_z.{host}", float(z))
            return True
        return False

    def rebalance_plan(self, per_host_microbatches: dict[str, int]) -> dict:
        """Shift one microbatch from each flagged host to the fastest host —
        the simplest work-stealing mitigation; called between steps."""
        if not self.events:
            return per_host_microbatches
        flagged = {e["host"] for e in self.events[-4:]}
        latest = {k: v[-1] for k, v in self.history.items() if v}
        if not latest:
            return per_host_microbatches
        fastest = min(latest, key=latest.get)
        plan = dict(per_host_microbatches)
        for h in flagged:
            if h in plan and plan[h] > 1 and fastest != h:
                plan[h] -= 1
                plan[fastest] = plan.get(fastest, 0) + 1
        return plan
