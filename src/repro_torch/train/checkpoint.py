"""Checkpointing: flat ``{name: tensor}`` states written with ``torch.save``,
atomic writes and an async saver, as the JAX package's
``repro.train.checkpoint`` (which writes msgpack; reading its files is not
ported).

A checkpoint file holds ``{"meta": dict, "arrays": {name: CPU tensor}}``.
It is written to ``<path>.tmp``, flushed, fsynced and renamed, so a crash
leaves either the old file or the new one, never a partial file under the
final name.  Loading uses ``torch.load(weights_only=True)``, which reads
tensors and plain containers only.
"""

from __future__ import annotations

import os
import threading
from collections.abc import Mapping

import torch


def save(path: str, tree: Mapping[str, torch.Tensor],
         meta: dict | None = None) -> None:
    """Atomic: write to .tmp, fsync, rename.  Tensors are stored on the CPU."""
    payload = {"meta": dict(meta or {}),
               "arrays": {k: v.detach().cpu() for k, v in tree.items()}}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        torch.save(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def load(path: str, device: torch.device | str = "cpu"):
    """returns (arrays, meta): the stored ``{name: tensor}`` on ``device``
    and the metadata."""
    payload = torch.load(path, map_location=device, weights_only=True)
    return payload["arrays"], payload["meta"]


class AsyncSaver:
    """Background-thread checkpoint writer: training continues while the
    submitted state serializes.  ``submit`` takes a host copy of the state
    before the thread starts, so updates in place after it returns cannot
    reach the file."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def submit(self, path: str, tree: Mapping[str, torch.Tensor],
               meta: dict | None = None) -> None:
        self.wait()
        # A real copy, never a view of ``tree``'s storage (as ``.cpu()`` of
        # a CPU tensor is): sync copy, then async IO.
        host_tree = {k: v.detach().to("cpu", copy=True)
                     for k, v in tree.items()}

        def work():
            try:
                save(path, host_tree, meta)
            except Exception as e:                    # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
