"""Scoped runtime configuration — ``repro_torch.api.config``.

A context manager over the kernels' ContextVar overrides
(``kernels.ops.overrides``): the setting holds exactly within the ``with``
block, in the current thread or task, and is restored on exit, even on
error:

    with repro_torch.api.config(impl="cuda"):
        y = repro_torch.api.kernel("logf").run(x)
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def config(impl: str | None = None, tuned_defaults: bool | None = None):
    """Scoped kernel-runtime override.

    ``impl``            'auto' | 'cuda' | 'reference' kernel dispatch;
    ``tuned_defaults``  tuned block tilings: ``True`` is not ported yet
                        (ROADMAP §1 item 2) and raises; ``False`` and
                        ``None`` change nothing, since the port's kernels
                        have no block tiling to tune.

    ``None`` leaves a setting untouched; nesting composes (inner scopes
    win).
    """
    if tuned_defaults:
        raise NotImplementedError(
            "config(tuned_defaults=True): the tuned tiling defaults come "
            "with the analytic model's tuner, ROADMAP §1 item 2")
    from repro_torch.kernels import ops as kops
    with kops.overrides(impl=impl):
        yield
