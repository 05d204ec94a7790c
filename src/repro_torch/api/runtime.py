"""Scoped runtime configuration — ``repro_torch.api.config``.

A context manager over the kernels' ContextVar overrides
(``kernels.ops.overrides``): the setting holds exactly within the ``with``
block, in the current thread or task, and is restored on exit, even on
error:

    with repro_torch.api.config(impl="cuda", tuned_defaults=True):
        y = repro_torch.api.kernel("logf").run(x)
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def config(impl: str | None = None, tuned_defaults: bool | None = None):
    """Scoped kernel-runtime override.

    ``impl``            'auto' | 'cuda' | 'reference' kernel dispatch;
    ``tuned_defaults``  let the tuner (``repro_torch.tune``) pick the
                        kernels' default block tilings.

    ``None`` leaves a setting untouched; nesting composes (inner scopes
    win).
    """
    from repro_torch.kernels import ops as kops
    with kops.overrides(impl=impl, tuned_defaults=tuned_defaults):
        yield
