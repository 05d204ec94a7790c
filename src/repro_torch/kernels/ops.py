"""Public entry points of the COPIFT kernels, with implementation dispatch.

Implementation selection (``impl=``):

* ``"auto"``       — the CUDA kernel for a tensor or device on the card, the
  plain PyTorch version for one on the CPU (the default);
* ``"cuda"``       — the CUDA kernel; a CPU tensor is a ``ValueError``;
* ``"reference"``  — the plain PyTorch version, on whatever device.

There is no fallback from a kernel to its plain version: a kernel that does
not build or launch raises.  ``exp`` and ``softmax`` carry a gradient
(``expf.ExpFn``, ``softmax.SoftmaxFn``) on both routes, so the CPU runs the
backward that the card runs.  The kernels take any length, so the JAX
package's padding to (rows, 1024) tiles has no counterpart here.

Tiling (``block_rows=``): the JAX package's Pallas tile height, which the
port maps onto each kernel's block size (``exp_plan``, ``log_plan``,
``uniform_plan``, ``softmax_plan``).  ``None`` takes the module default, or
with tuned defaults on (``set_tuned_defaults``, ``overrides``,
``repro_torch.api.config``) the default scaled by the tuner's block choice
(``_tuned_block_rows``).  No value depends on the tiling, and the plain
versions ignore it, so the tiling is resolved only for a launch.

Both settings come in two layers, as in the JAX package: a scoped override
(``overrides``) in a ContextVar, over a process-wide default (``set_impl``,
``set_tuned_defaults``) that every thread sees — ``ServeEngine(autotune=
True)`` sets it in ``__init__`` and ``generate()`` may run on another
thread, whose context starts empty.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import torch

from repro_torch.kernels import decode_attn as _decode
from repro_torch.kernels import expf as _exp
from repro_torch.kernels import logf as _log
from repro_torch.kernels import montecarlo as _mc
from repro_torch.kernels import prng as _prng
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import softmax as _softmax

_IMPLS = ("auto", "cuda", "reference")

_IMPL_DEFAULT = "auto"
_TUNED_DEFAULT = False
_IMPL_VAR: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("repro_torch_kernels_impl", default=None)
_TUNED_VAR: contextvars.ContextVar[bool | None] = \
    contextvars.ContextVar("repro_torch_kernels_tuned_defaults", default=None)


def _check_impl(impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {_IMPLS}")


def current_impl() -> str:
    """The impl default in effect: the innermost scoped override, else the
    process-wide default."""
    v = _IMPL_VAR.get()
    return _IMPL_DEFAULT if v is None else v


def tuned_defaults_enabled() -> bool:
    """Whether the tuner picks the default tilings: the innermost scoped
    override, else the process-wide default."""
    v = _TUNED_VAR.get()
    return _TUNED_DEFAULT if v is None else v


def set_impl(impl: str) -> str:
    """Set the process-wide impl default; returns the one it displaced."""
    global _IMPL_DEFAULT
    _check_impl(impl)
    prev, _IMPL_DEFAULT = _IMPL_DEFAULT, impl
    return prev


def set_tuned_defaults(enable: bool = True) -> bool:
    """Let the autotuner (``repro_torch.tune``) pick the kernels' default
    tiling — the process-wide default, visible from every thread.  Entry
    points called without an explicit ``block_rows`` then scale the module
    default by the tuned block's share of the Table-I cap (the analytic
    model's block choice transferred onto the kernel's block size); tuned
    results come from the persistent tune cache, so the first call per
    kernel searches and the rest are free.  Prefer the scoped
    ``repro_torch.api.config(...)`` unless the setting must outlive a
    ``with`` block (``ServeEngine`` setup).

    Returns the *previous* process-wide default, so that a caller can
    restore the state it found (``ServeEngine.close()`` does)."""
    global _TUNED_DEFAULT
    prev = _TUNED_DEFAULT
    _TUNED_DEFAULT = bool(enable)
    _tuned_block_rows.cache_clear()
    return prev


@contextlib.contextmanager
def overrides(impl: str | None = None, tuned_defaults: bool | None = None):
    """Scoped kernel-config override — the engine behind
    ``repro_torch.api.config``.  ``None`` leaves a setting untouched; values
    are restored (and the tuned-tiling memo dropped) on exit, even on
    error."""
    tokens = []
    if impl is not None:
        _check_impl(impl)
        tokens.append((_IMPL_VAR, _IMPL_VAR.set(impl)))
    if tuned_defaults is not None:
        tokens.append((_TUNED_VAR, _TUNED_VAR.set(bool(tuned_defaults))))
        _tuned_block_rows.cache_clear()
    try:
        yield
    finally:
        for var, token in reversed(tokens):
            var.reset(token)
        if tuned_defaults is not None:
            _tuned_block_rows.cache_clear()


@functools.lru_cache(maxsize=None)
def _tuned_block_rows(kernel: str, default_rows: int) -> int:
    """The tuner's tiling for ``kernel``: ``default_rows`` scaled by the
    tuned block's share of the workload's cap, through the facade's shared
    default tuner (one cache and cost oracle across ops, copift and the
    serve engine)."""
    from repro_torch.api import default_tuner
    tuner = default_tuner()
    w = tuner._workload(kernel)
    res = tuner.block(w)          # only the block transfers to the tiling
    return max(1, round(default_rows * res.best.block / w.max_block))


def _resolve_rows(kernel: str, explicit: int | None, default_rows: int) -> int:
    """An explicit ``block_rows``, else the tuned tiling when tuned defaults
    are on, else the module default.  The ``(ImportError, KeyError)`` catch
    is the JAX package's: a kernel without a tunable workload keeps its
    default.  It is a lookup in the analytic model, not a device fallback."""
    if explicit is not None:
        return explicit
    if tuned_defaults_enabled():
        try:
            return _tuned_block_rows(kernel, default_rows)
        except (ImportError, KeyError):
            pass
    return default_rows


def _use_kernel(impl: str | None, device: torch.device) -> bool:
    impl = impl or current_impl()
    _check_impl(impl)
    if impl == "reference":
        return False
    if device.type == "cuda":
        return True
    if impl == "cuda":
        raise ValueError(f"impl='cuda' launches a CUDA kernel, but the data "
                         f"lies on {device}")
    return False


def exp(x: torch.Tensor, impl: str | None = None,
        block_rows: int | None = None) -> torch.Tensor:
    """COPIFT exp (glibc-expf style), elementwise, any shape; fp32 compute,
    the result in ``x``'s dtype."""
    if not _use_kernel(impl, x.device):
        return _exp.ExpFn.apply(x, False)
    rows = _resolve_rows("expf", block_rows, _exp.DEFAULT_BLOCK_ROWS)
    return _exp.ExpFn.apply(x, True, rows)


def log(x: torch.Tensor, impl: str | None = None,
        block_rows: int | None = None) -> torch.Tensor:
    """COPIFT log (glibc-logf style, table gather) for positive normals;
    fp32 compute, the result in ``x``'s dtype.  The kernel maps ``x <= 0``
    to 1.0, as the JAX package's Pallas path does; the reference path is
    ``log_ref`` with no such map, as in JAX."""
    if not _use_kernel(impl, x.device):
        return _ref.log_ref(x).to(x.dtype)
    rows = _resolve_rows("logf", block_rows, _log.DEFAULT_BLOCK_ROWS)
    xf = x.to(torch.float32).contiguous()
    return _log.log_cuda(xf, rows).to(x.dtype)


def softmax(x: torch.Tensor, axis: int = -1, impl: str | None = None,
            block_rows: int | None = None) -> torch.Tensor:
    """COPIFT softmax.  The kernel runs over the last axis; another axis
    takes the plain version, as in the JAX package.  ``block_rows`` is the
    warp path's rows a block (``softmax_plan``)."""
    axis = axis % x.ndim
    if axis != x.ndim - 1:
        y = _softmax.SoftmaxFn.apply(x.movedim(axis, -1), False)
        return y.movedim(-1, axis)
    if not _use_kernel(impl, x.device):
        return _softmax.SoftmaxFn.apply(x, False)
    rows = _resolve_rows("softmax", block_rows, _softmax.DEFAULT_BLOCK_ROWS)
    return _softmax.SoftmaxFn.apply(x, True, rows)


def decode_scores(q: torch.Tensor, k_cache: torch.Tensor, lo: int, hi: int,
                  scale: float, impl: str | None = None) -> torch.Tensor:
    """Decode attention's score product over a KV cache, in place: ``q``
    (B, 1, Hkv, g, Dh) against ``k_cache`` (B, S, Hkv, Dh); fp32 scores
    (B, Hkv, g, 1, S), ``scale`` times the dot product on the slots
    [lo, hi) that the mask keeps, ``decode_attn.NEG_INF`` on the others."""
    if not _use_kernel(impl, q.device):
        return _decode.decode_scores_plain(q, k_cache, lo, hi, scale)
    return _decode.decode_scores_cuda(q, k_cache, lo, hi, scale)


def decode_pv(p: torch.Tensor, v_cache: torch.Tensor, lo: int, hi: int,
              impl: str | None = None) -> torch.Tensor:
    """Decode attention's PV product over a KV cache, in place: the
    probabilities ``p`` (B, Hkv, g, 1, S), 0 outside [lo, hi), times
    ``v_cache`` (B, S, Hkv, Dh); (B, 1, Hkv, g, Dh) in ``p``'s dtype."""
    if not _use_kernel(impl, p.device):
        return _decode.decode_pv_plain(p, v_cache, lo, hi)
    return _decode.decode_pv_cuda(p, v_cache, lo, hi)


def uniform(seed: int, shape: tuple[int, ...], kind: str = "xoshiro128p",
            impl: str | None = None, device: torch.device | str = "cuda",
            block_rows: int | None = None) -> torch.Tensor:
    """Deterministic counter-based uniforms in [0, 1) (the paper's PRNGs);
    ``seed`` is a uint32."""
    device = torch.device(device)
    n = math.prod(shape)
    if _use_kernel(impl, device):
        rows = _resolve_rows("prng", block_rows, _prng.DEFAULT_BLOCK_ROWS)
        u = _prng.uniform_cuda(seed, n, kind, device, rows)
    else:
        u = _prng.uniform_plain(seed, n, kind, device)
    return u.reshape(shape)


def _monte_carlo(problem: str, seed: int, n_samples: int, kind: str,
                 n_blocks: int, impl: str | None,
                 device: torch.device | str) -> torch.Tensor:
    device = torch.device(device)
    iters = n_samples // (n_blocks * _mc.LANES)
    run = (_mc.mc_partial_sums_cuda if _use_kernel(impl, device)
           else _mc.mc_blocked_plain)
    sums = run(seed, kind=kind, problem=problem, iters=iters,
               n_blocks=n_blocks, device=device)
    return _mc.mc_estimate(sums, problem, iters)


def mc_pi(seed: int, n_samples: int, kind: str = "xoshiro128p",
          n_blocks: int = 8, impl: str | None = None,
          device: torch.device | str = "cuda") -> torch.Tensor:
    """π via hit-and-miss Monte Carlo over ``n_blocks × 1024`` lanes, each
    taking ``n_samples // (n_blocks * 1024)`` samples; an fp32 scalar
    tensor, NaN when that is 0."""
    return _monte_carlo("pi", seed, n_samples, kind, n_blocks, impl, device)


def mc_poly(seed: int, n_samples: int, kind: str = "xoshiro128p",
            n_blocks: int = 8, impl: str | None = None,
            device: torch.device | str = "cuda") -> torch.Tensor:
    """∫₀¹ f for the Table-I polynomial via hit-and-miss Monte Carlo, as
    ``mc_pi``."""
    return _monte_carlo("poly", seed, n_samples, kind, n_blocks, impl, device)
