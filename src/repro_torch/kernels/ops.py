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

The default comes in two layers, as in the JAX package: a scoped override
(``overrides``) in a ContextVar, over a process-wide default (``set_impl``)
that every thread sees.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch

from repro_torch.kernels import expf as _exp
from repro_torch.kernels import logf as _log
from repro_torch.kernels import montecarlo as _mc
from repro_torch.kernels import prng as _prng
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import softmax as _softmax

_IMPLS = ("auto", "cuda", "reference")

_IMPL_DEFAULT = "auto"
_IMPL_VAR: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("repro_torch_kernels_impl", default=None)


def _check_impl(impl: str) -> None:
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {_IMPLS}")


def current_impl() -> str:
    """The impl default in effect: the innermost scoped override, else the
    process-wide default."""
    v = _IMPL_VAR.get()
    return _IMPL_DEFAULT if v is None else v


def set_impl(impl: str) -> str:
    """Set the process-wide impl default; returns the one it displaced."""
    global _IMPL_DEFAULT
    _check_impl(impl)
    prev, _IMPL_DEFAULT = _IMPL_DEFAULT, impl
    return prev


@contextlib.contextmanager
def overrides(impl: str | None = None):
    """Scoped impl override; ``None`` leaves it untouched.  Restored on
    exit, even on error."""
    if impl is None:
        yield
        return
    _check_impl(impl)
    token = _IMPL_VAR.set(impl)
    try:
        yield
    finally:
        _IMPL_VAR.reset(token)


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


def exp(x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
    """COPIFT exp (glibc-expf style), elementwise, any shape; fp32 compute,
    the result in ``x``'s dtype."""
    return _exp.ExpFn.apply(x, _use_kernel(impl, x.device))


def log(x: torch.Tensor, impl: str | None = None) -> torch.Tensor:
    """COPIFT log (glibc-logf style, table gather) for positive normals;
    fp32 compute, the result in ``x``'s dtype.  The kernel maps ``x <= 0``
    to 1.0, as the JAX package's Pallas path does; the reference path is
    ``log_ref`` with no such map, as in JAX."""
    if not _use_kernel(impl, x.device):
        return _ref.log_ref(x).to(x.dtype)
    xf = x.to(torch.float32).contiguous()
    return _log.log_cuda(xf).to(x.dtype)


def softmax(x: torch.Tensor, axis: int = -1,
            impl: str | None = None) -> torch.Tensor:
    """COPIFT softmax.  The kernel runs over the last axis; another axis
    takes the plain version, as in the JAX package."""
    axis = axis % x.ndim
    if axis != x.ndim - 1:
        y = _softmax.SoftmaxFn.apply(x.movedim(axis, -1), False)
        return y.movedim(-1, axis)
    return _softmax.SoftmaxFn.apply(x, _use_kernel(impl, x.device))


def uniform(seed: int, shape: tuple[int, ...], kind: str = "xoshiro128p",
            impl: str | None = None,
            device: torch.device | str = "cuda") -> torch.Tensor:
    """Deterministic counter-based uniforms in [0, 1) (the paper's PRNGs);
    ``seed`` is a uint32."""
    device = torch.device(device)
    n = math.prod(shape)
    if _use_kernel(impl, device):
        u = _prng.uniform_cuda(seed, n, kind, device)
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
