"""Constants and plain oracles shared by the port's kernels.

A copy of the parts of the JAX package's ``repro.kernels.ref`` that the
serving path needs: the constants of the COPIFT exp construction and of the
LCG, and the oracles ``exp_ref`` and ``softmax_ref`` written in PyTorch with
the same phase order.  Every constant is an exact float32 value, so a Python
float scalar that PyTorch rounds to float32 does not change it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# exp: glibc-expf style, fp32, exp2 formulation
# ---------------------------------------------------------------------------

_LOG2E = float(np.float32(1.4426950408889634))     # 1/ln(2)
#: Cody–Waite split of ln2: HI exact in fp32 (0x3f318000), LO the residual,
#: so the remainder r = x − kd·HI − kd·LO is formed in x units.
_LN2_HI = float(np.float32(0.693359375))
_LN2_LO = float(np.float32(-2.12194440e-4))
#: Taylor coefficients of e^r, |r| ≤ ln2/2, degree 7 (Horner order).
_EXP2_POLY = tuple(float(np.float32(1.0 / math.factorial(k)))
                   for k in range(7, 0, -1))

# ---------------------------------------------------------------------------
# LCG constants (the paper's generator)
# ---------------------------------------------------------------------------

LCG_A = 1664525
LCG_C = 1013904223


def _exp_poly(r: torch.Tensor) -> torch.Tensor:
    """FP phase: polynomial for e^r on [-ln2/2, ln2/2] (Horner)."""
    p = torch.full_like(r, _EXP2_POLY[0])
    for c in _EXP2_POLY[1:]:
        p = p * r + c
    return p * r + 1.0


def exp_ref(x: torch.Tensor) -> torch.Tensor:
    """COPIFT exp: FP phase 0 (scale/round/remainder) → INT phase 1 (scale-
    bit assembly) → FP phase 2 (polynomial × scale).  Clamps the input into
    [-104, 89] first, as the JAX oracle does; the selects at the end make
    the result equal to the kernel's, which does not clamp."""
    x = x.to(torch.float32)
    xc = x.clamp(-104.0, 89.0)
    z = xc * _LOG2E
    kd = torch.round(z)                      # half to even, as jnp.round
    r = (xc - kd * _LN2_HI) - kd * _LN2_LO
    ki = kd.to(torch.int32).clamp(-126, 127)
    s = ((ki + 127) << 23).view(torch.float32)
    y = _exp_poly(r) * s
    y = torch.where(x > 88.0, math.inf, y)
    return torch.where(x < -87.0, 0.0, y)


def softmax_ref(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Numerically stable softmax whose exp is the COPIFT construction.  As
    in the JAX oracle, ``x - max`` is taken in the input dtype."""
    m = torch.amax(x, dim=axis, keepdim=True)
    e = exp_ref((x - m).to(torch.float32))
    return (e / e.sum(dim=axis, keepdim=True)).to(x.dtype)
