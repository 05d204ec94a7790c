"""Constants and plain oracles shared by the port's kernels.

A copy of the JAX package's ``repro.kernels.ref`` written in PyTorch with
the same phase order: the COPIFT exp and softmax, the glibc-style log with
its 16-entry table, the paper's two generators (LCG and xoshiro128+) and
the hit-and-miss Monte-Carlo estimates.  Every floating-point constant is an
exact float32 value, so a Python float scalar that PyTorch rounds to
float32 does not change it.

uint32 on the CPU: PyTorch has no uint32 ``+``, ``>>`` or ``<<`` there, so
every uint32 word is held in an int64 tensor and masked with
``& 0xFFFFFFFF`` after each add, multiply and left shift.  The oracles that
make data rather than take it (``prng_uniform``, ``mc_pi_ref``,
``mc_poly_ref``) make it on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# ---------------------------------------------------------------------------
# exp: glibc-expf style, fp32, exp2 formulation
# ---------------------------------------------------------------------------

_LOG2E = float(np.float32(1.4426950408889634))     # 1/ln(2)
_LN2 = float(np.float32(0.6931471805599453))
#: Cody–Waite split of ln2: HI exact in fp32 (0x3f318000), LO the residual,
#: so the remainder r = x − kd·HI − kd·LO is formed in x units.
_LN2_HI = float(np.float32(0.693359375))
_LN2_LO = float(np.float32(-2.12194440e-4))
#: Taylor coefficients of e^r, |r| ≤ ln2/2, degree 7 (Horner order).
_EXP2_POLY = tuple(float(np.float32(1.0 / math.factorial(k)))
                   for k in range(7, 0, -1))

# ---------------------------------------------------------------------------
# log: glibc-logf style with the 16-entry invc/logc table
# ---------------------------------------------------------------------------

_LOGF_TABLE_BITS = 4
_LOGF_OFF = 0x3F330000


def _build_logf_table() -> tuple[np.ndarray, np.ndarray]:
    n = 1 << _LOGF_TABLE_BITS
    invc = np.empty(n, np.float32)
    logc = np.empty(n, np.float32)
    for i in range(n):
        # Center of the i-th mantissa window after the OFF re-bias.
        bits = np.int32(_LOGF_OFF + (i << (23 - _LOGF_TABLE_BITS))
                        + (1 << (22 - _LOGF_TABLE_BITS)))
        c = np.frombuffer(bits.tobytes(), np.float32)[0].astype(np.float64)
        invc[i] = np.float32(1.0 / c)
        logc[i] = np.float32(np.log(c))
    return invc, logc


#: The tables, fp32 on the CPU.
LOGF_INVC, LOGF_LOGC = (torch.from_numpy(t) for t in _build_logf_table())
_LOGF_TABLES: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}


def logf_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(invc, logc) on ``device``, copied there once: later calls, and work
    captured in a CUDA graph, use the same two tensors."""
    if device not in _LOGF_TABLES:
        _LOGF_TABLES[device] = (LOGF_INVC.to(device), LOGF_LOGC.to(device))
    return _LOGF_TABLES[device]


#: ln(1+r) Taylor coefficients (degree 4), |r| ≲ 0.05, Horner order.
_LOG1P_POLY = (-0.25, float(np.float32(1.0 / 3.0)), -0.5)

# ---------------------------------------------------------------------------
# PRNGs: LCG and xoshiro128+ (the paper's generators), lane-parallel
# ---------------------------------------------------------------------------

LCG_A = 1664525
LCG_C = 1013904223

_MASK = 0xFFFFFFFF
_PHI = 0x9E3779B9


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2**32 for a uint32 word ``a`` held in int64 and a uint32
    constant ``c``.  The full product can pass 2**63; multiplying by the two
    16-bit halves of ``c`` keeps every partial product below 2**48, so no
    int64 overflow happens, and the low 32 bits are the uint32 product."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def splitmix32(z: torch.Tensor) -> torch.Tensor:
    """Seed expander (lane decorrelation), uint32 → uint32."""
    z = (z + _PHI) & _MASK
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


def _lanes(seed: int, lanes: int, device) -> torch.Tensor:
    return (torch.arange(lanes, dtype=torch.int64, device=device)
            + int(seed)) & _MASK


def lcg_init(seed: int, lanes: int,
             device: torch.device | str = "cpu") -> torch.Tensor:
    return splitmix32(_lanes(seed, lanes, device))


def lcg_next(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One LCG step per lane; the output mixes the high bits in."""
    new = (_mul32(state, LCG_A) + LCG_C) & _MASK
    return new, (new >> 9) ^ new


def xoshiro128p_init(seed: int, lanes: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    base = _lanes(seed, lanes, device)
    return torch.stack([splitmix32((base + ((k * _PHI) & _MASK)) & _MASK)
                        for k in range(4)])          # (4, lanes)


def xoshiro128p_next(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One xoshiro128+ step per lane (the paper's 8-op integer core)."""
    s0, s1, s2, s3 = state
    out = (s0 + s3) & _MASK
    t = (s1 << 9) & _MASK
    s2 = s2 ^ s0
    s3 = s3 ^ s1
    s1 = s1 ^ s2
    s0 = s0 ^ s3
    s2 = s2 ^ t
    s3 = ((s3 << 11) & _MASK) | (s3 >> 21)
    return torch.stack([s0, s1, s2, s3]), out


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → fp32 in [0, 1) from the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _generator(kind: str):
    if kind == "lcg":
        return lcg_init, lcg_next
    if kind == "xoshiro128p":
        return xoshiro128p_init, xoshiro128p_next
    raise ValueError(f"unknown kind {kind!r}; expected 'lcg' or "
                     f"'xoshiro128p'")


def prng_uniform(kind: str, seed: int, shape: tuple[int, ...],
                 device: torch.device | str = "cuda") -> torch.Tensor:
    """Dense uniform block, one draw per element (lane-parallel)."""
    init, step = _generator(kind)
    _, bits = step(init(seed, math.prod(shape), device))
    return uniform_from_bits(bits).reshape(shape)

# ---------------------------------------------------------------------------
# Monte-Carlo integration (hit and miss)
# ---------------------------------------------------------------------------

#: The polynomial the poly kernels integrate: f(x) = (4x³+3x²+2x+1)/10, so
#: f([0,1]) ⊂ [0,1].  ∫₀¹ f = 0.4.
MC_POLY_COEFFS = (0.4, 0.3, 0.2, 0.1)
MC_POLY_INTEGRAL = 0.4
_MC_POLY_F32 = tuple(float(np.float32(c)) for c in MC_POLY_COEFFS)


def mc_poly_eval(x: torch.Tensor) -> torch.Tensor:
    """Horner, one rounding per multiply and per add."""
    p = torch.full_like(x, _MC_POLY_F32[0])
    for c in _MC_POLY_F32[1:]:
        p = p * x + c
    return p


def mc_hit(problem: str, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The hit test: x² + u² < 1 (pi) or u < f(x) (poly)."""
    if problem == "pi":
        return (x * x + u * u) < 1.0
    if problem == "poly":
        return u < mc_poly_eval(x)
    raise ValueError(f"unknown problem {problem!r}; expected 'pi' or 'poly'")


def _mc_hits(problem: str, kind: str, seed: int, n_samples: int, lanes: int,
             device) -> tuple[torch.Tensor, int]:
    init, step = _generator(kind)
    state = init(seed, lanes, device)
    iters = n_samples // lanes
    acc = torch.zeros(lanes, dtype=torch.float32, device=device)
    for _ in range(iters):
        state, bx = step(state)
        state, bu = step(state)             # two draws per sample
        acc = acc + mc_hit(problem, uniform_from_bits(bx),
                           uniform_from_bits(bu)).to(torch.float32)
    return acc, iters


def mc_pi_ref(kind: str, seed: int, n_samples: int, lanes: int = 1024,
              device: torch.device | str = "cuda") -> torch.Tensor:
    """π/4 hit-and-miss: hit if x² + y² < 1.  Returns the π estimate."""
    acc, iters = _mc_hits("pi", kind, seed, n_samples, lanes, device)
    return 4.0 * torch.sum(acc) / (iters * lanes)


def mc_poly_ref(kind: str, seed: int, n_samples: int, lanes: int = 1024,
                device: torch.device | str = "cuda") -> torch.Tensor:
    """Hit-and-miss integral of the MC polynomial on [0, 1]."""
    acc, iters = _mc_hits("poly", kind, seed, n_samples, lanes, device)
    return torch.sum(acc) / (iters * lanes)

# ---------------------------------------------------------------------------
# exp, log and softmax oracles
# ---------------------------------------------------------------------------


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


def log_ref(x: torch.Tensor) -> torch.Tensor:
    """COPIFT log: INT phase 0 (bit manipulation and the table index) →
    gather → FP phase 1 (r = z·invc − 1, polynomial, + logc + k·ln2).  For
    positive normals; nothing maps the inputs outside that domain."""
    x = x.to(torch.float32)
    # --- INT phase 0.
    ix = x.view(torch.int32)
    tmp = ix - _LOGF_OFF
    i = (tmp >> (23 - _LOGF_TABLE_BITS)) & ((1 << _LOGF_TABLE_BITS) - 1)
    k = tmp >> 23                  # arithmetic shift: the signed exponent
    iz = ix - (tmp & ~0x7FFFFF)              # & 0xff800000 as int32
    z = iz.view(torch.float32)
    # --- gather: invc[i], logc[i] at the integer-computed index.
    invc_t, logc_t = logf_tables(x.device)
    invc, logc = invc_t[i.long()], logc_t[i.long()]
    # --- FP phase 1.
    r = z * invc - 1.0
    p = torch.full_like(r, _LOG1P_POLY[0])
    for c in _LOG1P_POLY[1:]:
        p = p * r + c
    y = (p * r + 1.0) * r                    # ln(1 + r)
    return y + logc + k.to(torch.float32) * _LN2


def softmax_ref(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Numerically stable softmax whose exp is the COPIFT construction.  As
    in the JAX oracle, ``x - max`` is taken in the input dtype."""
    m = torch.amax(x, dim=axis, keepdim=True)
    e = exp_ref((x - m).to(torch.float32))
    return (e / e.sum(dim=axis, keepdim=True)).to(x.dtype)
