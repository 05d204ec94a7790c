"""The numbers that decide ``correct``, and the verdict.

Serving: the widest gap by which the served token's logit lies below the
reference's best logit at the same position (scores with the call's own
Gumbel noise for sampled traffic), or the widest relative distance of the
logits the program returned from the reference's.  Training: the widest relative
gap of the three steps' losses, and by the worst parameter the gap
between the program's and the reference's norms of the first step's
clipped gradient and of the change over the steps, relative to the
reference's norm of that parameter or the median parameter's, whichever
is larger.  Parameters whose first gradient the reference finds under a
thousandth of the median parameter's move by round-off alone and are left
out of the change.
"""

from __future__ import annotations

import math
import statistics

import torch


def served_gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> float:
    """max over positions of best − logit of ``chosen``; ref_logits (N, V)
    fp32, chosen (N,) token ids."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, chosen.long()[:, None])[:, 0]
    return float((best - got).max())


def logit_error(logits: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """max over positions of |logits − reference| / |reference| (the
    2-norms of each position's vector)."""
    diff = (logits.float() - ref_logits).norm(dim=-1)
    return float((diff / ref_logits.norm(dim=-1)).max())


def loss_gap(program: list[float], reference: list[float]) -> float:
    if len(program) < len(reference) or not all(map(math.isfinite, program)):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def leaf_gap(program: dict[str, float], reference: dict[str, float],
             leave_out: frozenset = frozenset()) -> float:
    """The worst parameter's relative gap."""
    if set(program) != set(reference):
        return math.inf
    names = [n for n in reference if n not in leave_out]
    floor = statistics.median(reference[n] for n in names)
    return max(abs(program[n] - reference[n]) / max(reference[n], floor)
               if math.isfinite(program[n]) else math.inf for n in names)


def still_leaves(first_grad: dict[str, float]) -> frozenset:
    """Parameters the reference's first gradient leaves all but still."""
    med = statistics.median(first_grad.values())
    return frozenset(n for n, g in first_grad.items() if g < 1e-3 * med)


def train_numbers(program: dict, reference: dict) -> dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of a training run;
    each side a dict of ``loss`` (list), ``grad`` and ``change`` (by
    parameter)."""
    still = still_leaves(reference["grad"])
    return {
        "loss_gap": loss_gap(program["loss"], reference["loss"]),
        "grad_gap": leaf_gap(program["grad"], reference["grad"]),
        "change_gap": leaf_gap(program["change"], reference["change"],
                               still),
    }


def verdict(numbers: dict[str, float], limits: dict[str, float]):
    """(correct, lines): each number at or under its limit; a number that
    is missing or not finite fails."""
    ok, lines = True, []
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        good = math.isfinite(v) and v <= limit
        ok &= good
        lines.append(f"check {name} {v!r} limit {limit!r} "
                     f"{'ok' if good else 'FAIL'}")
    return ok, lines
