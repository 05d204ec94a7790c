"""The plain reference of a decoder-only transformer, in fp32 PyTorch.

It computes what the configuration file states, from the seed-made
weights (``weights.py``), with no kernel, cache or batching of the program:
token embedding; per layer a norm, multi-head attention with rotary
embeddings and a causal mask, a residual, a norm and a SwiGLU feed-forward
or a mixture of experts, a residual; a final norm and the readout.  The
mixture of experts is the configuration's routing: a softmax router, the
top-k experts of each token renormalised over the k, a capacity of
``ceil(S * k / E * capacity_factor)`` slots per expert in a group of S
tokens that keeps the pairs in (token, choice) order and drops the rest,
the shared experts on every token, and the Switch load-balance loss.

Departures from the published models are the configuration's, listed in
its file under ``departures``.  Matrix products go through a
``Precision``: ``"fp32"`` (TF32 off), or the lower precisions a control
computes in, whose operands are rounded to bf16 or to fp8 (e4m3, one
scale per tensor) in the forward and the backward pass.  This module
imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.weights import ParamSpec


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoE:
    n_experts: int
    top_k: int
    n_shared: int
    d_expert: int
    capacity_factor: float
    layer_pattern: str            # "all" | "all_but_first"
    group_tokens: int             # tokens a routing group holds at most


@dataclass(frozen=True)
class Model:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    norm: str                     # "nonparam_ln" | "layernorm" | "rmsnorm"
    norm_eps: float
    act: str                      # "swiglu" | "geglu"
    rope_theta: float
    tie_embeddings: bool
    aux_weight: float
    z_weight: float
    moe: MoE | None = None

    @classmethod
    def from_config(cls, config: dict) -> "Model":
        """The model a configuration file states (its ``model`` and
        ``loss``; the program's settings there are not the reference's)."""
        m = config["model"]
        kw = {k: m[k] for k in cls.__dataclass_fields__ if k in m}
        kw.update(aux_weight=config["loss"]["aux_weight"],
                  z_weight=config["loss"]["z_weight"],
                  moe=MoE(**m["moe"]) if m.get("moe") else None)
        return cls(**kw)

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.d_head

    def is_moe(self, layer: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.layer_pattern == "all":
            return True
        if self.moe.layer_pattern == "all_but_first":
            return layer > 0
        raise ValueError(f"layer pattern {self.moe.layer_pattern!r}")

    def capacity(self, n_tokens: int) -> int:
        e = self.moe
        return int(math.ceil(n_tokens * e.top_k / e.n_experts
                             * e.capacity_factor))


# ---------------------------------------------------------------------------
# parameter names and shapes: the layout the weights are loaded in
# ---------------------------------------------------------------------------

def layer_prefix(m: Model, layer: int) -> str:
    """The name prefix of ``layer``'s parameters: a leading dense layer
    (a mixture whose first layer is dense) is ``stack.prefix.0``, the
    others are ``stack.periods.<i>.sub0``."""
    lead = 1 if (m.moe and m.moe.layer_pattern == "all_but_first") else 0
    if layer < lead:
        return f"stack.prefix.{layer}."
    return f"stack.periods.{layer - lead}.sub0."


def _norm_specs(m: Model, name: str) -> list[ParamSpec]:
    if m.norm == "nonparam_ln":
        return []
    out = [ParamSpec(f"{name}.g", (m.d_model,), "ones")]
    if m.norm == "layernorm":
        out.append(ParamSpec(f"{name}.b", (m.d_model,), "zeros"))
    return out


def _mat(name: str, shape: tuple[int, ...], fan_in: int) -> ParamSpec:
    return ParamSpec(name, shape, "normal", fan_in ** -0.5)


def layer_specs(m: Model, layer: int) -> list[ParamSpec]:
    p = layer_prefix(m, layer)
    d, a, kv = m.d_model, m.attn_dim, m.n_kv_heads * m.d_head
    out = _norm_specs(m, p + "norm1") + _norm_specs(m, p + "norm2")
    out += [_mat(p + "attn.q.w", (d, a), d), _mat(p + "attn.k.w", (d, kv), d),
            _mat(p + "attn.v.w", (d, kv), d), _mat(p + "attn.o.w", (a, d), a)]
    if m.is_moe(layer):
        e = m.moe
        de = e.d_expert
        out.append(_mat(p + "moe.router.w", (d, e.n_experts), d))
        for bank, n in (("experts", e.n_experts), ("shared", e.n_shared)):
            if n:
                out += [_mat(f"{p}moe.{bank}.up", (n, d, de), d),
                        _mat(f"{p}moe.{bank}.down", (n, de, d), de),
                        _mat(f"{p}moe.{bank}.gate", (n, d, de), d)]
    else:
        f = m.d_ff
        out += [_mat(p + "ffn.up.w", (d, f), d), _mat(p + "ffn.down.w", (f, d), f),
                _mat(p + "ffn.gate.w", (d, f), d)]
    return out


def param_specs(m: Model) -> list[ParamSpec]:
    """Every parameter in the order the flat weight buffer holds them."""
    out = [ParamSpec("embed.table", (m.vocab_size, m.d_model), "normal",
                     m.d_model ** -0.5)]
    for layer in range(m.n_layers):
        out += layer_specs(m, layer)
    out += _norm_specs(m, "final_norm")
    if not m.tie_embeddings:
        out.append(_mat("head.w", (m.d_model, m.vocab_size), m.d_model))
    return out


# ---------------------------------------------------------------------------
# precision of the matrix products
# ---------------------------------------------------------------------------

_F8_MAX = 448.0


def _round(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "fp32":
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if kind == "fp8":
        s = x.detach().abs().amax().clamp(min=1e-30) / _F8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    raise ValueError(f"precision {kind!r}")


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` of operands rounded to ``kind``; the backward's products
    round their operands too."""

    @staticmethod
    def forward(ctx, a, b, kind):
        ar, br = _round(a, kind), _round(b, kind)
        ctx.save_for_backward(ar, br)
        ctx.kind = kind
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = _round(g, ctx.kind)
        da = gr @ br.transpose(-1, -2)
        db = ar.transpose(-1, -2) @ gr
        # broadcast batch dimensions of b (a weight) are summed
        while db.ndim > br.ndim:
            db = db.sum(0)
        return da, db, None


@dataclass(frozen=True)
class Precision:
    kind: str = "fp32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return a @ b
        return _RoundedMatmul.apply(a, b, self.kind)


FP32 = Precision("fp32")


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def norm(m: Model, W: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    if m.norm in ("nonparam_ln", "layernorm"):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mu) / torch.sqrt(var + m.norm_eps)
        if m.norm == "layernorm":
            y = y * W[name + ".g"] + W[name + ".b"]
        return y
    if m.norm == "rmsnorm":
        y = x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + m.norm_eps)
        return y * W[name + ".g"]
    raise ValueError(f"norm {m.norm!r}")


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (b, T, H, Dh), rotated pairwise: element i of the first half with
    element i of the second, by angle pos / theta ** (2i / Dh)."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = pos.to(torch.float32)[:, None] * inv[None]           # (T, Dh/2)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(m: Model, W: dict, p: str, x: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """Causal self-attention of x (b, T, D) from position 0."""
    b, T, _ = x.shape
    H, Hkv, Dh = m.n_heads, m.n_kv_heads, m.d_head
    q = prec.mm(x, W[p + "attn.q.w"]).view(b, T, H, Dh)
    k = prec.mm(x, W[p + "attn.k.w"]).view(b, T, Hkv, Dh)
    v = prec.mm(x, W[p + "attn.v.w"]).view(b, T, Hkv, Dh)
    pos = torch.arange(T, device=x.device)
    q, k = rope(q, pos, m.rope_theta), rope(k, pos, m.rope_theta)
    g = H // Hkv                  # query head h reads key head h // g
    q = q.transpose(1, 2)
    k = k.transpose(1, 2).repeat_interleave(g, dim=1)
    v = v.transpose(1, 2).repeat_interleave(g, dim=1)
    s = prec.mm(q, k.transpose(-1, -2)) * Dh ** -0.5          # (b, H, T, T)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = prec.mm(torch.softmax(s, dim=-1), v)                    # (b, H, T, Dh)
    o = o.transpose(1, 2).reshape(b, T, H * Dh)
    return prec.mm(o, W[p + "attn.o.w"])


def _act(m: Model, x: torch.Tensor) -> torch.Tensor:
    if m.act == "swiglu":
        return F.silu(x)
    if m.act == "geglu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"act {m.act!r}")


def ffn(m: Model, up, down, gate, x, prec: Precision) -> torch.Tensor:
    return prec.mm(prec.mm(x, up) * _act(m, prec.mm(x, gate)), down)


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of each row's ``k`` largest probabilities, largest
    first, the lower index first among equals."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]


def moe(m: Model, W: dict, p: str, x: torch.Tensor, prec: Precision,
        per_row: bool, choose=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (b, T, D) → (out, aux).  ``per_row``: each row is a routing group
    and aux is the sum of the rows' losses (the caller divides by the
    batch's rows); else the b·T tokens are one group.  ``choose(probs)``,
    where given, picks the (G, S, k) experts in place of the top-k."""
    b, T, D = x.shape
    e = m.moe
    E, K = e.n_experts, e.top_k
    xg = x if per_row else x.reshape(1, b * T, D)
    G, S, _ = xg.shape
    probs = torch.softmax(prec.mm(xg, W[p + "moe.router.w"]), dim=-1)
    idx = top_k(probs, K) if choose is None else choose(probs)
    vals = probs.gather(-1, idx)
    gate = vals / vals.sum(dim=-1, keepdim=True)
    first = F.one_hot(idx[..., 0], E).to(torch.float32).mean(dim=1)
    aux = E * (probs.mean(dim=1) * first).sum(dim=-1)        # (G,)
    # A pair's slot is the number of earlier pairs of its group, in
    # (token, choice) order, that chose its expert; slots at or beyond the
    # capacity drop.
    flat = idx.reshape(G, S * K)
    seen = torch.cumsum(F.one_hot(flat, E), dim=1)
    rank = seen.gather(2, flat[..., None])[..., 0] - 1
    kept = rank < m.capacity(S)
    del seen
    weight = gate.reshape(G, S * K)
    out = torch.zeros_like(xg)
    up, down, gt = (W[p + "moe.experts." + n] for n in ("up", "down", "gate"))
    for ex in range(E):
        gi, pi = torch.nonzero((flat == ex) & kept, as_tuple=True)
        if gi.numel() == 0:
            continue
        tok = pi // K
        y = ffn(m, up[ex], down[ex], gt[ex], xg[gi, tok], prec)
        out = out.index_put((gi, tok), y * weight[gi, pi, None],
                            accumulate=True)
    if e.n_shared:
        su, sd, sg = (W[p + "moe.shared." + n] for n in ("up", "down", "gate"))
        for j in range(e.n_shared):
            out = out + ffn(m, su[j], sd[j], sg[j], xg, prec)
    return out.reshape(b, T, D), aux.sum()


def block(m: Model, W: dict, layer: int, x: torch.Tensor, prec: Precision,
          per_row: bool, choose=None) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer; returns (x, aux) with aux 0 for a dense layer."""
    p = layer_prefix(m, layer)
    x = x + attention(m, W, p, norm(m, W, p + "norm1", x), prec)
    h = norm(m, W, p + "norm2", x)
    if m.is_moe(layer):
        out, aux = moe(m, W, p, h, prec, per_row, choose)
    else:
        out = ffn(m, W[p + "ffn.up.w"], W[p + "ffn.down.w"],
                  W[p + "ffn.gate.w"], h, prec)
        aux = torch.zeros((), device=x.device)
    return x + out, aux


def logits(m: Model, W: dict, h: torch.Tensor, prec: Precision):
    """Logits of final hidden states h (..., D)."""
    h = norm(m, W, "final_norm", h)
    if m.tie_embeddings:
        return prec.mm(h, W["embed.table"].T)
    return prec.mm(h, W["head.w"])


def per_row_groups(m: Model, batch: int, seq: int) -> bool:
    """Whether a (batch, seq) input of more than one token a row routes
    each row as its own group: when it holds more tokens than a group."""
    return m.moe is not None and batch * seq > m.moe.group_tokens


# ---------------------------------------------------------------------------
# serving: logits of given positions, layer by layer
# ---------------------------------------------------------------------------

class Routes:
    """The experts of each mixture layer, (R, T, k) a layer, for R
    sequences: ``follow`` (given) makes ``serve_logits`` use them in place
    of its own top-k and records ``gaps``, by how far (in log-probability)
    each followed choice lies below its own k-th; ``made`` records the
    choices a run made."""

    def __init__(self, follow: dict | None = None):
        self.follow = follow
        self.made: dict[int, list] = {}
        self.gaps: list[float] = []

    def chooser(self, m: Model, layer: int, lo: int, hi: int):
        k = m.moe.top_k

        def choose(probs):
            own = top_k(probs, k)
            idx = own
            if self.follow is not None:
                idx = self.follow[layer][lo:hi].to(probs.device).long()
                kth = probs.gather(-1, own[..., -1:])[..., 0]
                low = probs.gather(-1, idx).min(dim=-1).values
                self.gaps.append(float((torch.log(kth) - torch.log(low))
                                       .clamp(min=0).max()))
            self.made.setdefault(layer, []).append(idx.to(torch.uint8))
            return idx
        return choose


@torch.no_grad()
def serve_logits(m: Model, redraw, tokens: torch.Tensor, positions,
                 prec: Precision = FP32, rows_at_once: int = 1,
                 routes: Routes | None = None):
    """The logits (R, len(positions), V) at ``positions`` of R sequences
    ``tokens`` (R, T), each its own request from position 0.  The weights
    come one layer at a time from ``redraw(name)`` (as served), cast to
    fp32; each layer runs ``rows_at_once`` sequences at a time.  Each
    sequence is one routing group, as a prefill of more tokens than a
    group routes each row; ``routes`` records, or gives, the experts."""
    dev = tokens.device
    specs = param_specs(m)

    def fetch(names):
        return {n: redraw(n).to(torch.float32) for n in names}

    table = fetch(["embed.table"])["embed.table"]
    x = table[tokens]                                          # (R, T, D)
    del table
    for layer in range(m.n_layers):
        W = fetch([s.name for s in layer_specs(m, layer)])
        for lo in range(0, x.shape[0], rows_at_once):
            hi = lo + rows_at_once
            choose = (routes.chooser(m, layer, lo, hi)
                      if routes is not None and m.is_moe(layer) else None)
            x[lo:hi] = block(m, W, layer, x[lo:hi], prec, per_row=True,
                             choose=choose)[0]
        del W
    pos = torch.as_tensor(positions, device=dev)
    h = x[:, pos]
    last = [s.name for s in specs
            if s.name.startswith("final_norm") or s.name == "head.w"]
    W = fetch(last + (["embed.table"] if m.tie_embeddings else []))
    return logits(m, W, h, prec)


# ---------------------------------------------------------------------------
# training: loss, gradients and AdamW
# ---------------------------------------------------------------------------

def loss_terms(m: Model, W: dict, tokens: torch.Tensor, prec: Precision,
               per_row: bool, remat: bool = True):
    """(Σ nll, Σ logz², Σ aux) of a block of rows ``tokens`` (b, T): the
    next-token cross-entropy over T − 1 positions a row, the z-loss's
    squares and the layers' aux losses (summed over rows when each row is
    a group)."""
    x = W["embed.table"][tokens]
    aux = torch.zeros((), device=tokens.device)
    for layer in range(m.n_layers):
        def run(x, layer=layer):
            return block(m, W, layer, x, prec, per_row)
        x, a = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        aux = aux + a
    z = logits(m, W, x[:, :-1], prec)
    logz = torch.logsumexp(z, dim=-1)
    ll = z.gather(-1, tokens[:, 1:, None])[..., 0]
    return (logz - ll).sum(), (logz * logz).sum(), aux


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up, then a cosine to ``min_lr_ratio`` of the rate."""
    lr, warm = opt["lr"], opt["warmup_steps"]
    if step < warm:
        return lr * step / max(1, warm)
    t = min(1.0, max(0.0, (step - warm) / max(1, opt["total_steps"] - warm)))
    r = opt["min_lr_ratio"]
    return lr * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * t)))


def train(m: Model, params: dict, batches: list[torch.Tensor], opt: dict,
          start_of, prec: Precision = FP32, rows_at_once: int = 1) -> dict:
    """AdamW steps on ``params`` (name → fp32 tensor, updated in place),
    one a batch; ``start_of(name)`` gives a parameter's first value again.
    Returns ``loss`` (a float a step), ``grad`` (each parameter's norm of
    the first step's clipped gradient) and ``change`` (each parameter's
    norm of its change over all the steps)."""
    names = list(params)
    mom = {n: torch.zeros_like(params[n]) for n in names}
    var = {n: torch.zeros_like(params[n]) for n in names}
    decay = {n: params[n].ndim >= 2 for n in names}
    losses, first_grad = [], None
    for step, tokens in enumerate(batches, start=1):
        B, T = tokens.shape
        per_row = per_row_groups(m, B, T)
        n_tok = B * (T - 1)
        W = {n: params[n].detach().requires_grad_(True) for n in names}
        blocks = range(0, B, rows_at_once) if per_row or m.moe is None \
            else [0]
        width = rows_at_once if per_row or m.moe is None else B
        total = 0.0
        for lo in blocks:
            nll, zsq, aux = loss_terms(m, W, tokens[lo:lo + width], prec,
                                       per_row)
            aux = aux / B if per_row else aux
            part = nll / n_tok + m.z_weight * zsq / n_tok \
                + m.aux_weight * aux
            part.backward()
            total += float(part.detach())
        losses.append(total)
        with torch.no_grad():
            grads = {n: W[n].grad for n in names}
            gn = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
            scale = min(1.0, opt["grad_clip"] / (gn + 1e-9))
            lr = lr_at(opt, step)
            b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            if first_grad is None:
                first_grad = {n: float(grads[n].norm()) * scale
                              for n in names}
            for n in names:
                g = grads[n] * scale
                mom[n].mul_(b1).add_(g, alpha=1 - b1)
                var[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mom[n] / bc1) / (torch.sqrt(var[n] / bc2) + eps)
                if decay[n]:
                    upd = upd + opt["weight_decay"] * params[n]
                params[n].sub_(lr * upd)
        del W, grads
    change = {n: float((params[n] - start_of(n).to(params[n].dtype)).norm())
              for n in names}
    return {"loss": losses, "grad": first_grad, "change": change}
