"""State-space sequence mixers, as the JAX package's ``repro.models.ssm``:
RWKV-6 ("Finch", data-dependent decay) and Mamba (Jamba's mixer).

Both are recurrences over time, run step by step in a Python loop.  Above
``CHUNK`` steps the time axis is cut into chunks of ``CHUNK``; under
autograd each chunk runs in ``torch.utils.checkpoint``, as the JAX
package's ``jax.checkpoint``-ed chunk body, so that training keeps only the
states at chunk boundaries and recomputes the steps in the backward pass.

The elementwise inputs of a step (casts, Mamba's ``exp(Δ·A)`` and
``Δ·B·x``) are computed for a whole chunk before its loop: the same values
as the JAX package's cell computes step by step, with fewer launches.

Decode runs the same recurrence for one step and carries the states in the
cache: ``conv`` and ``h`` for Mamba, ``x_prev``, ``S`` and ``cm_prev`` for
RWKV-6.  The SSMs' exps are ``torch.exp``, as the JAX package's are
``jnp.exp``: the COPIFT kernels run where the JAX package calls them.
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import autoshard

CHUNK = 128


def _chunked_scan(chunk_fn, state, xs, chunk: int = CHUNK):
    """``chunk_fn(state, xs_c) -> (state, ys_c)`` over the time axis (dim 1)
    of the tensors ``xs``, in chunks of ``chunk`` steps when there are more;
    returns (state, ys) with ys concatenated on dim 1."""
    T = xs[0].shape[1]
    if T <= chunk:
        return chunk_fn(state, xs)
    if T % chunk:
        raise ValueError(f"scan of {T} steps: more than one chunk of {chunk} "
                         "must be a whole number of chunks")
    remat = torch.is_grad_enabled()
    ys = []
    for lo in range(0, T, chunk):
        xc = tuple(a[:, lo:lo + chunk] for a in xs)
        if remat:
            state, y = checkpoint(chunk_fn, state, xc, use_reentrant=False)
        else:
            state, y = chunk_fn(state, xc)
        ys.append(y)
    return state, torch.cat(ys, dim=1)


def _scan(make_chunk, consts, state, xs, x_chans):
    """``_chunked_scan(make_chunk(*consts), state, xs)``.  ``consts`` are
    (channels, ...) tensors, the state is (B, channels, ...), each of
    ``xs`` is (B, t, ...) with its channel dimension at ``x_chans`` (None
    for none) and the ys come back as (B, t, channels, ...).

    On DTensors it runs on each rank's shards in a known layout: the batch
    and channel shards of ``xs[0]`` (heads for RWKV-6, ``di`` for Mamba),
    every other dimension whole.  The recurrence is independent across
    rows and channels, so each rank's steps are the unsharded steps of its
    slice; run as DTensor ops, each of the T steps would cost a sharding
    decision."""
    ref = xs[0]
    if not isinstance(ref, DTensor):
        return _chunked_scan(make_chunk(*consts), state, xs)
    mesh = ref.device_mesh
    kinds = ["b" if p.is_shard() and p.dim == 0 else
             "c" if p.is_shard() and p.dim == x_chans[0] else None
             for p in ref.placements]

    def placements(b, c):
        return [Shard(b) if k == "b" and b is not None else
                Shard(c) if k == "c" and c is not None else Replicate()
                for k in kinds]

    def local(t, b, c):
        t, pl = L.replicated_like(t, ref), placements(b, c)
        if list(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        # A tensor whole where the steps are split (a decay over the
        # rows, B and C over the channels) takes a share of its gradient.
        return t.to_local(grad_placements=[
            Partial() if k is not None and p == Replicate() else p
            for k, p in zip(kinds, pl)])

    state, ys = _chunked_scan(
        make_chunk(*(local(t, None, 0) for t in consts)), local(state, 0, 1),
        tuple(local(t, 0, c) for t, c in zip(xs, x_chans)))
    return (DTensor.from_local(state, mesh, placements(0, 1),
                               run_check=False),
            DTensor.from_local(ys, mesh, placements(0, 2), run_check=False))


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_prev, then x without its last step."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


class _Vec(nn.Module):
    """A named set of (d,)-vectors, each filled with a constant."""

    def __init__(self, d: int, device, **fills: float):
        super().__init__()
        self._fills = fills
        for name in fills:
            setattr(self, name, L._param((d,), torch.float32, device))

    def init_(self, generator: torch.Generator | None = None) -> None:
        for name, value in self._fills.items():
            getattr(self, name).data.fill_(value)


# ===========================================================================
# RWKV-6 time mix
# ===========================================================================

class LoRA(nn.Module):
    def __init__(self, d: int, rank: int, dtype, device):
        super().__init__()
        self.a = L.Linear(d, rank, dtype, device)
        self.b = L.Linear(rank, d, dtype, device, scale=rank ** -0.5)


class RWKV6(_Vec):
    """Token-shift mixes ``mu_*``, decay bias ``w0``, bonus ``u`` (H, hs),
    the decay's LoRA ``lora_w``, projections ``r k v g o`` and ``ln_x``."""

    def __init__(self, cfg: ModelConfig, device):
        d = cfg.d_model
        super().__init__(d, device, mu_x=0.0, mu_w=0.0, mu_k=0.0, mu_v=0.0,
                         mu_r=0.0, mu_g=0.0, w0=-6.0)
        dt = getattr(torch, cfg.dtype)
        hs = cfg.ssm.head_dim
        self.u = L._param((d // hs, hs), dt, device)
        self.lora_w = LoRA(d, 64, dt, device)
        for name in "rkvg":
            setattr(self, name, L.Linear(d, d, dt, device))
        self.o = L.Linear(d, d, dt, device, scale=d ** -0.5)
        self.ln_x = L.Norm("layernorm", d, device)

    def init_(self, generator: torch.Generator) -> None:
        super().init_()
        with torch.no_grad():
            u = torch.randn(self.u.shape, generator=generator,
                            device=self.u.device)
            self.u.copy_(u * 0.1)


def _rwkv6_chunk(u):
    """The WKV recurrence over one chunk: S ← w·S + kᵀv, y = r·(S + u·kᵀv).

    The step's operands are laid out for the whole chunk first, one
    (B·H, ...) slice a step: kᵀv and u·kᵀv are elementwise in the step, so
    computing them for all steps gives the same values with a few
    launches; a step is then two adds, a multiply and one batched
    product."""

    def run(S, xs):
        r, k, v, w = xs                                     # (B,t,H,hs) fp32
        B, t, H, hs = r.shape

        def steps(a, shape):                      # (t, B·H, *shape)
            return a.transpose(0, 1).reshape(t, B * H, *shape)

        kv = steps(k, (hs, 1)) * steps(v, (1, hs))          # (t,BH,hs,hs)
        ukv = u.repeat(B, 1)[None, :, :, None] * kv
        S = S.reshape(B * H, hs, hs)
        ys = []
        for r_t, w_t, kv_t, ukv_t in zip(steps(r, (1, hs)).unbind(0),
                                          steps(w, (hs, 1)).unbind(0),
                                          kv.unbind(0), ukv.unbind(0)):
            # Σ_k r_k (S + u·kv)_kv, as a (1, hs) @ (hs, hs) product a head.
            ys.append(torch.bmm(r_t, S + ukv_t))
            S = w_t * S + kv_t
        y = torch.stack(ys).reshape(t, B, H, hs).transpose(0, 1)
        return S.reshape(B, H, hs, hs), y

    return run


def rwkv6_mix(p: RWKV6, cfg: ModelConfig, x, state=None):
    """x: (B, T, D) → (out, state).  state = (x_prev (B,D), S (B,H,hs,hs))."""
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    B, T, D = x.shape
    hs = cfg.ssm.head_dim
    H = D // hs
    if state is None:
        x_prev = L.sharded_like(torch.zeros((B, D), dtype=dt,
                                            device=x.device), x, dims=(0, 2))
    else:
        x_prev, S0 = state

    xx = _shift(x, x_prev)
    dx = xx - x

    def mixed(name):
        return x + dx * getattr(p, f"mu_{name}").to(dt)

    xw, xk, xv, xr, xg = (mixed(n) for n in "wkvrg")

    # Data-dependent decay (the Finch contribution): per-token, per-channel.
    lw = torch.tanh(L.linear(p.lora_w.a, xw, dt))
    w_log = p.w0.to(f32) + L.linear(p.lora_w.b, lw, dt).to(f32)
    w = torch.exp(-torch.exp(w_log))                         # (B,T,D) in (0,1)

    r = L.linear(p.r, xr, dt).reshape(B, T, H, hs)
    k = L.linear(p.k, xk, dt).reshape(B, T, H, hs)
    v = L.linear(p.v, xv, dt).reshape(B, T, H, hs)
    g = F.silu(L.linear(p.g, xg, dt))
    u = p.u.to(f32)
    if state is None:
        S0 = L.sharded_like(torch.zeros((B, H, hs, hs), dtype=f32,
                                        device=x.device), r,
                            dims=(0, 2, None, None))

    xs = (r.to(f32), k.to(f32), v.to(f32), w.reshape(B, T, H, hs))
    S, ys = _scan(_rwkv6_chunk, (u,), S0, xs, (2, 2, 2, 2))
    y = ys.reshape(B, T, D).to(dt)
    y = L.norm("layernorm", p.ln_x, y)     # a layernorm over all of D
    out = L.linear(p.o, y * g, dt)
    return out, (x[:, -1].to(dt), S)


class RWKV6ChannelMix(_Vec):
    def __init__(self, cfg: ModelConfig, device):
        d, dff = cfg.d_model, cfg.d_ff
        super().__init__(d, device, mu_k=0.0, mu_r=0.0)
        dt = getattr(torch, cfg.dtype)
        self.k = L.Linear(d, dff, dt, device)
        self.v = L.Linear(dff, d, dt, device, scale=dff ** -0.5)
        self.r = L.Linear(d, d, dt, device)


def rwkv6_channel_mix(p: RWKV6ChannelMix, cfg: ModelConfig, x, x_prev=None):
    """RWKV FFN ('channel mix'): squared relu with a receptance gate.
    Returns (out, the last step of x)."""
    dt = getattr(torch, cfg.dtype)
    B, T, D = x.shape
    if x_prev is None:
        x_prev = L.sharded_like(torch.zeros((B, D), dtype=dt,
                                            device=x.device), x, dims=(0, 2))
    dx = _shift(x, x_prev) - x
    xk = x + dx * p.mu_k.to(dt)
    xr = x + dx * p.mu_r.to(dt)
    k = torch.square(torch.relu(L.linear(p.k, xk, dt)))
    kv = L.linear(p.v, k, dt)
    return torch.sigmoid(L.linear(p.r, xr, dt)) * kv, x[:, -1].to(dt)


# ===========================================================================
# Mamba (selective SSM) — Jamba's mixer
# ===========================================================================

class DtProj(nn.Module):
    """Δ's projection: ``w`` (dt_rank, di) a plain normal × dt_rank^-½,
    ``b`` softplus⁻¹(0.01) = -4.6."""

    def __init__(self, dtr: int, di: int, dtype, device):
        super().__init__()
        self.w = L._param((dtr, di), dtype, device)
        self.b = L._param((di,), torch.float32, device)

    def init_(self, generator: torch.Generator) -> None:
        _normal_(self.w, self.w.shape[0] ** -0.5, generator)
        self.b.data.fill_(-4.6)


@torch.no_grad()
def _normal_(p: torch.Tensor, scale: float, generator) -> None:
    p.copy_(torch.randn(p.shape, generator=generator, device=p.device)
            * scale)


def _dims(cfg: ModelConfig) -> tuple[int, int]:
    """(di, dt_rank) of the Mamba mixer."""
    s = cfg.ssm
    return s.expand * cfg.d_model, s.dt_rank or max(1, cfg.d_model // 16)


class Mamba(_Vec):
    def __init__(self, cfg: ModelConfig, device):
        s = cfg.ssm
        d = cfg.d_model
        di, dtr = _dims(cfg)
        super().__init__(di, device, conv_b=0.0, D=1.0)
        dt = getattr(torch, cfg.dtype)
        self.in_proj = L.Linear(d, 2 * di, dt, device)
        self.conv_w = L._param((s.d_conv, di), dt, device)
        self.x_proj = L.Linear(di, dtr + 2 * s.d_state, dt, device)
        self.dt_proj = DtProj(dtr, di, dt, device)
        self.A_log = L._param((di, s.d_state), dt, device)
        self.out_proj = L.Linear(di, d, dt, device, scale=di ** -0.5)

    def init_(self, generator: torch.Generator) -> None:
        super().init_()
        K, di = self.conv_w.shape
        _normal_(self.conv_w, (K * di) ** -0.5, generator)
        ds = self.A_log.shape[1]
        A = torch.arange(1, ds + 1, dtype=torch.float32,
                         device=self.A_log.device).repeat(di, 1)
        self.A_log.data.copy_(torch.log(A))


def _mamba_chunk(A):
    """The selective scan over one chunk: h ← exp(Δ·A)·h + Δ·B·x,
    y = h·C; a step is a multiply, an add and one batched product."""

    def run(h, xs):
        xc, delta, Bm, Cm = xs          # (B,t,di) dt, (B,t,di) fp32, (B,t,ds)
        f32 = torch.float32
        dA = torch.exp(delta[..., None] * A)                    # (B,t,di,ds)
        dBx = delta[..., None] * Bm.to(f32)[:, :, None, :] \
            * xc.to(f32)[..., None]
        ys = []
        for dA_t, dBx_t, C_t in zip(dA.unbind(1), dBx.unbind(1),
                                    Cm.to(f32)[..., None].unbind(1)):
            h = dA_t * h + dBx_t
            ys.append(torch.bmm(h, C_t))                    # Σ_s h_ds C_s
        return h, torch.stack(ys, dim=1)[..., 0]

    return run


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)) for every x (``F.softplus`` returns x above 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _halves(w: DTensor) -> DTensor:
    """The fused input projection's (D, 2·di) weight as (D, 2, di), x's
    columns and z's, each half's di sharded over the mesh axis that
    shards ``w``'s columns.  On n ranks of that axis rank r holds the
    fused column blocks 2r and 2r + 1 of di/n columns (x's on the first
    half of the ranks, z's on the second) and needs block r of x and of z:
    one all-to-all of weight blocks takes each where it is needed, and its
    backward takes the gradient back."""
    axes = [i for i, q in enumerate(w.placements)
            if q.is_shard() and q.dim == 1]
    if not axes:
        return w.unflatten(1, (2, -1))
    (i,) = axes
    mesh = w.device_mesh
    n, r = mesh.size(i), mesh.get_local_rank(i)
    if n > 1 and (n % 2 or w.shape[1] // 2 % n):
        raise ValueError(f"in_proj's {w.shape[1]} columns over {n} ranks: "
                         "each half's must divide over an even count")
    local = w.to_local()
    rows, c = local.shape[0], local.shape[1] // 2
    send, recv = [0] * n, [0] * n
    for to in (2 * r % n, (2 * r + 1) % n):
        send[to] += rows
    for frm in (r // 2, (n + r) // 2):                  # x's block, z's
        recv[frm] += rows
    blocks = funcol.all_to_all_single_autograd(
        local.unflatten(1, (2, c)).transpose(0, 1).reshape(2 * rows, c),
        recv, send, mesh.get_group(i))
    D, di = w.shape[0], w.shape[1] // 2
    return DTensor.from_local(
        blocks.reshape(2, rows, c).transpose(0, 1), mesh,
        [Shard(2) if j == i else q for j, q in enumerate(w.placements)],
        run_check=False, shape=(D, 2, di), stride=(2 * di, di, 1))


def _in_proj(p: L.Linear, x, dt):
    """The fused input projection's two halves, x and z ((B, T, di) each).

    On DTensors each half is a product of its own, over the weight's
    columns of that half (``_halves``).  The rule table shards the
    (D, 2·di) weight's columns: split after one product, the first half
    of an axis's ranks would hold all of x and the second all of z, and
    the whole (B, T, 2·di) product would be gathered on every rank.  Here
    only the weight moves, and each rank's share of x and of z is
    computed where it stays."""
    if not isinstance(x, DTensor):
        return L.linear(p, x, dt).chunk(2, dim=-1)
    wx, wz = _halves(p.w.to(dt)).unbind(1)
    x = L.reduced(x).to(dt)
    return x @ wx, x @ wz


def mamba_mix(p: Mamba, cfg: ModelConfig, x, state=None):
    """x: (B, T, D) → (out, state).  state = (conv (B,K-1,di), h (B,di,ds))."""
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    s = cfg.ssm
    B, T, D = x.shape
    di, dtr = _dims(cfg)
    K = s.d_conv

    xin, z = _in_proj(p.in_proj, x, dt)                     # (B,T,di) each
    if state is None:
        conv_state = L.sharded_like(torch.zeros((B, K - 1, di), dtype=dt,
                                                device=x.device), xin,
                                    dims=(0, None, 2))
        h0 = L.sharded_like(torch.zeros((B, di, s.d_state), dtype=f32,
                                        device=x.device), xin,
                            dims=(0, 2, None))
    else:
        conv_state, h0 = state

    # Causal depthwise conv via shifted adds (kernel K small), summed from
    # i = 0 in the compute dtype.
    xpad = torch.cat([conv_state, xin], dim=1)              # (B, T+K-1, di)
    conv = sum(xpad[:, i:i + T] * p.conv_w[i].to(dt) for i in range(K))
    xc = F.silu(conv + p.conv_b.to(dt))

    # x_proj's partial sums (its di sharded) are reduced, and so is their
    # gradient (Δ's product and the scan's B and C give partial sums,
    # which x_proj's backward would multiply whole on every rank); dt_proj's
    # rank dimension is gathered where FSDP shards it: torch 2.11 resolves
    # a contraction sharded on "data" beside batch shards by a Shard to
    # Partial redistribution it does not have.
    proj = autoshard.grad_placed(L.reduced(L.linear(p.x_proj, xc, dt)))
    dt_in, Bmat, Cmat = proj.split([dtr, s.d_state, s.d_state], dim=-1)
    delta = softplus(dt_in.to(f32) @ L.whole(p.dt_proj.w.to(f32), 0)
                     + p.dt_proj.b.to(f32))                 # (B,T,di)
    A = -torch.exp(p.A_log)                                 # (di, ds)

    h, ys = _scan(_mamba_chunk, (A,), h0, (xc, delta, Bmat, Cmat),
                  (2, 2, None, None))
    y = ys.to(dt) + xc * p.D.to(dt)
    # The product's gradient keeps x and z's channel shards: left to
    # DTensor it comes back with its rows sharded over their axis, and
    # every elementwise step of the backward moves (B, T, di) tensors
    # between their dimensions.
    out = L.linear(p.out_proj, autoshard.grad_placed(y * F.silu(z)), dt)
    new_conv = xpad[:, -(K - 1):] if K > 1 else conv_state
    return out, (new_conv, h)
