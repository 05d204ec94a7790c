"""Attention: MHA / GQA / MQA with RoPE / M-RoPE, qk-norm, causal and
sliding-window masks, KV-cache decode.  The softmax of a materialised score
matrix goes through the COPIFT softmax kernel and the exp of the chunked
(online-softmax) path through the COPIFT exp kernel
(``repro_torch.kernels.ops``) when ``cfg.use_copift_softmax`` is set.  A
decode step (one query a row over a KV cache, plain tensors) runs its two
products through the decode-attention kernels (``ops.decode_scores``,
``ops.decode_pv``), which read the cache in place at the slots the mask
keeps.

Layout as in the JAX package: q (B, T, H, Dh); kv (B, S, Hkv, Dh); GQA
repeats kv groups at use.  On DTensors (the sharded step) the two products
run on each rank's shards, batch and KV heads (``_Heads``), and the
chunked path's scores take the JAX package's sharding constraint
(``parallel.autoshard.scores``).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.decode_attn import NEG_INF
from repro_torch.models import layers as L
from repro_torch.obs import card
from repro_torch.parallel import autoshard


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        d, a = cfg.d_model, cfg.attn_dim
        kv_dim = cfg.n_kv_heads * cfg.d_head
        self.q = L.Linear(d, a, dt, device)
        self.k = L.Linear(d, kv_dim, dt, device)
        self.v = L.Linear(d, kv_dim, dt, device)
        self.o = L.Linear(a, d, dt, device, scale=a ** -0.5)
        if cfg.qk_norm:
            self.q_norm = L.Norm("rmsnorm", cfg.d_head, device)
            self.k_norm = L.Norm("rmsnorm", cfg.d_head, device)


def _rotate(cfg: ModelConfig, x, positions):
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        return L.apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    if positions.ndim == 3:                   # (3, B, T) given, 1-D wanted
        positions = positions[0]
    return L.apply_rope(x, positions, cfg.rope_theta)


def _softmax(cfg: ModelConfig, scores):
    if cfg.use_copift_softmax:
        return kops.softmax(scores, axis=-1, impl=cfg.softmax_impl)
    return torch.softmax(scores, dim=-1)


def _mask_bias(cfg: ModelConfig, q_len: int, kv_len: int, q_offset: int,
               dtype, device) -> torch.Tensor:
    """(q_len, kv_len) additive mask.  q_offset positions the query block
    inside the kv timeline (decode: q_offset = cache position)."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    keep = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if cfg.causal:
        keep &= k_pos <= q_pos
    if cfg.sliding_window:
        keep &= k_pos > q_pos - cfg.sliding_window
    return torch.where(keep, 0.0, NEG_INF).to(dtype)


#: switch to the chunked (online-softmax) path above this many score elems.
CHUNKED_THRESHOLD = 1 << 23
KV_CHUNK = 1024
Q_BLOCK = 1024


def _exp(cfg: ModelConfig, x):
    if cfg.use_copift_softmax:
        return kops.exp(x, impl=cfg.softmax_impl)   # the COPIFT construction
    return torch.exp(x)


def _chunk_keep(cfg: ModelConfig, q_pos, k_pos, valid_limit=None):
    keep = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if cfg.causal:
        keep &= k_pos[None, :] <= q_pos[:, None]
    if cfg.sliding_window:
        keep &= k_pos[None, :] > q_pos[:, None] - cfg.sliding_window
    if valid_limit is not None:     # cache: slots beyond the write are junk
        keep &= k_pos[None, :] < valid_limit
    return keep


class _Heads:
    """The layout of attention's two products on DTensors: a grouped query
    (B, T, Hkv, g, Dh) and keys and values (B, S, Hkv, Dh).  The batch
    shards of either are kept ("b"); the "model" axis shards the head
    dimension Dh where the keys have it so (the rule table's decode cache:
    the scores then hold partial sums, "d"), else the KV heads where they
    divide by it ("h"); every other mesh dimension is replicated.
    ``contract`` runs an einsum on each rank's shards in that layout: the
    layout is known, and DTensor's search for a batched product's sharding
    over a 3-D mesh takes minutes."""

    PARTIAL = "partial"
    QG = {"b": 0, "h": 2, "d": 4}                 # (B, T, Hkv, g, Dh)
    KV = {"b": 0, "h": 2, "d": 3}                 # (B, S, Hkv, Dh)
    SCORES = {"b": 0, "h": 1, "d": PARTIAL}       # (B, Hkv, g, T, S), made
    PROBS = {"b": 0, "h": 1}                      # ... and read

    def __init__(self, qg: DTensor, k: DTensor):
        self.mesh = mesh = qg.device_mesh
        names = mesh.mesh_dim_names or ()
        self.axes = []
        for i, p in enumerate(qg.placements):
            # The batch shards of the query or of the keys (a decode cache
            # placed by the rule table, where torch 2.11 gives a query
            # whose batch is replicated: the cache would be gathered).
            if p.is_shard() and p.dim == 0 or (k.placements[i].is_shard()
                                               and k.placements[i].dim == 0):
                self.axes.append("b")
            elif i < len(names) and names[i] == "model":
                kp = k.placements[i]
                self.axes.append(
                    "d" if kp.is_shard() and kp.dim == 3 else
                    "h" if qg.shape[2] % mesh.size(i) == 0 else None)
            else:
                self.axes.append(None)

    def placements(self, dims: dict) -> list:
        out = []
        for a in self.axes:
            d = dims.get(a)
            out.append(Replicate() if d is None else
                       Partial() if d == self.PARTIAL else Shard(d))
        return out

    def place(self, x: DTensor, dims: dict) -> DTensor:
        pl = self.placements(dims)
        return x if list(x.placements) == pl else \
            x.redistribute(self.mesh, pl)

    def contract(self, eq: str, a, a_dims, b, b_dims, out_dims):
        y = torch.einsum(eq, self.place(a, a_dims).to_local(),
                         self.place(b, b_dims).to_local())
        return DTensor.from_local(y, self.mesh, self.placements(out_dims),
                                  run_check=False)


def _einsum(heads: _Heads | None, eq: str, a, a_dims, b, b_dims, out_dims):
    """``torch.einsum(eq, a, b)``; on DTensors in the ``heads`` layout."""
    if heads is None:
        return torch.einsum(eq, a, b)
    return heads.contract(eq, a, a_dims, b, b_dims, out_dims)


def _merge_heads(heads: _Heads | None, out):
    """(B, T, Hkv, g, Dh) → (B, T, H·Dh).  On DTensors the batch and KV-head
    shards are kept, Dh made whole, and the reshape runs on the local
    shard: DTensor cannot split a sharded H·Dh into (Hkv, g, Dh) when Hkv
    does not divide by the shards, which the reshape's backward asks."""
    B, T = out.shape[:2]
    if heads is None:
        return out.reshape(B, T, -1)
    out = heads.place(out, {"b": 0, "h": 2})
    local = out.to_local()
    n = math.prod(out.shape[2:])
    return DTensor.from_local(local.reshape(*local.shape[:2], -1),
                              heads.mesh, out.placements, run_check=False,
                              shape=(B, T, n), stride=(T * n, n, 1))


def _chunked_attention(cfg: ModelConfig, q, k, v, q_offset: int,
                       valid_limit=None):
    """FlashAttention-style two-level blocking: the (T, S) score matrix is
    never materialised.  The outer loop tiles queries; the inner loop
    streams KV chunks with a running (m, l, acc).  Each query block visits
    only the static range of KV chunks that its causal / sliding-window
    mask can reach.

    q: (B,T,Hkv,g,Dh) grouped; k/v: (B,S,Hkv,Dh).  Returns (B,T,Hkv,g,Dh)
    in fp32.
    """
    B, T, Hkv, g, Dh = q.shape
    S = k.shape[1]
    C = min(KV_CHUNK, S)
    n_chunks = S // C
    scale = Dh ** -0.5
    Tq = min(Q_BLOCK, T)
    if T % Tq:
        raise ValueError(f"T={T} is not a multiple of the query block {Tq}")
    nq = T // Tq
    dev = q.device
    heads = _Heads(q, k) if isinstance(q, DTensor) else None

    def q_block(qb, qb_pos, lo, hi):
        """qb: (B,Tq,Hkv,g,Dh); qb_pos: (Tq,) absolute positions; [lo, hi):
        the kv-chunk range this block attends."""
        qf = qb.to(torch.float32)
        if heads is not None:
            qf = heads.place(qf, _Heads.QG)
        # The running (m, l, acc), made like the query block so that a
        # sharded block gives them its placements.
        m = torch.full_like(qf[..., 0].permute(0, 2, 3, 1), NEG_INF,
                            memory_format=torch.contiguous_format)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for c in range(lo, hi):
            kc = k[:, c * C:(c + 1) * C].to(torch.float32)
            vc = v[:, c * C:(c + 1) * C].to(torch.float32)
            s = autoshard.scores(_einsum(
                heads, "bthgd,bshd->bhgts", qf, _Heads.QG, kc, _Heads.KV,
                _Heads.SCORES) * scale)
            k_pos = torch.arange(C, device=dev) + c * C
            keep = L.replicated_like(
                _chunk_keep(cfg, qb_pos, k_pos, valid_limit), s)  # (Tq, C)
            s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))          # (B,Hkv,g,Tq)
            p = torch.where(keep, _exp(cfg, s - m_new[..., None]), 0.0)
            corr = _exp(cfg, m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = _einsum(heads, "bhgts,bshd->bthgd", p, _Heads.PROBS, vc,
                         _Heads.KV, _Heads.QG)
            corr_t = corr.permute(0, 3, 1, 2)                 # (B,Tq,Hkv,g)
            acc = acc * corr_t[..., None] + pv
            m = m_new
        denom = l.permute(0, 3, 1, 2)
        return acc / torch.clamp(denom, min=1e-30)[..., None]

    def chunk_range(first_pos: int, last_pos: int) -> tuple[int, int]:
        """kv-chunk window for q positions [first, last]."""
        if not cfg.causal:
            return 0, n_chunks
        hi = min(last_pos // C + 1, n_chunks)
        lo = 0
        if cfg.sliding_window:
            lo = max(0, (first_pos - cfg.sliding_window + 1) // C)
        return lo, max(hi, lo + 1)

    outs = []
    for i in range(nq):
        start = q_offset + i * Tq
        lo, hi = chunk_range(start, start + Tq - 1)
        pos = torch.arange(Tq, device=dev) + start
        outs.append(q_block(q[:, i * Tq:(i + 1) * Tq], pos, lo, hi))
    return torch.cat(outs, dim=1)


def attention(p: Attention, cfg: ModelConfig, x, positions, kv_cache=None,
              cache_index: int | None = None):
    """x: (B, T, D).  Training/prefill: kv_cache None.
    Decode: kv_cache = dict(k=(B, S, Hkv, Dh), v=...), cache_index an int —
    writes the new keys and values into the cache IN PLACE at
    ``cache_index`` (the JAX package returns an updated copy; writing in
    place saves one cache copy per layer per step) and attends over the
    cache.  Returns (out, kv_cache).  The card span ``attn`` covers it all,
    ``attn.core`` the score product to the PV product."""
    with card.span("attn") as sp:
        out = _attention(p, cfg, sp.input(x), positions, kv_cache,
                         cache_index)
        return sp.output(out), kv_cache


def _attention(p: Attention, cfg: ModelConfig, x, positions, kv_cache,
               cache_index):
    dt = getattr(torch, cfg.dtype)
    B, T, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    q = L.split_dim(L.linear(p.q, x, dt), -1, (H, Dh))
    k = L.split_dim(L.linear(p.k, x, dt), -1, (Hkv, Dh))
    v = L.split_dim(L.linear(p.v, x, dt), -1, (Hkv, Dh))
    if cfg.qk_norm:
        q = L.norm("rmsnorm", p.q_norm, q)
        k = L.norm("rmsnorm", p.k_norm, k)
    q = _rotate(cfg, q, positions)
    k = _rotate(cfg, k, positions)

    if kv_cache is not None:
        kv_cache["k"][:, cache_index:cache_index + T] = k
        kv_cache["v"][:, cache_index:cache_index + T] = v
        k, v = kv_cache["k"], kv_cache["v"]
        q_offset = cache_index
    else:
        q_offset = 0

    # GQA: (B, S, Hkv, Dh) → group queries; einsum over grouped heads.
    S = k.shape[1]
    g = H // Hkv
    qg = L.split_dim(q, 2, (Hkv, g))

    with card.span("attn.core") as sp:
        qg, k, v = sp.input(qg), sp.input(k), sp.input(v)
        if T > 1 and T * S > CHUNKED_THRESHOLD and S % KV_CHUNK == 0:
            valid = None if kv_cache is None else q_offset + T
            out = sp.output(_chunked_attention(cfg, qg, k, v, q_offset,
                                               valid).to(dt))
        elif T == 1 and kv_cache is not None and not (
                isinstance(qg, DTensor) or isinstance(k, DTensor)):
            out = sp.output(_decode(cfg, qg, k, v, q_offset, dt, sp))
        else:
            out = sp.output(_scores_pv(cfg, qg, k, v, q_offset,
                                       kv_cache is not None, dt))
    heads = _Heads(qg, k) if isinstance(out, DTensor) else None
    return L.linear(p.o, _merge_heads(heads, out), dt)


def _scores_pv(cfg: ModelConfig, qg, k, v, q_offset: int, cached: bool, dt):
    """Attention over the materialised (B, Hkv, g, T, S) score matrix:
    (B, T, Hkv, g, Dh) in ``dt``."""
    T, S, Dh = qg.shape[1], k.shape[1], qg.shape[-1]
    # Scores in fp32, as the JAX package's preferred_element_type=float32:
    # the products of bf16 values are exact in fp32, and a bf16 matmul would
    # round the scores to bf16 before the mask and the softmax.
    heads = _Heads(qg, k) if isinstance(qg, DTensor) else None
    scores = L.reduced(_einsum(heads, "bthgd,bshd->bhgts",
                               qg.to(torch.float32), _Heads.QG,
                               k.to(torch.float32), _Heads.KV, _Heads.SCORES))
    scores = scores * (Dh ** -0.5)
    bias = _mask_bias(cfg, T, S, q_offset, scores.dtype, qg.device)
    if cached:
        # Mask out cache slots beyond the current position.
        valid = torch.arange(S, device=qg.device)[None, :] \
            <= (q_offset + T - 1)
        bias = bias + torch.where(valid, 0.0, NEG_INF).to(scores.dtype)
    scores = scores + L.replicated_like(bias, scores)[None, None, None]
    w = _softmax(cfg, scores).to(dt)
    return _einsum(heads, "bhgts,bshd->bthgd", w, _Heads.PROBS, v.to(dt),
                   _Heads.KV, _Heads.QG)


def _decode(cfg: ModelConfig, qg, k, v, pos: int, dt, sp):
    """One query a row at cache position ``pos``: the two products read the
    cache in place, only at the slots [lo, hi) that the causal and
    sliding-window mask keeps, with the softmax between.  (B, 1, Hkv, g,
    Dh) in ``dt``."""
    lo = max(0, pos - cfg.sliding_window + 1) if cfg.sliding_window else 0
    hi = pos + 1
    sp.count(decode_kernel=1, cache_slots=qg.shape[0] * (hi - lo))
    scores = kops.decode_scores(qg.contiguous(), k, lo, hi,
                                qg.shape[-1] ** -0.5, impl=cfg.softmax_impl)
    w = _softmax(cfg, scores).to(dt)
    return kops.decode_pv(w, v, lo, hi, impl=cfg.softmax_impl)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  n_attn_layers: int, dtype=None, device="cuda"):
    dt = getattr(torch, dtype or cfg.dtype)
    shape = (n_attn_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
