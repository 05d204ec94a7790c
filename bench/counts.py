"""Operations and bytes from shapes, and the card's peaks.

The least work each forward pass needs, counted from the configuration's
shapes and never from what the program launches: a matrix product of an
(n, k) input by a (k, m) weight is 2·n·k·m operations; causal attention
over T tokens from position 0 is 2·a·T·(T + 1) operations a row and layer
(QKᵀ and PV over the keys at or before each query, a = heads × head
size); a training step is three times its forward pass (recompute is the
program's choice and is not counted).  A token of a mixture of experts
goes through its top-k and the shared experts.  Bytes are what a forward
pass must read: every weight but the embedding table (a gather of a few
rows; with tied embeddings the table is the readout and counts) and, in a
decode step, the keys and values at or before the position.

The per-token products are those of ``benchmarks/costmodel.py`` (its
``causal_skip`` attention), rewritten over the benchmark's own
configuration files and without the work it counts as executed: the
experts' capacity padding, the recompute and the norms.
"""

from __future__ import annotations

import re

from bench.reference.decoder import Model

#: NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def layer_matmul_params(m: Model, layer: int) -> int:
    """Weights one token multiplies through in ``layer``."""
    d, a, kv = m.d_model, m.attn_dim, m.n_kv_heads * m.d_head
    attn = d * a + 2 * d * kv + a * d
    if m.is_moe(layer):
        e = m.moe
        return attn + d * e.n_experts + (e.top_k + e.n_shared) * 3 * d * e.d_expert
    return attn + 3 * d * m.d_ff


def matmul_params(m: Model) -> int:
    """Weights one token multiplies through in all layers (no readout)."""
    return sum(layer_matmul_params(m, i) for i in range(m.n_layers))


def head_params(m: Model) -> int:
    return m.d_model * m.vocab_size


def causal_attention_flops(m: Model, T: int) -> int:
    """QKᵀ and PV of one row of T tokens from position 0, all layers."""
    return 2 * m.attn_dim * T * (T + 1) * m.n_layers


def train_step_flops(m: Model, batch: int, seq: int) -> int:
    """Forward and backward of a step: the layers over every token, the
    readout over the seq − 1 predicted positions of a row."""
    fwd = (2 * batch * seq * matmul_params(m)
           + 2 * batch * (seq - 1) * head_params(m)
           + batch * causal_attention_flops(m, seq))
    return 3 * fwd


def prefill_flops(m: Model, batch: int, prompt: int) -> int:
    """A prefill of ``batch`` prompts, logits of the last position only."""
    return (2 * batch * prompt * matmul_params(m)
            + 2 * batch * head_params(m)
            + batch * causal_attention_flops(m, prompt))


def decode_step_flops(m: Model, batch: int, pos: int) -> int:
    """One token a row at 0-based position ``pos`` (pos + 1 keys)."""
    return (2 * batch * (matmul_params(m) + head_params(m))
            + batch * 4 * m.attn_dim * (pos + 1) * m.n_layers)


def weight_bytes(m: Model, specs, dtype: str) -> int:
    """Bytes of the weights a forward pass reads, served in ``dtype``."""
    size = ITEMSIZE[dtype]
    skip = set() if m.tie_embeddings else {"embed.table"}
    return sum(s.numel * size for s in specs if s.name not in skip)


def kv_bytes(m: Model, batch: int, pos: int, dtype: str) -> int:
    """Keys and values a decode step at position ``pos`` reads."""
    return (2 * m.n_layers * batch * (pos + 1) * m.n_kv_heads * m.d_head
            * ITEMSIZE[dtype])


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time of a pass: the larger of its two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def softmax_bytes(rows: int, cols: int, itemsize: int = 4) -> int:
    """A softmax over (rows, cols): each input read once, each output
    written once."""
    return 2 * rows * cols * itemsize


def causal_exp_bytes(batch: int, heads: int, seq: int,
                     itemsize: int = 4) -> int:
    """The exponentials causal attention needs over (seq, seq) scores: the
    entries at or below the diagonal, each read once and written once."""
    return 2 * batch * heads * seq * (seq + 1) // 2 * itemsize


def forward_softmax_bytes(m: Model, forward: tuple) -> int:
    """The softmax bytes of one forward pass ``(kind, batch, tokens or
    position, keys)``: every layer's scores of its queries (a decode step
    has one a row) over the ``keys`` positions the attention hands it."""
    kind, batch, t, keys = forward
    queries = 1 if kind == "decode" else t
    return m.n_layers * softmax_bytes(batch * m.n_heads * queries, keys)


#: The program's kernels, by their names in a device trace: the COPIFT
#: softmax's three paths (``csrc/softmax.cu``) and exp's two
#: (``csrc/expf.cu``).  PyTorch's own (``softmax_warp_forward``,
#: ``exp_kernel_cuda``) do not match.
_SOFTMAX = re.compile(r"(^|[\s:])softmax_(warp_|cluster_)?kernel\b")
_EXP = re.compile(r"(^|[\s:])exp(_vec)?_kernel\b")


def is_softmax_kernel(name: str) -> bool:
    return _SOFTMAX.search(name) is not None


def is_exp_kernel(name: str) -> bool:
    return _EXP.search(name) is not None
