"""Model/run configuration dataclasses.

A copy of the JAX package's ``repro.configs.base`` so that ``repro_torch``
stands alone: the architectures are defined in ``registry.py`` with their
public-literature dimensions, each with a reduced ``smoke()`` variant that
the CPU tests run.  The only change is ``softmax_impl``, whose kernel route
is ``"cuda"`` here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0              # per-expert FFN hidden dim
    capacity_factor: float = 1.25
    router_jitter: bool = False
    #: layers that are MoE (predicate over layer index); "all", "every_2",
    #: or "all_but_first" (DeepSeekMoE layer 0 is dense).
    layer_pattern: str = "all"


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"            # mamba | rwkv6
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64             # rwkv6: WKV head size
    dt_rank: int = 0               # mamba: Δ projection rank (0 → d_model/16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | audio | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 → d_model // n_heads
    norm: str = "rmsnorm"          # rmsnorm | gemma_rmsnorm | layernorm |
                                   # nonparam_ln
    act: str = "swiglu"            # swiglu | geglu | gelu
    rope: str = "rope"             # rope | mrope | none
    rope_theta: float = 10000.0
    qk_norm: bool = False
    causal: bool = True
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma: embeddings × sqrt(d_model)
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    #: per-layer mixer pattern: "attn" | "mamba" | "rwkv6"; "attn"*n default.
    #: For jamba: period-8 string like "mmmmammm" repeated.
    layer_types: str = ""
    #: M-RoPE sections (t, h, w) for qwen2-vl.
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    #: frontend stub: none | audio | vision — audio/vision feed precomputed
    #: frame/patch embeddings (per the task spec, the modality frontend is a
    #: STUB; input_specs() provides the embeddings).
    frontend: str = "none"
    max_seq_len: int = 131072
    #: sliding-window size used by hybrid archs for the long_500k shape.
    sliding_window: int = 0

    # --- execution knobs ---
    dtype: str = "bfloat16"        # activation/param compute dtype
    param_dtype: str = "float32"   # master params
    opt_state_dtype: str = "float32"
    remat: str = "none"            # none | dots | full
    use_copift_softmax: bool = True
    softmax_impl: str = "auto"     # auto | cuda | reference
    scan_layers: bool = True
    #: Megatron-style vocab-parallel CE: logits stay vocab-sharded, the
    #: logsumexp/target terms reduce via scalar psums (training slice).
    vocab_parallel_ce: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if not self.layer_types:
            object.__setattr__(self, "layer_types", "a" * self.n_layers)
        assert len(self.layer_types) == self.n_layers, self.name

    @property
    def n_q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def attn_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), for the
        6·N·D MODEL_FLOPS roofline term."""
        d, v = self.d_model, self.vocab_size
        total = v * d * (1 if self.tie_embeddings else 2)
        for lt in self.layer_types:
            if lt == "a":
                total += d * self.attn_dim + 2 * d * self.n_kv_heads * self.d_head \
                    + self.attn_dim * d
            elif lt == "m":          # mamba
                di = self.ssm.expand * d
                dtr = self.ssm.dt_rank or max(1, d // 16)
                total += d * 2 * di + di * self.ssm.d_conv \
                    + di * (dtr + 2 * self.ssm.d_state) + dtr * di \
                    + di * self.ssm.d_state + di + di * d
            elif lt == "r":          # rwkv6 time-mix
                total += 5 * d * d + d * d   # r,k,v,g,w projections + out
            total += self._ffn_params(lt)
            total += 2 * d           # norms
        return total

    def _ffn_params(self, lt: str) -> int:
        d = self.d_model
        gated = self.act in ("swiglu", "geglu")
        mult = 3 if gated else 2
        if self.moe is None:
            return mult * d * self.d_ff
        e = self.moe
        per_expert = mult * d * (e.d_expert or self.d_ff)
        shared = e.n_shared * per_expert
        router = d * e.n_experts
        return e.n_experts * per_expert + shared + router

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        gated = self.act in ("swiglu", "geglu")
        mult = 3 if gated else 2
        e = self.moe
        per_expert = mult * d * (e.d_expert or self.d_ff)
        full = self.n_params()
        inactive = (e.n_experts - e.top_k) * per_expert * \
            sum(1 for lt in self.layer_types)  # approx: all layers MoE
        return full - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One cell of the (arch × shape) matrix."""
    name: str                      # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The runnable cells for one arch (encoder-only archs have no decode)."""
    out = ["train_4k", "prefill_32k"]
    if not cfg.is_encoder_only:
        out.append("decode_32k")
        subquadratic = any(t in ("m", "r") for t in cfg.layer_types)
        if subquadratic:
            out.append("long_500k")
    return out
