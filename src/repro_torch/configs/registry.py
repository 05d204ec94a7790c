"""Architecture registry: full-size configs (public-literature dimensions)
and reduced smoke variants.  ``--arch <id>`` everywhere resolves here."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

# ---------------------------------------------------------------------------
# full-size configs — one per assigned architecture
# ---------------------------------------------------------------------------

#: [arXiv:2402.00838; hf] — non-parametric LN, SwiGLU, tied embeddings.
OLMO_1B = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=8192, vocab_size=50304, norm="nonparam_ln",
    act="swiglu", tie_embeddings=True, remat="full")

#: [arXiv:2404.14219] — RoPE, SwiGLU, full GQA (kv=32).
PHI3_MINI = ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32064, act="swiglu",
    remat="full")

#: [hf:Qwen/Qwen3-8B scaled per task table] — qk-norm, GQA kv=8, d_head 128.
QWEN3_32B = ModelConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_head=128, d_ff=25600, vocab_size=151936, qk_norm=True,
    act="swiglu", rope_theta=1e6, remat="full")

#: [arXiv:2403.08295] — GeGLU, head_dim 256, MQA (kv=1), 256 k vocab,
#: embedding scaling and (1+g) RMSNorm.
GEMMA_2B = ModelConfig(
    name="gemma-2b", family="dense", n_layers=18, d_model=2048, n_heads=8,
    n_kv_heads=1, d_head=256, d_ff=16384, vocab_size=256000,
    norm="gemma_rmsnorm", act="geglu", tie_embeddings=True, embed_scale=True,
    remat="full")

#: [arXiv:2401.06066] — 2 shared + 64 routed top-6 fine-grained experts,
#: dense first layer (d_ff 10944).
DEEPSEEK_MOE_16B = ModelConfig(
    name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=10944, vocab_size=102400, act="swiglu",
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  layer_pattern="all_but_first"), remat="full")

#: [hf:xai-org/grok-1] — 8 experts top-2, GQA kv=8.
GROK_1 = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144, n_heads=48,
    n_kv_heads=8, d_head=128, d_ff=32768, vocab_size=131072, act="geglu",
    moe=MoEConfig(n_experts=8, top_k=2, layer_pattern="all"),
    remat="full", opt_state_dtype="bfloat16")

#: [arXiv:2106.07447] — encoder-only audio transformer; stub frontend
#: provides precomputed frame embeddings; 504-class per-frame head.
HUBERT_XLARGE = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab_size=504, norm="layernorm",
    act="gelu", rope="none", causal=False, frontend="audio", remat="full")

#: [arXiv:2404.05892] — RWKV-6 "Finch": data-dependent decay, attn-free.
RWKV6_1B6 = ModelConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048, n_heads=32,
    n_kv_heads=32, d_ff=7168, vocab_size=65536, norm="layernorm",
    rope="none", layer_types="r" * 24,
    ssm=SSMConfig(kind="rwkv6", head_dim=64), remat="full")

#: [arXiv:2403.19887] — Mamba+attention 1:7 interleave, MoE 16e top-2 on
#: every other layer; attention uses GQA kv=8.
JAMBA_52B = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536, act="swiglu",
    layer_types=("mmmmammm" * 4), sliding_window=4096,
    moe=MoEConfig(n_experts=16, top_k=2, layer_pattern="every_2"),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    remat="full")

#: [arXiv:2409.12191] — M-RoPE (t/h/w sections), stub vision frontend.
QWEN2_VL_72B = ModelConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192, n_heads=64,
    n_kv_heads=8, d_head=128, d_ff=29568, vocab_size=152064, act="swiglu",
    rope="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6, remat="full")

FULL_CONFIGS: dict[str, ModelConfig] = {c.name: c for c in [
    OLMO_1B, PHI3_MINI, QWEN3_32B, GEMMA_2B, DEEPSEEK_MOE_16B, GROK_1,
    HUBERT_XLARGE, RWKV6_1B6, JAMBA_52B, QWEN2_VL_72B]}

ARCHS = list(FULL_CONFIGS)


# ---------------------------------------------------------------------------
# reduced smoke variants (same family/features, tiny dims) — CPU tests
# ---------------------------------------------------------------------------

def smoke(name: str) -> ModelConfig:
    cfg = FULL_CONFIGS[name]
    # fp32 compute at smoke scale: the decode-equivalence tests compare
    # cached vs uncached paths whose reduction orders differ — bf16 noise
    # would flip MoE router top-k choices and mask real bugs.
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(1, min(
        cfg.n_kv_heads, 2)), d_head=16, d_ff=128, vocab_size=503,
        max_seq_len=128, remat="none", layer_types="", dtype="float32")
    if cfg.moe:
        pattern = cfg.moe.layer_pattern
        # capacity_factor 8 → no token dropping at smoke scale, so the
        # prefill+decode == full-forward equivalence test holds exactly.
        kw["moe"] = MoEConfig(n_experts=4, top_k=2,
                              n_shared=min(cfg.moe.n_shared, 1),
                              d_expert=32 if cfg.moe.d_expert else 0,
                              capacity_factor=8.0,
                              layer_pattern=pattern)
        if pattern == "all_but_first":
            kw["n_layers"] = 3
    if cfg.name == "rwkv6-1.6b":
        kw["layer_types"] = "r" * kw["n_layers"]
        kw["ssm"] = SSMConfig(kind="rwkv6", head_dim=16)
    if cfg.name == "jamba-v0.1-52b":
        kw["n_layers"] = 8
        kw["layer_types"] = "mmmmammm"
        kw["ssm"] = SSMConfig(kind="mamba", d_state=4, d_conv=4, expand=2)
        kw["sliding_window"] = 32
    if cfg.rope == "mrope":
        kw["mrope_sections"] = (4, 2, 2)
    return cfg.replace(**kw)


def load_config(name: str, variant: str = "full") -> ModelConfig:
    if name not in FULL_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; choices: {ARCHS}")
    return FULL_CONFIGS[name] if variant == "full" else smoke(name)
