"""The 10 assigned architectures — exact configs from the assignment table
(a copy of :mod:`repro.configs.archs`).

Each entry also defines a REDUCED smoke config of the same family (small
width/depth, tiny vocab) used by per-arch CPU smoke tests; in the port the
full ``tinyllama-1.1b`` runs on the card in ``chip_smoke.py``.

Sources are cited per config ([arXiv/hf] tags from the assignment).
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

# ---------------------------------------------------------------------------
# full configs
# ---------------------------------------------------------------------------

MIXTRAL_8X22B = ModelConfig(                     # [arXiv:2401.04088; hf]
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, block_pattern=("moe",),
    moe=MoEConfig(n_experts=8, top_k=2),
    sliding_window=4096,                         # SWA per assignment
    rope_theta=1e6, max_seq_len=65536,
)

GRANITE_MOE_1B = ModelConfig(                    # [hf:ibm-granite/granite-3.0-1b-a400m-base]
    name="granite-moe-1b-a400m",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
    vocab=49155, block_pattern=("moe",),
    moe=MoEConfig(n_experts=32, top_k=8),
    tie_embeddings=True, rope_theta=10000.0,
)

TINYLLAMA_1B = ModelConfig(                      # [arXiv:2401.02385; hf]
    name="tinyllama-1.1b",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
    vocab=32000, block_pattern=("attn",),
)

GRANITE_3_2B = ModelConfig(                      # [hf:ibm-granite/granite-3.0-2b-base]
    name="granite-3-2b",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=49155, block_pattern=("attn",), tie_embeddings=True,
)

QWEN2_5_14B = ModelConfig(                       # [hf:Qwen/Qwen2.5-14B]
    name="qwen2.5-14b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab=152064, block_pattern=("attn",), qkv_bias=True,
    rope_theta=1e6,
)

QWEN2_72B = ModelConfig(                         # [arXiv:2407.10671]
    name="qwen2-72b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, block_pattern=("attn",), qkv_bias=True,
    rope_theta=1e6,
)

ZAMBA2_1B = ModelConfig(                         # [arXiv:2411.15242]
    name="zamba2-1.2b",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000,
    # Mamba2 backbone; weight-tied shared attention every 6th layer
    block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                   "shared_attn"),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1),
    sliding_window=4096,   # bounds shared-attn KV for the 500k cell
)

INTERNVL2_1B = ModelConfig(                      # [arXiv:2404.16821]
    name="internvl2-1b",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151655, block_pattern=("attn",), qkv_bias=True,
    tie_embeddings=True, vision_seq=256, rope_theta=1e6,
)

WHISPER_SMALL = ModelConfig(                     # [arXiv:2212.04356]
    name="whisper-small",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab=51865, block_pattern=("attn",), mlp_kind="gelu",
    norm_kind="layernorm", encoder_layers=12, encoder_seq=1500,
)

RWKV6_1B6 = ModelConfig(                         # [arXiv:2404.05892]
    name="rwkv6-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab=65536, block_pattern=("rwkv6",),
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        MIXTRAL_8X22B, GRANITE_MOE_1B, TINYLLAMA_1B, GRANITE_3_2B,
        QWEN2_5_14B, QWEN2_72B, ZAMBA2_1B, INTERNVL2_1B, WHISPER_SMALL,
        RWKV6_1B6,
    ]
}


# ---------------------------------------------------------------------------
# reduced smoke configs (same family, tiny dims, CPU-runnable)
# ---------------------------------------------------------------------------

def smoke_config(arch_id: str) -> ModelConfig:
    full = ARCHS[arch_id]
    kw = dict(
        n_layers=min(full.n_layers, 4),
        d_model=64, n_heads=4,
        n_kv_heads=min(4, max(1, full.n_kv_heads * 4 // full.n_heads)),
        d_head=16,
        d_ff=128, vocab=128, max_seq_len=128,
        attn_chunk_q=32, attn_chunk_k=32, logits_chunk=32,
        dtype="float32", use_scan=full.use_scan, remat=False,
        rope_theta=10000.0,
    )
    if full.moe is not None:
        kw["moe"] = MoEConfig(n_experts=min(8, full.moe.n_experts),
                              top_k=min(2, full.moe.top_k))
    if full.ssm is not None:
        kw["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2,
                              n_groups=1, chunk=16)
    if full.sliding_window is not None:
        kw["sliding_window"] = 64
    if full.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 24
    if full.vision_seq:
        kw["vision_seq"] = 8
    if "shared_attn" in full.layer_types:
        kw["n_layers"] = 6   # keep one shared block in the pattern
    return full.replace(**kw)
