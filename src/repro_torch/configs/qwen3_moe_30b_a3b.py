"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                 # per-expert FFN width
    vocab_size=151936,
    head_dim=128,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, renorm_gate=True),
)
