"""zamba2-7b [hybrid] — Zamba2-7B-Instruct at its published widths [arXiv:2411.15242].

81 Mamba2 layers (d_inner 7168, 112 heads of 64, 2 groups, d_state 64); before
the Mamba2 of each of the 13 hybrid layers, one of two shared transformer
blocks, taken in turn, reads concat(h, embeddings) (width 7168): attention of
32 heads of 224 scaled by (224 / 2)^-0.5, then a gated-GELU MLP of 14336
with a rank-128 LoRA of the site's own on its gate_up, then the site's own
3584 x 3584 projection, whose output joins that layer's Mamba2 input and
not the residual. Source: hf Zyphra/Zamba2-7B-Instruct, config.json.

Not in the registry: the dry-run, mesh and JAX-parity tests run every
registered config against the JAX package, which has no Zamba2-7B.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=224,
    rope_theta=1e4,
    norm_eps=1e-5,
    attn_every=6,
    hybrid_sites=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    n_shared_blocks=2,
    shared_lora_rank=128,
    tie_embeddings=True,
    max_seq_len=4096,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, n_groups=2, head_dim=64, chunk=128),
)
