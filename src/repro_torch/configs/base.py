"""Architecture configuration dataclasses.

Every assigned architecture is expressed as a :class:`ModelConfig`.  Configs
are plain frozen dataclasses — importing a config module never touches jax
device state.  ``reduced()`` produces the small-family smoke-test variant of
the same architecture (same family/topology, tiny dims).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    renorm_gate: bool = True          # renormalize top-k softmax (mixtral/qwen3 style)
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    n_groups: int = 1
    head_dim: int = 64                # Mamba2 "P"
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # SWA (mixtral)
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0               # hybrid: shared attn block after layers i%attn_every==attn_every-1
    # --- Zamba2's shared transformer blocks (hybrid; unset, the Zamba-style
    # block above: one attention block added to the residual) ---
    # the layers whose Mamba2 input takes a shared block's output, in order
    # (Zamba2's hybrid_layer_ids); None: the Zamba-style block after every
    # attn_every-th layer. Set, there are n_layers // attn_every of them, and
    # each block reads concat(h, embeddings) and runs a gated-GELU MLP of d_ff.
    hybrid_sites: Optional[Tuple[int, ...]] = None
    n_shared_blocks: int = 1          # site k runs shared block k % n_shared_blocks
    shared_lora_rank: int = 0         # rank of each site's own LoRA on the MLP's gate_up
    frontend: str = "tokens"          # tokens | patch (vlm) | frames (audio)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- runtime knobs ---
    remat: bool = True
    attn_impl: str = "auto"           # auto | pallas | ref
    max_seq_len: int = 131072
    # perf: pad attention head counts up to a multiple (zero-initialized
    # padded heads -> exact semantics, TP-clean sharding).  See EXPERIMENTS.md §Perf.
    head_pad_multiple: Optional[int] = None
    # perf: decode attention over a sequence-sharded KV cache via shard_map
    # split-KV flash-decode (psum of softmax partials instead of cache gathers)
    sharded_decode_attn: bool = False
    # perf: constrain per-block activations to stay batch-sharded over ALL
    # mesh axes (forces GSPMD to all-gather weights, i.e. true FSDP)
    fsdp_act_constraint: bool = False
    # perf: int8 KV cache (per-token-per-head absmax scales) — halves the
    # decode memory-roofline cache-streaming term
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8

    def __post_init__(self):
        if self.hybrid_sites is None:
            if (self.n_shared_blocks, self.shared_lora_rank) != (1, 0):
                raise ValueError("more than one shared block, or a LoRA, needs hybrid_sites "
                                 "(the Zamba2 order)")
            return
        sites = tuple(int(i) for i in self.hybrid_sites)
        object.__setattr__(self, "hybrid_sites", sites)   # a JSON list, hashable now
        if self.family != "hybrid" or not self.attn_every:
            raise ValueError("hybrid_sites belong to a hybrid config with attn_every")
        if len(sites) != self.n_layers // self.attn_every:
            raise ValueError(f"{len(sites)} hybrid_sites, but the cache holds "
                             f"n_layers // attn_every = {self.n_layers // self.attn_every}")
        if list(sites) != sorted(set(sites)) or not 0 <= sites[0] <= sites[-1] < self.n_layers:
            raise ValueError(f"hybrid_sites {sites} must rise strictly within the layers")
        if self.n_shared_blocks < 1 or self.shared_lora_rank < 1:
            raise ValueError("the Zamba2 order needs a shared block and each site's LoRA")

    @property
    def attn_scale(self) -> float:
        """The attention scores' scale: (head_dim / 2)^-0.5 in the Zamba2
        order, as published, else head_dim^-0.5."""
        hd = self.resolved_head_dim
        return (hd / 2 if self.hybrid_sites is not None else hd) ** -0.5

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def eff_n_heads(self) -> int:
        if self.head_pad_multiple:
            return _round_up(self.n_heads, self.head_pad_multiple)
        return self.n_heads

    @property
    def eff_n_kv_heads(self) -> int:
        if self.head_pad_multiple:
            return _round_up(self.n_kv_heads, self.head_pad_multiple)
        return self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a TP-friendly multiple (MaxText-style)."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_subquadratic_attention(self) -> bool:
        """True if long-context (500k) decode is in scope for this arch."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        D, F, V = self.d_model, self.d_ff, self.padded_vocab
        hd = self.resolved_head_dim
        n = V * D * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("ssm", "hybrid"):
            s = self.ssm
            di = s.d_inner(D)
            nh = s.n_heads(D)
            conv_dim = di + 2 * s.n_groups * s.d_state
            per_layer += D * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
            per_layer += conv_dim * s.d_conv                               # conv
            per_layer += di * D                                            # out_proj
            per_layer += 2 * nh + di + D                                   # A, D, norm, ln
        if self.family in ("dense", "vlm", "audio") or self.attn_every:
            qkv = D * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * D
            n_attn = self.n_layers if not self.attn_every else 1  # shared block for hybrid
            per_attn = qkv + 2 * D
            if not self.attn_every:
                per_layer += per_attn
            else:
                n += per_attn  # one shared block
        if self.family in ("dense", "vlm", "audio"):
            per_layer += 3 * D * F + 2 * D
        if self.family == "moe":
            qkv = D * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * D
            per_layer += qkv + 2 * D
            per_layer += D * self.moe.n_experts
            per_layer += 3 * D * self.moe.d_ff_expert * self.moe.n_experts
        n += per_layer * self.n_layers + D
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE uses top_k experts only)."""
        if self.family != "moe":
            return self.n_params()
        dense_like = self.n_params()
        e, k = self.moe.n_experts, self.moe.top_k
        expert_params = 3 * self.d_model * self.moe.d_ff_expert * self.moe.n_experts * self.n_layers
        return dense_like - expert_params + expert_params * k // e

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if not self.attn_every else 6),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
            max_seq_len=512,
            remat=False,
        )
        if self.moe is not None:
            # capacity_factor high enough that the toy config never drops
            # tokens — keeps prefill/decode numerically consistent in tests
            kw["moe"] = dataclasses.replace(self.moe, n_experts=min(self.moe.n_experts, 4),
                                            top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                                            capacity_factor=8.0)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=32, chunk=32)
        if self.sliding_window is not None:
            kw["sliding_window"] = 64
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
# Shape sets (assigned): every LM arch gets all four; applicability of
# decode/long cells is resolved by `cells_for()` below.
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell."""
    if shape.name == "long_500k" and not cfg.has_subquadratic_attention:
        return False, "long_500k skipped: pure full-attention arch (quadratic); see DESIGN.md"
    return True, ""
