"""Config registry: --arch <id> resolves here."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME, cell_supported

from repro_torch.configs.internvl2_76b import CONFIG as internvl2_76b
from repro_torch.configs.granite_8b import CONFIG as granite_8b
from repro_torch.configs.qwen2_7b import CONFIG as qwen2_7b
from repro_torch.configs.deepseek_7b import CONFIG as deepseek_7b
from repro_torch.configs.mistral_nemo_12b import CONFIG as mistral_nemo_12b
from repro_torch.configs.musicgen_medium import CONFIG as musicgen_medium
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from repro_torch.configs.mixtral_8x7b import CONFIG as mixtral_8x7b
from repro_torch.configs.zamba2_1p2b import CONFIG as zamba2_1p2b
from repro_torch.configs.mamba2_2p7b import CONFIG as mamba2_2p7b

ARCHS = {
    c.name: c
    for c in (
        internvl2_76b, granite_8b, qwen2_7b, deepseek_7b, mistral_nemo_12b,
        musicgen_medium, qwen3_moe_30b_a3b, mixtral_8x7b, zamba2_1p2b,
        mamba2_2p7b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
