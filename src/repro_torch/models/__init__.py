from repro_torch.models.model import (
    decode_step,
    embed_inputs,
    forward,
    init_cache,
    init_params,
    lm_logits,
    params_from_numpy,
    prefill,
)
