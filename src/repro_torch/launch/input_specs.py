"""Meta-tensor stand-ins for every model input: the port of
``repro.launch.input_specs`` (``jax.eval_shape``'s counterpart is the meta
device). The trees are the port's: ``params["blocks"]`` holds one dict per
layer. Nothing is allocated and nothing is drawn."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as model_mod
from repro_torch.training import optimizer as opt_mod


def param_structs(cfg: ModelConfig):
    return model_mod.init_params(cfg, device="meta")


def opt_structs(cfg: ModelConfig):
    return opt_mod.init_opt_state(param_structs(cfg))


def cache_structs(cfg: ModelConfig, batch: int, max_len: int):
    return model_mod.init_cache(cfg, batch, max_len, device="meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The kwargs tree of meta tensors for the step function of this (arch,
    shape) cell: ``{"batch"}`` for train and prefill, ``{"cache",
    "tokens"}`` for decode."""
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    if shape.kind == "train":
        if cfg.frontend == "tokens":
            batch = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
        else:
            batch = {"embeds": _meta((B, S, D), torch.bfloat16),
                     "labels": _meta((B, S), torch.int32)}
        return {"batch": batch}
    if shape.kind == "prefill":
        if cfg.frontend == "tokens":
            return {"batch": {"tokens": _meta((B, S), torch.int32)}}
        return {"batch": {"embeds": _meta((B, S, D), torch.bfloat16)}}
    if shape.kind == "decode":
        return {"cache": cache_structs(cfg, B, S), "tokens": _meta((B,), torch.int32)}
    raise ValueError(shape.kind)
