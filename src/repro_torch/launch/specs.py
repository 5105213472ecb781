"""Abstract input and state specs for every (architecture x input shape)
pair (the port of ``repro.launch.specs``).

Everything here is a tensor on the ``meta`` device: shapes and types,
nothing drawn or allocated, so the dry run can price full-scale configs
on any host.  Token ids are int64 (the reference's are int32), the
type ``torch.nn.functional.embedding`` and the pipeline use.
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import InputShape
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import torch_dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Batch specs for a *training or prefill* step."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    specs = {}
    if cfg.inputs_embeds:
        specs["embeds"] = _meta((B, S, cfg.d_model), dt)
    else:
        specs["tokens"] = _meta((B, S), torch.int64)
    if shape.kind == "train":
        specs["targets"] = _meta((B, S), torch.int64)
    if cfg.arch_type == "vlm":
        specs["image_embeds"] = _meta((B, cfg.n_image_tokens, cfg.d_model),
                                      dt)
    return specs


def decode_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """Input specs for one decode step: ONE token against a seq_len
    cache."""
    B = shape.global_batch
    dt = torch_dtype(cfg.dtype)
    inp = (_meta((B, 1, cfg.d_model), dt) if cfg.inputs_embeds
           else _meta((B, 1), torch.int64))
    specs = {"inp": inp, "pos": _meta((), torch.int64)}
    if cfg.arch_type == "vlm":
        specs["image_embeds"] = _meta((B, cfg.n_image_tokens, cfg.d_model),
                                      dt)
    return specs


def param_spec_tree(cfg: ModelConfig):
    return M.param_specs(cfg)


def decode_state_specs(cfg: ModelConfig, shape: InputShape):
    return M.decode_state_specs(cfg, shape.global_batch, shape.seq_len)


def input_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The full abstract input set for this (arch, shape) pair."""
    if shape.kind == "decode":
        return {
            "params": param_spec_tree(cfg),
            "state": decode_state_specs(cfg, shape),
            **decode_specs(cfg, shape),
        }
    return {"params": param_spec_tree(cfg), "batch": batch_specs(cfg, shape)}
