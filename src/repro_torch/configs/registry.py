"""Architecture registry: ``--arch <id>`` resolution + the 4 input shapes
(the port's copy of ``repro.configs.registry``; equal to it)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

from repro_torch.models.config import ModelConfig

_MODULES = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "mamba2-370m": "repro_torch.configs.mamba2_370m",
    "qwen1.5-4b": "repro_torch.configs.qwen15_4b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
}

ARCH_IDS = list(_MODULES)

# §Perf winners (EXPERIMENTS.md): per-arch knob sets that survived the
# hypothesis->measure cycles. Defaults stay paper-faithful; pass
# optimized=True (or --optimized on the launchers) to adopt them.
# The mesh knobs (attn_shard, moe_weight_gather, moe_shard_capacity) are
# no-ops on one device in the port; ssm_split_proj changes the layout only.
OPTIMIZED_KNOBS: dict[str, dict] = {
    "dbrx-132b": {"moe_weight_gather": True, "attn_shard": "heads"},
    "phi3.5-moe-42b-a6.6b": {"moe_weight_gather": True,
                             "attn_shard": "heads"},
    "qwen1.5-4b": {"attn_shard": "batch"},  # 20 heads !% 16-way model axis
    "zamba2-7b": {"ssm_split_proj": True, "attn_shard": "heads"},
    "mamba2-370m": {"ssm_split_proj": True},
    "granite-20b": {"attn_shard": "heads"},
    "granite-3-8b": {"attn_shard": "heads"},
    "starcoder2-15b": {"attn_shard": "heads"},
    "llama-3.2-vision-11b": {"attn_shard": "heads"},
    "musicgen-large": {"attn_shard": "heads"},
}


def get_config(arch: str, optimized: bool = False) -> ModelConfig:
    cfg = importlib.import_module(_MODULES[arch]).CONFIG
    if optimized:
        cfg = dataclasses.replace(cfg, **OPTIMIZED_KNOBS.get(arch, {}))
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch]).smoke()


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

SHAPE_IDS = list(INPUT_SHAPES)
