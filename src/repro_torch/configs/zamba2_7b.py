"""zamba2-7b — Mamba2 backbone + shared attention block [arXiv:2411.15242].

81 Mamba2 layers with one *shared* attention+MLP block applied every 6
layers (the Zamba2 shared-transformer pattern, simplified: a single shared
block without per-invocation LoRA)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", arch_type="hybrid", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, d_ff=14336, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, shared_attn_every=6,
    mlp="swiglu",
    source="arXiv:2411.15242",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", arch_type="hybrid", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
        ssm_state=16, ssm_expand=2, ssm_head_dim=32, shared_attn_every=2,
        mlp="swiglu", dtype="float32",
        source=CONFIG.source,
    )
