"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", arch_type="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab=32064,
    n_experts=16, top_k=2, mlp="swiglu",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi35-moe-smoke", arch_type="moe", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=384, vocab=512,
        n_experts=4, top_k=2, mlp="swiglu", dtype="float32",
        source=CONFIG.source,
    )
