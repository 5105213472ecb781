"""dbrx-132b — MoE, 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100352,
    n_experts=16, top_k=4, mlp="swiglu",
    source="hf:databricks/dbrx-base",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", arch_type="moe", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=448, vocab=512,
        n_experts=4, top_k=2, mlp="swiglu", dtype="float32",
        source=CONFIG.source,
    )
