"""granite-3-8b — dense GQA [hf:ibm-granite/granite-3.0-2b-base family]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", arch_type="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=12800, vocab=49155,
    mlp="swiglu",
    source="hf:ibm-granite/granite-3.0-2b-base",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite3-smoke", arch_type="dense", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=768, vocab=512,
        mlp="swiglu", dtype="float32",
        source=CONFIG.source,
    )
