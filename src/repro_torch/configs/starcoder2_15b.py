"""starcoder2-15b — dense GQA, RoPE [arXiv:2402.19173]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", arch_type="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152,
    mlp="gelu", rope_theta=100_000.0,
    source="arXiv:2402.19173",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-smoke", arch_type="dense", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=1024, vocab=512,
        mlp="gelu", dtype="float32",
        source=CONFIG.source,
    )
