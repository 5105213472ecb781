"""granite-20b — llama-arch code model, MQA (kv=1) [arXiv:2405.04324].

GPT-BigCode lineage: MQA + non-gated GELU MLP (d_ff = 4 * d_model).
Deviation noted in DESIGN.md: we use RoPE rather than learned absolute
positions so the long_500k sliding-window variant has well-defined
positions beyond the training window."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", arch_type="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152,
    mlp="gelu",
    source="arXiv:2405.04324",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite20b-smoke", arch_type="dense", n_layers=2, d_model=256,
        n_heads=8, n_kv_heads=1, d_ff=1024, vocab=512,
        mlp="gelu", dtype="float32",
        source=CONFIG.source,
    )
