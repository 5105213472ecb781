"""qwen1.5-4b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B family]."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", arch_type="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936,
    qkv_bias=True, mlp="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", arch_type="dense", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab=512,
        qkv_bias=True, mlp="swiglu", dtype="float32",
        source=CONFIG.source,
    )
