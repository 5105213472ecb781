"""llama-3.2-vision-11b — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision encoder + projector is a STUB (DESIGN.md §4): ``input_specs``
provides precomputed patch embeddings (B, n_image_tokens, d_model). The
language decoder — 40 layers with a cross-attention layer every 5th — is
implemented in full."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", arch_type="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256,
    cross_attn_every=5, n_image_tokens=1600, mlp="swiglu",
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama-vision-smoke", arch_type="vlm", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=2, d_ff=768, vocab=512,
        cross_attn_every=2, n_image_tokens=16, mlp="swiglu", dtype="float32",
        source=CONFIG.source,
    )
