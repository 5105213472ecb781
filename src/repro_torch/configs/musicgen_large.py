"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec/mel frontend is a STUB (DESIGN.md §4): ``input_specs`` provides
precomputed frame embeddings (B, T, d_model); the decoder transformer and its
2048-way codebook head are implemented in full. Sinusoidal positions, as in
the paper.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", arch_type="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=2048,
    mlp="gelu", pos="sinusoidal", inputs_embeds=True,
    source="arXiv:2306.05284",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", arch_type="audio", n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=4, d_ff=1024, vocab=256,
        mlp="gelu", pos="sinusoidal", inputs_embeds=True, dtype="float32",
        source=CONFIG.source,
    )
