"""mamba2-370m — pure SSD (state-space duality), attention-free
[arXiv:2405.21060]. DSO's attention-sharding aspects are inapplicable
(DESIGN.md §Arch-applicability); the scan shards over batch/heads."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", arch_type="ssm", n_layers=48, d_model=1024,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    source="arXiv:2405.21060",
)


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", arch_type="ssm", n_layers=2, d_model=256,
        d_ff=0, vocab=512,
        ssm_state=32, ssm_expand=2, ssm_head_dim=32, dtype="float32",
        source=CONFIG.source,
    )
