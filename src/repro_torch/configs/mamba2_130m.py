"""Mamba2-130M [arXiv:2405.21060]: 24L, d=768, attention-free SSD,
ssm_state=128, vocab 50280 (padded to 50288 for lane alignment in the HF
release; we keep the published 50280)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2_130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
                      chunk=32),
        param_dtype="float32",
    )
