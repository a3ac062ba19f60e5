"""Yi-6B [arXiv:2403.04652; hf]: llama-arch GQA: 32L, d=4096, 32H (kv=4),
d_ff=11008, vocab 64000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi_6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab_size=256, param_dtype="float32",
    )
