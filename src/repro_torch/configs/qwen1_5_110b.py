"""Qwen1.5-110B [hf:Qwen/Qwen1.5-110B family]: 80L, d=8192, 64H GQA(kv=8),
d_ff=49152, vocab 152064, QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1_5_110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=256, param_dtype="float32",
    )
