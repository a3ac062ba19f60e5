"""Mixtral 8x22B [arXiv:2401.04088; hf]: 56L, d=6144, 48H GQA(kv=8),
d_ff=16384 per expert, vocab 32768, MoE 8 experts top-2, sliding-window
attention. SWA makes the long_500k decode cell runnable (rolling cache)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral_8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=16384),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=128),
        param_dtype="float32",
    )
