"""DeepSeekMoE 16B [arXiv:2401.06066; hf]: 28L, d=2048, 16H (kv=16),
fine-grained MoE with 64 routed experts (d_expert=1408) top-6 plus 2 shared
experts; layer 0 is a dense MLP (d_ff=10944) per the released config."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek_moe_16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    first_dense_ff=10944,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=48, vocab_size=256, first_dense_ff=96,
        moe=MoEConfig(n_experts=8, top_k=3, d_expert=48, n_shared=1),
        param_dtype="float32",
    )
