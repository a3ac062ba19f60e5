"""Jamba-v0.1 52B [arXiv:2403.19887; hf]: 32L hybrid, d=4096, 32H GQA(kv=8)
in the attention layers (1 per 8), Mamba elsewhere (d_state=16), d_ff=14336,
MoE 16 experts top-2 on every other layer, vocab 65536."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba_v0_1_52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attn_period=8,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1),
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, every=2),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=256, attn_period=4,
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, n_groups=1,
                      chunk=32),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=96, every=2),
        param_dtype="float32",
    )
