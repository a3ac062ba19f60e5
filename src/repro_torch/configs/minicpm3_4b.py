"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: 62L, d=2560, 40H, d_ff=6400,
vocab 73448, Multi-head Latent Attention (q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64)."""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3_4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,  # qk_nope + qk_rope
    d_ff=6400,
    vocab_size=73448,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
        d_ff=128, vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        param_dtype="float32",
    )
