"""InternVL2-2B [arXiv:2404.16821; hf]: InternLM2-1.8B language backbone
(24L, d=2048, 16H GQA kv=8, d_ff=8192, vocab 92553) + InternViT stub: the
vision tower is a stub; callers pass 256 precomputed patch embeddings at
1024 dims, mapped by an MLP projector."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2_2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision_stub",
    frontend_dim=1024,
    frontend_len=256,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, frontend_dim=32, frontend_len=16,
        param_dtype="float32",
    )
