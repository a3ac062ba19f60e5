"""Whisper-tiny [arXiv:2212.04356]: enc-dec, 4+4L, d=384, 6H, d_ff=1536,
vocab 51865, GELU, LayerNorm, learned positions. The conv audio frontend is
a stub: callers pass precomputed frame embeddings (B, 1500, 384)."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper_tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    encoder=EncoderConfig(n_layers=4, source_len=1500),
    frontend="audio_stub",
    frontend_dim=384,
    norm="layernorm",
    act="gelu",
    learned_pos=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        encoder=EncoderConfig(n_layers=2, source_len=64),
        frontend_dim=64, param_dtype="float32",
    )
