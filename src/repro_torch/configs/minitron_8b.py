"""Minitron-8B [arXiv:2407.14679; hf]: pruned Nemotron-4: 32L, d=4096,
32H GQA(kv=8), d_ff=16384, vocab 256000, squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron_8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    act="relu2",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab_size=512, param_dtype="float32",
    )
