"""Architecture configuration (twin of ``repro/configs/base.py``): the fields
the decoder families read (GQA with QKV bias and sliding windows, MLA,
MoE, SwiGLU / GELU / squared-ReLU MLPs, tied embeddings), the Mamba2 mixer
and the hybrid period (``SSMConfig``, ``ssm``, ``attn_period``), the
encoder-decoder and VLM fields (``EncoderConfig``, ``encoder``, the
frontend stub, LayerNorm, learned positions) and the per-layer numerics
plan, and the train path's ``remat``. ``ShapeConfig`` and
``cell_is_runnable`` belong to the dry run and port with it."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.plan.schema import NumericsPlan


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    n_shared: int = 0  # always-on shared experts (DeepSeekMoE)
    capacity_factor: float = 1.25
    every: int = 1  # MoE layer period (Jamba: 2); dense MLP otherwise
    router_numerics: bool = True  # route through the numerics backend softmax


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    source_len: int  # frozen source length (Whisper: 1500 frames)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    attn_bias: bool = False  # Qwen-style QKV bias
    sliding_window: Optional[int] = None  # Mixtral SWA: a ring cache
    mla: Optional[MLAConfig] = None
    rope_theta: float = 1e4
    moe: Optional[MoEConfig] = None
    first_dense_ff: Optional[int] = None  # DeepSeekMoE: dense layer 0 with own d_ff
    ssm: Optional[SSMConfig] = None
    attn_period: int = 0  # hybrid: 1 attention layer per this many (Jamba: 8)
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None  # audio_stub | vision_stub
    frontend_dim: int = 0  # stub embedding dim (projector input)
    frontend_len: int = 0  # number of prepended frontend tokens
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (SwiGLU) | gelu | relu2
    learned_pos: bool = False  # Whisper: learned positions instead of RoPE
    max_pos: int = 32768  # learned-position table height (learned_pos only)
    tie_embeddings: bool = False
    numerics: str = "exact"  # exact | interp | interp-fused
    # per-layer heterogeneous numerics (DESIGN.md §16). When set, the plan
    # overrides ``numerics``: each layer x op site carries its own backend
    # and library slot. Frozen and hashable, so the config stays a key.
    plan: Optional[NumericsPlan] = None
    param_dtype: str = "bfloat16"
    # activation checkpointing of the train path, per layer: none | block
    # (matmul outputs saved, the rest recomputed) | full
    remat: str = "block"

    @property
    def head_size(self) -> int:
        return self.head_dim if self.head_dim is not None else \
            self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM/hybrid state or
        SWA)"""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS = ["mixtral_8x22b", "deepseek_moe_16b", "qwen1_5_110b",
            "minicpm3_4b", "minitron_8b", "yi_6b", "mamba2_130m",
            "jamba_v0_1_52b", "whisper_tiny", "internvl2_2b"]


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}").CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}").smoke_config()
