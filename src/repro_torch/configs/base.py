"""Architecture configuration (twin of ``repro/configs/base.py``): the fields
the dense GQA decoder and the MoE family read, and the per-layer numerics
plan. QKV bias, sliding windows, tied embeddings, other norms and
activations port with the model families that use them."""
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
class ModelConfig:
    name: str
    family: str  # this port serves "dense" and "moe"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 1e4
    moe: Optional[MoEConfig] = None
    first_dense_ff: Optional[int] = None  # DeepSeekMoE: dense layer 0 with own d_ff
    numerics: str = "exact"  # exact | interp | interp-fused
    # per-layer heterogeneous numerics (DESIGN.md §16). When set, the plan
    # overrides ``numerics``: each layer x op site carries its own backend
    # and library slot. Frozen and hashable, so the config stays a key.
    plan: Optional[NumericsPlan] = None
    param_dtype: str = "bfloat16"

    @property
    def head_size(self) -> int:
        return self.head_dim if self.head_dim is not None else \
            self.d_model // self.n_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS = ["deepseek_moe_16b", "yi_6b"]


def get_config(arch: str) -> ModelConfig:
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}").CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_')}").smoke_config()
