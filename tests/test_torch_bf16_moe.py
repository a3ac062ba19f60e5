"""The bfloat16 path of the MoE families against the reference:
``deepseek_moe_16b`` (shared experts, dense layer 0), ``mixtral_8x22b``
(top-2, sliding window) and ``jamba_v0_1_52b`` (SSM / attention hybrid
with MoE layers), on their smoke configs at ``param_dtype="bfloat16"``.
Jamba on prompts where a GEMM tie falls: ``test_torch_bf16_ssm_encdec.py``.

The reference keeps both expert products in float32
(``preferred_element_type=float32``), takes the silu on the float32 gate
and combines in float32; the port's ``moe.expert_mm`` does the same (on
the CPU by upcasting the bf16 operands, which is exact). Held:

* one bf16 ``moe_block`` under interp-fused numerics bitwise the
  reference's, and under exact numerics within twice the reference's own
  distance from its float32 run on the same bf16 values;
* the whole model (prefill of 16 tokens, three decodes teacher-forced with
  the reference's tokens) under interp-fused bitwise, logits and caches,
  with the port's bf16 GEMMs in the reference's accumulation order
  (``ReferenceGemm``), and bitwise as it runs; under exact within twice the
  reference's bf16-versus-float32 distance with tie-aware greedy tokens;
  cache positions bitwise;
* ``expert_mm``'s product and gradients: float32 out, each gradient in its
  operand's dtype, equal to float32 autograd on the upcast operands.

``tests/torch_bf16_parity.py`` has the shim that lets the reference's CPU
backend run its bf16 x bf16 -> float32 einsums, and the compile options.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bf16_parity as bp
from repro.configs import base as jbase
from repro.models import moe as jmoe
from repro.models.layers import init_tree
from repro_torch.configs import base
from repro_torch.models import moe

ARCHS = ["deepseek_moe_16b", "mixtral_8x22b", "jamba_v0_1_52b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _shim(monkeypatch):
    bp.patch_reference(monkeypatch)


def _layer(arch: str, dtype: str):
    """The MoE block's reference parameters at ``dtype`` (the router stays
    float32), the port's as their values, and seeded bf16-valued input
    (2, 16, d)."""
    jcfg = jbase.get_smoke_config(arch).replace(param_dtype=dtype)
    cfg = base.get_smoke_config(arch).replace(param_dtype=dtype)
    jp = init_tree(jax.random.key(0), jmoe.moe_shapes(jcfg))
    tdt = getattr(torch, dtype)
    p = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else tdt) for k, v in jp.items()}
    x = np.random.default_rng(16).standard_normal((2, 16, cfg.d_model))
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return jcfg, cfg, jp, p, x


def _moe_pair(arch: str, name: str, dtype: str = "bfloat16"):
    jcfg, cfg, jp, p, x = _layer(arch, dtype)
    jnum, tnum = bp.numerics(name)
    want = bp.ref_jit(jmoe.moe_block, cfg=jcfg, numerics=jnum)(
        jp, jnp.asarray(x, dtype))
    got = moe.moe_block(p, torch.from_numpy(x).to(getattr(torch, dtype)),
                        cfg, tnum)
    return np.asarray(want).astype(np.float32), got


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_bf16_interp_fused_is_bitwise_the_reference(arch):
    """Under interp-fused numerics (the silu and the router softmax read
    the same tables in both packages) one bf16 MoE layer is bitwise the
    reference's. Before the expert products were float32 44%
    (DeepSeekMoE) and 67% (Mixtral) of its elements differed."""
    want, got = _moe_pair(arch, "interp-fused")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_bf16_exact_within_the_reference_bf16_distance(arch):
    """Under exact numerics (``jax.nn`` against ``torch`` silu and softmax,
    float32 in another order) within twice the reference's own distance
    from its float32 layer on the same bf16-valued weights and input."""
    want, got = _moe_pair(arch, "exact")
    want32, _ = _moe_pair(arch, "exact", "float32")
    bound = 2 * np.abs(want - want32).max()
    assert bound > 0
    assert np.abs(got.float().numpy() - want).max() <= bound


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_bitwise_under_the_reference_gemm_order(arch):
    """Interp-fused prefill and decodes with the port's bf16 GEMMs in the
    reference's accumulation order: logits and every cache leaf bitwise
    (the float32 SSM state within its reassociation)."""
    bp.hold_family(arch, "interp-fused", "bitwise", gemm=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_interp_fused_is_bitwise_the_reference(arch):
    """The same as the port runs: no GEMM tie falls on these inputs."""
    bp.hold_family(arch, "interp-fused", "bitwise")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_exact_within_the_reference_bf16_distance(arch):
    bp.hold_family(arch, "exact", "f32")


def test_moe_tp_all_reduce_is_the_float32_output(monkeypatch):
    """One bf16 DeepSeekMoE smoke layer traced on a tp = 4 mesh: the
    expert products are bf16 x bf16 -> float32 on the card's op
    (``aten::bmm.dtype``), and the layer all-reduces its combined float32
    output (B, S, d) once and the shared experts' bf16 output once (the
    reference's all-reduce lands on y), not the float32 (E, B, C + 1, d)
    expert buffer."""
    from repro_torch.launch.mesh import trace_mesh
    from repro_torch.launch.xprof import profile_step
    from repro_torch.models.layers import spec
    from repro_torch.numerics.ops import get_numerics

    cfg = base.get_smoke_config("deepseek_moe_16b").replace(
        param_dtype="bfloat16")
    m, d, tp, bf = cfg.moe, cfg.d_model, 4, torch.bfloat16
    de, sh = m.d_expert // tp, m.n_shared * m.d_expert // tp
    p = {"router": spec((d, m.n_experts), torch.float32),
         "wi": spec((m.n_experts, d, 2 * de), bf),
         "wo": spec((m.n_experts, de, d), bf),
         "shared_wi": spec((d, 2 * sh), bf), "shared_wo": spec((sh, d), bf)}
    mesh = trace_mesh((tp,), ("model",))
    b, s = 2, 16
    seen = []
    real = moe._mm_f32

    def spy(a, w):
        out = real(a, w)
        seen.append((a.dtype, w.dtype, out.dtype))
        return out

    monkeypatch.setattr(moe, "_mm_f32", spy)
    prof, y = profile_step(
        lambda p_, x: moe.moe_block(p_, x, cfg, get_numerics("exact"),
                                    mesh=mesh), p, spec((b, s, d), bf))
    assert y.dtype == bf and tuple(y.shape) == (b, s, d)
    assert seen == [(bf, bf, torch.float32)] * 2
    assert prof.collective_count == {"all_reduce": 2}
    ring = 2 * (tp - 1) / tp
    assert prof.collective_bytes["all_reduce"] == ring * b * s * d * (4 + 2)


def test_expert_mm_float32_product_and_gradients():
    """``expert_mm`` on bf16 operands: a float32 product equal to the
    float32 product of the upcast operands (exact: every bf16 x bf16
    product is a float32), and gradients in the operands' own dtypes equal
    to float32 autograd through the upcast operands, cast back."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(4, 10, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(4, 64, 48, generator=g).to(torch.bfloat16)
    w = torch.randn(4, 10, 48, generator=g)
    a.requires_grad_(True)
    b.requires_grad_(True)
    y = moe.expert_mm(a, b)
    assert y.dtype == torch.float32
    (y * w).sum().backward()
    a32 = a.detach().float().requires_grad_(True)
    b32 = b.detach().float().requires_grad_(True)
    y32 = torch.bmm(a32, b32)
    (y32 * w).sum().backward()
    assert torch.equal(y, y32)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert torch.equal(a.grad, a32.grad.to(torch.bfloat16))
    assert torch.equal(b.grad, b32.grad.to(torch.bfloat16))
    with torch.no_grad():
        assert torch.equal(moe.expert_mm(a, b), y32)
    f = torch.randn(2, 3, 5, generator=g)
    assert torch.equal(moe.expert_mm(f, f.transpose(1, 2)),
                       torch.bmm(f, f.transpose(1, 2)))


def test_bf16_moe_train_step_runs_on_cpu():
    """One bf16 DeepSeekMoE smoke train step through ``expert_mm``'s
    backward: a finite loss and gradient norm, bf16 parameters after the
    update."""
    from repro_torch.data import make_batch
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw_init
    from repro_torch.train import StepConfig, TrainState, make_train_step
    from repro_torch.util.tree import leaves_with_paths

    cfg = base.get_smoke_config("deepseek_moe_16b").replace(
        param_dtype="bfloat16")
    params = tf.init_params(cfg, 0, "cpu")
    step = make_train_step(cfg, StepConfig(peak_lr=1e-3, warmup=0), None)
    state, m = step(TrainState(params, adamw_init(params), None),
                    make_batch(cfg, 32, 2), 0)
    assert np.isfinite([float(m["loss"]), float(m["grad_norm"])]).all()
    assert float(m["grad_norm"]) > 0
    wi = [t for n, t in leaves_with_paths(state.params) if n.endswith("wi")]
    assert wi and all(t.dtype == torch.bfloat16 for t in wi)
