"""The bfloat16 path of the dense, MLA and VLM families against the
reference: ``yi_6b``, ``qwen1_5_110b`` (QKV bias), ``minitron_8b``
(squared ReLU), ``minicpm3_4b`` (MLA) and ``internvl2_2b`` (its patches
through the projector), on their smoke configs at
``param_dtype="bfloat16"``; and the test-side pieces of
``tests/torch_bf16_parity.py``: the reference's einsum shim and the
reference-order GEMM.

Held (``torch_bf16_parity.hold_family``): prefill of 16 tokens and three
decodes teacher-forced with the reference's tokens. Under interp-fused
numerics, with the port's bf16 GEMMs in the reference's accumulation
order, logits and caches are bitwise; as the port runs, Qwen1.5 and
Minitron are bitwise, while Yi-6B, MiniCPM3 and InternVL2 take one bf16
GEMM tie each (a float32 sum that lands on the other side of a bf16
rounding boundary: ``test_bf16_gemm_differences_are_summation_ties``) and
stay within one bf16 ulp of each step's largest |logit|. Under exact
numerics within twice the reference's own bf16-versus-float32 distance.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bf16_parity as bp

ARCHS = ["yi_6b", "qwen1_5_110b", "minitron_8b", "minicpm3_4b",
         "internvl2_2b"]
# as the port runs, a bf16 GEMM tie falls on these inputs
TIED = {"yi_6b", "minicpm3_4b", "internvl2_2b"}


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


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_bitwise_under_the_reference_gemm_order(arch):
    """Interp-fused prefill and decodes with the port's bf16 GEMMs in the
    reference's accumulation order: logits and every cache leaf bitwise."""
    bp.hold_family(arch, "interp-fused", "bitwise", gemm=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_interp_fused_matches_reference(arch):
    """As the port runs: bitwise, or within one bf16 ulp of each step's
    largest |logit| where a GEMM tie falls."""
    diffs = bp.hold_family(arch, "interp-fused",
                           "ulp" if arch in TIED else "bitwise")
    assert (max(diffs) > 0) == (arch in TIED)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_exact_within_the_reference_bf16_distance(arch):
    bp.hold_family(arch, "exact", "f32")


def test_bf16_gemm_differences_are_summation_ties():
    """The port's CPU bf16 x bf16 -> bf16 products against XLA's on the
    same operands at the smoke models' shapes: most elements equal, and
    every one that differs is one whose exact value lies within the
    float32 summation bound of the rounding boundary between the two."""
    rng = np.random.default_rng(0)
    differ = 0
    for m, k, n in [(32, 64, 256), (32, 64, 320), (2, 128, 64),
                    (32, 96, 512), (16, 64, 192)]:
        a = np.asarray(jnp.asarray(rng.standard_normal((4, m, k)),
                                   jnp.bfloat16), np.float32)
        b = np.asarray(jnp.asarray(rng.standard_normal((k, n)) / 8,
                                   jnp.bfloat16), np.float32)
        want = np.asarray(jax.jit(lambda x, y: x @ y)(
            jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)),
            np.float32)
        got = (torch.from_numpy(a).bfloat16()
               @ torch.from_numpy(b).bfloat16()).float().numpy()
        assert (got == want).mean() > 0.99
        assert bp.near_ties(a, b, got, want).all()
        differ += int((got != want).sum())
    assert differ > 0


def test_reference_gemm_takes_only_bf16_products():
    """Under ``ReferenceGemm`` a bf16 x bf16 product is XLA's, a float32
    one and every other call run as they are."""
    g = torch.Generator().manual_seed(1)
    a = torch.randn(3, 5, 64, generator=g).bfloat16()
    b = torch.randn(64, 7, generator=g).bfloat16()
    f = torch.randn(5, 64, generator=g)
    want = np.asarray(jnp.asarray(a.float().numpy(), jnp.bfloat16)
                      @ jnp.asarray(b.float().numpy(), jnp.bfloat16),
                      np.float32)
    with bp.ReferenceGemm() as mode:
        got = a @ b
        got32 = f @ b.float()
        got_mm = torch.matmul(a, b)
        summed = a.sum()
    assert mode.calls == 2 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got_mm, got)
    assert torch.equal(got32, f @ b.float()) and torch.equal(summed, a.sum())


def test_shim_is_jax_numpy_but_for_float32_preferred_einsums(monkeypatch):
    """Every name of the shim is ``jax.numpy``'s own object but
    ``einsum``; its einsum is bitwise ``jnp.einsum`` on float32 operands
    (with and without ``preferred_element_type``), and on bf16 operands
    asked for float32 it is the float32 einsum of the upcast operands; the
    patch sets ``jnp`` in the listed reference modules and nowhere else
    (``monkeypatch`` undoes it after each test)."""
    names = [n for n in dir(jnp) if not n.startswith("__")]
    assert "einsum" in names
    assert all(getattr(bp.SHIM, n) is getattr(jnp, n)
               for n in names if n != "einsum")
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 3, 64)), jnp.float32)
    y = jnp.asarray(rng.standard_normal((2, 64, 5)), jnp.float32)
    for kw in ({}, {"preferred_element_type": jnp.float32}):
        np.testing.assert_array_equal(
            np.asarray(bp.SHIM.einsum("bij,bjk->bik", x, y, **kw)),
            np.asarray(jnp.einsum("bij,bjk->bik", x, y, **kw)))
    xb, yb = x.astype(jnp.bfloat16), y.astype(jnp.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(bp.SHIM.einsum("bij,bjk->bik", xb, yb,
                                  preferred_element_type=jnp.float32)),
        np.asarray(jnp.einsum("bij,bjk->bik", xb.astype(jnp.float32),
                              yb.astype(jnp.float32),
                              preferred_element_type=jnp.float32)))
    assert bp.SHIM.einsum("bij,bjk->bik", xb, yb).dtype == jnp.bfloat16
    # the autouse fixture patched the modules: each reads the shim
    assert all(m.jnp is bp.SHIM for m in bp.REF_MODULES)
    import repro.models.layers as jl
    import repro.models.transformer as jtf
    assert jl.jnp is jnp and jtf.jnp is jnp
