"""The bfloat16 path of the SSM and encoder-decoder families against the
reference: ``mamba2_130m`` and ``whisper_tiny`` (its frames through the
encoder, the decoder reading them through ``cross``) on their smoke
configs at ``param_dtype="bfloat16"``, and ``jamba_v0_1_52b`` and
``mamba2_130m`` on prompts of 13 and 64 tokens (one partial, two whole
SSD chunks).

Held as ``tests/torch_bf16_parity.py`` says: under interp-fused numerics
bitwise with the port's bf16 GEMMs in the reference's accumulation order
(logits, bf16 and integer cache leaves; the float32 SSM state within its
own reassociation); as the port runs, bitwise where no GEMM tie falls,
else within one bf16 ulp of each step's largest |logit| (Mamba2 at 64
tokens), or, where a tie falls in an early layer of Jamba's eight, within
twice the reference's own bf16-versus-float32 distance (0.027 at 13
tokens, 0.020 at 64, against an ulp of 0.0156); under exact numerics
within that distance. Whisper is bitwise only against the reference
compiled with every bf16 rounding kept (``test_xla_excess_precision_alone
_moves_whisper``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_bf16_parity as bp

ARCHS = ["mamba2_130m", "whisper_tiny"]


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
    bp.hold_family(arch, "interp-fused", "bitwise", gemm=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_interp_fused_is_bitwise_the_reference(arch):
    bp.hold_family(arch, "interp-fused", "bitwise")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_exact_within_the_reference_bf16_distance(arch):
    bp.hold_family(arch, "exact", "f32")


@pytest.mark.parametrize("arch,n,bound", [
    ("jamba_v0_1_52b", 13, "f32"), ("jamba_v0_1_52b", 64, "f32"),
    ("mamba2_130m", 64, "ulp")])
@pytest.mark.parametrize("gemm", [True, False])
def test_bf16_ssm_prompts_where_a_gemm_tie_falls(arch, n, bound, gemm):
    """Bitwise under the reference's GEMM order; as the port runs, the tie
    moves the logits (by more than one bf16 ulp for Jamba, whose eight
    layers carry it on) within the stated bound."""
    diffs = bp.hold_family(arch, "interp-fused",
                           "bitwise" if gemm else bound, gemm=gemm, n=n)
    assert (max(diffs) > 0) != gemm


def test_xla_excess_precision_alone_moves_whisper():
    """The reference compiled with XLA's default excess precision (a bf16
    residual add fused into the LayerNorm that upcasts it, the rounding
    between them dropped) moves Whisper's logits off the same reference
    compiled with every rounding kept, which the port equals bitwise."""
    s = bp.bf16_pair("whisper_tiny")
    ins = bp.inputs("whisper_tiny")
    jnum, tnum = bp.numerics("interp-fused")
    kept, feed, _ = bp.reference("whisper_tiny", "interp-fused", None)
    fused, _, _ = bp.run_reference(s["jcfg"], s["jparams"], jnum, ins,
                                   feed=feed, compiler_options=None)
    got, _ = bp.run_port(s["cfg"], s["params"], tnum, ins, feed)
    moved = [float(np.abs(a - b).max()) for a, b in zip(kept, fused)]
    assert min(moved) > 0
    for g, w in zip(got, kept):
        np.testing.assert_array_equal(g.float().numpy(), w)
