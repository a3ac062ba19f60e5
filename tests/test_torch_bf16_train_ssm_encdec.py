"""The bfloat16 train path of the SSM and encoder-decoder families against
the reference: ``mamba2_130m`` (the SSD mixer, whose ``a_log``,
``dt_bias`` and ``d_skip`` are float32 leaves fed by bf16 activations)
and ``whisper_tiny`` (its frames through the encoder, the decoder reading
them through cross attention; LayerNorm, learned positions), on their
smoke configs at ``param_dtype="bfloat16"``; Jamba, the SSM / attention
/ MoE hybrid, in ``test_torch_bf16_train_hybrid.py``. Held as
``tests/test_torch_bf16_train_dense.py`` says: the loss bitwise and every
gradient leaf within 2 bf16 ulps of its largest magnitude (the float32
SSM leaves too) with the port's forward products and CE from XLA; as the
port runs under exact numerics, within twice the reference's own bf16
error of the reference. Inside the port at bf16, remat none, block and
full bitwise on Yi-6B, DeepSeekMoE, Mamba2 and Jamba. Mamba2's train
step is held in ``test_torch_bf16_train_step_dense_ssm.py``.
"""
from __future__ import annotations

import pytest
import torch

import torch_bf16_parity as bp
from repro_torch.train.step import batch_to, loss_and_grads
from repro_torch.util.tree import leaves_with_paths

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
def test_train_bitwise_under_the_reference_order(arch, record_property):
    ulps = bp.hold_train_gemm(arch)
    record_property("max_grad_ulps", max(ulps.values()))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_exact_within_the_reference_bf16_error(arch, record_property):
    out = bp.hold_train_exact(arch)
    record_property("max_accuracy_ratio", max(out["acc"].values()))
    record_property("max_own_ratio", max(out["own"].values()))



@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b",
                                  "mamba2_130m", "jamba_v0_1_52b"])
def test_remat_policies_bitwise_at_bf16(arch):
    """none, block (matmul outputs saved) and full recomputation give the
    same bf16 loss and gradients, bit for bit, as the port runs on the
    card's dtype under exact numerics."""
    s = bp.bf16_pair(arch)
    batch = batch_to(bp.train_batch(arch), "cpu")
    num = bp.numerics("exact")[1]
    out = {r: loss_and_grads(s["params"], batch, s["cfg"].replace(remat=r),
                             num) for r in ("none", "block", "full")}
    for r in ("block", "full"):
        assert torch.equal(out[r][0], out["none"][0])
        assert torch.equal(out[r][1], out["none"][1])
        for (n, a), (_, b) in zip(leaves_with_paths(out[r][2]),
                                  leaves_with_paths(out["none"][2])):
            assert a.dtype == b.dtype and torch.equal(a, b), (r, n)
