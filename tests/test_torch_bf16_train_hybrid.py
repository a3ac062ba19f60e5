"""The bfloat16 train path of ``jamba_v0_1_52b`` against the reference: the
SSM / attention hybrid with MoE layers (eight smoke layers: one attention
layer, seven SSD mixers, four MoE FFNs), on its smoke config at
``param_dtype="bfloat16"``. Held as ``test_torch_bf16_train_moe.py``
says: the loss bitwise and every gradient within 2 bf16 ulps with the
forward products in XLA's order; the aux loss within its mean's
summation order; every flipped route a near tie, layer by layer; as the
port runs under exact numerics, with the reference's routes, within
twice the reference's own bf16 error of the reference (the unforced
figures recorded), but for the second SSD layer's ``a_log``: its port and
reference bf16 errors, -5.6e-4 and +4.3e-4 at one element, fall on
either side of the float32 gradient and add to 1.15 x twice the own
error, each within the accuracy form (``assert_independent_errors``).
Its own file: the reference's compile of this model is the longest of
the ten. Jamba's train step: ``test_torch_bf16_train_step.py`` and
``test_torch_bf16_train_step_hybrid.py``.
"""
from __future__ import annotations

import pytest
import torch

import torch_bf16_parity as bp

ARCH = "jamba_v0_1_52b"


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


def test_train_bitwise_under_the_reference_order(record_property):
    ulps = bp.hold_train_gemm(ARCH)
    record_property("max_grad_ulps", max(ulps.values()))


def test_route_flips_are_near_ties(record_property):
    """Five tokens flip over the four MoE layers (1, 2, 2, 0), each at a
    gap below that layer's probability difference."""
    flips = bp.assert_flips_are_ties(ARCH)
    record_property("flips", [(f["flipped"], f["gaps"].tolist(),
                               f["dprob"]) for f in flips])
    assert len(flips) == 4


def test_train_exact_within_the_reference_bf16_error(record_property):
    out = bp.hold_train_exact(ARCH)
    for k in ("acc", "own", "own_unforced"):
        record_property(f"max_{k}_ratio", max(out[k].values()))
    record_property("two_sided", out["two_sided"])
    assert set(out["two_sided"]) == {"segments/seg0/1/mixer/a_log"}
