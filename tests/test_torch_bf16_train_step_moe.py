"""The bf16 train step of DeepSeekMoE against the reference's, held as
``test_torch_bf16_train_step.py`` says: at one and two microbatches,
three steps each from the reference's state (the first step's sign ties
move about 100 bf16 parameters), so that the second and third steps run
on the bf16 router the first wrote; the aux loss within its mean's
summation order at either count. Jamba's step, the other MoE family's,
is in ``test_torch_bf16_train_step.py``.
"""
from __future__ import annotations

import pytest
import torch

import torch_bf16_parity as bp


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


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches, record_property):
    counts = bp.hold_train_step("deepseek_moe_16b", microbatches, carry=True)
    record_property("params_differ", counts)
    assert len(counts) == 3
