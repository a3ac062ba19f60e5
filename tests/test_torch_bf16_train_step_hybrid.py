"""The bf16 train step of Jamba at one microbatch against the
reference's, held as ``test_torch_bf16_train_step.py`` says (its two
microbatch run is there): three steps each from the reference's state,
so that the second and third run on the bf16 router and SSM leaves the
first wrote; the aux loss within its mean's summation order.
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


def test_train_step_matches_reference(record_property):
    counts = bp.hold_train_step("jamba_v0_1_52b", 1, carry=True)
    record_property("params_differ", counts)
    assert len(counts) == 3
