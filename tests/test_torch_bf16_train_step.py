"""The train step at bf16 against the reference's: ``make_train_step``
(microbatch accumulation in float32, the global-norm clip, AdamW's float32
master and moments, the parameters cast back to bf16, int8 error-feedback
compression) in both packages, under interp numerics bound to the default
library, the port's forward products and CE from XLA
(``tests/torch_bf16_parity.py`` ``train_steps``), three steps at one and
at two microbatches each on Yi-6B, DeepSeekMoE, Mamba2 and Jamba's smoke
configs at ``param_dtype="bfloat16"``: Jamba's two microbatches here,
its one in ``test_torch_bf16_train_step_hybrid.py``, DeepSeekMoE's in
``test_torch_bf16_train_step_moe.py``, Yi-6B's and Mamba2's in
``test_torch_bf16_train_step_dense_ssm.py`` (the reference's compiles of
a step are the longest of these tests, so they are spread over files).

Held per step (``hold_train_step``): the learning rate equal; the loss
bitwise at the first step; the aux loss within its mean's summation
order; the gradient norm, the moments, the master and the bf16 parameters
within what the gradients' own 2-ulp difference allows (AdamW's first
update is sign(g): where g lies within that difference of zero the sign
is a tie, and the master moves by up to 2 lr there; elsewhere the update
is the same to float32 roundings). Yi-6B and Mamba2 run on from their own
states; DeepSeekMoE and Jamba, whose sign ties move about 100 parameters
at the first step (the next steps' batches then meet other weights),
start each step from the reference's state, carried over by
``train_state_from_jax``: from the second step on, the router and the
SSM's float32 leaves are bf16, as the optimizer wrote them.
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
    """Jamba, two microbatches, three steps each from the reference's
    state (its sign ties move about 100 of 590,000 parameters at the
    first step)."""
    counts = bp.hold_train_step("jamba_v0_1_52b", 2, carry=True)
    record_property("params_differ", counts)
    assert len(counts) == 3
