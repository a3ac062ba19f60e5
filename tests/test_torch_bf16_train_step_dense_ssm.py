"""The bf16 train step of Yi-6B and Mamba2 against the reference's, held as
``test_torch_bf16_train_step.py`` says: at one and two microbatches,
three steps each on the port's own state (Yi-6B's bf16 parameters
bitwise the reference's after every step; Mamba2's after the first, its
``a_log``, ``dt_bias`` and ``d_skip`` bf16 from the second on, as the
optimizer wrote them); and one step with int8 error-feedback compression.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
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
def test_yi_train_step_matches_reference(microbatches, record_property):
    counts = bp.hold_train_step("yi_6b", microbatches, carry=False)
    record_property("params_differ", counts)
    assert counts == [0, 0, 0]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_mamba2_train_step_matches_reference(microbatches, record_property):
    counts = bp.hold_train_step("mamba2_130m", microbatches, carry=False)
    record_property("params_differ", counts)
    assert len(counts) == 3 and counts[0] == 0


def test_compress_step_payload_and_residual():
    """One step with ``compress_pods`` from the same state, held as every
    step (``assert_step``), its parameters bitwise; the error-feedback
    residual within the gradients' own difference; and both packages'
    ``compress_grads`` on their own bf16 gradients (the bitwise hold's):
    the int8 payload bitwise except where a gradient lies within that
    difference of a boundary of the int8 grid (one step apart there), the
    scales within a bf16 rounding, the residuals within the difference."""
    from repro.optim.compress import compress_grads as jcompress
    from repro_torch.optim.compress import compress_grads

    arch = "yi_6b"
    out = next(bp.train_steps(arch, 1, 1, compress=True))
    assert bp.assert_step(bp.bf16_pair(arch)["cfg"], 1, *out) == 0
    _k, _before, jstate, jm, _pbefore, state, _m, _sink = out
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    want = bp.ref_train(arch, "interp")
    got = bp.port_train(arch, "interp", gemm=True)
    r_p, r_r = bp.named(state.residual), bp.named(jstate.residual)
    jq, js, jr = jcompress(
        {n: jnp.asarray(g) for n, g in want["grads"].items()},
        {n: jnp.zeros(g.shape) for n, g in want["grads"].items()})
    q, sc, r = compress_grads(
        {n: torch.from_numpy(g) for n, g in got["grads"].items()},
        {n: torch.zeros(g.shape) for n, g in got["grads"].items()})
    ties = 0
    for name, g in want["grads"].items():
        top = float(np.abs(g).max())
        big = 2 * bp.bf16_ulp(top) if top else 0.0
        assert (np.abs(r_p[name] - r_r[name]) <= clip * big
                + 2.0 ** -22 * np.abs(r_r[name])).all(), name
        scale = float(js[name])
        np.testing.assert_allclose(float(sc[name]), scale, rtol=2.0 ** -8)
        qp, qr = q[name].numpy(), np.asarray(jq[name])
        off = qp != qr
        if off.any():
            edge = np.abs(g / scale - np.floor(g / scale) - 0.5) * scale
            assert (np.abs(qp.astype(int) - qr)[off] == 1).all(), name
            assert (edge[off] <= big).all(), name
            ties += int(off.sum())
        assert (np.abs(r[name].numpy() - np.asarray(jr[name]))
                <= big + 2.0 ** -22 * np.abs(np.asarray(jr[name]))).all()
    assert ties <= 1e-3 * sum(g.size for g in want["grads"].values())
