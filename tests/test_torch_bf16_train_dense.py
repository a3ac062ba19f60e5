"""The bfloat16 train path of the dense, MLA and VLM families against the
reference: ``yi_6b``, ``qwen1_5_110b`` (QKV bias), ``minitron_8b``
(squared ReLU), ``minicpm3_4b`` (MLA) and ``internvl2_2b`` (its patches
through the projector), on their smoke configs at
``param_dtype="bfloat16"`` (``tests/torch_bf16_parity.py``'s weights, a
``make_batch`` of 2 x 32 tokens), ``loss_fn`` differentiated by each
package (the reference's ``jax.value_and_grad``, compiled with every bf16
rounding kept):

* bitwise hold (``hold_train_gemm``): under interp numerics, with the
  port's forward bf16 x bf16 products and its CE from XLA (the backward
  is the port's own), the loss bitwise and every gradient leaf within 2
  bf16 ulps of its largest magnitude; Qwen1.5's QKV biases within that
  plus the reference's own bf16 sum of their cotangent over the 64 rows
  (``test_reduced_leaves_are_summed_in_bf16_by_the_reference``);
* as the port runs, under exact numerics (``hold_train_exact``): the loss
  and every gradient leaf within twice the reference's own bf16 error
  (its distance from its float32 run on the same bf16-valued weights) of
  the reference, and the port's own bf16 error within twice the
  reference's.

Yi-6B's train step is held in ``test_torch_bf16_train_step_dense_ssm.py``.
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


def test_reduced_leaves_are_summed_in_bf16_by_the_reference():
    """Why a QKV bias (and ``d_skip`` once a step has written it back in
    bf16) is held apart: added to (multiplied into) a bf16 activation by
    broadcast, its gradient is a sum of bf16 cotangents over the rows,
    which the reference's backward reduces in bf16 (the transpose of a
    bf16 broadcast: every addition rounds) and the port in float32, one
    rounding at the end. On seeded cotangents over Qwen1.5's 64 rows and
    Mamba2's 64 x 16 (bf16 products with the activation for ``d_skip``, in
    both packages): the port's gradient is the exact sum rounded once,
    the reference's is off it by more than one ulp somewhere, within
    (N - 1) 2^-8 sum |g_i| of it everywhere."""
    rng = np.random.default_rng(3)
    cases = (((2, 32, 32), (0, 1), lambda b: b),  # bias (n,)
             ((2, 32, 8, 16), (0, 1, 3),  # d_skip (H,)
              lambda b: b[None, None, :, None]))
    for shape, axes, view in cases:
        g, x = (np.asarray(jnp.asarray(rng.standard_normal(shape) * sc,
                                       jnp.bfloat16), np.float32)
                for sc in (1e-2, 1.0))
        bias = len(axes) == 2
        leaf = np.full(shape[-1] if bias else shape[2], 0.0 if bias else 1.0,
                       np.float32)
        # the cotangent rows reaching the leaf: bf16 products for d_skip
        rows = g if bias else np.asarray(jnp.asarray(g * x, jnp.bfloat16),
                                         np.float32)
        n_rows = g.size // leaf.size
        exact = rows.astype(np.float64).sum(axes)

        def jf(b):
            xb = jnp.asarray(x, jnp.bfloat16)
            y = xb + view(b) if bias else xb * view(b)
            return jnp.sum(y.astype(jnp.float32) * g)

        want = np.asarray(jax.jit(jax.grad(jf), compiler_options=bp.
                                  COMPILER_OPTIONS)(jnp.asarray(
                                      leaf, jnp.bfloat16)), np.float32)
        tb = torch.from_numpy(leaf).bfloat16().requires_grad_()
        xt = torch.from_numpy(x).bfloat16()
        y = xt + view(tb) if bias else xt * view(tb)
        (y.float() * torch.from_numpy(g)).sum().backward()
        got = tb.grad.float().numpy()
        once = np.asarray(jnp.asarray(exact, jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(got, once)
        ulp = np.array([bp.bf16_ulp(v) for v in np.abs(exact)])
        assert (np.abs(want - exact) > ulp).any()
        bound = (n_rows - 1) * 2.0 ** -8 * np.abs(rows).astype(
            np.float64).sum(axes)
        assert (np.abs(want - exact) <= bound).all()
