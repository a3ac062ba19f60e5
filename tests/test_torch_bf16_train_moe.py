"""The bfloat16 train path of the MoE families against the reference:
``deepseek_moe_16b`` (shared experts, dense layer 0) and ``mixtral_8x22b``
(top-2, sliding window), on their smoke configs at
``param_dtype="bfloat16"``; Jamba, the MoE hybrid, in
``test_torch_bf16_train_hybrid.py``. Held as
``tests/test_torch_bf16_train_dense.py`` says (the loss bitwise and every
gradient within 2 bf16 ulps with the forward products in XLA's order; as
the port runs under exact numerics within twice the reference's own bf16
error), and:

* the MoE aux loss within the summation order of its mean router
  probability (``aux_order_bound``);
* route flips told from faults: under exact numerics, layer by layer with
  the earlier layers' routes forced to the reference's (a test-side hook
  on ``moe.route``; the reference's top-k ids from an ordered
  ``jax.debug.callback``), every token whose expert set flips lies at a
  near tie, its reference gap between the k-th and (k+1)-th probability
  within the layer's max |port - reference| router probability; the
  exact hold then runs with every layer routed as the reference routes,
  and the unforced figures are recorded;
* the router after an optimizer step: ``adamw_update`` writes every leaf
  back in the parameter dtype in both packages, so a trained state's
  router is bf16. The port refused such a state (``params_from_jax``) and
  its router product raised on a bf16 router; both repaired;
* DeepSeekMoE's train step: ``test_torch_bf16_train_step_moe.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_bf16_parity as bp

ARCHS = ["deepseek_moe_16b", "mixtral_8x22b"]


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
def test_route_flips_are_near_ties(arch, record_property):
    """DeepSeekMoE flips one token in each of its two MoE layers, at gaps of
    2.4e-4 and 7.8e-4 against probability differences of 3.2e-3 and
    4.3e-3; Mixtral's routes agree."""
    flips = bp.assert_flips_are_ties(arch)
    record_property("flips", [(f["flipped"], f["gaps"].tolist(),
                               f["dprob"]) for f in flips])
    assert len(flips) == sum(k.ffn == "moe" for *_, k in
                             bp.tf.layer_slots(bp.bf16_pair(arch)["cfg"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_exact_within_the_reference_bf16_error(arch, record_property):
    out = bp.hold_train_exact(arch)
    for k in ("acc", "own", "own_unforced"):
        record_property(f"max_{k}_ratio", max(out[k].values()))


def test_stepped_router_is_bf16_and_routes_as_the_reference():
    """After one AdamW step every leaf of the reference's state is bf16,
    the router too. The port takes that state (``params_from_jax`` refused
    the bf16 router) and its MoE layer on it (the router product raised:
    a float32 @ bf16 ``matmul``) is bitwise the reference's, which
    promotes the router to float32, under interp-fused numerics."""
    from repro.models import moe as jmoe
    from repro.optim.adamw import adamw_init, adamw_update
    from repro_torch.convert import params_from_jax
    from repro_torch.models import moe

    s = bp.bf16_pair("deepseek_moe_16b")
    jp = s["jparams"]
    grads = jax.tree.map(lambda t: jnp.full(t.shape, 1e-3, t.dtype), jp)
    stepped, _, _ = jax.jit(adamw_update)(grads, adamw_init(jp),
                                          jnp.float32(1e-3))
    # the first of seg1's two stacked MoE layers, in both trees
    jlayer = jax.tree.map(lambda t: t[0],
                          stepped["segments"]["seg1"]["0"]["ffn"])
    assert jlayer["router"].dtype == jnp.bfloat16
    params = params_from_jax(jax.tree.map(np.asarray, stepped), s["cfg"],
                             "cpu")
    layer = {n: t[0] for n, t in params["segments"]["seg1"]["0"][
        "ffn"].items()}
    assert layer["router"].dtype == torch.bfloat16
    x = np.random.default_rng(16).standard_normal((2, 16, s["cfg"].d_model))
    x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    jnum, tnum = bp.numerics("interp-fused")
    want = bp.ref_jit(jmoe.moe_block, cfg=s["jcfg"], numerics=jnum)(
        jlayer, jnp.asarray(x, jnp.bfloat16))
    got = moe.moe_block(layer, torch.from_numpy(x).bfloat16(), s["cfg"],
                        tnum)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))

