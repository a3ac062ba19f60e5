"""The reference's per-architecture smoke checks (``tests/models/
test_smoke.py``) on the port, for all ten ``ARCH_IDS`` (reduced configs,
the reference's parameters carried over by ``params_from_jax``, batches
from ``make_batch``): the loss and its gradients finite (the loss within
rtol 2e-4 of the reference's), the forward's logits of shape (B, S, V)
and finite, and prefill's last logits within 2e-2 of the forward's with
three finite decode steps after it. Gradients are held leaf by leaf
against ``jax.grad`` of the reference's (within 2e-3 of each leaf's
largest magnitude) for all ten families, the aux loss at rtol 2e-4 (the
MoE families'; zero elsewhere). The bfloat16 train path is held in
``tests/test_torch_bf16_train_*.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.configs.base import get_config as jax_get_config
from repro.models.layers import count_params as jax_count_params
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import make_batch
from repro_torch.models import transformer as tf
from repro_torch.models.layers import count_params
from repro_torch.numerics.ops import get_numerics
from repro_torch.optim import global_norm
from repro_torch.train.step import batch_to, loss_and_grads
from repro_torch.util.tree import leaves_with_paths

SEQ, BATCH = 64, 2
GRAD_ARCHS = tuple(ARCH_IDS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch(request):
    jcfg = jax_smoke_config(request.param)
    cfg = get_smoke_config(request.param)
    jparams = jax.jit(jtf.init_params, static_argnums=1)(jax.random.key(0),
                                                         jcfg)
    batch = make_batch(cfg, SEQ, BATCH)
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, jparams=jparams,
                params=params_from_jax(jax.tree.map(np.asarray, jparams),
                                       cfg, "cpu"),
                batch=batch, tbatch=batch_to(batch, "cpu"))


def test_loss_and_grad(arch):
    cfg = arch["cfg"]
    loss, aux, grads = loss_and_grads(arch["params"], arch["tbatch"], cfg,
                                      get_numerics("exact"))
    assert np.isfinite(float(loss)) and float(loss) > 0, arch["name"]
    gnorm = float(global_norm(grads))
    assert np.isfinite(gnorm) and gnorm > 0, arch["name"]
    jn = jax_get_numerics("exact")
    jbatch = {k: jnp.asarray(v) for k, v in arch["batch"].items()}
    if arch["name"] not in GRAD_ARCHS:
        want = jax.jit(lambda p: jtf.loss_fn(p, jbatch, arch["jcfg"],
                                             jn)[0])(arch["jparams"])
        np.testing.assert_allclose(float(loss), float(want), rtol=2e-4)
        return
    (want, m), jg = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jbatch, arch["jcfg"], jn),
        has_aux=True))(arch["jparams"])
    np.testing.assert_allclose(float(loss), float(want), rtol=2e-4)
    np.testing.assert_allclose(float(aux), float(m["aux"]), rtol=2e-4)
    assert (float(aux) > 0) == (cfg.moe is not None)
    ref = dict(leaves_with_paths(jax.tree.map(np.asarray, jg)))
    for name, g in leaves_with_paths(grads):
        g, r = g.to(torch.float32).numpy(), ref[name].astype(np.float32)
        err, scale = np.abs(g - r).max(), np.abs(r).max()
        assert err <= 2e-3 * scale or err == 0, (name, err, scale)


def test_forward_logits_shape(arch):
    cfg, b = arch["cfg"], arch["tbatch"]
    with torch.no_grad():
        logits = tf.forward(arch["params"], b["tokens"], cfg,
                            get_numerics("exact"),
                            frontend_emb=b.get("frontend_emb"),
                            enc_frames=b.get("enc_frames"))
    assert tuple(logits.shape) == (BATCH, SEQ, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()


def test_prefill_decode_consistency(arch):
    """Prefill's last-position logits against the teacher-forced forward
    (the reference's 2e-2), then three greedy decode steps, finite and of
    shape (B, 1, V)."""
    cfg, p, b = arch["cfg"], arch["params"], arch["tbatch"]
    num = get_numerics("exact")
    with torch.no_grad():
        full = tf.forward(p, b["tokens"], cfg, num,
                          frontend_emb=b.get("frontend_emb"),
                          enc_frames=b.get("enc_frames"))
        cross = (tf.encoder_forward(p["encoder"], b["enc_frames"], cfg, num)
                 if cfg.encoder is not None else None)
        last, caches = tf.prefill(p, b["tokens"], cfg, num, SEQ + 8,
                                  frontend_emb=b.get("frontend_emb"),
                                  cross=cross)
        np.testing.assert_allclose(last[:, 0].float().numpy(),
                                   full[:, -1].float().numpy(), rtol=2e-2,
                                   atol=2e-2)
        tok = last.argmax(-1).to(torch.int32)
        for i in range(3):
            logits, caches = tf.decode_step(p, tok, SEQ + i, caches, cfg,
                                            num, cross=cross)
            assert tuple(logits.shape) == (BATCH, 1, cfg.vocab_size)
            assert torch.isfinite(logits.float()).all(), arch["name"]
            tok = logits.argmax(-1).to(torch.int32)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_shapes_and_count_at_full_width(arch):
    """``model_shapes`` names the reference's leaves with their shapes, and
    ``count_params`` counts what the reference's counts, at full width."""
    shapes = tf.model_shapes(get_config(arch))
    jshapes = jtf.model_shapes(jax_get_config(arch))
    got = leaves_with_paths(shapes)
    want = leaves_with_paths(jshapes)
    assert [(n, sp.shape) for n, sp in got] == \
        [(n, tuple(sp.shape)) for n, sp in want]
    assert count_params(shapes) == jax_count_params(jshapes) > 0
