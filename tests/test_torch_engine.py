"""The port's continuous-batching engine on the ``yi_6b`` (dense) and
``deepseek_moe_16b`` (MoE) smoke configs.

* Against the reference ``ServeEngine(fused=True)`` with interp numerics on
  the same parameters and library: token streams match, tie-aware. At the
  first divergence in a stream, the reference's own logits for that step
  (recomputed by an exact-length reference prefill over the prompt and the
  tokens before it) must show a top-2 gap inside the parity tolerance of
  ``test_torch_model.py`` (4 * 2^-12 * max|logit|, doubled for the
  recomputation); after it the streams are free to differ.
* Inside the port: continuous batching is invisible, bitwise, against
  serving each request alone in an engine of the same geometry.
* The typed rejections.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.serve.engine import Request as JaxRequest
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import Rejected, Request, ServeEngine

LENGTHS = (5, 11, 3, 8, 2)
MAX_NEW = 6
CACHE = 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["yi_6b", "deepseek_moe_16b"])
def setup(request):
    jcfg = jax_smoke_config(request.param).replace(numerics="interp")
    cfg = get_smoke_config(request.param).replace(numerics="interp-fused")
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in LENGTHS]
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jlib=default_explorer().compile(),
                lib=InterpLibrary.default_library("cpu"), prompts=prompts)


def _port_engine(s, slots=2, **kw):
    return ServeEngine(s["cfg"], s["params"], slots=slots, cache_len=CACHE,
                       library=s["lib"], horizon=8, device="cpu", **kw)


def _serve(eng, prompts, rids=None, req=Request):
    for i, p in zip(rids or range(len(prompts)), prompts):
        eng.submit(req(i, p, max_new=MAX_NEW))
    return {r.rid: list(r.out) for r in eng.run()}


def test_token_streams_match_reference_engine(setup):
    s = setup
    ref_eng = JaxEngine(s["jcfg"], s["jparams"], slots=2, cache_len=CACHE,
                        library=s["jlib"], fused=True, horizon=8)
    ref = _serve(ref_eng, s["prompts"], req=JaxRequest)
    got = _serve(_port_engine(s), s["prompts"])
    assert set(got) == set(ref) == set(range(len(LENGTHS)))
    jnum = jax_get_numerics(s["jcfg"], s["jlib"], fused=True)
    jpre = jax.jit(functools.partial(jtf.prefill, cfg=s["jcfg"],
                                     numerics=jnum, cache_len=CACHE))
    n_equal = 0
    for rid, prompt in enumerate(s["prompts"]):
        a, b = ref[rid], got[rid]
        assert len(a) == len(b) == MAX_NEW
        t = next((i for i in range(MAX_NEW) if a[i] != b[i]), None)
        if t is None:
            n_equal += 1
            continue
        seq = np.concatenate([prompt, np.asarray(a[:t], np.int32)])
        logits = np.asarray(jpre(s["jparams"], jnp.asarray(seq[None]))[0])
        logits = logits[0, -1]
        top2 = np.sort(logits)[-2:]
        tol = 2 * 4 * 2.0 ** -12 * np.abs(logits).max()
        assert top2[1] - top2[0] <= tol, (rid, t, top2, tol)
        assert {a[t], b[t]} <= set(np.argsort(logits)[-2:].tolist())
    assert n_equal >= len(LENGTHS) - 1


def test_continuous_batching_is_invisible_bitwise(setup):
    s = setup
    eng = _port_engine(s)
    batched = _serve(eng, s["prompts"])
    assert eng.stats["prefills"] == len(LENGTHS)
    assert eng.stats["decode_steps"] > 0 and eng.stats["ticks"] > 0
    assert eng.stats["launches"] == dict.fromkeys(eng.stats["launches"], 0)
    for rid, prompt in enumerate(s["prompts"]):
        solo = _serve(_port_engine(s), [prompt], rids=[rid])
        assert solo[rid] == batched[rid], f"request {rid} diverged"


def test_exact_numerics_engine_serves_without_library(setup):
    s = setup
    cfg = s["cfg"].replace(numerics="exact")
    eng = ServeEngine(cfg, s["params"], slots=2, cache_len=CACHE,
                      horizon=4, device="cpu")
    assert eng.library is None
    out = _serve(eng, s["prompts"][:3])
    assert all(len(v) == MAX_NEW for v in out.values())
    with pytest.raises(ValueError, match="never reads"):
        ServeEngine(cfg, s["params"], slots=1, cache_len=8,
                    library=s["lib"], device="cpu")


@pytest.mark.parametrize("reason", ["bad_prompt", "prompt_overflow",
                                    "decode_overflow", "queue_full"])
def test_rejections(reason, setup):
    s = setup
    eng = _port_engine(s, max_queue=1)
    ok = np.arange(4, dtype=np.int32)
    bad = {
        "bad_prompt": [Request(0, np.array([], np.int32), 2),
                       Request(1, np.array([3, 256], np.int32), 2),
                       Request(2, np.array([-1], np.int32), 2)],
        "prompt_overflow": [Request(0, np.zeros(CACHE + 1, np.int32), 1)],
        "decode_overflow": [Request(0, np.zeros(CACHE - 2, np.int32), 4)],
        "queue_full": [Request(0, ok, 2), Request(1, ok, 2)],
    }[reason]
    if reason == "queue_full":
        eng.submit(bad[0])
        bad = bad[1:]
    for r in bad:
        with pytest.raises(Rejected) as e:
            eng.submit(r)
        assert e.value.reason == reason
    assert eng.stats["rejected"] == len(bad)
    # the edge that fits: prompt + max_new - 1 == cache_len
    if reason == "decode_overflow":
        eng.submit(Request(9, np.zeros(CACHE - 3, np.int32), 4))
