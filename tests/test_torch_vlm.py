"""The VLM frontend (``internvl2_2b``) through the port's model stack and
serving engine on its smoke config (float32), reference parameters carried
over by ``params_from_jax``.

* ``_project_frontend`` alone (a float32 LayerNorm, ``numerics.gelu``, two
  products) against the reference's, under exact and interp-fused
  numerics (the port's plain versions against the reference's fused
  backend in interpret mode).
* Prefill with the 16 patch embeddings in place of the prompt's first rows,
  and without them, then three teacher-forced decodes: logits and caches
  (positions bitwise, K / V within 10x the logit bound) against the
  reference's.
* Patches for more rows than the prompt has: the reference fails, the port
  refuses with ``ValueError`` before any launch.
* The engine serves the config as a text decoder, as the reference's does:
  streams and counters of the fused tick and the serial oracle against the
  reference engine's, and an AOT engine's counters (no packed admission).
* The serve CLI.

Tolerances are ``tests/test_torch_families.py``'s: the reference's smoke
tolerance rtol = atol = 2e-2 and the port's own bound (2e-5 exact, 4 *
2^-12 * max|output| fused), with greedy tokens equal wherever the
reference's top-2 gap is clear of it.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import default_explorer
from repro.configs import base as jbase
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.serve import engine as jengine
from repro_torch.api.library import InterpLibrary
from repro_torch.configs import base
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import get_numerics
from repro_torch.serve import engine as tengine

ARCH = "internvl2_2b"
CACHE = 48
SMOKE_TOL = 2e-2  # tests/models/test_smoke.py
LENGTHS = (20, 5, 17, 11)
MAX_NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: waking the intra-op thread pool costs far more than
    the work (and the suite runs several workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _libs():
    return default_explorer().compile(), InterpLibrary.default_library("cpu")


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jbase.get_smoke_config(ARCH), base.get_smoke_config(ARCH)
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(0)
    patches = rng.standard_normal(
        (2, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                patches=patches)


def _numerics(name):
    jlib, lib = _libs()
    interp = name != "exact"
    return (jax_get_numerics(name, jlib if interp else None),
            get_numerics(name, lib if interp else None))


def _tol(name, ref):
    return 2e-5 if name == "exact" else 4 * 2.0 ** -12 * np.abs(ref).max()


def _close(got, want, tol):
    """Within the reference's smoke tolerance and the port's own bound;
    greedy tokens equal where the reference's top-2 gap is clear."""
    np.testing.assert_allclose(got, want, rtol=SMOKE_TOL, atol=SMOKE_TOL)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ref = want.reshape(-1, want.shape[-1])
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(
        ref.argmax(-1)[clear], got.reshape(ref.shape).argmax(-1)[clear])


def _assert_cache(tcache, jcache, tol):
    jk, jv, jpos = (np.asarray(t) for t in jcache["seg0"]["0"])
    np.testing.assert_array_equal(tcache.pos.numpy(), jpos)
    for got, want in ((tcache.k, jk), (tcache.v, jv)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=10 * tol)


@pytest.mark.parametrize("name", ["exact", "interp-fused"])
def test_project_frontend_matches_reference(name, setup):
    """The projector alone on (2, 16, 32) float32 patches: (2, 16, 64) in
    the patches' dtype."""
    s = setup
    jnum, tnum = _numerics(name)
    want = np.asarray(jtf._project_frontend(
        s["jparams"], jnp.asarray(s["patches"]), s["jcfg"], jnum))
    got = tf._project_frontend(s["params"], torch.from_numpy(s["patches"]),
                               s["cfg"], tnum)
    assert tuple(got.shape) == want.shape == (2, 16, 64)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, _tol(name, want))


@pytest.mark.parametrize("with_patches", [True, False])
@pytest.mark.parametrize("name", ["exact", "interp-fused"])
def test_prefill_and_decode_match_reference(name, with_patches, setup):
    """A 20-token prompt, its first 16 rows the projected patches (or the
    tokens alone), then three decodes teacher-forced with the reference's
    greedy tokens."""
    s = setup
    jnum, tnum = _numerics(name)
    toks = np.random.default_rng(1).integers(
        0, s["cfg"].vocab_size, (2, 20)).astype(np.int32)
    emb = s["patches"] if with_patches else None
    jlog, jcache, jcross = jtf.prefill(
        s["jparams"], jnp.asarray(toks), s["jcfg"], jnum, CACHE,
        frontend_emb=None if emb is None else jnp.asarray(emb))
    assert jcross is None
    tlog, tcache = tf.prefill(
        s["params"], torch.from_numpy(toks).long(), s["cfg"], tnum, CACHE,
        frontend_emb=None if emb is None else torch.from_numpy(emb))
    jlog = np.asarray(jlog)
    tol = _tol(name, jlog)
    _close(tlog.numpy(), jlog, tol)
    _assert_cache(tcache, jcache, tol)
    jdec = jax.jit(functools.partial(jtf.decode_step, cfg=s["jcfg"],
                                     numerics=jnum))
    pos = np.full(2, 20, np.int32)
    tok = jlog[:, 0].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jlog, jcache = jdec(s["jparams"], jnp.asarray(tok), jnp.asarray(pos),
                            jcache)
        tlog, tcache = tf.decode_step(s["params"],
                                      torch.from_numpy(tok).long(),
                                      torch.from_numpy(pos), tcache,
                                      s["cfg"], tnum)
        jlog = np.asarray(jlog)
        _close(tlog.numpy(), jlog, _tol(name, jlog))
        tok = jlog[:, 0].argmax(-1)[:, None].astype(np.int32)
        pos = pos + 1
    _assert_cache(tcache, jcache, tol)


def test_patches_move_the_logits(setup):
    """The patches take the first rows: prefill with them differs from
    prefill without them, and equals a prefill whose patch rows hold other
    token ids (the ids under the patches are never read)."""
    s = setup
    num = get_numerics("exact")
    toks = np.random.default_rng(2).integers(
        0, s["cfg"].vocab_size, (2, 20)).astype(np.int32)
    other = toks.copy()
    other[:, :16] = (other[:, :16] + 1) % s["cfg"].vocab_size
    emb = torch.from_numpy(s["patches"])
    run = functools.partial(tf.prefill, s["params"], cfg=s["cfg"],
                            numerics=num, cache_len=CACHE)
    with_p, _ = run(torch.from_numpy(toks).long(), frontend_emb=emb)
    without, _ = run(torch.from_numpy(toks).long())
    swapped, _ = run(torch.from_numpy(other).long(), frontend_emb=emb)
    assert not torch.allclose(with_p, without)
    assert torch.equal(with_p, swapped)


def test_patches_past_the_prompt_are_refused(setup):
    """16 patches for a 10-token prompt: the reference's concatenation
    gives 16 rows against 10 positions and fails; the port refuses with
    ``ValueError`` before it projects anything."""
    s = setup
    jnum, tnum = _numerics("exact")
    toks = np.zeros((2, 10), np.int32)
    with pytest.raises(Exception):
        jtf.prefill(s["jparams"], jnp.asarray(toks), s["jcfg"], jnum, CACHE,
                    frontend_emb=jnp.asarray(s["patches"]))

    class NoNumerics:
        def __getattr__(self, name):
            raise AssertionError(f"projected before the check: {name}")

    with pytest.raises(ValueError, match="16 patch embeddings for a "
                                         "10-token prompt"):
        tf.prefill(s["params"], torch.from_numpy(toks).long(), s["cfg"],
                   NoNumerics(), CACHE,
                   frontend_emb=torch.from_numpy(s["patches"]))


def _prompts(cfg, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in LENGTHS]


def _serve(mod, cfg, params, slots=2, **kw):
    if mod is tengine:
        kw.setdefault("device", "cpu")
    eng = mod.ServeEngine(cfg, params, slots=slots, cache_len=CACHE, **kw)
    for i, p in enumerate(_prompts(cfg)):
        eng.submit(mod.Request(i, p, max_new=MAX_NEW))
    return {r.rid: list(r.out) for r in eng.run()}, eng


@pytest.mark.parametrize("fused", [True, False])
def test_engines_match_reference(fused, setup):
    """Four prompts over two slots, exact numerics, served as a text
    decoder on the fused tick and on the serial oracle: streams and the
    reference's counters equal the reference engine's."""
    want, ref = _serve(jengine, setup["jcfg"], setup["jparams"], fused=fused)
    got, eng = _serve(tengine, setup["cfg"], setup["params"], fused=fused)
    assert got == want and set(got) == set(range(len(LENGTHS)))
    assert {k: eng.stats[k] for k in ref.stats} == ref.stats


def test_interp_fused_engine_matches_reference(setup):
    """The same on interp-fused numerics (the port's plain versions against
    the reference's interpret-mode kernels): streams equal."""
    cfg = setup["cfg"].replace(numerics="interp-fused")
    jcfg = setup["jcfg"].replace(numerics="interp")
    jlib, lib = _libs()
    want, _ = _serve(jengine, jcfg, setup["jparams"], library=jlib)
    got, _ = _serve(tengine, cfg, setup["params"], library=lib)
    assert got == want


def test_aot_engine_counters_equal_reference(setup):
    """``aot_buckets=True`` on a frontend config: no packed admission is
    prepared or used (the patches carry no per-row length), and the AOT
    counters equal the reference engine's."""
    want, ref = _serve(jengine, setup["jcfg"], setup["jparams"],
                       aot_buckets=True)
    got, eng = _serve(tengine, setup["cfg"], setup["params"],
                      aot_buckets=True)
    assert got == want
    keys = [k for k in ref.stats if k.startswith(("aot_", "packed_"))
            or k == "admit_dispatches"]
    assert keys and {k: eng.stats[k] for k in keys} == {
        k: ref.stats[k] for k in keys}
    assert eng.stats["packed_admits"] == 0 and not eng._packable


def test_prefill_padded_refused(setup):
    """As the reference: a bucketed prefill is refused for a frontend
    config."""
    with pytest.raises(ValueError, match="encoder/frontend"):
        tf.prefill_padded(setup["params"], torch.zeros((1, 8),
                                                       dtype=torch.int64),
                          [5], setup["cfg"], get_numerics("exact"), CACHE)


def test_serves_through_the_cli(capsys):
    """``python -m repro_torch.launch.serve --arch internvl2_2b --smoke
    --device cpu``: every request completes."""
    import json

    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
          "--max-new", "3", "--cache-len", "48", "--numerics",
          "interp-fused"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["tokens"] == 6 and out["failed"] == 0
