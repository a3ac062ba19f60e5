"""Per-layer numerics plans in the port against the reference
(``repro.plan``, ``tests/plan/test_schema.py``, ``tests/plan/test_assign.py``,
``tests/serve/test_plan_engine.py``), on the ``yi_6b`` smoke config.

* Schema: every case of the reference's schema test runs on both packages
  (one parametrised case each); plan snapshots written by either package
  load in the other.
* Numerics: prefill logits under a mixed plan (a two-slot plan, and one
  that mixes exact, interp, interp-fused and interp-guarded sites) against
  the reference's under the same plan and parameters, within
  4 * 2^-12 * max|logit| (a few table-code flips, as
  ``tests/test_torch_model.py``); the slot libraries compile to the
  reference's ROM bytes (``rom_sha``). Inside the port, bitwise: a uniform
  plan is the homogeneous backend (logits, and an engine's streams and
  final caches).
* ``auto_plan``: on the committed frontiers the port's plan and
  ``PlanReport.to_dict()`` equal the reference's exactly (the scores are
  modeled: bit-reproducible floats); ``verify=True`` meets its budget, and
  flips the reference's sites wherever the reference's measured error is
  clear of the budget by more than the logit tolerance.
* Plan engines (both packages, same faults): a poisoned slot moves only
  its layers to exact and the engine stays fused; the serial rung guards
  every interp site. Fault logs, the reference's stats and the failed
  requests agree; token streams tie-aware.
"""
from __future__ import annotations

import functools
import json

import jax
import numpy as np
import pytest
import torch

import repro.faults as jfaults
import repro.plan as jplan
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import transformer as jtf
from repro.numerics.ops import get_numerics as jax_get_numerics
from repro.plan.assign import auto_plan as jax_auto_plan
from repro.serve import engine as jengine
import repro_torch.plan as plan_mod
from repro_torch import faults
from repro_torch.api.library import InterpLibrary
from repro_torch.configs.base import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.numerics.ops import (ExactNumerics, FusedInterpNumerics,
                                      get_numerics)
from repro_torch.plan import LayerAssign, NumericsPlan, SiteAssign
from repro_torch.plan.assign import auto_plan
from repro_torch.plan.numerics import (PlanNumerics, SiteNumerics,
                                       compile_plan_libraries)
from repro_torch.serve.engine import Request, ServeEngine

MAX_NEW = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ schema

def _mixed_plan(P, n=4):
    """The reference test's plan: layer 0 fully interp-fused on R5; layer 1
    softmax-only interp on the default slot; the rest exact; ``rest``
    reads R5 through its act site."""
    r5 = P.SlotSpec(lookup_bits=5)
    layers = [P.LayerAssign(P.SiteAssign("interp-fused", r5),
                            P.SiteAssign("interp-fused", r5),
                            P.SiteAssign("interp-fused", r5)),
              P.LayerAssign(softmax=P.SiteAssign("interp"))]
    layers += [P.LayerAssign()] * (n - 2)
    return P.NumericsPlan(layers=tuple(layers), rest=P.LayerAssign(
        act=P.SiteAssign("interp-guarded", r5)))


def _case_slot_key_canonicalization(P, smoke, tmp):
    S = P.SlotSpec
    assert S().key == "default"
    assert S(lookup_bits=6).key == "R6"
    assert S(lookup_bits=6, degree=2).key == "R6.d2"
    assert S(lookup_bits=6, degree=2, segmentation="hier").key == \
        "R6.d2.hier"
    assert S(segmentation="hier").key == "hier"
    assert S(lookup_bits=6).table_kwargs() == {"lookup_bits": 6}


def _case_invalid_names_refused(P, smoke, tmp):
    with pytest.raises(ValueError, match="backend"):
        P.SiteAssign("fp8")
    with pytest.raises(ValueError, match="segmentation"):
        P.SlotSpec(segmentation="octree")


def _case_uniform_plan_collapses(P, smoke, tmp):
    plan = P.NumericsPlan.uniform("interp-fused", 3)
    assert plan.n_layers == 3 and plan.uses_interp
    assert plan.slot_keys() == ("default",)
    for la in plan.layers + (plan.rest,):
        assert la.uniform_backend == "interp-fused"
    exact = P.NumericsPlan.uniform("exact", 3)
    assert not exact.uses_interp and exact.slot_keys() == ()


def _case_mixed_layer_has_no_uniform_backend(P, smoke, tmp):
    assert P.LayerAssign(softmax=P.SiteAssign("interp")).uniform_backend \
        is None
    la2 = P.LayerAssign(P.SiteAssign("interp", P.SlotSpec(lookup_bits=5)),
                        P.SiteAssign("interp"), P.SiteAssign("interp"))
    assert la2.uniform_backend is None


def _case_plan_is_hashable_and_config_embeddable(P, smoke, tmp):
    plan = _mixed_plan(P)
    assert hash(plan) == hash(_mixed_plan(P))
    cfg = smoke("yi_6b").replace(plan=plan)
    assert hash(cfg) != hash(smoke("yi_6b"))
    assert cfg.replace(plan=plan) == cfg


def _case_round_trip_dict(P, smoke, tmp):
    plan = _mixed_plan(P)
    assert P.NumericsPlan.from_dict(plan.to_dict()) == plan


def _case_snapshot_envelope_round_trip(P, smoke, tmp):
    plan = _mixed_plan(P)
    path = tmp / "plan.json"
    P.save_plan(path, plan, seed=3, meta_extra={"arch": "yi_6b"})
    assert P.load_plan(path) == plan


def _case_newer_schema_refused(P, smoke, tmp):
    doc = _mixed_plan(P).to_dict()
    doc["plan_schema"] = P.PLAN_SCHEMA + 1
    with pytest.raises(ValueError, match="newer"):
        P.NumericsPlan.from_dict(doc)


def _case_slot_bookkeeping(P, smoke, tmp):
    plan = _mixed_plan(P)
    assert plan.slot_keys() == ("R5", "default")
    assert plan.layers_using_slot("R5") == (0, "rest")
    assert plan.layers_using_slot("default") == (1,)
    assert plan.layers_using_slot("R9") == ()


def _case_degrade_serial_guards_every_interp_site(P, smoke, tmp):
    plan = _mixed_plan(P).degrade_serial()
    for _label, _site, a in plan.assignments():
        assert a.backend in ("exact", "interp-guarded")
    assert plan.rest.act.backend == "interp-guarded"
    assert plan.layers[2].softmax.backend == "exact"


def _case_degrade_exact_kills_all_interp(P, smoke, tmp):
    plan = _mixed_plan(P).degrade_exact()
    assert not plan.uses_interp
    assert plan.layers[0].softmax.slot == P.SlotSpec(lookup_bits=5)


def _case_degrade_layers_is_surgical(P, smoke, tmp):
    plan = _mixed_plan(P)
    down = plan.degrade_layers([0, "rest"], ["R5"])
    assert down.layers[0].uniform_backend == "exact"
    assert down.rest.act.backend == "exact"
    assert down.layers[1].softmax.backend == "interp"
    assert plan.degrade_layers([1], ["R5"]) == plan


def _case_plan_for_matches_config_numerics(P, smoke, tmp):
    cfg = smoke("yi_6b").replace(numerics="interp")
    plan = P.plan_for(cfg)
    assert plan == P.NumericsPlan.uniform("interp", cfg.n_layers)
    assert set(s for _, s, _ in plan.assignments()) == set(P.SITES)


SCHEMA_CASES = {n[len("_case_"):]: f for n, f in dict(globals()).items()
                if n.startswith("_case_")}
PACKAGES = {"port": (plan_mod, get_smoke_config),
            "reference": (jplan, jax_smoke_config)}


def test_schema_cases_cover_the_reference_test():
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).parent / "plan" / "test_schema.py")
    spec = importlib.util.spec_from_file_location("_ref_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref = {n[len("test_"):] for n in dir(mod) if n.startswith("test_")}
    assert ref == set(SCHEMA_CASES)


@pytest.mark.parametrize("case", sorted(SCHEMA_CASES))
def test_schema_case(case, tmp_path):
    """The reference's schema test, case by case, on the port (and on the
    reference beside it, so both packages hold the same semantics)."""
    for name, (P, smoke) in PACKAGES.items():
        (tmp_path / name).mkdir()
        SCHEMA_CASES[case](P, smoke, tmp_path / name)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_plan_snapshot_loads_in_the_other_package(writer, tmp_path):
    """A plan snapshot written by either package loads in the other, equal
    as a dict; the envelope carries each writer's own meta."""
    path = tmp_path / "plan.json"
    src, dst = (plan_mod, jplan) if writer == "port" else (jplan, plan_mod)
    plan = _mixed_plan(src)
    src.save_plan(path, plan, seed=1, meta_extra={"arch": "yi_6b"})
    got = dst.load_plan(path)
    assert got.to_dict() == plan.to_dict()
    assert got == _mixed_plan(dst)
    meta = json.loads(path.read_text())["meta"]
    assert ("torch" in meta) == (writer == "port")
    assert meta["seed"] == 1 and meta["arch"] == "yi_6b"


def test_config_carries_a_plan_and_stays_hashable():
    cfg = get_smoke_config("yi_6b")
    plan = NumericsPlan.uniform("interp-fused", cfg.n_layers)
    with_plan = cfg.replace(plan=plan)
    assert {with_plan: 1}[cfg.replace(plan=plan)] == 1
    assert with_plan != cfg and cfg.plan is None


# ----------------------------------------------------------------- numerics

@functools.lru_cache(maxsize=None)
def _model():
    jcfg = jax_smoke_config("yi_6b")
    jparams = jtf.init_params(jax.random.key(0), jcfg)
    cfg = get_smoke_config("yi_6b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _two_slot_plan(P, n_layers):
    """Layer 0 interp-fused on its own R5 slot; every other layer and
    ``rest`` interp-fused on the default slot."""
    r5 = P.SlotSpec(lookup_bits=5)
    first = P.LayerAssign(P.SiteAssign("interp-fused", r5),
                          P.SiteAssign("interp-fused", r5),
                          P.SiteAssign("interp-fused", r5))
    rest = P.LayerAssign(P.SiteAssign("interp-fused"),
                         P.SiteAssign("interp-fused"),
                         P.SiteAssign("interp-fused"))
    return P.NumericsPlan(layers=(first,) + (rest,) * (n_layers - 1),
                          rest=rest)


def _site_mix_plan(P, n_layers):
    """Every backend on some site: layer 0 exact softmax, interp rmsnorm
    and interp-fused act on R5; the other layers interp-guarded softmax
    and interp-fused elsewhere; ``rest`` interp-fused."""
    r5 = P.SlotSpec(lookup_bits=5)
    first = P.LayerAssign(P.SiteAssign("exact"),
                          P.SiteAssign("interp", r5),
                          P.SiteAssign("interp-fused", r5))
    other = P.LayerAssign(P.SiteAssign("interp-guarded"),
                          P.SiteAssign("interp-fused"),
                          P.SiteAssign("interp-fused"))
    return P.NumericsPlan(layers=(first,) + (other,) * (n_layers - 1),
                          rest=P.LayerAssign(
                              *(P.SiteAssign("interp-fused"),) * 3))


@functools.lru_cache(maxsize=None)
def _libraries(plan_name: str):
    """Both packages' slot libraries of a plan (the reference's through its
    default session, the port's through ``compile_plan_libraries``)."""
    jcfg, _, cfg, _ = _model()
    make = {"two_slot": _two_slot_plan, "site_mix": _site_mix_plan}[plan_name]
    jp, p = make(jplan, jcfg.n_layers), make(plan_mod, cfg.n_layers)
    from repro.plan.numerics import compile_plan_libraries as jcompile

    return jp, p, jcompile(jp), compile_plan_libraries(p, device="cpu")


@pytest.mark.parametrize("plan_name", ["two_slot", "site_mix"])
def test_mixed_plan_prefill_matches_reference(plan_name):
    """Prefill logits of the smoke model under a mixed plan against the
    reference's under the same plan and parameters (4 * 2^-12 * max|logit|,
    greedy tokens equal where the reference's top-2 gap clears twice
    that); every slot library is the reference's ROM."""
    jcfg, jparams, cfg, params = _model()
    jp, p, jlibs, libs = _libraries(plan_name)
    assert sorted(libs) == sorted(jlibs)
    for key in libs:
        assert libs[key].rom_sha() == jlibs[key].rom_sha(), key
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jc = jcfg.replace(plan=jp)
    want, _, _ = jtf.prefill(jparams, tokens, jc,
                             jax_get_numerics(jc, jlibs), 16)
    want = np.asarray(want)
    c = cfg.replace(plan=p)
    num = get_numerics(c, libs)
    assert isinstance(num, PlanNumerics)
    with torch.inference_mode():
        got, _ = tf.prefill(params, torch.as_tensor(tokens, dtype=torch.int64),
                            c, num, 16)
    got = got.numpy()
    tol = 4 * 2.0 ** -12 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    ref = want.reshape(-1, want.shape[-1])
    top2 = np.sort(ref, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * tol
    np.testing.assert_array_equal(ref.argmax(-1)[clear],
                                  got.reshape(ref.shape).argmax(-1)[clear])


def test_plan_resolution_interns_and_routes():
    """Layers with equal assignments share one backend; a collapsed layer
    is the homogeneous backend itself; a mixed layer routes each op
    family to its site; a softmax site without fused attention sends the
    attention to the glue path (None)."""
    _, _, cfg, _ = _model()
    _, p, _, libs = _libraries("site_mix")
    num = PlanNumerics(p, libs)
    first = num.for_layer(0)
    assert isinstance(first, SiteNumerics)
    assert isinstance(first.softmax_backend, ExactNumerics)
    assert first.fused_attention(None, None, None, None, None, causal=True,
                                 window=None, scale=None) is None
    assert num.for_layer(1) is num.for_layer(cfg.n_layers - 1)
    assert isinstance(num.rmsnorm.__self__, FusedInterpNumerics)  # rest
    uni = PlanNumerics(NumericsPlan.uniform("interp-fused", cfg.n_layers),
                       {"default": libs["default"]})
    assert uni.for_layer(0) is uni.for_layer(1)
    assert type(uni.for_layer(0)) is FusedInterpNumerics
    assert uni.for_layer(0).library is libs["default"]


def test_decode_reads_host_decides_per_layer():
    """The host-read test asks every layer's softmax site: a plan that puts
    one layer's softmax on exact takes the glue path in that layer, whose
    chunk liveness test reads the host once a call has 8 key chunks; the
    all-fused plan does not (its attention takes up to 4096 keys). At the
    decode's own chunk (``min(4096, cache_len)``) the two agree at every
    cache length: a glue call over at most 4096 keys is one chunk."""
    _, _, cfg, _ = _model()
    lib = InterpLibrary.default_library("cpu")
    fused = NumericsPlan.uniform("interp-fused", cfg.n_layers)
    one_exact = NumericsPlan(
        layers=(LayerAssign(SiteAssign("exact"),
                            SiteAssign("interp-fused"),
                            SiteAssign("interp-fused")),)
        + fused.layers[1:], rest=fused.rest)
    for plan, glue in ((fused, False), (one_exact, True)):
        num = PlanNumerics(plan, {"default": lib})
        assert attn.attention_reads_host(4096, 512, num) is glue
        assert attn.attention_reads_host(4096, 1024, num) is False
        assert attn.decode_reads_host(4096, num) is False
        assert attn.decode_reads_host(16384, num) is False  # 4 chunks
        assert attn.decode_reads_host(32768, num) is True  # past 4096 keys
        # a prefill's key chunk is 1024: 8192 keys read the host on the
        # glue path, which every layer takes past 4096 keys
        assert attn.prefill_reads_host(8192, num) is True
        assert attn.prefill_reads_host(4096, num) is False
        # 5003 keys (a prime) divide only into one-key chunks on the glue
        # path, which every layer takes past 4096 keys: a host read
        assert attn.decode_reads_host(5003, num) is True


def test_uniform_plan_is_the_homogeneous_backend_bitwise():
    """Inside the port: prefill logits and caches under the uniform
    interp-fused plan, and a plan engine's streams and final caches,
    bitwise the homogeneous interp-fused ones."""
    _, _, cfg, params = _model()
    lib = InterpLibrary.default_library("cpu")
    pc = cfg.replace(plan=NumericsPlan.uniform("interp-fused", cfg.n_layers))
    hc = cfg.replace(numerics="interp-fused")
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 9)), dtype=torch.int64)
    with torch.inference_mode():
        a, ca = tf.prefill(params, tokens, pc, get_numerics(pc, {
            "default": lib}), 16)
        b, cb = tf.prefill(params, tokens, hc, get_numerics(hc, lib), 16)
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(ca, cb))
    outs = {}
    for name, c, library in (("plan", pc, {"default": lib}),
                             ("homogeneous", hc, lib)):
        eng = ServeEngine(c, params, slots=2, cache_len=48, library=library,
                          device="cpu")
        for i, pr in enumerate(_prompts(cfg, (5, 11, 3))):
            eng.submit(Request(i, pr, max_new=MAX_NEW))
        outs[name] = ({r.rid: r.out for r in eng.run()}, eng.caches)
    assert outs["plan"][0] == outs["homogeneous"][0]
    assert all(torch.equal(x, y) for x, y in
               zip(outs["plan"][1], outs["homogeneous"][1]))


def test_get_numerics_compiles_plan_slots_on_the_device():
    """``get_numerics`` resolves a config carrying a plan (compiling the
    slot libraries on the device asked for) instead of refusing it."""
    _, _, cfg, _ = _model()
    c = cfg.replace(plan=_two_slot_plan(plan_mod, cfg.n_layers))
    num = get_numerics(c, device="cpu")
    assert sorted(num.libraries) == ["R5", "default"]
    assert all(v.device == torch.device("cpu")
               for v in num.libraries.values())


# -------------------------------------------------------------- auto_plan

@pytest.mark.parametrize("budget", [0.05, 1.0, 0.0, 0.01])
def test_auto_plan_equals_the_reference(budget):
    """On the committed frontiers (``artifacts/dse/FRONTIER_{8,6}.json``)
    the port's plan and full report equal the reference's (modeled
    scores: the same float arithmetic)."""
    got = auto_plan(get_smoke_config("yi_6b"), error_budget=budget,
                    verify=False)
    want = jax_auto_plan(jax_smoke_config("yi_6b"), error_budget=budget,
                         verify=False)
    assert got.to_dict() == want.to_dict()
    assert got.plan.to_dict() == want.plan.to_dict()


def test_assign_helpers_equal_the_reference():
    from repro.plan import assign as ja
    from repro_torch.plan import assign as pa

    assert pa.site_errors() == ja.site_errors()
    assert pa.load_frontier_candidates() == ja.load_frontier_candidates()
    assert pa.DEFAULT_FRONTIERS[0].relative_to(pa._REPO) == \
        ja.DEFAULT_FRONTIERS[0].relative_to(ja._REPO)
    cfg = get_smoke_config("yi_6b")
    rep = auto_plan(cfg, error_budget=0.05, verify=False)
    plan = rep.plan
    jplan_ = jplan.NumericsPlan.from_dict(plan.to_dict())
    assert pa.predicted_error(plan, pa.site_errors()) == \
        ja.predicted_error(jplan_, ja.site_errors())
    for h in (1, 4, 8):
        assert pa.modeled_tokens_per_s(plan, rep.slot_delays, horizon=h) \
            == ja.modeled_tokens_per_s(jplan_, rep.slot_delays, horizon=h)


def test_auto_plan_verified_meets_budget_like_the_reference():
    """``verify=True`` on the reference's parameters: the measured
    prefill-logit error fits the budget, interp sites remain, and the
    measured errors of the two packages agree within the logit tolerance
    (so the flips agree wherever the reference's error is clear of the
    budget by more than that)."""
    jcfg, jparams, cfg, params = _model()
    budget = 0.05
    got = auto_plan(cfg, error_budget=budget, verify=True, params=params,
                    device="cpu")
    want = jax_auto_plan(jcfg, error_budget=budget, verify=True,
                         params=jparams)
    assert got.measured_error is not None
    assert got.measured_error <= got.error_budget
    assert got.predicted_error <= got.error_budget
    assert got.plan.uses_interp and got.speedup > 1.0
    tol = 4 * 2.0 ** -12
    assert abs(got.measured_error - want.measured_error) <= 2 * tol
    if abs(want.measured_error - budget) > 2 * tol:
        assert got.plan.to_dict() == want.plan.to_dict()
        assert got.flipped == want.flipped


# ---------------------------------------------------------- plan engines

def _prompts(cfg, lengths, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]


def _engines(plan_name="two_slot", **kw):
    """(reference engine, port engine) on the same plan, parameters and
    slot libraries (fresh dicts: the engines replace entries)."""
    jcfg, jparams, cfg, params = _model()
    jp, p, jlibs, libs = _libraries(plan_name)
    kw.setdefault("slots", 2)
    kw.setdefault("cache_len", 48)
    ref = jengine.ServeEngine(jcfg.replace(plan=jp), jparams,
                              library=dict(jlibs), **kw)
    port = ServeEngine(cfg.replace(plan=p), params, library=dict(libs),
                       device="cpu", **kw)
    return ref, port


def _same_engines(ref, port):
    assert port.faults == ref.faults
    assert {k: port.stats[k] for k in ref.stats} == ref.stats
    assert sorted((r.rid, r.error) for r in port.failed) == \
        sorted((r.rid, r.error) for r in ref.failed)
    assert sorted(r.rid for r in port.finished) == \
        sorted(r.rid for r in ref.finished)
    assert port.cfg.plan.to_dict() == ref.cfg.plan.to_dict()


def test_mixed_plan_engine_serves_one_library_per_slot():
    """A two-slot plan through the fused tick on the CPU in both packages:
    one library per slot, every request complete, no degradation, the
    same streams (tie-aware: the reference's top-2 gap at a divergence)."""
    ref, port = _engines()
    assert sorted(port.library) == ["R5", "default"] == sorted(ref.library)
    for eng, mod in ((ref, jengine), (port, None)):
        for i, p in enumerate(_prompts(port.cfg, (5, 11, 3))):
            eng.submit((mod.Request if mod else Request)(i, p,
                                                         max_new=MAX_NEW))
    a = {r.rid: r.out for r in ref.run()}
    b = {r.rid: r.out for r in port.run()}
    assert port.stats["degradations"] == {} == ref.stats["degradations"]
    assert set(a) == set(b) == {0, 1, 2}
    assert all(len(v) == MAX_NEW for v in b.values())
    _same_engines(ref, port)
    _tie_aware(a, b, ref)


def _tie_aware(a, b, ref):
    """Streams equal, or diverging only where the reference's own logits
    (an exact-length prefill of the shared prefix under the plan) have a
    top-2 gap inside 2 * 4 * 2^-12 * max|logit|."""
    jcfg, jparams, _, _ = _model()
    prompts = {r.rid: r.prompt for r in ref.finished + ref.failed}
    num = jax_get_numerics(ref.cfg, ref.library)
    for rid in a:
        t = next((i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                  if x != y), None)
        if t is None:
            assert len(a[rid]) == len(b[rid])
            continue
        seq = np.concatenate([prompts[rid], np.asarray(a[rid][:t], np.int32)])
        logits = np.asarray(jtf.prefill(jparams, seq[None], ref.cfg, num,
                                        64)[0])[0, -1]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= 2 * 4 * 2.0 ** -12 * np.abs(logits).max()


def test_mixed_plan_slots_are_live():
    """R5 tables on layer 0 change the prefill logits against the uniform
    default-slot plan: the per-layer slots are not dead code."""
    _, _, cfg, params = _model()
    _, p, _, libs = _libraries("two_slot")
    tokens = torch.as_tensor(np.asarray([_prompts(cfg, (8,))[0]]),
                             dtype=torch.int64)
    out = {}
    for name, plan in (("mixed", p), ("uniform", NumericsPlan.uniform(
            "interp-fused", cfg.n_layers))):
        c = cfg.replace(plan=plan)
        with torch.inference_mode():
            out[name], _ = tf.prefill(params, tokens, c,
                                      get_numerics(c, libs), 16)
    assert not torch.equal(out["mixed"], out["uniform"])


def test_poisoned_slot_downgrades_only_its_layers():
    """The per-layer rung, both packages: a flipped bit in the R5 slot ROM
    (read only by layer 0, replaced in the engine's dict) and one poisoned
    tick retire layer 0's sites to exact; the other layers keep their
    fused backends, the engine stays fused and serves fresh work, and the
    fault log and ``degradations == {"0": 1}`` name the layer."""
    ref, port = _engines()
    for eng, flt, req in ((ref, jfaults, jengine.Request),
                          (port, faults, Request)):
        eng.library["R5"] = flt.flip_rom_bit(eng.library["R5"], seed=3)
        flt.TickFaultInjector("nan", every_n=1, limit=1).install(eng)
        for i, p in enumerate(_prompts(port.cfg, (5, 7))):
            eng.submit(req(i, p, max_new=MAX_NEW))
        eng.run()
    assert isinstance(port.numerics, PlanNumerics)
    for eng in (ref, port):
        assert len(eng.failed) == 2
        assert all(r.error == "non_finite_output" for r in eng.failed)
        assert eng.stats["rom_faults"] == 1
        assert eng.stats["degradations"] == {"0": 1}
        fault = next(f for f in eng.faults if f["reason"] == "rom_integrity")
        assert fault["action"] == "slots:R5->exact"
        assert fault["layers"] == ("0",)
        new_plan = eng.cfg.plan
        assert new_plan.layers[0].uniform_backend == "exact"
        assert new_plan.layers[1].uniform_backend == "interp-fused"
        assert new_plan.rest.uniform_backend == "interp-fused"
        assert eng.fused is True
        assert sorted(eng.library) == ["default"]
    _same_engines(ref, port)
    assert isinstance(port.numerics.for_layer(0), ExactNumerics)
    outs = {}
    for name, eng, req in (("ref", ref, jengine.Request),
                           ("port", port, Request)):
        for i, p in enumerate(_prompts(port.cfg, (4, 6), seed=9)):
            eng.submit(req(10 + i, p, max_new=3))
        outs[name] = {r.rid: r.out for r in eng.run() if r.rid >= 10}
    assert set(outs["port"]) == {10, 11}
    assert all(len(v) == 3 for v in outs["port"].values())
    _tie_aware(outs["ref"], outs["port"], ref)


def test_plan_engine_serial_rung_guards_interp_sites():
    """Repeated watchdog trips walk the plan-level fused -> serial rung in
    both packages: every interp site drops to the guarded datapath."""
    ref, port = _engines(slots=1, cache_len=64, watchdog_limit=2)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, port.cfg.vocab_size, 4).astype(np.int32)
               for _ in range(4)]
    for eng, flt, req in ((ref, jfaults, jengine.Request),
                          (port, faults, Request)):
        flt.TickFaultInjector("nan", every_n=1, limit=2).install(eng)
        for i, p in enumerate(prompts):
            eng.submit(req(i, p, max_new=3))
        eng.run()
    for eng in (ref, port):
        assert eng.fused is False
        assert eng.stats["degradations"] == {"engine": 1}
        for _label, _site, a in eng.cfg.plan.assignments():
            assert a.backend == "interp-guarded"
        assert len(eng.finished) == 2
    _same_engines(ref, port)


def test_plan_engine_exact_rung_drops_every_library():
    """A ROM fault on a homogeneous rung below serial: ``degrade_exact``
    takes every site to exact and the engine holds no library."""
    _, port = _engines()
    port._degrade("test", to="exact")
    assert not port.cfg.plan.uses_interp and port.library is None
    assert port.stats["degradations"] == {"engine": 1}
    port.submit(Request(0, _prompts(port.cfg, (5,))[0], max_new=3))
    (done,) = port.run()
    assert len(done.out) == 3


def test_uniform_exact_plan_matches_exact_engine():
    _, _, cfg, params = _model()
    outs = []
    for c in (cfg.replace(plan=NumericsPlan.uniform("exact", cfg.n_layers)),
              cfg):
        eng = ServeEngine(c, params, slots=2, cache_len=48, device="cpu")
        assert eng.library is None
        for i, p in enumerate(_prompts(cfg, (5, 11, 3))):
            eng.submit(Request(i, p, max_new=MAX_NEW))
        outs.append({r.rid: r.out for r in eng.run()})
    assert outs[0] == outs[1]


def test_serve_cli_plan_flags(tmp_path, capsys):
    """``--save-plan`` writes the served uniform plan; ``--plan`` serves it
    (one library per slot), and the reference's loader reads the file."""
    from repro_torch.launch.serve import main

    path = tmp_path / "plan.json"
    main(["--arch", "yi_6b", "--smoke", "--device", "cpu", "--requests",
          "2", "--max-new", "3", "--numerics", "interp-fused",
          "--save-plan", str(path)])
    capsys.readouterr()
    assert jplan.load_plan(path) == jplan.NumericsPlan.uniform(
        "interp-fused", 2)
    main(["--arch", "yi_6b", "--smoke", "--device", "cpu", "--requests",
          "2", "--max-new", "3", "--plan", str(path)])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["numerics"] == "plan" and report["tokens"] == 6
    assert report["rom_sha"] == {
        "default": InterpLibrary.default_library("cpu").rom_sha()}


def test_calibration_measures_the_aot_tick_and_feeds_throughput():
    """The reference's calibration case on the port: measured per-slot
    decode latencies from AOT-prepared engines on the CPU (wall clock of
    the CPU here: only the structure is held) displace the modeled
    constants exactly as the model says, and ``calibration=None`` keeps
    the modeled scoring and the plan."""
    from repro_torch.dse.probe import DISPATCH_COST_S, TRANSFER_COST_S
    from repro_torch.plan.assign import (calibrate_slot_latencies,
                                         modeled_tokens_per_s)

    _, _, cfg, params = _model()
    calib = calibrate_slot_latencies(cfg, params, horizon=4, reps=1,
                                     device="cpu")
    assert "exact" in calib["site_cost_s"]
    assert len(calib["site_cost_s"]) >= 2
    assert all(v > 0 for v in calib["site_cost_s"].values())
    assert all(v > 0 for v in calib["per_slot_step_s"].values())
    plan = NumericsPlan.uniform("exact", cfg.n_layers)
    measured = modeled_tokens_per_s(plan, {}, horizon=4, calibration=calib)
    n_terms = len(list(plan.assignments()))
    assert measured == pytest.approx(
        1.0 / ((DISPATCH_COST_S + TRANSFER_COST_S) / 4
               + n_terms * calib["site_cost_s"]["exact"]))
    assert measured != modeled_tokens_per_s(plan, {}, horizon=4)
    rep = auto_plan(cfg, error_budget=0.05, verify=False, calibrate=True,
                    params=params, horizon=4, device="cpu")
    assert rep.calibration is not None
    assert rep.to_dict()["calibration"] == rep.calibration
    assert rep.plan == auto_plan(cfg, error_budget=0.05, verify=False).plan
