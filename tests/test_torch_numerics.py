"""The numerics backends' activations and the domain guard, held against
the reference (``repro/numerics/ops.py``, ``repro/numerics/guard.py``).

* gelu, sigmoid, softplus and tanh (and silu beside them) of
  ``InterpNumerics`` bound to a library, of ``FusedInterpNumerics`` (on the
  CPU: ``act_lib``'s plain version) and of the unbound ``InterpNumerics``,
  on the uniform default library and the default manifest segmented
  (ROM v2, ``f775a828748d4ea9``, the reference's library loaded into the
  port): bitwise the reference on inputs that reach every code of the
  slot, the window's edges and the tails. ``ExactNumerics``: within 4
  float32 ulps of the output (two libms).
* ``GuardedNumerics`` against the reference's guard on poisoned inputs
  (NaN, +-Inf, zero, negatives, subnormals, huge): the activations
  bitwise; exp_neg / recip_pos / rsqrt_pos within the reference's CPU
  ``exp2`` error at the power of two their glue scales by (exact in the
  port; the reference flushes 2^-126 to 0); the same violation counts,
  but for positive subnormals, which the reference's compares flush and
  the port counts as outside exp_neg's domain; the composites (softmax,
  rmsnorm) within the bounds of
  ``test_torch_pertable.py`` (a row sum or a mean in another order moves a
  recip / rsqrt code by at most one step). The reference's property tests
  as seeded draws; the non-positive draw uses the float32-exact bound
  -float32(1e30), where the reference's ``st.floats(-1e30, 0.0, width=32)``
  is refused by hypothesis.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.numerics as jnumerics
from repro import api as jax_api
from repro.numerics import guard as jguard
from repro.numerics import ops as jops
from repro_torch import api
from repro_torch import numerics as tnumerics
from repro_torch.api import Explorer, ExploreConfig, InterpLibrary
from repro_torch.core.funcspec import ACT_HI, ACT_LO
from repro_torch.numerics import guard, ops
from repro_torch.numerics.guard import DomainViolation, GuardedNumerics

ACT = ("gelu", "sigmoid", "softplus", "tanh", "silu")
NEW_ACT = ACT[:4]
PER_TABLE = {k: getattr(ops, f"approx_{k}") for k in ACT}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _fresh_default_sessions(tmp_path_factory):
    """Both packages' default Explorers on fresh cache directories (what
    the unbound backends read), restored after."""
    old, jold = api.default_explorer(), jax_api.default_explorer()
    api.set_default_explorer(Explorer(ExploreConfig(
        device="cpu", cache_dir=str(tmp_path_factory.mktemp("port")))))
    jax_api.set_default_explorer(jax_api.Explorer(jax_api.ExploreConfig(
        cache_dir=str(tmp_path_factory.mktemp("ref")))))
    yield
    api.set_default_explorer(old)
    jax_api.set_default_explorer(jold)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{"uniform" | "segmented": (port library, reference library)}."""
    jseg = jax_api.default_explorer().compile_segmented()
    path = jseg.save(str(tmp_path_factory.mktemp("seg") / "seg"))
    seg = InterpLibrary.load(str(path).removesuffix(".json"), device="cpu")
    assert seg.rom_sha() == jseg.rom_sha() == "f775a828748d4ea9"
    return {"uniform": (InterpLibrary.default_library("cpu"),
                        jax_api.default_explorer().compile()),
            "segmented": (seg, jseg)}


def _act_inputs(lib, kind) -> np.ndarray:
    """Every code of ``kind``'s window (its exact point and one inside its
    rounding interval), the window's edges, the tails and seeded normal
    draws (float32)."""
    m = lib.meta(kind)
    lo, hi, n = m.act_lo, m.act_hi, 1 << m.in_bits
    codes = np.arange(n)
    centers = lo + np.concatenate([codes, codes + 0.3]) / n * (hi - lo)
    edges = [lo - 1e6, lo - 1.0, lo, np.nextafter(np.float32(lo), 0),
             -1e-30, 0.0, 1e-30, hi - 1e-3, hi - 1e-6, hi,
             np.nextafter(np.float32(hi), 0), hi + 1.0, hi + 1e6]
    draws = np.random.default_rng(5).normal(0.0, 4.0, 512)
    return np.concatenate([centers, edges, draws]).astype(np.float32)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_backend_names_constants_and_exports():
    for name, cls in ops.BACKENDS.items():
        jcls = jops.BACKENDS[name]
        assert cls.__name__ == jcls.__name__
        assert cls.name == jcls.name
    assert tuple(ops.BACKENDS) == tuple(jops.BACKENDS)
    assert ops.INTERP_BACKENDS == jops.INTERP_BACKENDS
    assert ops.FusedInterpNumerics.fused is jops.FusedInterpNumerics.fused
    for name in ("ExactNumerics", "InterpNumerics"):
        assert hasattr(getattr(ops, name), "fused") == hasattr(
            getattr(jops, name), "fused")
    assert ops.ExactNumerics.library is None
    public = {n for n in dir(jnumerics) if not n.startswith("_")}
    assert public - {"guard", "ops", "registry"} <= set(dir(tnumerics))
    for mod in (ops, jops):
        g = mod.get_numerics("interp-guarded")
        assert type(g).__name__ == "GuardedNumerics"
        assert type(g.inner).__name__ == "InterpNumerics"
        assert g.name == "interp" and g.library is None
    cfg = type("Cfg", (), {"numerics": "interp-guarded", "plan": None})()
    assert isinstance(ops.get_numerics(cfg), GuardedNumerics)


@pytest.mark.parametrize("name", ["uniform", "segmented"])
@pytest.mark.parametrize("kind", ACT)
def test_bound_activations_bitwise_reference(kind, name, libs):
    """Library-bound and fused-plain activations, every code of the slot,
    against the reference's bound and fused backends."""
    lib, jlib = libs[name]
    x = _act_inputs(lib, kind)
    m = lib.meta(kind)
    codes = ops._quantize((torch.clamp(torch.from_numpy(x), m.act_lo,
                                       m.act_hi - 1e-6) - m.act_lo)
                          / (m.act_hi - m.act_lo), m.in_bits)
    assert torch.unique(codes).numel() == 1 << m.in_bits
    want = getattr(jops.InterpNumerics(jlib), kind)(jnp.asarray(x))
    got = getattr(ops.InterpNumerics(lib), kind)(torch.from_numpy(x))
    _eq(got, want)
    jfused = getattr(jops.FusedInterpNumerics(jlib), kind)(jnp.asarray(x))
    _eq(getattr(ops.FusedInterpNumerics(lib), kind)(torch.from_numpy(x)),
        jfused)
    _eq(getattr(ops.PlainFusedNumerics(lib), kind)(torch.from_numpy(x)),
        jfused)


@pytest.mark.parametrize("kind", ACT)
def test_unbound_and_per_table_activations_bitwise_reference(kind, libs):
    lib, _ = libs["uniform"]
    x = _act_inputs(lib, kind)
    want = getattr(jops.InterpNumerics(), kind)(jnp.asarray(x))
    _eq(getattr(ops.InterpNumerics(), kind)(torch.from_numpy(x)), want)
    _eq(PER_TABLE[kind](torch.from_numpy(x)),
        getattr(jops, f"approx_{kind}")(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ACT)
def test_exact_activations_match_reference(kind):
    """Two libms: within 4 float32 ulps of the output; gelu and silu are x
    times a factor that cancels in float32 for large negative x (gelu's
    1 + tanh), so theirs are ulps of max(|y|, |x|)."""
    x = np.concatenate([np.linspace(-30, 30, 4001),
                        np.random.default_rng(1).normal(0, 5, 1000)]
                       ).astype(np.float32)
    got = getattr(ops.ExactNumerics, kind)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jops.ExactNumerics, kind)(jnp.asarray(x)))
    scale = np.abs(want)
    if kind in ("gelu", "silu"):
        scale = np.maximum(scale, np.abs(x))
    ulp = np.spacing(scale.astype(np.float32))
    assert np.all(np.abs(got - want) <= 4 * np.maximum(ulp, 2.0 ** -149))


@pytest.mark.parametrize("kind", ACT)
def test_activation_out_of_window_clamps_to_tails(kind, libs):
    """Twin of the reference's: finite inputs past the window take the
    tail values, identically through the per-table glue, the library glue
    and the fused backend, saturating, never wrapped."""
    lib, _ = libs["uniform"]
    x = torch.tensor([ACT_LO - 100.0, ACT_LO, -1.0, 0.0, 1.0,
                      ACT_HI - 1e-3, ACT_HI, ACT_HI + 100.0])
    a = PER_TABLE[kind](x)
    assert torch.equal(a, getattr(ops.InterpNumerics(lib), kind)(x))
    assert torch.equal(a, getattr(ops.FusedInterpNumerics(lib), kind)(x))
    assert torch.isfinite(a).all()
    top = 1.0 if kind in ("sigmoid", "tanh") else float(x[-1])
    bot = -1.0 if kind == "tanh" else 0.0
    assert float(a[-1]) == top and float(a[0]) == bot
    assert float(a[0]) == float(PER_TABLE[kind](torch.tensor(
        [ACT_LO - 1e6]))[0])


# -------------------------------------------------------------- the guard

POISON = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, -1e-40,
                   -1e-45, 1e-40, 1e-45, 1.1754944e-38, 3e38, 3.4e38,
                   -3.4e38, 2.0, 0.5, -5.0, 1e12, -1e12, -126.0, -127.0,
                   -1e30, 7.9, -7.9, 8.0, -8.0, 100.0, -100.0],
                  np.float32)


def _guard_pair(name, libs, inner="bound"):
    lib, jlib = libs[name] if inner == "bound" else (None, None)
    return (GuardedNumerics(ops.InterpNumerics(lib), count=True),
            jguard.GuardedNumerics(jops.InterpNumerics(jlib)))


def _exp2_err(k: np.ndarray) -> np.ndarray:
    """Relative error of the reference's CPU float32 ``exp2`` at the
    integers -k (exact powers of two in the port; 2^-126 flushes to 0)."""
    got = np.asarray(jnp.exp2(-jnp.asarray(k, jnp.float32)), np.float64)
    exact = np.ldexp(1.0, -k.astype(np.int64))
    return np.abs(got - exact) / exact


def _pow2_k(op: str, x: np.ndarray) -> np.ndarray:
    """The power of two the glue of ``op`` scales its table read by."""
    if op == "exp_neg":
        t = np.minimum(np.maximum(-x, 0).astype(np.float32)
                       * np.float32(ops.LOG2E), np.float32(126.0))
        return np.floor(t)
    _, e = np.frexp(x.astype(np.float32))
    return e - 1 if op == "recip_pos" else np.where(e % 2, e - 1, e - 2) // 2


@pytest.mark.parametrize("name,inner", [("uniform", "bound"),
                                        ("segmented", "bound"),
                                        ("uniform", "unbound")])
@pytest.mark.parametrize("op", ["exp_neg", "recip_pos", "rsqrt_pos", *ACT])
def test_guard_matches_reference(op, name, inner, libs):
    """Poisoned and healthy inputs through both guards: the same violation
    counts and, for the activations, the same outputs bit for bit. The
    exp2neg / recip / rsqrt glue scales its table read by a power of two,
    exact in the port and inexact on the reference's CPU (2^-126 flushing
    to 0: a held difference), so those are within the reference's exp2
    error at the element's power plus one float32 rounding."""
    g, jg = _guard_pair(name, libs, inner)
    x = np.concatenate([POISON, np.random.default_rng(3).normal(
        0, 20, 200).astype(np.float32)])
    got = getattr(g, op)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jg, op)(jnp.asarray(x)))
    # the reference's XLA compares flush subnormals, so it finds no
    # positive subnormal above exp_neg's domain (x <= 0); the port does
    extra = int(np.sum((x > 0) & (x < 2.0 ** -126))) if op == "exp_neg" \
        else 0
    assert extra < g.total_violations() == jg.total_violations() + extra
    assert set(g.violations) == set(jg.violations)
    if op in ACT:
        np.testing.assert_array_equal(got, want)
        return
    bounds = {"exp_neg": (guard._EXP_NEG_FLOOR, 0.0, guard._EXP_NEG_FLOOR),
              "recip_pos": (guard._POS_TINY, guard._POS_HUGE, 1.0),
              "rsqrt_pos": (guard._POS_TINY, guard._POS_HUGE, 1.0)}[op]
    clean = GuardedNumerics(None)._guard(op, torch.from_numpy(x), *bounds)
    rtol = _exp2_err(_pow2_k(op, clean.numpy())) + 2.0 ** -24
    flushed = (want == 0) & (np.abs(got) < 2.0 ** -125)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.all(flushed | (np.abs(got - want) <= rtol * np.abs(want)))


@pytest.mark.parametrize("name", ["uniform", "segmented"])
def test_guard_composites_match_reference(name, libs):
    """softmax and rmsnorm through both guards on rows with poison: the
    same violation counts; outputs within one recip / rsqrt code."""
    g, jg = _guard_pair(name, libs)
    rng = np.random.default_rng(4)
    x = rng.normal(0, 3, (6, 64)).astype(np.float32)
    # softmax rows: keys far below the row max clamp to the exp2neg floor
    # (2^-126: exact in the port, flushed to 0 by the reference's exp2,
    # hence the absolute 1e-30); rmsnorm rows: NaN and infinite variances
    xs = x.copy()
    xs[2, 5], xs[3, 0], xs[4, 7] = -np.inf, -1e30, -3e38
    xr = x.copy()
    xr[1, 3], xr[2, 5], xr[3, 0] = np.nan, np.inf, -np.inf
    gamma = rng.normal(1, 0.1, 64).astype(np.float32)
    lib = libs[name][0]
    for op, args, rtol in (
            ("softmax", (xs,), ops.softmax_ulp_bound(lib.meta("exp2neg"),
                                                     lib.meta("recip"))),
            ("rmsnorm", (xr, gamma),
             2 * 2.0 ** -(lib.meta("rsqrt").out_bits - 1) + 1e-6)):
        got = getattr(g, op)(*map(torch.from_numpy, args)).numpy()
        want = np.asarray(getattr(jg, op)(*map(jnp.asarray, args)))
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        assert np.all(np.abs(got[fin] - want[fin])
                      <= rtol * np.abs(want[fin]) + 1e-30)
    assert g.violations == jg.violations


@pytest.mark.parametrize("kind", ["recip", "rsqrt"])
def test_nonpositive_input_raises_through_strict_guard(kind, libs):
    """Twin of the reference's: the positive-domain tables have no
    certified meaning at x <= 0; the strict guard refuses."""
    lib, _ = libs["uniform"]
    g = GuardedNumerics(ops.InterpNumerics(lib), strict=True)
    op = g.recip_pos if kind == "recip" else g.rsqrt_pos
    for bad in (0.0, -1.0, np.nan, np.inf, -np.inf):
        with pytest.raises(DomainViolation):
            op(torch.tensor([bad], dtype=torch.float32))
    assert g.total_violations() == 5


@pytest.mark.parametrize("kind", ["recip", "rsqrt"])
def test_nonpositive_never_silently_wraps(kind, libs):
    """The reference's property test with float32-exact bounds: seeded
    draws over every float32 in [-float32(1e30), 0] (uniform in the bit
    pattern, so every binade is hit) and its edges raise through the strict
    guard of both packages."""
    lib, jlib = libs["uniform"]
    lo = np.float32(-1e30)
    mag = np.random.default_rng(9).integers(
        0, int((-lo).view(np.int32)), 40, endpoint=True).astype(np.int32)
    draws = np.concatenate([-mag.view(np.float32),
                            np.array([0.0, -0.0, -1e-45, -1e-40, -1.0, lo],
                                     np.float32)])
    assert np.all(draws <= 0) and np.all(draws >= lo)
    g = GuardedNumerics(ops.InterpNumerics(lib), strict=True)
    jg = jguard.GuardedNumerics(jops.InterpNumerics(jlib), strict=True)
    for bad in draws:
        for guard_, arr in ((g, torch.tensor([bad])),
                            (jg, jnp.asarray([bad], jnp.float32))):
            op = guard_.recip_pos if kind == "recip" else guard_.rsqrt_pos
            with pytest.raises((DomainViolation, jguard.DomainViolation)):
                op(arr)
    assert g.total_violations() == jg.total_violations() == len(draws)


@pytest.mark.parametrize("kind", ["recip", "rsqrt"])
def test_guard_clamp_equals_unguarded_on_clamped_input(kind, libs):
    """Twin of the reference's: a bad input evaluates as the nearest
    in-domain input does through the unguarded path."""
    lib, _ = libs["uniform"]
    g = GuardedNumerics(ops.InterpNumerics(lib), count=True)
    plain = ops.InterpNumerics(lib)
    bad = torch.tensor([0.0, -5.0, np.inf, -np.inf, np.nan, 2.0])
    clamped = torch.tensor([guard._POS_TINY, guard._POS_TINY, guard._POS_HUGE,
                            guard._POS_TINY, 1.0, 2.0])
    assert torch.equal(getattr(g, f"{kind}_pos")(bad),
                       getattr(plain, f"{kind}_pos")(clamped))
    assert g.violations[f"{kind}_pos"] == 5


@pytest.mark.parametrize("kind", ACT)
def test_guard_repairs_nonfinite_activations(kind, libs):
    lib, _ = libs["uniform"]
    g = GuardedNumerics(ops.InterpNumerics(lib), count=True)
    y = getattr(g, kind)(torch.tensor([np.nan, np.inf, -np.inf, 1.0]))
    assert torch.isfinite(y).all()
    assert g.violations[kind] == 3
    ref = getattr(ops.InterpNumerics(lib), kind)(torch.tensor([1.0]))
    assert float(y[3]) == float(ref[0])


def test_guard_counts_only_on_request(libs):
    """Without ``count`` (the engine's guarded rung) the guard clamps the
    same values and reads nothing back; strict implies counting."""
    lib, _ = libs["uniform"]
    quiet = GuardedNumerics(ops.InterpNumerics(lib))
    loud = GuardedNumerics(ops.InterpNumerics(lib), count=True)
    x = torch.from_numpy(POISON)
    for op in ("exp_neg", "recip_pos", "rsqrt_pos", *ACT):
        assert torch.equal(getattr(quiet, op)(x), getattr(loud, op)(x))
    assert quiet.violations == {} and loud.total_violations() > 0
    assert GuardedNumerics(ops.InterpNumerics(lib), strict=True).count


def test_guard_passes_other_capabilities_through(libs):
    lib, _ = libs["uniform"]
    g = GuardedNumerics(ops.FusedInterpNumerics(lib))
    assert g.fused is True and g.library is lib
    assert g.fused_attention.__self__ is g.inner
    assert getattr(GuardedNumerics(ops.InterpNumerics(lib)),
                   "fused_attention", None) is None


@pytest.mark.parametrize("kind", NEW_ACT)
def test_new_activations_bf16_as_reference(kind, libs):
    """bf16 inputs (the served dtype): the port's bound and fused-plain
    activations against the reference's, bitwise."""
    lib, jlib = libs["uniform"]
    x32 = _act_inputs(lib, kind)
    x = torch.from_numpy(x32).to(torch.bfloat16)
    jx = jnp.asarray(x32).astype(jnp.bfloat16)
    want = np.asarray(getattr(jops.InterpNumerics(jlib), kind)(jx)
                      .astype(jnp.float32))
    for num in (ops.InterpNumerics(lib), ops.FusedInterpNumerics(lib)):
        got = getattr(num, kind)(x)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
