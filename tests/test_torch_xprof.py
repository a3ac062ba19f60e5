"""The port's per-rank op profiler (``repro_torch.launch.xprof``) against
the reference's HLO profiler (``repro.launch.xprof.analyze_hlo``).

* The torch rebuild of ``tests/system/test_xprof.py``'s synthetic case (a
  10-trip loop of an 8 x 8 x 8 dot and an all-reduce over a 4-rank group,
  here on a traced mesh) gives exactly 10 * 2 * 8^3 FLOPs and 10 * 2 *
  (3/4) * 256 all-reduce bytes; L chained matmuls exactly L * (2mkn +
  2mnk).
* The smoke Yi-6B prefill at (2, 64) and one decode step on no mesh give
  the reference's ``analyze_hlo`` FLOPs of the same steps compiled on one
  CPU device, within 1% (measured gap: 0, 26,279,936 and 475,136 FLOPs on
  both sides).
* A port kernel's wrapper counts as one op; the layer loop, traced once
  per segment and counted once per repeat, gives the FLOPs of tracing
  every layer; bytes and peak live bytes on hand-built steps.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.launch.mesh import trace_mesh
from repro_torch.launch.xprof import profile_step, tensor_bytes
from repro_torch.models import transformer as tf
from repro_torch.models.layers import spec
from repro_torch.numerics.ops import get_numerics


def test_synthetic_loop_flops_and_all_reduce_bytes():
    mesh = trace_mesh((4,), ("model",))

    def step(x):
        for _ in range(10):
            x = mesh.all_reduce(x @ x, "model")
        return x

    prof, out = profile_step(step, spec((8, 8), torch.float32))
    assert prof.flops == 10 * 2 * 8 * 8 * 8
    want = 10 * 2 * (3 / 4) * (8 * 8 * 4)
    assert abs(prof.collective_bytes["all_reduce"] - want) < 1e-6
    assert prof.collective_count == {"all_reduce": 10}
    assert tuple(out.shape) == (8, 8)


def test_chained_matmuls_match_analytic():
    L, m, k, n = 7, 32, 64, 48

    def f(x, w, back):
        for i in range(L):
            x = (x @ w[i]) @ back
        return x

    prof, _ = profile_step(f, spec((m, k), torch.float32),
                           spec((L, k, n), torch.float32),
                           spec((n, k), torch.float32))
    assert prof.flops == L * (2 * m * k * n + 2 * m * n * k)


def test_bytes_of_a_product_and_a_broadcast():
    """mm reads both operands and writes its output; a stride-0 operand is
    read once per distinct element; a view moves nothing."""
    prof, _ = profile_step(lambda a, b: a @ b, spec((16, 32), torch.float32),
                           spec((32, 8), torch.float32))
    assert prof.hbm_bytes == 4 * (16 * 32 + 32 * 8 + 16 * 8)
    prof, _ = profile_step(lambda a, r: a + r.expand(64, 128),
                           spec((64, 128), torch.float32),
                           spec((1, 128), torch.float32))
    assert prof.hbm_bytes == 4 * (64 * 128 + 128 + 64 * 128)
    prof, _ = profile_step(lambda a: a.reshape(-1).view(128, 64).t(),
                           spec((64, 128), torch.float32))
    assert prof.hbm_bytes == 0 and prof.flops == 0


def test_peak_live_bytes_tracks_freed_storages():
    """Two 4 KiB temporaries and the 4-byte sum alive at once (the first
    temporary freed before): the peak is what was live together, the
    argument left out."""
    def f(x):
        a = x * 2.0
        b = a + 1.0
        del a
        c = b * b
        return c.sum()

    prof, _ = profile_step(f, spec((1024,), torch.float32))
    assert prof.peak_live_bytes == 2 * 4096 + 4


def _jax_flops(kind: str) -> float:
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_smoke_config as jsmoke
    from repro.launch.xprof import analyze_hlo
    from repro.models import transformer as jtf
    from repro.numerics.ops import get_numerics as jnum

    cfg = jsmoke("yi_6b")
    num = jnum(cfg)
    ps = jtf.model_shapes(cfg)
    if kind == "prefill":
        fn = jax.jit(lambda p, t: jtf.prefill(p, t, cfg, num, 64))
        lowered = fn.lower(ps, jax.ShapeDtypeStruct((2, 64), jnp.int32))
    else:
        fn = jax.jit(lambda p, t, c: jtf.decode_step(p, t, 5, c, cfg, num))
        lowered = fn.lower(ps, jax.ShapeDtypeStruct((2, 1), jnp.int32),
                           jtf.cache_shapes(cfg, 2, 64))
    return analyze_hlo(lowered.compile().as_text()).flops


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_smoke_flops_match_analyze_hlo(kind):
    """Within 1% of the reference's analyze_hlo on one CPU device (the gap
    measured: 0)."""
    cfg = get_smoke_config("yi_6b")
    num = get_numerics(cfg)
    p = tf.param_shapes(cfg)
    if kind == "prefill":
        prof, _ = profile_step(lambda p, t: tf.prefill(p, t, cfg, num, 64),
                               p, spec((2, 64), torch.int32))
    else:
        prof, _ = profile_step(
            lambda p, t, c: tf.decode_step(p, t, 5, c, cfg, num), p,
            spec((2, 1), torch.int32), tf.cache_shapes(cfg, 2, 64))
    want = _jax_flops(kind)
    assert abs(prof.flops - want) <= 0.01 * want, (prof.flops, want)


@pytest.fixture(scope="module")
def lib():
    from repro_torch.api.library import InterpLibrary

    return InterpLibrary.default_library("cpu")


@pytest.mark.parametrize("kernel", ["rmsnorm_lib", "act_lib", "softmax_lib",
                                    "flash_attn_lib"])
def test_a_kernel_call_counts_as_one_op(lib, kernel):
    """The wrapper is one op: its inputs read, its output written, one
    launch; its plain version's intermediates are not counted."""
    from repro_torch.kernels.flashattn.ops import attention_fused_library
    from repro_torch.kernels.interp.ops import act_library
    from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_library
    from repro_torch.kernels.softmax.ops import approx_softmax_library

    x = spec((4, 256), torch.float32)
    if kernel == "rmsnorm_lib":
        args, fn = (x, spec((256,), torch.bfloat16)), \
            lambda a, g: approx_rmsnorm_library(a, g, lib)
        want = 4 * 4 * 256 * 2 + 2 * 256
    elif kernel == "act_lib":
        args, fn = (x,), lambda a: act_library(a, lib, "silu")
        want = 4 * 4 * 256 * 2
    elif kernel == "softmax_lib":
        args, fn = (x,), lambda a: approx_softmax_library(a, lib)
        want = 4 * 4 * 256 * 2
    else:
        q = spec((2, 16, 4, 32), torch.float32)
        kv = spec((2, 16, 2, 32), torch.float32)
        args, fn = (q, kv, kv), lambda q, k, v: attention_fused_library(
            q, k, v, lib, causal=True)
        want = 4 * (2 * 16 * 4 * 32 * 2 + 2 * 2 * 16 * 2 * 32)
    prof, _ = profile_step(fn, *args)
    assert prof.kernel_launches == {kernel: 1}
    assert [(r["op"], r["calls"]) for r in prof.breakdown()] == [(kernel, 1)]
    assert prof.hbm_bytes == want
    if kernel == "flash_attn_lib":  # 2 (D + Dv) per causal pair and head
        assert prof.flops == 2 * (32 + 32) * (16 * 17 // 2) * 4 * 2


@pytest.mark.parametrize("kernel", ["rmsnorm_lib", "act_lib", "softmax_lib",
                                    "flash_attn_lib"])
def test_a_real_tensor_ignores_the_tracer(lib, kernel, monkeypatch):
    """While a profiler's hook is set, a wrapper given a real tensor still
    takes its own path (here the CPU's plain version, bitwise) and never
    calls the hook: only fake tensors are traced."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flashattn.ops import attention_fused_library
    from repro_torch.kernels.interp.ops import act_library
    from repro_torch.kernels.rmsnorm.ops import approx_rmsnorm_library
    from repro_torch.kernels.softmax.ops import approx_softmax_library

    class Hook:
        def kernel(self, *a, **k):
            raise AssertionError("a real tensor reached the tracer")

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 256, generator=g)
    q, k, v = (torch.randn(1, 8, 2, 32, generator=g) for _ in range(3))
    call = {"rmsnorm_lib": lambda: approx_rmsnorm_library(
                x, torch.ones(256), lib),
            "act_lib": lambda: act_library(x, lib, "silu"),
            "softmax_lib": lambda: approx_softmax_library(x, lib),
            "flash_attn_lib": lambda: attention_fused_library(
                q, k, v, lib, causal=True)}[kernel]
    want = call()
    monkeypatch.setattr(build, "TRACER", Hook())
    assert build.tracer_for(x) is None
    assert torch.equal(call(), want)


def test_a_trace_leaves_the_library_caches_real(lib, tmp_path):
    """A library whose lazy caches (its datapath rows) are first built
    inside a trace still holds real tensors after it: the next real call
    returns a real tensor, bitwise the untraced library's."""
    from torch._subclasses.fake_tensor import is_fake

    from repro_torch.api.library import InterpLibrary
    from repro_torch.kernels.interp.ops import act_library

    fresh = InterpLibrary.load(lib.save(tmp_path / "lib"), device="cpu")
    profile_step(lambda t: act_library(t, fresh, "silu"),
                 spec((4, 256), torch.float32))
    assert not is_fake(fresh.meta_rows())
    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(1))
    got = act_library(x, fresh, "silu")
    assert not is_fake(got)
    assert torch.equal(got, act_library(x, lib, "silu"))


@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
def test_layer_loop_counts_each_repeat(mode):
    """The layer loop traced once per segment and scaled by its repeats
    gives exactly the FLOPs, HBM bytes and peak live bytes of tracing
    every layer (the training peak within 1e-5 relative: measured on the
    CPU 4 bytes over, 1.9e-6); ``trip_counts`` holds the repeats."""
    from repro_torch.train.step import loss_and_grads

    cfg = get_smoke_config("deepseek_moe_16b").replace(n_layers=5)
    num = get_numerics(cfg)
    p = tf.param_shapes(cfg)
    if mode == "prefill":
        fn, args = (lambda p, t: tf.prefill(p, t, cfg, num, 32)), (
            p, spec((2, 32), torch.int32))
    elif mode == "decode":
        fn, args = (lambda p, t, c: tf.decode_step(p, t, 3, c, cfg, num)), (
            p, spec((2, 1), torch.int32), tf.cache_shapes(cfg, 2, 32))
    else:
        b = {k: spec((2, 32), dt) for k, dt in (
            ("tokens", torch.int32), ("labels", torch.int32),
            ("mask", torch.float32))}
        fn, args = (lambda p, b: loss_and_grads(p, b, cfg, num)), (p, b)
    looped, out = profile_step(fn, *args)
    full, out_full = profile_step(fn, *args, loops=False)
    assert looped.trip_counts == [4] and full.trip_counts == []
    assert looped.flops == full.flops > 0
    if mode == "prefill":  # every layer's cache, stacked
        assert [tuple(t.shape) for t in out[1]] == [
            tuple(t.shape) for t in out_full[1]]
    assert looped.hbm_bytes == full.hbm_bytes
    if mode == "train":
        np.testing.assert_allclose(looped.peak_live_bytes,
                                   full.peak_live_bytes, rtol=1e-5)
    else:
        assert looped.peak_live_bytes == full.peak_live_bytes


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "minicpm3_4b",
                                  "jamba_v0_1_52b", "whisper_tiny"])
def test_layer_loop_matches_every_layer_on_the_mesh(arch, shape,
                                                    monkeypatch):
    """A dry-run cell of the smoke config (at least 4 layers, the shape cut
    to 32 x 64) on the traced (16, 16) mesh: the looped trace against
    every layer traced. FLOPs, HBM bytes and collective bytes exactly
    equal (MoE aux, MLA, a four-layer hybrid pattern with Mamba2, cross
    attention: its gradient gathered from every layer), ZeRO-3's gathers
    included; the peak live bytes exactly equal in serving and within
    1e-5 relative in training (measured on the CPU: at most 12 bytes
    over, 4.7e-6, in the MoE archs; the other training cells exact)."""
    import dataclasses

    from repro_torch.configs.base import SHAPES
    from repro_torch.launch import dryrun

    monkeypatch.setitem(SHAPES, shape, dataclasses.replace(
        SHAPES[shape], seq_len=64, global_batch=32))
    cfg = get_smoke_config(arch)
    cfg = cfg.replace(n_layers=max(cfg.n_layers, 4))
    fn, args, _ = dryrun.lower_cell(arch, shape, cfg=cfg)
    looped, _ = profile_step(fn, *args)
    full, _ = profile_step(fn, *args, loops=False)
    assert looped.trip_counts and not full.trip_counts
    assert looped.flops == full.flops > 0
    assert looped.hbm_bytes == full.hbm_bytes
    assert looped.collective_bytes == full.collective_bytes
    # counts are static, as the reference's (a loop body's once)
    assert set(looped.collective_count) == set(full.collective_count)
    if shape == "train_4k":
        assert full.peak_live_bytes <= looped.peak_live_bytes
        np.testing.assert_allclose(looped.peak_live_bytes,
                                   full.peak_live_bytes, rtol=1e-5)
    else:
        assert looped.peak_live_bytes == full.peak_live_bytes


def test_tensor_bytes_counts_each_storage_once():
    t = torch.zeros(16, 4)
    assert tensor_bytes({"a": t, "b": t[2:], "c": spec((3, 2),
                                                       torch.bfloat16)}) \
        == 16 * 4 * 4 + 3 * 2 * 2
