"""The comparison that decides ``correct`` has to fail a broken timed
path. Each test drives a whole harness run on the CPU (no look for a
card) at smoke size with the program broken underneath, once for each
fault a serving cell can have, and sees ``correct`` come out false; the
same run unbroken is correct (``test_portbench_reference``)."""
from __future__ import annotations

import pytest

from portbench.tests.conftest import cell_limits


@pytest.fixture
def broken(monkeypatch):
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.serve import engine as eng_mod

    def altered_token():
        """A served token altered where the tick hands it to the host."""
        orig = eng_mod.ServeEngine._finish_tick

        def finish(self, out, ok, steps, t0, toks=None):
            if out is not None:
                out = out.copy()
                out[-1] = (out[-1] + 1) % self.cfg.vocab_size
            return orig(self, out, ok, steps, t0, toks)
        monkeypatch.setattr(eng_mod.ServeEngine, "_finish_tick", finish)

    def state_unchanged():
        """A decode step that leaves the cache as it found it."""
        orig = attn.gqa_decode

        def decode(p, x, pos, cache, cfg, numerics, mesh=None):
            copy = attn.KVCache(*(t.clone() for t in cache))
            y, _ = orig(p, x, pos, copy, cfg, numerics, mesh)
            return y, cache
        monkeypatch.setattr(attn, "gqa_decode", decode)

    def half_the_batch():
        """Half of the slots decoded from the other half's rows."""
        orig = tf.decode_step

        def step(p, token, pos, caches, cfg, numerics, cross=None,
                 mesh=None):
            lg, caches = orig(p, token, pos, caches, cfg, numerics, cross,
                              mesh)
            b = lg.shape[0]
            lg = lg.clone()
            lg[b // 2:] = lg[:b - b // 2]
            return lg, caches
        monkeypatch.setattr(tf, "decode_step", step)

    return {"altered_token": altered_token,
            "state_unchanged": state_unchanged,
            "half_the_batch": half_the_batch}


@pytest.mark.parametrize("fault", ["altered_token", "state_unchanged",
                                   "half_the_batch"])
@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_moe_16b"])
def test_a_broken_path_is_not_correct(run_tiny, broken, fault, arch):
    """Under the cell's own limits (the widest gap on Yi-6B, the mean gap
    on DeepSeekMoE), a number they name is over its limit."""
    broken[fault]()
    v = run_tiny(arch)["verdict"]
    assert not v["correct"], v
    assert v["limits"] == cell_limits(arch)
    assert any(v[k] > lim for k, lim in v["limits"].items()), v
