"""The port's synthetic data (``repro_torch.data``) against the reference's
``repro.data``: every batch field bitwise (tokens, labels, mask and the
vision / audio stubs), the skip-ahead and the host slice, on the smoke
configs of every family."""
from __future__ import annotations

import numpy as np
import pytest

from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.data.synthetic import dataset_for as jax_dataset_for
from repro.data.synthetic import make_batch as jax_make_batch
from repro_torch.configs.base import ARCH_IDS, get_smoke_config
from repro_torch.data import dataset_for, make_batch


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_bitwise(arch):
    """``make_batch`` at two steps and two seeds equals the reference's,
    stub fields included (``frontend_emb`` for InternVL2, ``enc_frames``
    for Whisper)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    for step, seed in ((0, 0), (5, 3)):
        got = make_batch(cfg, 24, 3, step=step, seed=seed)
        _assert_same(got, jax_make_batch(jcfg, 24, 3, step=step, seed=seed))
    stub = {"internvl2_2b": "frontend_emb", "whisper_tiny": "enc_frames"}
    if arch in stub:
        assert stub[arch] in got and np.isfinite(got[stub[arch]]).all()


def test_skip_ahead_and_host_slice():
    """``batch_at(step)`` depends on the step alone (no stream state), a
    host slice [lo, hi) is those rows of the full batch, labels are the
    next tokens, and all of it is the reference's."""
    cfg, jcfg = get_smoke_config("yi_6b"), jax_smoke_config("yi_6b")
    ds, jds = dataset_for(cfg, 32, 8, seed=3), jax_dataset_for(jcfg, 32, 8,
                                                              seed=3)
    b17 = ds.batch_at(17)
    _ = ds.batch_at(4)  # an unrelated draw between the two reads
    _assert_same(ds.batch_at(17), b17)
    _assert_same(b17, jds.batch_at(17))
    assert not np.array_equal(ds.batch_at(18)["tokens"], b17["tokens"])
    sl = ds.batch_at(17, 2, 6)
    _assert_same(sl, jds.batch_at(17, 2, 6))
    np.testing.assert_array_equal(sl["tokens"], b17["tokens"][2:6])
    np.testing.assert_array_equal(b17["labels"][:, :-1], b17["tokens"][:, 1:])
    assert b17["tokens"].min() >= 0 and b17["tokens"].max() < cfg.vocab_size


@pytest.mark.parametrize("arch", ["internvl2_2b", "whisper_tiny"])
def test_stub_host_slice(arch):
    """The stubs draw the whole global batch and slice it, so a host's
    rows of ``frontend_emb`` / ``enc_frames`` are the full batch's rows."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    ds, jds = dataset_for(cfg, 16, 4, seed=1), jax_dataset_for(jcfg, 16, 4,
                                                              seed=1)
    full, part = ds.batch_at(2), ds.batch_at(2, 1, 3)
    _assert_same(part, jds.batch_at(2, 1, 3))
    key = "frontend_emb" if arch == "internvl2_2b" else "enc_frames"
    np.testing.assert_array_equal(part[key], full[key][1:3])
    want = ((4, cfg.frontend_len, cfg.frontend_dim) if key == "frontend_emb"
            else (4, cfg.encoder.source_len, cfg.d_model))
    assert full[key].shape == want and full[key].dtype == np.float32
