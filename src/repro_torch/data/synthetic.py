"""Deterministic synthetic data (twin of ``repro/data/synthetic.py``).

A counter-based PRNG (numpy's Philox keyed on ``(seed, step)``) gives O(1)
skip-ahead: after a restart the trainer asks for ``batch_at(resume_step)``
and gets the same bytes with no state to checkpoint and no stream to
replay. Each host materializes only its rows (``lo:hi``). Batches are numpy
and bitwise the reference's, the stub fields (``frontend_emb`` for the
vision stub, ``enc_frames`` for the audio stub) included; the trainer moves
them to its device.

Tokens follow a Zipf-like marginal (a realistic softmax and router load for
the tables); labels are the next token of the same stream.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _rng(seed: int, step: int, salt: int = 0) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=[seed + (salt << 32),
                                                     step]))


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    u = rng.random(shape)
    # inverse CDF of a truncated zipf(s=1.1) through the analytic pareto form
    z = ((vocab ** 0.1) - 1.0) * u + 1.0
    tok = (z ** 10.0 - 1.0).astype(np.int64)
    return np.clip(tok, 0, vocab - 1).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SyntheticDataset:
    """Step-indexed synthetic batches for one (config, shape) cell."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str | None = None
    frontend_len: int = 0
    frontend_dim: int = 0
    source_len: int = 0
    d_model: int = 0

    def batch_at(self, step: int, lo: int = 0, hi: int | None = None) -> dict:
        """Rows [lo, hi) of the global batch of ``step``."""
        hi = self.global_batch if hi is None else hi
        n = hi - lo
        rng = _rng(self.seed, step)
        toks = _zipf_tokens(rng, (self.global_batch, self.seq_len + 1),
                            self.vocab_size)[lo:hi]
        out = {"tokens": toks[:, :-1],
               "labels": toks[:, 1:].copy(),
               "mask": np.ones((n, self.seq_len), np.float32)}
        # the stubs draw the whole global batch, so a host slice takes the
        # same rows the full batch has
        if self.frontend == "vision_stub":
            out["frontend_emb"] = rng.standard_normal(
                (self.global_batch, self.frontend_len, self.frontend_dim),
                dtype=np.float32)[lo:hi]
        elif self.frontend == "audio_stub":
            out["enc_frames"] = rng.standard_normal(
                (self.global_batch, self.source_len, self.d_model),
                dtype=np.float32)[lo:hi]
        return out


def dataset_for(cfg, seq_len: int, global_batch: int,
                seed: int = 0) -> SyntheticDataset:
    return SyntheticDataset(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch, seed=seed, frontend=cfg.frontend,
        frontend_len=cfg.frontend_len, frontend_dim=cfg.frontend_dim,
        source_len=cfg.encoder.source_len if cfg.encoder else 0,
        d_model=cfg.d_model)


def make_batch(cfg, seq_len: int, batch: int, step: int = 0,
               seed: int = 0) -> dict:
    """One whole (small) batch as numpy, for tests and examples."""
    return dataset_for(cfg, seq_len, batch, seed).batch_at(step)
