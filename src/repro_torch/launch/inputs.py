"""Spec stand-ins for every model input: the dry run's signature (twin of
``repro/launch/inputs.py``).

``input_specs(cfg, shape)`` returns the abstract arguments of the step a
cell traces: a training batch for ``train_*`` shapes, a prompt batch for
``prefill_*`` (with the vision stub's patches or the encoder-decoder's
frames), and (token, pos, caches, cross) for ``decode_*`` / ``long_*``:
one new token against a ``seq_len``-deep cache, per the shape table. The
leaves are ``models.layers.Spec`` (the port's ``ShapeDtypeStruct``); no
tensor is allocated here. The prefill takes the frames, as the
reference's: the port's traced prefill runs ``encoder_forward`` over them
and hands its output to ``prefill(cross=)`` (``serve.engine.make_prefill``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import spec


def batch_shapes(cfg: ModelConfig, b: int, s: int) -> dict:
    out = {
        "tokens": spec((b, s), torch.int32),
        "labels": spec((b, s), torch.int32),
        "mask": spec((b, s), torch.float32),
    }
    if cfg.frontend == "vision_stub":
        out["frontend_emb"] = spec((b, cfg.frontend_len, cfg.frontend_dim),
                                   torch.float32)
    elif cfg.frontend == "audio_stub":
        out["enc_frames"] = spec((b, cfg.encoder.source_len, cfg.d_model),
                                 torch.float32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract inputs keyed by argument name, per the cell's step kind."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": batch_shapes(cfg, b, s)}
    if shape.kind == "prefill":
        out = {"tokens": spec((b, s), torch.int32)}
        if cfg.frontend == "vision_stub":
            out["frontend_emb"] = spec((b, cfg.frontend_len,
                                        cfg.frontend_dim), torch.float32)
        if cfg.encoder is not None:
            out["enc_frames"] = spec((b, cfg.encoder.source_len,
                                      cfg.d_model), torch.float32)
        return out
    # decode: one token against a seq_len-deep cache
    out = {
        "token": spec((b, 1), torch.int32),
        "pos": spec((), torch.int32),
        "caches": tf.cache_shapes(cfg, b, s),
    }
    if cfg.encoder is not None:
        out["cross"] = spec((b, cfg.encoder.source_len, cfg.d_model),
                            torch.bfloat16 if cfg.param_dtype == "bfloat16"
                            else torch.float32)
    return out
