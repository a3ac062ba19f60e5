"""Trainer: the train step, checkpoint / restart and straggler telemetry
(twin of ``repro/train/trainer.py``).

* **Checkpoint / restart**: ``CheckpointManager`` saves atomically every N
  steps; a new trainer restores the latest committed step and the data
  skips ahead to the next one (the Philox stream is keyed on the step, so
  nothing is replayed).
* **Stragglers**: each step's wall time feeds an EMA (the first step
  after start or resume is left out); a step slower than
  ``straggler_factor`` times the EMA is recorded with its index.
* **Preemption**: ``request_stop()`` (SIGTERM in ``launch/train.py``)
  lets the step in flight finish, saves it, and stops.

The step runs eagerly on ``device`` and donates the state (its optimizer
tensors are updated in place). On a card, ``library_eval``'s scatter-free
table reads are deterministic but autograd's index backward (the
embedding's, the MoE combine's) accumulates in no fixed order, so a run
resumed from a checkpoint matches a straight run to float rounding, not
bitwise.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager, save
from repro_torch.data.synthetic import dataset_for
from repro_torch.train.step import (StepConfig, TrainState, make_train_step,
                                    train_state_init)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0
    seq_len: int = 256
    global_batch: int = 8
    straggler_factor: float = 3.0
    step: StepConfig = dataclasses.field(default_factory=StepConfig)


class Trainer:
    def __init__(self, cfg, tc: TrainerConfig,
                 device: str | torch.device = "cuda"):
        self.cfg, self.tc = cfg, tc
        self.data = dataset_for(cfg, tc.seq_len, tc.global_batch, tc.seed)
        self.ckpt = CheckpointManager(tc.ckpt_dir, tc.ckpt_every,
                                      tc.ckpt_keep)
        self.step_fn = make_train_step(cfg, tc.step, donate=True)
        self._stop = False
        self.step_times: list[float] = []
        self.stragglers: list[tuple[int, float]] = []
        self.history: list[dict] = []

        state = train_state_init(cfg, tc.step, tc.seed, device)
        self.start_step = 0
        got = self.ckpt.restore_latest(state)
        if got[0] is not None:
            self.start_step = got[0] + 1
            state = got[1]
        self.state: TrainState = state

    def request_stop(self):
        self._stop = True

    def run(self) -> list[dict]:
        ema = None
        for step in range(self.start_step, self.tc.steps):
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(
                self.state, self.data.batch_at(step), step)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if step > self.start_step:
                if ema is not None and dt > self.tc.straggler_factor * ema:
                    self.stragglers.append((step, dt))
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            metrics["step"] = step
            metrics["wall_s"] = dt
            self.history.append(metrics)
            if step % self.tc.log_every == 0:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} gnorm "
                      f"{metrics['grad_norm']:.2f} {dt * 1e3:.0f} ms",
                      flush=True)
            saved = self.ckpt.maybe_save(step, self.state, {"step": step})
            if self._stop:
                if not saved:
                    save(self.tc.ckpt_dir, step, self.state, {"step": step})
                break
        return self.history
