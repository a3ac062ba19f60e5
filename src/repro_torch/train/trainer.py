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
  lets the step in flight finish, saves it, and stops. On a mesh the flag
  is agreed across the ranks after every step (``Mesh.agree``, the max
  over ranks, outside the train step): a stop requested on any rank stops
  every rank after the same step, and they save it together.

The step runs eagerly on ``device`` and donates the state (its optimizer
tensors are updated in place). On a card, ``library_eval``'s scatter-free
table reads are deterministic but autograd's index backward (the
embedding's, the MoE combine's) accumulates in no fixed order, so a run
resumed from a checkpoint matches a straight run to float rounding, not
bitwise.

``mesh=`` (``launch.mesh.make_host_mesh``), as the reference's
``Trainer(cfg, tc, mesh, shard_batch, shard_state)``: every rank builds
the same full state, restores the same checkpoint, and keeps its shard
(``shard_state``, by default ``train.step.shard_state``); each step takes
this rank's rows of the global batch (``shard_batch``, by default the
``data`` index's contiguous rows). A checkpoint holds the full state: the
shards are all-gathered over ``model`` on every rank, rank 0 writes, and
every rank waits for the write, so any mesh (or none) restores it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.util.tree import tree_leaves

from repro_torch.checkpoint import CheckpointManager, save
from repro_torch.data.synthetic import dataset_for
from repro_torch.train import step as step_mod
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
    def __init__(self, cfg, tc: TrainerConfig, mesh=None, shard_batch=None,
                 shard_state=None, device: str | torch.device = "cuda"):
        self.cfg, self.tc = cfg, tc
        self.mesh = mesh
        # the rank that logs and writes checkpoints
        self._lead = mesh is None or mesh.lead
        if mesh is not None and shard_batch is None:
            n = mesh.shape["data"]
            if tc.global_batch % n:
                raise ValueError(f"global batch {tc.global_batch} does not "
                                 f"split over data={n}")
            lo = mesh.index("data") * (tc.global_batch // n)
            hi = lo + tc.global_batch // n

            def shard_batch(b):
                return {k: v[lo:hi] for k, v in b.items()}
        if mesh is not None and shard_state is None:
            def shard_state(st):
                return step_mod.shard_state(st, cfg, mesh)
        self.shard_batch = shard_batch or (lambda b: b)
        self.data = dataset_for(cfg, tc.seq_len, tc.global_batch, tc.seed)
        self.ckpt = CheckpointManager(tc.ckpt_dir, tc.ckpt_every,
                                      tc.ckpt_keep)
        self.step_fn = make_train_step(cfg, tc.step, donate=True, mesh=mesh)
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
        if shard_state is not None:
            state = shard_state(state)
        self.state: TrainState = state

    def request_stop(self):
        self._stop = True

    def run(self) -> list[dict]:
        ema = None
        for step in range(self.start_step, self.tc.steps):
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(
                self.state, self.shard_batch(self.data.batch_at(step)), step)
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
            if step % self.tc.log_every == 0 and self._lead:
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics['lr']:.2e} gnorm "
                      f"{metrics['grad_norm']:.2f} {dt * 1e3:.0f} ms",
                      flush=True)
            saved = self._save(step)
            stop = self._stop
            if self.mesh is not None:  # one stop for every rank
                stop = self.mesh.agree([stop], "or")[0]
            if stop:
                if not saved:
                    self._save(step, force=True)
                break
        return self.history

    def _save(self, step: int, force: bool = False) -> bool:
        """Checkpoint ``step`` every ``ckpt_every`` steps (or now, with
        ``force``); on a mesh the full state from rank 0, every rank
        waiting for the write."""
        if not force and step % self.ckpt.every:
            return False
        state = self.state
        if self.mesh is not None:
            state = step_mod.gather_state(state, self.cfg, self.mesh)
        if self._lead:
            if force:
                save(self.tc.ckpt_dir, step, state, {"step": step})
            else:
                self.ckpt.maybe_save(step, state, {"step": step})
        if self.mesh is not None:  # every rank sees the committed step
            dev = tree_leaves(state.params)[0].device
            self.mesh.all_reduce(torch.zeros(1, device=dev), None)
        return True
