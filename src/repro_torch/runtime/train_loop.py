"""Fault-tolerant training loop: the reference's
``repro.runtime.train_loop`` in PyTorch.

* **checkpoint / restart**: periodic async checkpoints of the params,
  the optimizer state and the step; on start the loop restores the
  newest checkpoint and replays the data stream from the restored step
  (batches are index-addressable, so restart is exact);
* **failure handling**: an exception mid-run leaves the newest checkpoint
  intact (atomic publish), and the in-flight save is flushed in
  ``finally``; an injectable failure hook kills the loop at a chosen step;
* **straggler mitigation**: a per-step wall-time EWMA; a step slower than
  ``straggler_factor`` times the EWMA, or past ``step_deadline_s``, fires
  a callback with its record;
* **gradient compression**: opt-in int8 with error feedback on the
  gradients (``runtime/compression.py``), accumulated in float32.

The model and the optimizer state live on ``device`` (default: the card,
``RuntimeError`` without one); the step updates them in place."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.device import resolve_device
from repro_torch.launch.steps import accumulated_grads, loss_and_grads, make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.compression import compress_grads, init_error_feedback


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """The train step with the gradients int8-compressed (error feedback in
    ``opt_state["error_feedback"]``) before AdamW, the reference trainer's
    ``_with_compression``: the microbatch gradients accumulate in float32
    whatever ``cfg.grad_accum_dtype`` says, as the reference's do."""
    N = cfg.train_microbatches

    def step(params, opt_state, batch):
        inner = {k: opt_state[k] for k in ("mu", "nu", "step")}
        if N <= 1:
            loss, grads = loss_and_grads(cfg, params, batch)
        else:
            grads, loss = accumulated_grads(cfg, params, batch, N, torch.float32)
        grads, new_ef = compress_grads(grads, opt_state["error_feedback"])
        params, inner, metrics = adamw_update(grads, inner, params, opt_cfg)
        return params, dict(inner, error_feedback=new_ef), {"loss": loss, **metrics}

    return step


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0
    step_deadline_s: float | None = None
    grad_compression: bool = False
    seed: int = 0


@dataclass
class StepRecord:
    step: int
    loss: float
    grad_norm: float
    wall_s: float
    straggler: bool = False


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        data,
        store: CheckpointStore,
        loop_cfg: TrainLoopConfig | None = None,
        opt_cfg: AdamWConfig | None = None,
        failure_hook: Callable[[int], None] | None = None,
        straggler_hook: Callable[[StepRecord], None] | None = None,
        device=None,
    ):
        self.cfg = model_cfg
        self.data = data
        self.store = store
        self.loop_cfg = loop_cfg or TrainLoopConfig()
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.failure_hook = failure_hook
        self.straggler_hook = straggler_hook
        self.device = resolve_device(device)
        self.history: list[StepRecord] = []
        self._step_fn = (make_compressed_train_step(self.cfg, self.opt_cfg)
                         if self.loop_cfg.grad_compression
                         else make_train_step(self.cfg, self.opt_cfg))

    # -- state ----------------------------------------------------------------
    def init_state(self) -> tuple[T.Transformer, dict, int]:
        """Weights drawn from a ``torch.Generator`` on the device seeded with
        ``loop_cfg.seed``; float32 moments, as the reference's trainer
        makes them; the error feedback where compression is on."""
        gen = torch.Generator(device=self.device).manual_seed(self.loop_cfg.seed)
        params = T.init_params(self.cfg, generator=gen, device=self.device)
        opt = adamw_init(params)
        if self.loop_cfg.grad_compression:
            opt = dict(opt, error_feedback=init_error_feedback(params))
        return params, opt, 0

    def restore_or_init(self) -> tuple[T.Transformer, dict, int]:
        params, opt, _ = self.init_state()
        if self.store.latest_step() is None:
            return params, opt, 0
        (params, opt), extra = self.store.restore((params, opt))
        return params, opt, int(extra["next_step"])

    # -- run -------------------------------------------------------------------
    def run(self, max_steps: int | None = None) -> list[StepRecord]:
        params, opt, start = self.restore_or_init()
        total = self.loop_cfg.total_steps if max_steps is None else start + max_steps
        ewma = None
        try:
            for step in range(start, total):
                if self.failure_hook is not None:
                    self.failure_hook(step)  # may raise: a simulated node failure
                t0 = time.monotonic()
                batch = self.data.batch_at(step)
                params, opt, metrics = self._step_fn(params, opt, batch)
                loss = float(metrics["loss"])  # waits for the step
                wall = time.monotonic() - t0
                ewma = wall if ewma is None else 0.9 * ewma + 0.1 * wall
                straggler = (
                    wall > self.loop_cfg.straggler_factor * ewma
                    or (self.loop_cfg.step_deadline_s is not None
                        and wall > self.loop_cfg.step_deadline_s)
                )
                rec = StepRecord(step, loss, float(metrics["grad_norm"]), wall, straggler)
                self.history.append(rec)
                if straggler and self.straggler_hook is not None:
                    self.straggler_hook(rec)
                if (step + 1) % self.loop_cfg.ckpt_every == 0 or step + 1 == total:
                    self.store.save_async(step + 1, (params, opt),
                                          extra={"next_step": step + 1})
        finally:
            # flush the in-flight save even when a step raises: its snapshot
            # was taken, and losing it on a crash is the failure mode
            # checkpointing exists to prevent
            self.store.wait()
        self._final = (params, opt)
        return self.history
