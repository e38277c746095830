"""Fault-tolerant training loop: checkpoint/restart, failure handling,
straggler monitoring — the port of ``repro.train.trainer`` on one device.

Mirrors the paper's recovery philosophy at trainer scale:
  * periodic atomic commits (async), a ``clean`` marker set on the graceful
    stop's final commit;
  * a step failure (a raised step, a non-finite loss, an injected fault)
    restores from the last commit — the restore's manifest read is instant —
    and continues; past ``max_restarts`` failures the error is raised;
  * the straggler monitor flags steps whose wall time exceeds
    mean + k * sigma of the recent window.

The trainer runs on the card unless ``device`` names another and raises
without one. Each step's wall time is taken with the device synced, so it
covers the whole step (forward, backward and AdamW).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from collections import deque
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.layout import resolve_device
from repro_torch.models.transformer import ModelConfig, init_params
from repro_torch.train.steps import (TrainState, make_train_step, master_params, state_to,
                                     train_state_init)


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    async_checkpoint: bool = True
    max_restarts: int = 3
    straggler_window: int = 20
    straggler_sigma: float = 3.0
    peak_lr: float = 3e-4


class StragglerMonitor:
    """Per-step wall-time outlier detection (host-side)."""

    def __init__(self, window: int, sigma: float):
        self.times = deque(maxlen=window)
        self.sigma = sigma
        self.flagged = []

    def record(self, step: int, seconds: float) -> bool:
        is_straggler = False
        if len(self.times) >= max(5, self.times.maxlen // 2):
            mean = float(np.mean(self.times))
            std = float(np.std(self.times)) + 1e-9
            if seconds > mean + self.sigma * std:
                self.flagged.append((step, seconds, mean))
                is_straggler = True
        self.times.append(seconds)
        return is_straggler


def init_state(cfg: ModelConfig, seed: int, device) -> TrainState:
    """A step-0 state whose f32 masters are the initialisation drawn in f32
    on ``device`` from ``seed`` (the reference's f32 parameters; the working
    model rounds them to the compute dtype)."""
    return train_state_init(master_params(
        init_params(dataclasses.replace(cfg, dtype="float32"), seed, device)))


class Trainer:
    """``state``, when given, is the step-0 (or any) ``TrainState`` to start
    from; it is moved to ``device`` and updated in place. Otherwise the
    weights are drawn from ``seed``."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig, data_iter: Iterator[dict],
                 fault_hook: Optional[Callable[[int], None]] = None, seed: int = 0,
                 device=None, state: Optional[TrainState] = None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.data_iter = data_iter
        self.fault_hook = fault_hook          # raises to simulate failures
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir, tcfg.keep_checkpoints)
        self.monitor = StragglerMonitor(tcfg.straggler_window, tcfg.straggler_sigma)
        self.step_fn = make_train_step(cfg, peak_lr=tcfg.peak_lr)
        self.state = (init_state(cfg, seed, self.device) if state is None
                      else state_to(state, self.device))
        self.metrics_log = []
        self.restarts = 0
        self.version = 1

    # -- recovery ---------------------------------------------------------

    def _restore(self):
        self.ckpt.wait()          # an in-flight async commit must land first
        manifest, lazy, secs = self.ckpt.restore_manifest()
        if manifest is None:
            raise RuntimeError("no checkpoint to restore from")
        self.version = manifest["version"]
        self.state = self.ckpt.restore_tree(self.state, lazy)
        return manifest["step"], secs

    def resume_if_possible(self) -> Optional[int]:
        if self.ckpt.latest_step() is None:
            return None
        step, _ = self._restore()
        return step

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- main loop --------------------------------------------------------

    def run(self) -> dict:
        step = int(self.state.step)
        while step < self.tcfg.total_steps:
            batch = {k: torch.as_tensor(np.asarray(v), device=self.device)
                     for k, v in next(self.data_iter).items()}
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                self.state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics["loss"])
                grad_norm = float(metrics["grad_norm"])
                self._sync()
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
            except Exception as e:                      # failure path
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts:
                    raise
                restored_step, secs = self._restore()
                self.metrics_log.append(
                    {"step": step, "event": "restart", "error": repr(e),
                     "restored_step": restored_step, "manifest_restore_s": secs,
                     "restore_s": self.ckpt.last_restore["seconds"]})
                step = restored_step
                # a fresh working model (a real device failure would re-init it)
                self.step_fn = make_train_step(self.cfg, peak_lr=self.tcfg.peak_lr)
                continue

            dt = time.perf_counter() - t0
            straggler = self.monitor.record(step, dt)
            self.metrics_log.append({"step": step, "loss": loss, "seconds": dt,
                                     "straggler": straggler, "grad_norm": grad_norm})
            step += 1
            if step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step, self.state, clean=False, version=self.version,
                               blocking=not self.tcfg.async_checkpoint)
        # graceful shutdown: final clean commit (paper's clean marker)
        self.ckpt.wait()
        self.ckpt.save(step, self.state, clean=True, version=self.version, blocking=True)
        return {"final_step": step, "restarts": self.restarts,
                "stragglers": list(self.monitor.flagged), "log": self.metrics_log}
