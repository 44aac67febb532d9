"""Trainer: the epoch and step loop with validation, checkpoints and resume
(port of funasr_tpu/train/trainer.py; reference
funasr/train_utils/trainer.py:33).

A step's statistics stay on the device and are read back only every
``log_interval`` steps; the global step is counted on the host, so the loop
makes no other read-back.  Validation runs every ``validate_interval``
steps, a checkpoint every ``save_checkpoint_interval`` steps and at each
epoch's end (validated first), keep-n-best by the validation metric.  A
resumed run re-enters the epoch at the sampler's start step and seeds step
``g`` from ``(seed, g)`` as the uninterrupted run did, so both end on the
same parameters.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from funasr_torch.train.train_step import TrainState

log = logging.getLogger(__name__)


def step_seed(seed: int, step: int) -> int:
    """The seed of global step ``step`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])


class Trainer:
    def __init__(self, train_step: Callable, eval_step: Optional[Callable] = None,
                 checkpoint_manager=None, max_epoch: int = 100,
                 validate_interval: int = 5000, save_checkpoint_interval: int = 5000,
                 log_interval: int = 50, metric: str = "acc", seed: int = 0):
        """``train_step(state, batch, rng) -> (state, stats)``;
        ``eval_step(batch) -> stats``."""
        self.train_step = train_step
        self.eval_step = eval_step
        self.ckpt = checkpoint_manager
        self.max_epoch = max_epoch
        self.validate_interval = validate_interval
        self.save_checkpoint_interval = save_checkpoint_interval
        self.log_interval = log_interval
        self.metric = metric
        self.seed = seed
        self.start_epoch = 0
        self.start_step = 0
        self.history: List[Dict[str, float]] = []  # the statistics read at each log

    # ------------------------------------------------------------- resume
    def resume(self, state: TrainState) -> TrainState:
        """Load the latest checkpoint into ``state``, if there is one."""
        if self.ckpt is None:
            return state
        latest = self.ckpt.latest_step()
        if latest is None:
            return state
        payload = self.ckpt.restore(latest)
        state.load_state_dict(payload["state"])
        extra = payload.get("extra", {})
        self.start_epoch = int(extra.get("epoch", 0))
        self.start_step = int(extra.get("step_in_epoch", 0))
        log.info("resumed from step %s (epoch %d, step-in-epoch %d)",
                 latest, self.start_epoch, self.start_step)
        return state

    # -------------------------------------------------------------- train
    def run(self, state: TrainState,
            build_iter: Callable[[int, int], Iterable[Dict[str, Any]]],
            valid_iter: Optional[Callable[[], Iterable[Dict[str, Any]]]] = None) -> TrainState:
        gstep = int(state.step)
        last_val_step, val = -1, None
        for epoch in range(self.start_epoch, self.max_epoch):
            step_in_epoch = self.start_step if epoch == self.start_epoch else 0
            t_last = time.time()
            for batch in build_iter(epoch, step_in_epoch):
                state, stats = self.train_step(state, batch, step_seed(self.seed, gstep))
                gstep += 1
                step_in_epoch += 1
                if gstep % self.log_interval == 0:
                    stats = {k: float(v) for k, v in stats.items()}
                    dt = (time.time() - t_last) / self.log_interval
                    t_last = time.time()
                    self.history.append(dict(stats, step=gstep, epoch=epoch, s_per_step=dt))
                    log.info("epoch %d step %d loss %.4f acc %.4f gnorm %.2f %.3fs/step",
                             epoch, gstep, stats.get("loss", float("nan")),
                             stats.get("acc", float("nan")),
                             stats.get("grad_norm", float("nan")), dt)
                # validation on its own interval (reference trainer.py:497)
                if self.validate_interval and gstep % self.validate_interval == 0:
                    val = self._validate(gstep, valid_iter)
                    last_val_step = gstep
                if self.ckpt is not None and gstep % self.save_checkpoint_interval == 0:
                    if last_val_step != gstep:
                        val = self._validate(gstep, valid_iter)
                        last_val_step = gstep
                    self.ckpt.save(gstep, state.state_dict(),
                                   extra={"epoch": epoch, "step_in_epoch": step_in_epoch},
                                   val_metric=val)
            if self.ckpt is not None:  # epoch boundary: validate + checkpoint
                val = self._validate(gstep, valid_iter)
                self.ckpt.save(gstep, state.state_dict(),
                               extra={"epoch": epoch + 1, "step_in_epoch": 0},
                               val_metric=val)
        return state

    def _validate(self, gstep: int, valid_iter) -> Optional[float]:
        if self.eval_step is None or valid_iter is None:
            return None
        totals: Dict[str, torch.Tensor] = {}
        n = 0
        for batch in valid_iter():
            for k, v in self.eval_step(batch).items():
                totals[k] = totals.get(k, 0.0) + v.to(torch.float64)
            n += 1
        if n == 0:
            return None
        avg = {k: float(v) / n for k, v in totals.items()}
        log.info("validation at step %d: %s", gstep, avg)
        self.history.append(dict({f"valid_{k}": v for k, v in avg.items()}, step=gstep))
        return avg.get(self.metric)
