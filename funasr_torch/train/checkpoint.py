"""Checkpoint save and resume, keep-n-best pruning and n-best averaging
(port of funasr_tpu/train/checkpoint.py, on ``torch.save`` instead of orbax;
reference funasr/train_utils/trainer.py:138-330,
average_nbest_models.py:19,61).

- one checkpoint = ``{"state": train state, "extra": {...}}`` in
  ``ckpt-<step>.pt`` (written to a temporary file and renamed, so a reader
  never sees half a file);
- keep-n-best pruning by a validation metric (higher-better acc or
  lower-better loss), the latest step always kept (the resume point);
- ``best_step`` tracks the best scored step;
- ``average_nbest`` averages the parameters of the n best checkpoints in
  float64 and returns float32.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, Dict, List, Optional

import torch

_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep_nbest: int = 10, metric: str = "acc",
                 higher_better: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_nbest = keep_nbest
        self.metric = metric
        self.higher_better = higher_better
        self._scores_path = os.path.join(self.directory, "scores.json")
        self._scores: Dict[str, float] = {}
        if os.path.exists(self._scores_path):
            with open(self._scores_path) as f:
                self._scores = json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt-{step}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    # -------------------------------------------------------------- save
    def save(self, step: int, state: Any, extra: Optional[Dict] = None,
             val_metric: Optional[float] = None) -> None:
        """Write ``state`` (tensors copied to the host) at ``step``; a step
        already saved is kept as it is (the epoch-end save repeats the last
        interval save).  ``val_metric`` scores the step for pruning."""
        if step not in self.all_steps():
            payload = {"state": _to_host(state)}
            if extra is not None:
                payload["extra"] = extra
            tmp = self._path(step) + f".{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
        if val_metric is not None:
            self._scores[str(step)] = float(val_metric)
            self._prune()
            with open(self._scores_path, "w") as f:
                json.dump(self._scores, f)

    def _ranked(self) -> List[tuple]:
        return sorted(self._scores.items(), key=lambda kv: kv[1], reverse=self.higher_better)

    def _prune(self) -> None:
        """Keep the n best scored checkpoints and, always, the latest step;
        unscored older steps go too."""
        keep = {int(s) for s, _ in self._ranked()[: self.keep_nbest]}
        latest = self.latest_step()
        if latest is not None:
            keep.add(latest)
        for step in self.all_steps():
            if step not in keep:
                os.remove(self._path(step))
                self._scores.pop(str(step), None)

    # ------------------------------------------------------------ restore
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        if not self._scores:
            return self.latest_step()
        return int(self._ranked()[0][0])

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Optional[Dict]:
        """The payload of ``step`` (default: the latest), or None."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    # ----------------------------------------------------------- averaging
    def average_nbest(self, n: Optional[int] = None,
                      params_of: Optional[Callable[[Dict], Any]] = None):
        """The float32 average (float64 sums) of the parameters of the n
        best checkpoints, the latest one when none is scored
        (average_nbest_models.py:61).  ``params_of(payload)`` picks them
        (default ``payload["state"]["params"]``): a tensor or a dict of
        tensors."""
        n = n or self.keep_nbest
        steps = [int(s) for s, _ in self._ranked()[:n]] or (
            [self.latest_step()] if self.latest_step() is not None else [])
        if not steps:
            raise ValueError("no checkpoints to average")
        pick = params_of or (lambda p: p["state"]["params"])
        acc = None
        for s in steps:
            params = _as_dict(pick(self.restore(s)))
            if acc is None:
                acc = {k: v.to(torch.float64) for k, v in params.items()}
            else:
                for k, v in params.items():
                    acc[k] += v.to(torch.float64)
        out = {k: (v / len(steps)).to(torch.float32) for k, v in acc.items()}
        return out[None] if list(out) == [None] else out


def _as_dict(params) -> Dict:
    return params if isinstance(params, dict) else {None: params}


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree
