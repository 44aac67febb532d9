"""Optimizers and learning-rate schedules (port of funasr_tpu/train/optim.py;
reference funasr/optimizers/__init__.py:5,
funasr/schedulers/{warmup_lr,noam_lr,tri_stage_scheduler}.py).

The JAX package builds an optax chain; this module computes the same
updates in PyTorch, in optax's arithmetic and order, on one flat float32
tensor that holds every parameter (``train/train_step.py`` keeps the
model's parameters as views of it), so each step of the chain is one
elementwise operation on the device:

- ``clip_by_global_norm(max_norm)``: ``g`` where ``|g| < max_norm``, else
  ``(g / |g|) * max_norm`` (no epsilon, unlike ``clip_grad_norm_``);
- ``adam`` / ``fairseq_adam`` (``scale_by_adam``: ``b1`` 0.9, ``b2`` 0.999,
  ``eps`` 1e-8, ``eps_root`` 0), ``adamw`` (adam, then ``+ weight_decay *
  p``, optax's default ``weight_decay`` 1e-4), ``sgd`` (optional
  ``momentum`` trace, ``nesterov``);
- the learning rate ``schedule(count)`` scales by ``-lr``, where ``count``
  is the optimizer's own update count, 0 at the first update (optax's
  ``scale_by_schedule``).

Schedules are functions of a 0-d device tensor (the count) returning a 0-d
float32 tensor, so a step reads nothing back to the host:

- warmuplr (warmup_lr.py:11): ``lr * warmup^0.5 * min(step^-0.5,
  step * warmup^-1.5)``, ``step = max(count, 1)``;
- noamlr (noam_lr.py:12): ``lr * d^-0.5 * min(step^-0.5, step * warmup^-1.5)``;
- tri_stage (tri_stage_scheduler.py:15): linear warmup to the peak, hold,
  then exponential decay to ``final_lr_scale``;
- constant.

Non-finite steps are skipped by the train step, not here.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]


def warmup_lr_schedule(lr: float, warmup_steps: int = 25000) -> Schedule:
    def schedule(count: torch.Tensor) -> torch.Tensor:
        s = torch.clamp(count.to(torch.float32), min=1.0)
        return lr * warmup_steps ** 0.5 * torch.minimum(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def noam_lr_schedule(lr: float, model_size: int = 320,
                     warmup_steps: int = 25000) -> Schedule:
    def schedule(count: torch.Tensor) -> torch.Tensor:
        s = torch.clamp(count.to(torch.float32), min=1.0)
        return lr * model_size ** -0.5 * torch.minimum(s ** -0.5, s * warmup_steps ** -1.5)

    return schedule


def tri_stage_schedule(lr: float, phase_ratio=(0.1, 0.4, 0.5), total_steps: int = 100000,
                       init_lr_scale: float = 0.01, final_lr_scale: float = 0.01) -> Schedule:
    w = int(phase_ratio[0] * total_steps)
    h = int(phase_ratio[1] * total_steps)
    d = int(phase_ratio[2] * total_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        s = count.to(torch.float32)
        warm = lr * (init_lr_scale + (1 - init_lr_scale)
                     * torch.clamp(s / max(w, 1), max=1.0))
        decay_frac = torch.clamp((s - w - h) / max(d, 1), 0.0, 1.0)
        decay = lr * torch.exp(math.log(final_lr_scale) * decay_frac)
        return torch.where(s < w, warm, torch.where(s < w + h, lr, decay))

    return schedule


def constant_schedule(lr: float) -> Schedule:
    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr, dtype=torch.float32, device=count.device)

    return schedule


SCHEDULER_BUILDERS = {
    "warmuplr": lambda lr, conf: warmup_lr_schedule(lr, conf.get("warmup_steps", 25000)),
    "noamlr": lambda lr, conf: noam_lr_schedule(
        lr, conf.get("model_size", 320), conf.get("warmup_steps", 25000)),
    "tri_stage": lambda lr, conf: tri_stage_schedule(
        lr, conf.get("phase_ratio", (0.1, 0.4, 0.5)), conf.get("total_steps", 100000),
        conf.get("init_lr_scale", 0.01), conf.get("final_lr_scale", 0.01)),
    "constant": lambda lr, conf: constant_schedule(lr),
}


class Optimizer:
    """The optax chain ``clip_by_global_norm -> optimizer(schedule)`` on flat
    float32 tensors: :meth:`init` gives the state (``count`` an int32 0-d
    tensor, the moments or the momentum trace), :meth:`update` the updates
    and the new state, both without touching the parameters."""

    def __init__(self, kind: str, schedule: Schedule, grad_clip: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 eps_root: float = 0.0, weight_decay: float = 1e-4,
                 momentum: Optional[float] = None, nesterov: bool = False):
        self.kind = kind
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        state = {"count": torch.zeros((), dtype=torch.int32, device=params.device)}
        if self.kind == "sgd":
            if self.momentum is not None:
                state["trace"] = torch.zeros_like(params)
        else:
            state["mu"] = torch.zeros_like(params)
            state["nu"] = torch.zeros_like(params)
        return state

    def update(self, grads: torch.Tensor, state: Dict[str, torch.Tensor],
               params: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        g = grads
        if self.grad_clip and self.grad_clip > 0:
            g = clip_by_global_norm(g, self.grad_clip)
        count = state["count"]
        count_inc = count + 1
        new = {"count": count_inc}
        if self.kind == "sgd":
            u = g
            if self.momentum is not None:
                trace = g + self.momentum * state["trace"]
                u = g + self.momentum * trace if self.nesterov else trace
                new["trace"] = trace
        else:
            mu = (1 - self.b1) * g + self.b1 * state["mu"]
            nu = (1 - self.b2) * (g * g) + self.b2 * state["nu"]
            c = count_inc.to(torch.float32)
            mu_hat = mu / (1 - self.b1 ** c)
            nu_hat = nu / (1 - self.b2 ** c)
            u = mu_hat / (torch.sqrt(nu_hat + self.eps_root) + self.eps)
            if self.kind == "adamw":
                u = u + self.weight_decay * params
            new["mu"], new["nu"] = mu, nu
        step_size = -1 * self.schedule(count)
        return step_size * u, new


def global_norm(g: torch.Tensor) -> torch.Tensor:
    """The float32 2-norm of a flat tensor (optax ``global_norm``: the root
    of the summed squares), the squares summed pairwise: the CPU's
    ``vector_norm`` accumulates float32 in sequence, which drifts with the
    element count."""
    return torch.sqrt(torch.sum(g * g))


def clip_by_global_norm(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``: ``g`` when its norm is below
    ``max_norm``, else ``(g / norm) * max_norm``."""
    g_norm = global_norm(g)
    return torch.where(g_norm < max_norm, g, (g / g_norm) * max_norm)


def build_optimizer(optim: str = "adam", optim_conf: Optional[Dict[str, Any]] = None,
                    scheduler: str = "warmuplr",
                    scheduler_conf: Optional[Dict[str, Any]] = None,
                    grad_clip: float = 5.0) -> Tuple[Optimizer, Schedule]:
    """-> ``(tx, schedule)``: the clipped optimizer over the named schedule
    (optax's keyword arguments in ``optim_conf``; ``lr`` the base rate)."""
    conf = dict(optim_conf or {})
    lr = float(conf.pop("lr", 1e-3))
    schedule = SCHEDULER_BUILDERS[scheduler](lr, dict(scheduler_conf or {}))
    if optim in ("adam", "fairseq_adam"):
        kind = "adam"
    elif optim == "adamw":
        kind = "adamw"
    elif optim == "sgd":
        kind = "sgd"
    else:
        raise KeyError(f"unknown optimizer {optim!r}")
    allowed = {"adam": ("b1", "b2", "eps", "eps_root"),
               "adamw": ("b1", "b2", "eps", "eps_root", "weight_decay"),
               "sgd": ("momentum", "nesterov")}[kind]
    unknown = set(conf) - set(allowed)
    if unknown:
        raise TypeError(f"{optim}: unexpected optimizer arguments {sorted(unknown)}")
    return Optimizer(kind, schedule, grad_clip, **conf), schedule
