"""The training step: forward and backward over ``accum_grad`` micro-batches,
global-norm clipping, the optimizer update and non-finite-step skipping
(port of funasr_tpu/train/train_step.py; reference
funasr/train_utils/trainer.py:335-476).

The parameters live in one flat float32 tensor (``TrainState.params``); the
model's parameters are views of it (:func:`flatten_parameters`), so the
optimizer's arithmetic (``train/optim.py``) and the non-finite selection are
a few elementwise operations on the device.  The step reads nothing back to
the host: the loss, the statistics and ``grad_norm`` stay 0-d device
tensors, and a non-finite step is undone with ``torch.where``.

Semantics kept from the JAX package:

- gradients are summed over the ``accum_grad`` micro-batches (a leading
  axis of every batch tensor) and divided by ``accum_grad``; the statistics
  are their float32 means;
- ``grad_norm`` is the global norm before clipping (clipping is the
  optimizer's first stage);
- a step whose gradient norm is not finite leaves the parameters, the
  moments and the optimizer's count unchanged; ``state.step`` still
  advances.

Randomness: each micro-batch reseeds the default generators (dropout, the
recomputed layers of ``remat``) and a ``torch.Generator`` for the glancing
sampler's noise from the step's ``rng`` (an int), so a step is a function of
its inputs, and a run resumed from a checkpoint repeats the uninterrupted
one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from funasr_torch.train.optim import Optimizer, global_norm


def flatten_parameters(model: nn.Module) -> torch.Tensor:
    """Move every parameter of ``model`` into one flat float32 tensor, in
    ``model.parameters()`` order, and make the parameters views of it.
    Returns the flat tensor.  Move or cast the model before this: the train
    step refuses parameters that are no longer views (:func:`check_views`)."""
    params = list(model.parameters())
    bad = [p.dtype for p in params if p.dtype != torch.float32]
    if bad:
        raise ValueError(f"flatten_parameters: training keeps float32 parameters, got {bad[0]} "
                         "(build the model with param_dtype=torch.float32)")
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    offset = 0
    for p in params:
        n = p.numel()
        p.data = flat[offset:offset + n].view_as(p)
        offset += n
    return flat


def check_views(params: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Raise unless every parameter is still its view of ``flat``.  A
    ``model.to()``, ``.half()`` or ``.cuda()`` that reallocates a parameter
    cuts it off: the optimizer would update a tensor that the forward never
    reads.  Compares pointers on the host; no device work."""
    base, size, offset = flat.data_ptr(), flat.element_size(), 0
    for p in params:
        if p.dtype != flat.dtype or p.data_ptr() != base + offset * size:
            raise RuntimeError(
                "train_step: a model parameter is no longer a view of TrainState.params "
                "(the model was moved or cast after create_train_state); move or cast "
                "the model first, then create the train state")
        offset += p.numel()


def views_of(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    """Views of ``flat`` shaped as ``like``, packed in order."""
    out, offset = [], 0
    for t in like:
        out.append(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return out


class TrainState:
    """The model (its parameters views of ``params``), the flat float32
    parameters, the optimizer state and the step counter (an int32 0-d
    device tensor)."""

    def __init__(self, model: nn.Module, params: torch.Tensor,
                 opt_state: Dict[str, torch.Tensor], step: torch.Tensor):
        self.model = model
        self.params = params
        self.opt_state = opt_state
        self.step = step

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.params, "opt_state": dict(self.opt_state), "step": self.step}

    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        """Copy a :meth:`state_dict` (as saved, on any device) into this state."""
        self.params.copy_(payload["params"])
        for key, value in payload["opt_state"].items():
            self.opt_state[key].copy_(value)
        self.step.copy_(payload["step"])

    def named_parameters(self, flat: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """``{name: tensor}`` of ``flat`` (default: the current parameters)
        in the model's parameter names and shapes."""
        names, params = zip(*self.model.named_parameters())
        flat = self.params if flat is None else flat
        return dict(zip(names, views_of(flat, list(params))))


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    flat = flatten_parameters(model)
    return TrainState(model, flat, tx.init(flat),
                      torch.zeros((), dtype=torch.int32, device=flat.device))


def micro_seeds(rng: int, n: int) -> List[Tuple[int, int]]:
    """``n`` (dropout seed, sampler seed) pairs derived from ``rng``."""
    s = np.random.SeedSequence(int(rng)).generate_state(2 * n, np.uint64)
    return [(int(s[2 * i] >> np.uint64(1)), int(s[2 * i + 1] >> np.uint64(1)))
            for i in range(n)]


def make_train_step(model: nn.Module, tx: Optimizer, accum_grad: int = 1
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor], int],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch, rng) -> (state, stats)``.

    ``batch`` = dict(speech, speech_lengths, text, text_lengths) on the
    model's device; with ``accum_grad > 1`` every tensor carries a leading
    micro-batch axis.  ``rng`` is the step's seed.  The state is updated in
    place and returned; ``stats`` are the model's statistics plus
    ``grad_norm`` and ``finite``, 0-d device tensors."""
    params = list(model.parameters())
    grad_buf: List[Optional[torch.Tensor]] = [None]

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], rng: int):
        check_views(params, state.params)
        model.train()
        device = state.params.device
        if grad_buf[0] is None:
            grad_buf[0] = torch.zeros_like(state.params)
        grads = grad_buf[0].zero_()
        views = views_of(grads, params)
        totals: Dict[str, torch.Tensor] = {}
        for i, (drop_seed, samp_seed) in enumerate(micro_seeds(rng, accum_grad)):
            micro = batch if accum_grad == 1 else {k: v[i] for k, v in batch.items()}
            torch.manual_seed(drop_seed)
            gen = torch.Generator(device=device)
            gen.manual_seed(samp_seed)
            loss, stats = model(micro["speech"], micro["speech_lengths"], micro["text"],
                                micro["text_lengths"], generator=gen)
            g = torch.autograd.grad(loss, params, allow_unused=True)
            used = [(v, gi) for v, gi in zip(views, g) if gi is not None]
            torch._foreach_add_([v for v, _ in used], [gi for _, gi in used])
            for k, v in stats.items():
                v = v.detach()
                totals[k] = v if accum_grad == 1 else totals.get(k, 0) + v.to(torch.float32)
        if accum_grad > 1:
            grads = grads / accum_grad
            totals = {k: v / accum_grad for k, v in totals.items()}
        gnorm = global_norm(grads)
        finite = torch.isfinite(gnorm)
        safe = torch.where(finite, grads, 0.0)
        updates, new_opt = tx.update(safe, state.opt_state, state.params)
        state.params.copy_(torch.where(finite, state.params + updates, state.params))
        for key, value in new_opt.items():
            state.opt_state[key].copy_(torch.where(finite, value, state.opt_state[key]))
        state.step.add_(1)
        totals["grad_norm"] = gnorm
        totals["finite"] = finite.to(torch.float32)
        return state, totals

    return train_step


def make_eval_step(model: nn.Module) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Returns ``eval_step(batch) -> {"loss", "acc"}``: the training forward
    in ``eval()`` mode under ``torch.no_grad()`` (no dropout, no sampler; the
    attention kernel on the card), as the JAX package's ``deterministic=True``
    validation (bin/train.py:202-206 there)."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.eval()
        loss, stats = model(batch["speech"], batch["speech_lengths"], batch["text"],
                            batch["text_lengths"])
        return {"loss": loss, "acc": stats["acc"]}

    return eval_step
