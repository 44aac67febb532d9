"""CTC prefix scoring: the beam's prefix step and the frame recurrence, the
CUDA kernel's wrappers and their plain twins (port of
funasr_tpu/ops/ctc_prefix_pallas.py ``ctc_recurrence``, body ``_kernel``
:47, of the ``lax.scan`` form ops/beam_search.py:59-81, and of the prologue
around it, ``ctc_prefix_step`` :125).

The recurrence, for every row of the (B, K, W) candidate slots, with both
carries starting at the finite ``NEG_INF``::

    r_nb[t] = xg[t] + lse(r_nb[t-1], phi_shift[t])
    r_b[t]  = xb[t] + lse(r_b[t-1],  r_nb[t-1])

:func:`ctc_prefix_step` is the whole step of the beam in one launch: it
gathers xg from the candidates' rows of the time-minor log-probs, builds
phi_shift from the prefix state, runs the recurrence and returns
``sigma = lse(r_nb[T-1], r_b[T-1])`` with the new state (B, K, W, T, 2),
``[..., 0] = r_nb`` and ``[..., 1] = r_b``, the layout the beam keeps.
:func:`ctc_recurrence` is the Pallas kernel's own contract (phi_shift
given); the beam calls only the step.

- :func:`ctc_prefix_step` and :func:`ctc_recurrence` launch
  ``csrc/ctc_prefix.cu`` for CUDA tensors and count each launch in their
  ``launches``; for CPU tensors they run their twins.  There is no other
  path.
- :func:`ctc_prefix_step_ref` and :func:`ctc_recurrence_ref` are the plain
  PyTorch versions: elementwise ops in the kernel's order, so that on the
  card kernel and twin agree bit for bit (PyTorch's float32 exp/log there
  are the accurate ``expf``/``logf`` the kernel calls).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from funasr_torch.ops import cuda_build

NEG_INF = -1.0e10


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)) with the max clamped at ``NEG_INF``, so two
    ``NEG_INF`` (or -inf) operands give a finite result."""
    mx = torch.clamp(torch.maximum(a, b), min=NEG_INF)
    return mx + torch.log(torch.exp(a - mx) + torch.exp(b - mx))


def ctc_recurrence_ref(xg: torch.Tensor, xb: torch.Tensor,
                       phi_shift: torch.Tensor) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`ctc_recurrence`."""
    B, K, W, T = xg.shape
    out = torch.empty((B, K, W, T, 2), dtype=torch.float32, device=xg.device)
    r_nb = torch.full((B, K, W), NEG_INF, dtype=torch.float32, device=xg.device)
    r_b = r_nb.clone()
    for t in range(T):
        new_nb = xg[..., t] + logaddexp(r_nb, phi_shift[..., t])
        r_b = xb[:, None, None, t] + logaddexp(r_b, r_nb)
        r_nb = new_nb
        out[..., t, 0] = r_nb
        out[..., t, 1] = r_b
    return out


def ctc_prefix_step_ref(x_t: torch.Tensor, r_prev: torch.Tensor, last: torch.Tensor,
                        cand: torch.Tensor, prefix_empty: bool, blank_id: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: same inputs and outputs as :func:`ctc_prefix_step`."""
    B, K, T, _ = r_prev.shape
    W = cand.shape[-1]
    xg = torch.gather(x_t, 1, cand.reshape(B, K * W, 1).expand(B, K * W, T))
    xg = xg.reshape(B, K, W, T)
    xb = x_t[:, blank_id, :].contiguous()  # (B, T)

    r_nb_prev = r_prev[..., 0]  # (B, K, T)
    r_b_prev = r_prev[..., 1]
    same = cand == last[:, :, None]  # (B, K, W)
    # phi(t): mass of g ending at frame t usable before emitting v at t+1
    phi_all = logaddexp(r_nb_prev, r_b_prev)  # (B, K, T)
    phi = torch.where(same[..., None], r_b_prev[:, :, None, :],
                      phi_all[:, :, None, :])  # (B, K, W, T)
    phi0 = torch.full((B, K, W, 1), 0.0 if prefix_empty else NEG_INF,
                      dtype=torch.float32, device=x_t.device)
    phi_shift = torch.cat([phi0, phi[..., :-1]], dim=-1)

    r_new = ctc_recurrence_ref(xg, xb, phi_shift)  # (B, K, W, T, 2)
    sigma = logaddexp(r_new[..., -1, 0], r_new[..., -1, 1])  # (B, K, W)
    return sigma, r_new


def ctc_prefix_step(x_t: torch.Tensor, r_prev: torch.Tensor, last: torch.Tensor,
                    cand: torch.Tensor, prefix_empty: bool, blank_id: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score extending each prefix with each candidate.

    x_t (B, V, T) float32 masked CTC log-probs, time-minor; r_prev (B, K, T,
    2) float32 [nb, b] state of each prefix (a stride-0 K axis, the step-0
    broadcast, is taken as it is); last (B, K) int64 last token; cand (B,
    K, W) int64 candidate extensions in [0, V); prefix_empty: the prefixes
    hold no token yet (step 0).  Returns (sigma (B, K, W) total prefix
    scores, r_new (B, K, W, T, 2)), both float32."""
    cuda_build.refuse_autograd("ctc_prefix_step", x_t, r_prev, last, cand)
    if x_t.device.type == "cpu":
        return ctc_prefix_step_ref(x_t, r_prev, last, cand, prefix_empty, blank_id)
    if x_t.device.type != "cuda":
        raise ValueError(f"ctc_prefix_step: unsupported device {x_t.device}")
    return _launch_step(x_t, r_prev, last, cand, prefix_empty, blank_id)


_STEP_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                  + ([ctypes.c_void_p] + [ctypes.c_int64] * 2) * 2
                  + [ctypes.c_void_p] + [ctypes.c_int64] * 3 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p] * 3)


def _launch_step(x_t, r_prev, last, cand, prefix_empty, blank_id):
    """Check the step's operands, allocate its outputs and launch
    ``ctc_prefix_step_forward``.  last and cand are passed with their
    strides, r_prev with those of its two hypothesis axes."""
    if x_t.dim() != 3 or r_prev.dim() != 4 or r_prev.shape[-1] != 2:
        raise ValueError(f"ctc_prefix_step: x_t {tuple(x_t.shape)} must be (B, V, T) and "
                         f"r_prev {tuple(r_prev.shape)} (B, K, T, 2)")
    B, V, T = x_t.shape
    K = r_prev.shape[1]
    if r_prev.shape[0] != B or r_prev.shape[2] != T or T < 1:
        raise ValueError(f"ctc_prefix_step: r_prev {tuple(r_prev.shape)} does not match "
                         f"x_t {tuple(x_t.shape)} (B, T >= 1)")
    if last.shape != (B, K) or cand.dim() != 3 or cand.shape[:2] != (B, K):
        raise ValueError(f"ctc_prefix_step: last {tuple(last.shape)} must be ({B}, {K}) and "
                         f"cand {tuple(cand.shape)} ({B}, {K}, W)")
    W = cand.shape[2]
    if x_t.dtype != torch.float32 or r_prev.dtype != torch.float32:
        raise ValueError("ctc_prefix_step: x_t and r_prev must be float32")
    if last.dtype != torch.int64 or cand.dtype != torch.int64:
        raise ValueError("ctc_prefix_step: last and cand must be int64")
    if not all(t.device == x_t.device for t in (r_prev, last, cand)):
        raise ValueError("ctc_prefix_step: inputs on different devices")
    if not 0 <= blank_id < V:
        raise ValueError(f"ctc_prefix_step: blank_id {blank_id} outside [0, {V})")
    x_t = x_t.contiguous()
    if r_prev.stride(3) != 1 or r_prev.stride(2) != 2:  # frames as (t, 2) pairs
        r_prev = r_prev.contiguous()
    r_new = torch.empty((B, K, W, T, 2), dtype=torch.float32, device=x_t.device)
    sigma = torch.empty((B, K, W), dtype=torch.float32, device=x_t.device)
    fn = cuda_build.function("ctc_prefix", "ctc_prefix_step_forward", _STEP_ARGTYPES)
    status = fn(x_t.data_ptr(), B, V, T, r_prev.data_ptr(), *r_prev.stride()[:2],
                last.data_ptr(), *last.stride(), cand.data_ptr(), *cand.stride(), K, W,
                int(bool(prefix_empty)), int(blank_id), r_new.data_ptr(), sigma.data_ptr(),
                torch.cuda.current_stream(x_t.device).cuda_stream)
    cuda_build.check(status, "ctc prefix step kernel launch")
    ctc_prefix_step.launches += 1
    return sigma, r_new


ctc_prefix_step.launches = 0

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def ctc_recurrence(xg: torch.Tensor, xb: torch.Tensor,
                   phi_shift: torch.Tensor) -> torch.Tensor:
    """xg, phi_shift (B, K, W, T) float32; xb (B, T) float32 -> (B, K, W,
    T, 2) float32 (r_nb, r_b)."""
    cuda_build.refuse_autograd("ctc_recurrence", xg, xb, phi_shift)
    if xg.device.type == "cpu":
        return ctc_recurrence_ref(xg, xb, phi_shift)
    if xg.device.type != "cuda":
        raise ValueError(f"ctc_recurrence: unsupported device {xg.device}")
    return _launch(xg, xb, phi_shift)


def _launch(xg: torch.Tensor, xb: torch.Tensor,
            phi_shift: torch.Tensor) -> torch.Tensor:
    if xg.dim() != 4 or phi_shift.shape != xg.shape:
        raise ValueError(f"ctc_recurrence: xg {tuple(xg.shape)} and phi_shift "
                         f"{tuple(phi_shift.shape)} must be the same (B, K, W, T)")
    B, K, W, T = xg.shape
    if xb.shape != (B, T):
        raise ValueError(f"ctc_recurrence: xb must be (B, T) = ({B}, {T}), got "
                         f"{tuple(xb.shape)}")
    if any(t.dtype != torch.float32 for t in (xg, xb, phi_shift)):
        raise ValueError("ctc_recurrence: inputs must be float32")
    if not all(t.device == xg.device for t in (xb, phi_shift)):
        raise ValueError("ctc_recurrence: inputs on different devices")
    R = B * K * W
    xg, xb, phi_shift = xg.contiguous(), xb.contiguous(), phi_shift.contiguous()
    out = torch.empty((B, K, W, T, 2), dtype=torch.float32, device=xg.device)
    fn = cuda_build.function("ctc_prefix", "ctc_prefix_forward", _ARGTYPES)
    status = fn(xg.data_ptr(), phi_shift.data_ptr(), xb.data_ptr(), R, T, K * W,
                out.data_ptr(), torch.cuda.current_stream(xg.device).cuda_stream)
    cuda_build.check(status, "ctc prefix kernel launch")
    ctc_recurrence.launches += 1
    return out


ctc_recurrence.launches = 0
