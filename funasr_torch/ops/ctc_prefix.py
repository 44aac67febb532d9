"""CTC prefix-score frame recurrence: the CUDA kernel's wrapper and its plain
twin (port of funasr_tpu/ops/ctc_prefix_pallas.py ``ctc_recurrence``, body
``_kernel`` :47, and of the ``lax.scan`` form ops/beam_search.py:59-81).

Contract, for every row of the (B, K, W) candidate slots, with both carries
starting at the finite ``NEG_INF``::

    r_nb[t] = xg[t] + lse(r_nb[t-1], phi_shift[t])
    r_b[t]  = xb[t] + lse(r_b[t-1],  r_nb[t-1])

xg and phi_shift are (B, K, W, T) float32, xb is (B, T) float32 (broadcast
over K and W).  The result is one (B, K, W, T, 2) float32 tensor,
``[..., 0] = r_nb`` and ``[..., 1] = r_b``: the state layout of the beam
(``ops/beam_search.py`` ``ctc_prefix_step``), so the kernel writes it
directly and no stack copy follows.

- :func:`ctc_recurrence` launches ``csrc/ctc_prefix.cu`` for CUDA tensors
  and counts the launch in ``ctc_recurrence.launches``; for CPU tensors it
  runs :func:`ctc_recurrence_ref`.  There is no other path.
- :func:`ctc_recurrence_ref` is the plain PyTorch version: a loop over T of
  elementwise ops in the kernel's order, so that on the card the two agree
  bit for bit (PyTorch's float32 exp/log there are the accurate
  ``expf``/``logf`` the kernel calls).
"""

from __future__ import annotations

import ctypes

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


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2


def ctc_recurrence(xg: torch.Tensor, xb: torch.Tensor,
                   phi_shift: torch.Tensor) -> torch.Tensor:
    """xg, phi_shift (B, K, W, T) float32; xb (B, T) float32 -> (B, K, W,
    T, 2) float32 (r_nb, r_b)."""
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
