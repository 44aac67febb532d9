"""FSMN scorer network of the VAD (port of
funasr_tpu/models/fsmn_vad/encoder.py ``FsmnBasicBlock`` :24 and ``FSMN``
:74; reference funasr/models/fsmn_vad_streaming/encoder.py:200 ``FSMN``).

affine -> affine -> relu -> [linear -> depthwise memory -> affine -> relu]
x L -> affine -> affine -> softmax, in float32.  The memory is a causal
depthwise convolution over ``lorder`` past frames (dilation ``lstride``),
plus ``rorder`` future frames when set, added to its input.  The JAX
package runs it through ``ops/dwconv.py conv1d_grouped`` (XLA, not a Pallas
kernel); here it is a grouped ``F.conv1d``.  Streaming keeps a
``(lorder - 1) * lstride`` frame cache per layer.

Parameter names are FunASR's (``in_linear1.linear``, ``fsmn.{i}.linear.linear``,
``fsmn.{i}.fsmn_block.conv_left`` as a (D, 1, lorder, 1) Conv2d weight,
``fsmn.{i}.affine.linear``, ``out_linear2.linear``...), so
``funasr_tpu.convert.fsmn_vad_from_torch(FSMN.state_dict())`` gives the
JAX params.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.registry import tables


class _Linear(nn.Module):
    """FunASR's ``LinearTransform`` / ``AffineTransform``: a Linear named
    ``linear`` (with a bias for the affine form)."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.linear = nn.Linear(d_in, d_out, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x)


class FSMNBlock(nn.Module):
    """The depthwise memory: ``x + conv_left(x)`` over past frames (+
    ``conv_right`` over future frames when ``rorder > 0``)."""

    def __init__(self, dim: int, lorder: int, rorder: int, lstride: int = 1,
                 rstride: int = 1):
        super().__init__()
        self.lorder, self.rorder = lorder, rorder
        self.lstride, self.rstride = lstride, rstride
        self.conv_left = nn.Conv2d(dim, dim, (lorder, 1), dilation=(lstride, 1),
                                   groups=dim, bias=False)
        self.conv_right = (nn.Conv2d(dim, dim, (rorder, 1), dilation=(rstride, 1),
                                     groups=dim, bias=False) if rorder > 0 else None)

    def forward(self, p: torch.Tensor, cache: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """p (B, T, D); cache None or (B, (lorder - 1) * lstride, D) -> (p +
        memory, the new cache or None)."""
        D = p.shape[-1]
        hist = (self.lorder - 1) * self.lstride
        if p.shape[1] == 0:  # no frame (F.conv1d refuses an input under its kernel)
            return p, cache
        x = p.transpose(1, 2)  # (B, D, T)
        new_cache = None
        if cache is None:
            ctx = F.pad(x, (hist, 0))
        else:
            ctx = torch.cat([cache.to(p.dtype).transpose(1, 2), x], dim=2)
            new_cache = ctx[:, :, ctx.shape[2] - hist:].transpose(1, 2) if hist else cache
        out = x + F.conv1d(ctx, self.conv_left.weight[..., 0], dilation=self.lstride,
                           groups=D)
        if self.conv_right is not None:
            # frames t + rstride .. t + rorder * rstride
            shifted = F.pad(x, (0, self.rorder * self.rstride))[:, :, self.rstride:]
            mem_r = F.conv1d(shifted, self.conv_right.weight[..., 0],
                             dilation=self.rstride, groups=D)
            out = out + mem_r[:, :, : out.shape[2]]
        return out.transpose(1, 2), new_cache


class BasicBlock(nn.Module):
    """linear (no bias) -> FSMN memory -> affine -> relu (the JAX
    ``FsmnBasicBlock``)."""

    def __init__(self, linear_dim: int, proj_dim: int, lorder: int, rorder: int,
                 lstride: int = 1, rstride: int = 1):
        super().__init__()
        self.linear = _Linear(linear_dim, proj_dim, bias=False)
        self.fsmn_block = FSMNBlock(proj_dim, lorder, rorder, lstride, rstride)
        self.affine = _Linear(proj_dim, linear_dim)

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None):
        h, new_cache = self.fsmn_block(self.linear(x), cache)
        return torch.relu(self.affine(h)), new_cache


@tables.register("encoder_classes", "FSMN")
class FSMN(nn.Module):
    def __init__(self, input_dim: int, input_affine_dim: int, fsmn_layers: int,
                 linear_dim: int, proj_dim: int, lorder: int, rorder: int,
                 lstride: int, rstride: int, output_affine_dim: int, output_dim: int,
                 use_softmax: bool = True):
        super().__init__()
        self.lorder, self.lstride, self.proj_dim = lorder, lstride, proj_dim
        self.use_softmax = use_softmax
        self.in_linear1 = _Linear(input_dim, input_affine_dim)
        self.in_linear2 = _Linear(input_affine_dim, linear_dim)
        self.fsmn = nn.ModuleList([
            BasicBlock(linear_dim, proj_dim, lorder, rorder, lstride, rstride)
            for _ in range(fsmn_layers)])
        self.out_linear1 = _Linear(linear_dim, output_affine_dim)
        self.out_linear2 = _Linear(output_affine_dim, output_dim)

    def forward(self, x: torch.Tensor, cache: Optional[List[torch.Tensor]] = None):
        """x (B, T, input_dim) -> (B, T, output_dim) state posteriors; with
        ``cache`` (a list of per-layer (B, (lorder - 1) * lstride, proj_dim)
        tensors, :meth:`init_cache`) -> (posteriors, new caches)."""
        h = torch.relu(self.in_linear2(self.in_linear1(x.to(torch.float32))))
        new_caches = []
        for i, block in enumerate(self.fsmn):
            h, c = block(h, None if cache is None else cache[i])
            new_caches.append(c)
        h = self.out_linear2(self.out_linear1(h))
        if self.use_softmax:
            h = torch.softmax(h, dim=-1)
        return h if cache is None else (h, new_caches)

    def init_cache(self, batch_size: int = 1, device=None) -> List[torch.Tensor]:
        hist = (self.lorder - 1) * self.lstride
        return [torch.zeros((batch_size, hist, self.proj_dim), device=device)
                for _ in self.fsmn]
