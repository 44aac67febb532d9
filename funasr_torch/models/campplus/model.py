"""CAM++ speaker embedding model (port of funasr_tpu/models/campplus/model.py;
reference funasr/models/campplus/model.py:38 ``CAMPPlus``, components.py).

D-TDNN with context-aware masking: ``FCM`` (a 2-D residual front end over
the mel axis) -> a TDNN (kernel 5, stride 2) -> three dense blocks of
CAM-TDNN layers (dense concatenation, growth 32), each closed by a transit
layer halving the channels -> statistics pooling (mean and unbiased std,
floored at 1e-10) -> a 192-d embedding.  Layout (B, C, T), and (B, C, F, T)
in the head; parameter names are FunASR's (``head.layer1.0.conv1``,
``xvector.block1.tdnnd1.cam_layer.linear_local``, ``xvector.dense.linear``)
so a reference ``model.pt`` loads strictly.

Inference only, float32, BatchNorm on its running statistics.  The JAX
package computes CAM++ in XLA (no Pallas kernel), so the port runs plain
PyTorch: cuDNN convolutions on the card, with TF32 off
(``device.cudnn_float32``).  Defaults are the published 3D-Speaker CAM++
(``iic/speech_campplus_sv_zh-cn_16k-common``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.device import cudnn_float32, resolve_device
from funasr_torch.registry import tables


class BNReLU(nn.Module):
    """FunASR's ``get_nonlinear("batchnorm-relu")``: ``batchnorm`` then relu
    (``relu=False``, ``affine=False``: the embedding's "batchnorm_")."""

    def __init__(self, channels: int, relu: bool = True, affine: bool = True):
        super().__init__()
        self.batchnorm = nn.BatchNorm1d(channels, affine=affine)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.batchnorm(x)
        return torch.relu(x) if self.relu else x


class BasicResBlock(nn.Module):
    """Two 3x3 convs with a residual; ``stride`` on the frequency axis."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, (stride, 1), 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != planes:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, (stride, 1), bias=False),
                nn.BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return torch.relu(h + self.shortcut(x))


class FCM(nn.Module):
    """(B, T, feat_dim) -> (B, m_channels * feat_dim // 8, T), the flatten
    channel-major (components.py:76)."""

    def __init__(self, m_channels: int = 32, feat_dim: int = 80):
        super().__init__()
        self.conv1 = nn.Conv2d(1, m_channels, 3, 1, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(m_channels)
        self.layer1 = nn.Sequential(BasicResBlock(m_channels, m_channels, 2),
                                    BasicResBlock(m_channels, m_channels, 1))
        self.layer2 = nn.Sequential(BasicResBlock(m_channels, m_channels, 2),
                                    BasicResBlock(m_channels, m_channels, 1))
        self.conv2 = nn.Conv2d(m_channels, m_channels, 3, (2, 1), 1, bias=False)
        self.bn2 = nn.BatchNorm2d(m_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)[:, None]  # (B, 1, F, T)
        h = torch.relu(self.bn1(self.conv1(h)))
        h = self.layer2(self.layer1(h))
        h = torch.relu(self.bn2(self.conv2(h)))
        B, C, F_, T = h.shape
        return h.reshape(B, C * F_, T)


def same_conv1d(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
                bias: bool = False) -> nn.Conv1d:
    return nn.Conv1d(cin, cout, kernel, stride, (kernel - 1) // 2 * dilation, dilation,
                     bias=bias)


class TDNNLayer(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1):
        super().__init__()
        self.linear = same_conv1d(cin, cout, kernel, stride)
        self.nonlinear = BNReLU(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nonlinear(self.linear(x))


class CAMLayer(nn.Module):
    """A dilated conv masked by a context gate from the global mean plus the
    mean of each 100-frame segment (the tail segment over its true length:
    the reference's ``avg_pool1d(ceil_mode=True)``, components.py:172-175)."""

    def __init__(self, bn_channels: int, out_channels: int, kernel: int, dilation: int,
                 reduction: int = 2, seg_len: int = 100):
        super().__init__()
        self.seg_len = seg_len
        self.linear_local = same_conv1d(bn_channels, out_channels, kernel, dilation=dilation)
        self.linear1 = nn.Conv1d(bn_channels, bn_channels // reduction, 1)
        self.linear2 = nn.Conv1d(bn_channels // reduction, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.linear_local(x)
        B, C, T = x.shape
        L = self.seg_len
        nseg = -(-T // L)
        xp = F.pad(x, (0, nseg * L - T))
        counts = torch.clamp(T - torch.arange(nseg, device=x.device) * L, 1, L).to(x.dtype)
        seg = xp.reshape(B, C, nseg, L).sum(-1) / counts
        seg = seg.repeat_interleave(L, dim=-1)[..., :T]
        context = x.mean(-1, keepdim=True) + seg
        m = torch.sigmoid(self.linear2(torch.relu(self.linear1(context))))
        return y * m


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, cin: int, out_channels: int, bn_channels: int, kernel: int,
                 dilation: int):
        super().__init__()
        self.nonlinear1 = BNReLU(cin)
        self.linear1 = nn.Conv1d(cin, bn_channels, 1, bias=False)
        self.nonlinear2 = BNReLU(bn_channels)
        self.cam_layer = CAMLayer(bn_channels, out_channels, kernel, dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cam_layer(self.nonlinear2(self.linear1(self.nonlinear1(x))))


class CAMDenseTDNNBlock(nn.ModuleDict):
    """``tdnnd1`` .. ``tdnndN``, each output concatenated to its input."""

    def __init__(self, num_layers: int, cin: int, growth: int, bn_channels: int,
                 kernel: int, dilation: int):
        super().__init__({f"tdnnd{i + 1}": CAMDenseTDNNLayer(
            cin + i * growth, growth, bn_channels, kernel, dilation)
            for i in range(num_layers)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.values():
            x = torch.cat([x, layer(x)], dim=1)
        return x


class TransitLayer(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.nonlinear = BNReLU(cin)
        self.linear = nn.Conv1d(cin, cout, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.nonlinear(x))


class DenseLayer(nn.Module):
    """The embedding: a kernel-1 conv over the pooled statistics (applied as
    a matmul) and an affine-free BatchNorm."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = nn.Conv1d(cin, cout, 1, bias=False)
        self.nonlinear = BNReLU(cout, relu=False, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nonlinear(F.linear(x, self.linear.weight[..., 0]))


def stats_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, 2C): mean and unbiased std over time, the variance
    floored at 1e-10 (the JAX package's model.py:184-186)."""
    var = torch.var(x, dim=-1, unbiased=True)
    return torch.cat([x.mean(-1), torch.sqrt(torch.clamp(var, min=1e-10))], dim=-1)


class XVector(nn.ModuleDict):
    """FunASR's ``xvector`` Sequential: tdnn, block{i} + transit{i},
    out_nonlinear, (stats), dense."""

    def __init__(self, cin: int, embedding_size: int, growth: int, bn_size: int,
                 init_channels: int, blocks: Sequence[Tuple[int, int, int]]):
        layers = {"tdnn": TDNNLayer(cin, init_channels, 5, stride=2)}
        c = init_channels
        for i, (num_layers, kernel, dilation) in enumerate(blocks, 1):
            layers[f"block{i}"] = CAMDenseTDNNBlock(num_layers, c, growth, bn_size * growth,
                                                    kernel, dilation)
            c += num_layers * growth
            layers[f"transit{i}"] = TransitLayer(c, c // 2)
            c //= 2
        layers["out_nonlinear"] = BNReLU(c)
        layers["dense"] = DenseLayer(2 * c, embedding_size)
        super().__init__(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name, layer in self.items():
            if name == "dense":
                x = stats_pool(x)
            x = layer(x)
        return x


@tables.register("model_classes", "CAMPPlus")
class CAMPPlus(nn.Module):
    """fbank (B, T, feat_dim) -> (B, embedding_size) float32, on ``device``
    (default the GPU; raises without one unless ``device="cpu"``)."""

    def __init__(self, feat_dim: int = 80, embedding_size: int = 192, growth_rate: int = 32,
                 bn_size: int = 4, init_channels: int = 128,
                 blocks: Sequence[Tuple[int, int, int]] = ((12, 3, 1), (24, 3, 2),
                                                           (16, 3, 2)),
                 device=None):
        super().__init__()
        self.feat_dim = feat_dim
        self.embedding_size = embedding_size
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.head = FCM(feat_dim=feat_dim)
            self.xvector = XVector(32 * (feat_dim // 8), embedding_size, growth_rate,
                                   bn_size, init_channels, [tuple(b) for b in blocks])
        self.eval()

    @torch.inference_mode()
    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        with cudnn_float32():
            return self.xvector(self.head(feats.to(torch.float32)))
