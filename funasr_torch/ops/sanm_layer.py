"""Fused int8 SANM encoder layer (port of funasr_tpu/ops/sanm_layer_pallas.py
``_call``, body ``_sanm_layer_kernel`` :71-148).

Contract, x (B, T, D) bf16 or float32 with per-row ``lengths``; the
residual stream stays float32 inside the layer and is cast to x's dtype
once, at the end::

    h       = LN1(x)                                  float32, eps 1e-12
    qkv     = i8(h, wqkv) + bqkv                      float32 (B, T, 3D)
    vm      = v * valid
    mem     = (vm + sum_j tap_j * shift_j(vm)) * valid          (FSMN)
    ctx     = softmax(bf16(q * d^-0.5) bf16(k)^T + keymask) bf16(vm)
              (per head, p rounded to bf16, float32 context); with
              ``int8_attn`` (sanm_layer_pallas.py:112-117) the scores are
              (float32(q8 k8^T) * qs) * ks^T + keymask, q * d^-0.5 and k
              row-quantized per head
    x1      = ((x + i8(ctx, wout)) + bout) + mem
    hid     = relu(i8(LN2(x1), w1) + b1)
    out     = (x1 + i8(hid, w2)) + b2                 cast to x's dtype

where ``i8(a, w) = (acc(rowquant(a), w8) * sa) * sw`` with the fused
kernels' row quantize (``* f32(1/127)``) and weights quantized once per
model load from the float32 parameters (:func:`quantize_sanm_layer`).

On the card the layer is eight launches of four kernels: ``csrc/rowquant.cu``
(LN + quantize) and ``csrc/int8_gemm.cu`` for QKV, w1 and w2 (the bias,
relu and residual in the GEMM's epilogue), the float32-context entry of
``csrc/attention.cu`` (its int8-score entry with ``int8_attn``), and for
ctx -> wout the GEMM's row-quantizing entry (``int8_gemm_rq``), which
quantizes ctx in its A producer and computes the FSMN memory of v in its
epilogue, in place of a rowquant, an FSMN and a GEMM launch.  The other
three contractions keep rowquant + GEMM: there the fused entry measured
slower on an H100 (PERF.md section 6).  The TPU kernel runs the whole
layer in one VMEM-resident program; its 3.1 MB of int8 weights per layer
do not fit the 228 KB of shared memory of an H100 SM, so the Hopper layer
is a chain of fused kernels, with float32 activations between them in
device memory.

- :func:`fused_sanm_layer` runs the kernels for CUDA tensors and counts one
  launch per layer call in ``fused_sanm_layer.launches``; for CPU tensors
  it runs :func:`sanm_layer_ref`.  There is no other path.
- :func:`sanm_layer_ref` is the plain PyTorch version, built from the
  building blocks' twins (``int8_gemm_rq_ref``: ``rowquant_ref``,
  ``fsmn_ref`` and ``int8_gemm_ref``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from funasr_torch.ops import attention as A
from funasr_torch.ops import cuda_build
from funasr_torch.ops import int8_gemm as G
from funasr_torch.ops import rowquant as RQ
from funasr_torch.ops.masks import key_bias as make_key_bias
from funasr_torch.ops.quant import quantize_weight


class SanmLayerWeights(NamedTuple):
    ln1_w: torch.Tensor  # (D,) float32
    ln1_b: torch.Tensor
    wqkv: torch.Tensor   # (3D, D) int8
    sqkv: torch.Tensor   # (3D,) float32
    bqkv: torch.Tensor   # (3D,) float32
    taps: torch.Tensor   # (K, D) float32 FSMN taps
    wout: torch.Tensor   # (D, D) int8
    sout: torch.Tensor
    bout: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    w1: torch.Tensor     # (H, D) int8
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor     # (D, H) int8
    s2: torch.Tensor
    b2: torch.Tensor


def fsmn_taps(weight: torch.Tensor) -> torch.Tensor:
    """Depthwise Conv1d weight (D, 1, K) -> float32 taps (K, D)."""
    return weight[:, 0, :].T.to(torch.float32).contiguous()


def quantize_sanm_layer(ln1, wqkv, bqkv, fsmn_weight, wout, bout, ln2, w1, b1,
                        w2, b2) -> SanmLayerWeights:
    """float32 parameters in ``nn.Linear`` / ``Conv1d`` layout -> the layer's
    kernel operands.  ln1/ln2 are (weight, bias) pairs."""
    f = lambda t: t.to(torch.float32).contiguous()
    q = lambda t: quantize_weight(t.to(torch.float32))
    wqkv8, sqkv = q(wqkv)
    wout8, sout = q(wout)
    w18, s1 = q(w1)
    w28, s2 = q(w2)
    return SanmLayerWeights(f(ln1[0]), f(ln1[1]), wqkv8, sqkv, f(bqkv),
                            fsmn_taps(fsmn_weight), wout8, sout, f(bout),
                            f(ln2[0]), f(ln2[1]), w18, s1, f(b1), w28, s2, f(b2))


def _layer(x, lengths, w: SanmLayerWeights, n_head, left, key_bias, rowquant, gemm,
           gemm_rq, attention):
    B, T, D = x.shape
    x2 = x.reshape(B * T, D)
    if key_bias is None:
        key_bias = make_key_bias(lengths, T)
    hq, hs = rowquant(x2, (w.ln1_w, w.ln1_b))
    qkv = gemm(hq, hs, w.wqkv, w.sqkv, bias=w.bqkv).view(B, T, 3 * D)
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    ctx = attention(q, k, v, key_bias, n_head, (D // n_head) ** -0.5, lengths)
    x1 = gemm_rq(ctx.view(B * T, D), w.wout, w.sout, G.Fsmn(v, lengths, w.taps, left),
                 bias=w.bout, res=x2)
    h2q, h2s = rowquant(x1, (w.ln2_w, w.ln2_b))
    hid = gemm(h2q, h2s, w.w1, w.s1, bias=w.b1, relu=True)
    hq2, hs2 = rowquant(hid)
    out = gemm(hq2, hs2, w.w2, w.s2, bias=w.b2, res=x1, out_dtype=x.dtype)
    return out.view(B, T, D)


def sanm_layer_ref(x: torch.Tensor, lengths: torch.Tensor, w: SanmLayerWeights,
                   n_head: int, left: int, key_bias: Optional[torch.Tensor] = None,
                   int8_attn: bool = False) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`fused_sanm_layer`."""
    return _layer(x, lengths, w, n_head, left, key_bias, RQ.rowquant_ref,
                  G.int8_gemm_ref, G.int8_gemm_rq_ref,
                  A.attention_i8qk_ref if int8_attn else A.attention_f32ctx_ref)


def fused_sanm_layer(x: torch.Tensor, lengths: torch.Tensor, w: SanmLayerWeights,
                     n_head: int, left: int, key_bias: Optional[torch.Tensor] = None,
                     int8_attn: bool = False) -> torch.Tensor:
    """x (B, T, D), lengths (B,) valid frames, ``left`` FSMN padding,
    ``key_bias`` the (B, T) float32 key bias of ``lengths`` (built when
    None), ``int8_attn`` the int8 q.k scores -> (B, T, D) in x's dtype."""
    cuda_build.refuse_autograd("fused_sanm_layer", x, lengths, w, key_bias)
    if x.device.type == "cpu":
        return sanm_layer_ref(x, lengths, w, n_head, left, key_bias, int8_attn)
    if x.device.type != "cuda":
        raise ValueError(f"fused_sanm_layer: unsupported device {x.device}")
    out = _layer(x.contiguous(), lengths, w, n_head, left, key_bias, RQ.rowquant,
                 G.int8_gemm, G.int8_gemm_rq,
                 A.attention_i8qk if int8_attn else A.attention_f32ctx)
    fused_sanm_layer.launches += 1
    return out


fused_sanm_layer.launches = 0
