"""Fused int8 Paraformer decoder layer (port of
funasr_tpu/ops/decoder_layer_pallas.py ``_call``, body ``_dec_layer_kernel``
:54-119).

Contract, x (B, U, D) bf16 or float32 with token lengths, memory (B, T, D)
with memory lengths; float32 inside, cast to x's dtype at the end::

    hid  = LN_ffn(relu(i8(LN1(x), w1) + b1))          (B, U, H) float32
    h    = i8(hid, w2)                                no bias
    x1   = x + FSMN(LN2(h))                           token-length mask
    q    = i8(LN3(x1), wq) + bq
    kv   = i8(memory, wkv) + bkv                      (B, T, 2D)
    ctx  = softmax(bf16(q * d^-0.5) bf16(k)^T + memmask) bf16(v)
    out  = (x1 + i8(ctx, wout)) + bo                  cast to x's dtype

with ``i8`` and the FSMN as in ``ops/sanm_layer.py``; weights quantized
once per model load from the float32 parameters
(:func:`quantize_decoder_layer`).  The TPU kernel groups ``g`` batch items
per grid cell to lengthen its row dimension; on Hopper every kernel of the
chain already sees all B*U (or B*T) rows, so that grouping does not carry
over.

On the card the layer is twelve launches of four kernels: rowquant (LN
and quantize) x 5, the int8 GEMM x 5, ``csrc/fsmn.cu`` ``fsmn_ln`` (LN2,
the FSMN and the residual in one launch) and the float32-context
attention.  The memory's row quantization (no norm) is the same in every
layer, so a decoder stack makes it once with :func:`quantize_memory` and
passes it to each layer as ``memory_q``; the layer then makes eleven
launches.  Its other contractions keep rowquant + GEMM: the int8 GEMM's
row-quantizing entry measured slower there on an H100 (PERF.md section
6).

- :func:`fused_decoder_layer` runs the kernels for CUDA tensors and counts
  one launch per layer call in ``fused_decoder_layer.launches``; for CPU
  tensors it runs :func:`decoder_layer_ref`.  There is no other path.
- :func:`decoder_layer_ref` is the plain PyTorch version, built from the
  building blocks' twins (``fsmn_ln_ref``: ``rowquant_ref`` without the
  quantize, then ``fsmn_ref``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from funasr_torch.ops import attention as A
from funasr_torch.ops import cuda_build
from funasr_torch.ops import fsmn as FS
from funasr_torch.ops import int8_gemm as G
from funasr_torch.ops import rowquant as RQ
from funasr_torch.ops.masks import key_bias as make_key_bias
from funasr_torch.ops.quant import quantize_weight
from funasr_torch.ops.sanm_layer import fsmn_taps


class DecoderLayerWeights(NamedTuple):
    ln1_w: torch.Tensor   # (D,) float32
    ln1_b: torch.Tensor
    w1: torch.Tensor      # (H, D) int8
    s1: torch.Tensor
    b1: torch.Tensor
    lnf_w: torch.Tensor   # (H,) the FFN's inner norm
    lnf_b: torch.Tensor
    w2: torch.Tensor      # (D, H) int8, no bias
    s2: torch.Tensor
    ln2_w: torch.Tensor
    ln2_b: torch.Tensor
    taps: torch.Tensor    # (K, D) float32
    ln3_w: torch.Tensor
    ln3_b: torch.Tensor
    wq: torch.Tensor      # (D, D) int8
    sq: torch.Tensor
    bq: torch.Tensor
    wkv: torch.Tensor     # (2D, D) int8
    skv: torch.Tensor
    bkv: torch.Tensor
    wout: torch.Tensor    # (D, D) int8
    sout: torch.Tensor
    bout: torch.Tensor


def quantize_decoder_layer(ln1, w1, b1, lnf, w2, ln2, fsmn_weight, ln3, wq, bq,
                           wkv, bkv, wout, bout) -> DecoderLayerWeights:
    """float32 parameters in ``nn.Linear`` / ``Conv1d`` layout -> the layer's
    kernel operands.  ln1/lnf/ln2/ln3 are (weight, bias) pairs."""
    f = lambda t: t.to(torch.float32).contiguous()
    q = lambda t: quantize_weight(t.to(torch.float32))
    w18, s1 = q(w1)
    w28, s2 = q(w2)
    wq8, sq = q(wq)
    wkv8, skv = q(wkv)
    wout8, sout = q(wout)
    return DecoderLayerWeights(
        f(ln1[0]), f(ln1[1]), w18, s1, f(b1), f(lnf[0]), f(lnf[1]), w28, s2,
        f(ln2[0]), f(ln2[1]), fsmn_taps(fsmn_weight), f(ln3[0]), f(ln3[1]),
        wq8, sq, f(bq), wkv8, skv, f(bkv), wout8, sout, f(bout))


def quantize_memory(memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """memory (B, T, D) -> its rows in int8 (B*T, D) with their scales
    (B*T,): the rowquant kernel on CUDA tensors, its twin on CPU tensors."""
    B, T, D = memory.shape
    return RQ.rowquant(memory.reshape(B * T, D).contiguous())


def _layer(x, memory, tgt_lengths, mem_lengths, w: DecoderLayerWeights, n_head,
           left, mem_bias, memory_q, rowquant, gemm, fsmn_ln, attention):
    B, U, D = x.shape
    T = memory.shape[1]
    if mem_bias is None:
        mem_bias = make_key_bias(mem_lengths, T)
    x2 = x.reshape(B * U, D)
    q1, s1 = rowquant(x2, (w.ln1_w, w.ln1_b))
    hid = gemm(q1, s1, w.w1, w.s1, bias=w.b1, relu=True)
    qh, sh = rowquant(hid, (w.lnf_w, w.lnf_b))
    h = gemm(qh, sh, w.w2, w.s2)
    x1 = fsmn_ln(h.view(B, U, D), (w.ln2_w, w.ln2_b), tgt_lengths, w.taps, left,
                 res=x).view(B * U, D)
    q3, s3 = rowquant(x1, (w.ln3_w, w.ln3_b))
    q = gemm(q3, s3, w.wq, w.sq, bias=w.bq).view(B, U, D)
    qm, sm = rowquant(memory.reshape(B * T, D)) if memory_q is None else memory_q
    kv = gemm(qm, sm, w.wkv, w.skv, bias=w.bkv).view(B, T, 2 * D)
    ctx = attention(q, kv[..., :D], kv[..., D:], mem_bias, n_head,
                    (D // n_head) ** -0.5, None)
    cq, cs = rowquant(ctx.view(B * U, D))
    out = gemm(cq, cs, w.wout, w.sout, bias=w.bout, res=x1, out_dtype=x.dtype)
    return out.view(B, U, D)


def decoder_layer_ref(x: torch.Tensor, memory: torch.Tensor,
                      tgt_lengths: torch.Tensor, mem_lengths: torch.Tensor,
                      w: DecoderLayerWeights, n_head: int, left: int,
                      mem_bias: Optional[torch.Tensor] = None,
                      memory_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> torch.Tensor:
    """Plain twin: same inputs and output as :func:`fused_decoder_layer`."""
    return _layer(x, memory, tgt_lengths, mem_lengths, w, n_head, left, mem_bias,
                  memory_q, RQ.rowquant_ref, G.int8_gemm_ref, FS.fsmn_ln_ref,
                  A.attention_f32ctx_ref)


def fused_decoder_layer(x: torch.Tensor, memory: torch.Tensor,
                        tgt_lengths: torch.Tensor, mem_lengths: torch.Tensor,
                        w: DecoderLayerWeights, n_head: int, left: int,
                        mem_bias: Optional[torch.Tensor] = None,
                        memory_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> torch.Tensor:
    """x (B, U, D), memory (B, T, D), token and memory lengths (B,),
    ``left`` FSMN padding, ``mem_bias`` the (B, T) float32 key bias of
    ``mem_lengths`` (built when None), ``memory_q`` the memory's
    :func:`quantize_memory` (made here when None) -> (B, U, D) in x's
    dtype."""
    cuda_build.refuse_autograd("fused_decoder_layer", x, memory, tgt_lengths, mem_lengths, w,
                               mem_bias, memory_q)
    if x.device.type == "cpu":
        return decoder_layer_ref(x, memory, tgt_lengths, mem_lengths, w, n_head,
                                 left, mem_bias, memory_q)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decoder_layer: unsupported device {x.device}")
    out = _layer(x.contiguous(), memory.contiguous(), tgt_lengths, mem_lengths, w,
                 n_head, left, mem_bias, memory_q, RQ.rowquant, G.int8_gemm, FS.fsmn_ln,
                 A.attention_f32ctx)
    fused_decoder_layer.launches += 1
    return out


fused_decoder_layer.launches = 0
