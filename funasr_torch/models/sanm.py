"""SAN-M: self-attention with an FSMN memory branch (port of
funasr_tpu/models/sanm.py; reference funasr/models/sanm/attention.py:140
``MultiHeadedAttentionSANM``, funasr/models/sanm/encoder.py:44/188).

- fused QKV projection, FSMN memory (depthwise conv over V, plus V, masked),
- attention through the fused kernel wrapper (``ops/attention.py``) with a
  float32 key bias; softmax and layer norms in float32, everything else in
  the module ``dtype`` (bfloat16 in serving),
- parameter names are FunASR's torch names (``linear_q_k_v``,
  ``fsmn_block``, ``linear_out``, ``norm1``, ``encoders0.0``,
  ``encoders.{i}``...), so a reference ``model.pt`` loads with
  ``load_state_dict``.

Dense and FSMN weights are stored in ``param_dtype``, by default the
compute ``dtype`` (the JAX modules cast their float32 parameters to it at
use); layer-norm parameters stay float32.  No pipeline-parallel branch.

Training (the JAX modules' ``deterministic=False``) is the module's
``self.training``: dropout where the JAX package puts it (the FSMN memory
and the attention weights at the attention dropout rate, the FFN's hidden
units, the attention and FFN outputs at the layer's rate; none after the
positional encoding), and the attention in plain PyTorch
(:func:`masked_attention`, the XLA path of sanm.py:168-190), never the
kernel: a kernel wrapper has no backward, and refuses inputs that require
grad.  ``SANMEncoder(remat=True)`` recomputes each of ``encoders``' layers in
the backward pass (``torch.utils.checkpoint``, the RNG state kept, so the
dropout masks are the same), as ``nn.remat`` does there.  The modules are
built in ``eval()`` mode; the int8 weights are for serving
(``Paraformer.forward`` refuses them in training mode).

int8 serving (the JAX package's ``quantize=True`` path, sanm.py:329-344,
:430-467, :503-550): a model built with ``param_dtype=float32`` and then
``quantize_weights()`` runs

- every layer with ``in_size == size`` (layers 1-49 of Paraformer-large)
  through ``ops/sanm_layer.py`` ``fused_sanm_layer``, on int8 weights
  quantized once from the float32 parameters;
- the FFN of ``encoders0`` through ``ops/ffn.py`` ``fused_ffn_int8``;
- ``encoders0``'s projections through the QDense rule of :class:`Dense`:
  int8 (from the compute-dtype weights) when the contraction passes the
  ``ops/quant.py`` gate, the compute dtype otherwise.

Two opt-in routes, the JAX package's ``FUNASR_TPU_PALLAS_QMM=1`` and
``FUNASR_TPU_INT8_ATTN=1`` (both off by default there too), are arguments
here: a :class:`Dense` with ``qmm=True`` takes the fused int8 matmul
(``ops/qmm.py``) for a gated contraction, and ``SANMEncoder(int8_attn=True)``
gives layers 1-49 int8 q.k scores (``fused_sanm_layer(int8_attn=True)``).

The JAX package keeps TPU VMEM gates on its fused paths (``supported()``);
the port takes the fused kernels at every shape.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from funasr_torch.ops import attention as A
from funasr_torch.ops import ffn as FF
from funasr_torch.ops import qmm as QM
from funasr_torch.ops import quant as Q
from funasr_torch.ops import sanm_layer as SL
from funasr_torch.ops.dwconv import depthwise_conv1d
from funasr_torch.ops.masks import key_bias, sequence_mask
from funasr_torch.ops.posenc import sinusoidal_encoding
from funasr_torch.registry import tables


def ln_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           eps: float = 1e-12) -> torch.Tensor:
    """Layer norm with float32 statistics and output (torch eps 1e-12)."""
    return F.layer_norm(x.to(torch.float32), (x.shape[-1],),
                        weight.to(torch.float32), bias.to(torch.float32), eps)


class LayerNormF32(nn.Module):
    """Layer norm computed in float32, cast back to the compute dtype;
    parameters ``weight``/``bias`` in float32."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_f32(x, self.weight, self.bias, self.eps).to(self.dtype)


def rounded_once(op, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``op(x, w)`` (a dot or a convolution) in x's dtype.  On the CPU an op
    in another dtype than float32 runs in float32 and rounds once (torch's
    CPU bf16 GEMM blocks its sums by the thread count)."""
    if x.device.type == "cpu" and x.dtype != torch.float32:
        return op(x.to(torch.float32), w.to(torch.float32)).to(x.dtype)
    return op(x, w)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` in x's dtype (:func:`rounded_once`)."""
    return rounded_once(F.linear, x, w)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (flax ``nn.Dense(dtype=...)``):
    the input, weight and bias are cast to it.  The weights are stored in
    ``param_dtype`` (default: ``dtype``).

    After :meth:`quantize_weights` it follows the JAX package's QDense
    (quant.py ``QDense``): a contraction that passes the ``ops/quant.py``
    gate runs in int8 from the compute-dtype weights (flax casts before
    the dot), its result cast to ``dtype`` before the bias is added in
    ``dtype``; any other runs in ``dtype`` as before.  ``qmm`` sends the
    int8 contraction through the fused kernel (``ops/qmm.py``, the "mul"
    row quantize) instead of ``quant.int8_linear`` (the "div" form)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, qmm: bool = False):
        super().__init__(in_features, out_features, bias, dtype=param_dtype or dtype)
        self.compute_dtype = dtype
        self.qmm = qmm
        for name in ("w8", "sw", "bias_q"):
            self.register_buffer(name, None, persistent=False)

    def matrix(self) -> torch.Tensor:
        """The (out, in) weight matrix."""
        return self.weight

    def quantize_weights(self) -> None:
        """Build the int8 weight, its per-channel scales and the bias in
        compute-dtype values (non-persistent buffers, not in the state dict)."""
        dt = self.compute_dtype
        w8, sw = Q.quantize_weight(self.matrix().detach().to(dt))
        self.register_buffer("w8", w8, persistent=False)
        self.register_buffer("sw", sw, persistent=False)
        bias = None if self.bias is None else self.bias.detach().to(dt).to(torch.float32)
        self.register_buffer("bias_q", bias, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x.to(dt)
        if self.w8 is not None and Q.gate(x.numel() // x.shape[-1], self.out_features):
            linear = QM.quant_matmul if self.qmm else Q.int8_linear
            return linear(x, self.w8, self.sw, self.bias_q)
        y = dot(x, self.matrix().to(dt))
        # flax's Dense rounds its dot to dtype, then adds the bias in dtype
        return y if self.bias is None else y + self.bias.to(dt)


class PlainDense(Dense):
    """A dense layer in ``dtype`` that never takes int8: the JAX package's
    plain ``nn.Dense`` (no QDense contraction), which ``quantize=True`` leaves
    as it is.  :meth:`quantize_weights` does nothing."""

    def quantize_weights(self) -> None:
        pass


def quantize_dense_layers(root: nn.Module) -> None:
    """``quantize_weights()`` of every topmost module under ``root`` that has
    one: a :class:`Dense`, a :class:`PositionwiseFeedForward` (its fused int8
    weights) or a stack that owns fused int8 layers (:class:`SANMEncoder`, the
    Paraformer decoders), each left to quantize its own submodules."""
    for child in root.children():
        if hasattr(child, "quantize_weights"):
            child.quantize_weights()
        else:
            quantize_dense_layers(child)


class PointwiseConv(Dense):
    """A kernel-size-1 ``nn.Conv1d`` over the last axis, computed as a
    :class:`Dense` (the JAX package's QDense): the weight keeps the Conv1d
    shape (out, in, 1) of FunASR's state dict."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias, dtype, param_dtype)
        self.weight = nn.Parameter(self.weight.detach()[..., None])

    def matrix(self) -> torch.Tensor:
        return self.weight[..., 0]


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Float32 softmax over the last axis with key masking (funasr_tpu
    sanm.py:95): masked scores take float32's lowest finite value, and the
    weights of masked keys are set to 0 after the softmax.  ``mask``
    broadcasts to ``scores``, nonzero = valid."""
    valid = mask != 0
    scores = torch.where(valid, scores.to(torch.float32), torch.finfo(torch.float32).min)
    return torch.where(valid, torch.softmax(scores, dim=-1), 0.0)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, n_head: int,
                     attn_dropout: float = 0.0) -> torch.Tensor:
    """Attention under a per-query mask, the XLA code the JAX package runs
    for any mask its kernel does not take (funasr_tpu sanm.py:168-190, the
    masked cross-attention of paraformer/decoder.py:186-203): q (B, U, F)
    scaled by d_k^-0.5 and scored against k (B, T, F) in the compute dtype,
    :func:`masked_softmax` in float32 over ``valid`` (B, 1 or U, T) bool,
    dropout at ``attn_dropout`` on its weights (training), the context in
    the compute dtype -> (B, U, F)."""
    B, U, F_ = q.shape
    d_k = F_ // n_head

    def heads(x):
        return x.reshape(B, x.shape[1], n_head, d_k).transpose(1, 2)

    scores = rounded_once(torch.matmul, heads(q) * (d_k ** -0.5),
                          heads(k).transpose(-1, -2))  # (B, H, U, T)
    attn = F.dropout(masked_softmax(scores, valid[:, None]), attn_dropout, attn_dropout > 0)
    ctx = rounded_once(torch.matmul, attn.to(v.dtype), heads(v))
    return ctx.transpose(1, 2).reshape(B, U, F_)


def fsmn_memory(v: torch.Tensor, weight: torch.Tensor,
                mask: Optional[torch.Tensor], left: int,
                right: int) -> torch.Tensor:
    """Depthwise FSMN block (attention.py:207 ``forward_fsmn``):
    mask -> depthwise conv1d (no bias, ``ops/dwconv.py``) -> + residual -> mask.

    v (B, T, D); weight (D, 1, K) depthwise filters; mask (B, T, 1) or None.
    """
    if mask is not None:
        mask = mask.to(v.dtype)
        v = v * mask
    out = depthwise_conv1d(v, weight, padding=(left, right)) + v
    if mask is not None:
        out = out * mask
    return out


def fsmn_padding(kernel_size: int, sanm_shift: int):
    """(left, right) FSMN padding: left = (k-1)//2 + max(shift, 0)."""
    left = (kernel_size - 1) // 2 + max(sanm_shift, 0)
    return left, kernel_size - 1 - left


class MultiHeadedAttentionSANM(nn.Module):
    """Self-attention + FSMN memory: out = linear_out(attn(QKV)) + FSMN(V)."""

    def __init__(self, n_head: int, in_feat: int, n_feat: int,
                 kernel_size: int = 11, sanm_shift: int = 0,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.n_head = n_head
        self.n_feat = n_feat
        self.dropout_rate = dropout_rate
        self.linear_q_k_v = Dense(in_feat, 3 * n_feat, dtype=dtype,
                                  param_dtype=param_dtype)
        self.fsmn_block = nn.Conv1d(n_feat, n_feat, kernel_size, groups=n_feat,
                                    bias=False, dtype=param_dtype or dtype)
        self.linear_out = Dense(n_feat, n_feat, dtype=dtype, param_dtype=param_dtype)
        self.left, self.right = fsmn_padding(kernel_size, sanm_shift)

    def forward(self, x: torch.Tensor, mask_t: torch.Tensor, bias: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T, in_feat); mask_t (B, T, 1) float; bias (B, T) float32.
        ``attn_mask`` (B, T, T), nonzero = may attend: the attention runs
        :func:`masked_attention` over the key mask and it (the JAX package's
        XLA path, sanm.py:168-190); the FSMN memory stays gated by the key
        mask alone.  In training the attention always takes that path, with
        dropout on its weights and on the memory."""
        d_k = self.n_feat // self.n_head
        q, k, v = self.linear_q_k_v(x).split(self.n_feat, dim=-1)
        mem = fsmn_memory(v, self.fsmn_block.weight, mask_t, self.left,
                          self.right)
        mem = F.dropout(mem, self.dropout_rate, self.training)
        if attn_mask is None and not self.training:
            ctx = A.fused_attention(q * (d_k ** -0.5), k, v, bias, self.n_head)
        else:
            valid = mask_t[:, None, :, 0] != 0
            if attn_mask is not None:
                valid = valid & (attn_mask != 0)
            ctx = masked_attention(q, k, v, valid, self.n_head,
                                   self.dropout_rate if self.training else 0.0)
        return self.linear_out(ctx) + mem


class PositionwiseFeedForward(nn.Module):
    """w_2(relu(w_1(x))) — transformer/positionwise_feed_forward.py.  After
    :meth:`quantize_weights`, the fused int8 FFN (``ops/ffn.py``) on int8
    weights from the float32 parameters (sanm.py:329-344)."""

    def __init__(self, idim: int, hidden_units: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.w_1 = Dense(idim, hidden_units, dtype=dtype, param_dtype=param_dtype)
        self.w_2 = Dense(hidden_units, idim, dtype=dtype, param_dtype=param_dtype)
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.int8 = None

    def quantize_weights(self) -> None:
        w = FF.quantize_ffn(self.w_1.weight.detach(), self.w_1.bias.detach(),
                            self.w_2.weight.detach(), self.w_2.bias.detach())
        self.int8 = int8_buffers(self, "ffn_", w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8 is not None:
            return FF.fused_ffn_int8(x.to(self.dtype), self.int8(self))
        h = F.dropout(torch.relu(self.w_1(x)), self.dropout_rate, self.training)
        return self.w_2(h)


def int8_buffers(module: nn.Module, prefix: str, weights) -> callable:
    """Store a NamedTuple of kernel operands as non-persistent buffers
    ``prefix + field`` (they follow ``.to()`` and stay out of the state
    dict) and return a function that rebuilds the tuple from them."""
    cls = type(weights)
    for name, t in zip(weights._fields, weights):
        module.register_buffer(prefix + name, t, persistent=False)
    return lambda m: cls(*(getattr(m, prefix + n) for n in cls._fields))


class EncoderLayerSANM(nn.Module):
    """Pre-norm SANM encoder layer (sanm/encoder.py:44).  When
    ``in_size != size`` (the first layer, 560 -> 512 for Paraformer-large)
    the attention residual is skipped (encoder.py:120-137).  ``int8_attn``:
    int8 q.k scores in the fused int8 layer.  ``fused_int8`` set to False
    keeps the layer on the module path under int8 (the JAX package leaves
    the fused layer whenever an attention mask comes with the key mask,
    sanm.py:510): :meth:`quantize_weights` then quantizes its QDense
    projections and its FFN."""

    def __init__(self, in_size: int, size: int, n_head: int, linear_units: int,
                 kernel_size: int = 11, sanm_shift: int = 0,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, int8_attn: bool = False,
                 dropout_rate: float = 0.0, attention_dropout_rate: float = 0.0):
        super().__init__()
        self.int8_attn = int8_attn
        self.fused_int8 = True
        self.in_size = in_size
        self.size = size
        self.n_head = n_head
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.norm1 = LayerNormF32(in_size, dtype)
        self.self_attn = MultiHeadedAttentionSANM(
            n_head, in_size, size, kernel_size, sanm_shift, dtype, param_dtype,
            attention_dropout_rate)
        self.norm2 = LayerNormF32(size, dtype)
        self.feed_forward = PositionwiseFeedForward(size, linear_units, dtype,
                                                    param_dtype, dropout_rate)
        self.int8 = None

    def quantize_weights(self) -> None:
        """int8 operands for the fused layer (``in_size == size`` and
        ``fused_int8``), else the QDense projections and the fused FFN of the
        module path."""
        if self.in_size != self.size or not self.fused_int8:
            self.self_attn.linear_q_k_v.quantize_weights()
            self.self_attn.linear_out.quantize_weights()
            self.feed_forward.quantize_weights()
            return
        at, ff = self.self_attn, self.feed_forward
        d = lambda t: t.detach()
        w = SL.quantize_sanm_layer(
            (d(self.norm1.weight), d(self.norm1.bias)), d(at.linear_q_k_v.weight),
            d(at.linear_q_k_v.bias), d(at.fsmn_block.weight), d(at.linear_out.weight),
            d(at.linear_out.bias), (d(self.norm2.weight), d(self.norm2.bias)),
            d(ff.w_1.weight), d(ff.w_1.bias), d(ff.w_2.weight), d(ff.w_2.bias))
        self.int8 = int8_buffers(self, "sanm_", w)

    def forward(self, x: torch.Tensor, mask_t: torch.Tensor,
                bias: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.int8 is not None:
            if attn_mask is not None:
                raise RuntimeError("EncoderLayerSANM: an attention mask needs the module "
                                   "path; set fused_int8 = False before quantize_weights()")
            return SL.fused_sanm_layer(x.to(self.dtype), lengths, self.int8(self),
                                       self.n_head, self.self_attn.left, bias,
                                       self.int8_attn)
        p, train = self.dropout_rate, self.training
        attn = F.dropout(self.self_attn(self.norm1(x), mask_t, bias, attn_mask), p, train)
        x = x + attn if self.in_size == self.size else attn
        return x + F.dropout(self.feed_forward(self.norm2(x)), p, train)


@tables.register("encoder_classes", "SANMEncoder")
class SANMEncoder(nn.Module):
    """SAN-M encoder (sanm/encoder.py:188 ``SANMEncoder``):
    x * sqrt(d) -> sinusoidal PE at the input width -> encoders0
    (input_size -> output_size) -> encoders (num_blocks - 1 layers) ->
    after_norm."""

    def __init__(self, input_size: int, output_size: int = 256,
                 attention_heads: int = 4, linear_units: int = 2048,
                 num_blocks: int = 6, kernel_size: int = 11,
                 sanm_shift: int = 0, input_layer: Optional[str] = "pe",
                 normalize_before: bool = True,
                 dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1,
                 attention_dropout_rate: float = 0.0,
                 param_dtype: Optional[torch.dtype] = None, int8_attn: bool = False,
                 remat: bool = False):
        """The dropout rates act in training only (defaults: the JAX
        package's).  ``param_dtype``: storage of the Dense and FSMN weights
        (default ``dtype``; float32 for int8 serving); ``int8_attn``: int8
        q.k scores in the fused int8 layers; ``remat``: recompute
        ``encoders``' layers in the backward pass."""
        super().__init__()
        if input_layer not in ("pe", None):
            raise NotImplementedError(
                f"input_layer={input_layer!r} (only 'pe'/None for SANM)")
        self.input_size = input_size
        self._output_size = output_size
        self.input_layer = input_layer
        self.normalize_before = normalize_before
        self.dtype = dtype
        self.remat = remat
        rates = dict(dropout_rate=dropout_rate,
                     attention_dropout_rate=attention_dropout_rate)
        self.encoders0 = nn.ModuleList([EncoderLayerSANM(
            input_size, output_size, attention_heads, linear_units,
            kernel_size, sanm_shift, dtype, param_dtype, **rates)])
        self.encoders = nn.ModuleList([
            EncoderLayerSANM(output_size, output_size, attention_heads,
                             linear_units, kernel_size, sanm_shift, dtype,
                             param_dtype, int8_attn, **rates)
            for _ in range(num_blocks - 1)])
        if normalize_before:
            self.after_norm = LayerNormF32(output_size, dtype)
        self.eval()  # built for inference; train() switches to the training path

    def output_size(self) -> int:
        return self._output_size

    def quantize_weights(self) -> None:
        """Quantize every layer's weights once (sanm.py:521-535 hoists the
        stack's quantization out of the per-batch program the same way)."""
        for layer in list(self.encoders0) + list(self.encoders):
            layer.quantize_weights()

    def forward(self, xs: torch.Tensor, lengths: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None):
        """xs (B, T, input_size); lengths (B,) -> (out (B, T, D), lengths).
        ``attn_mask`` (B, T, T), nonzero = may attend: every layer's
        attention is restricted to it as well as to the key mask
        (funasr_tpu sanm.py:123-128, :573), on the module path."""
        B, T, _ = xs.shape
        mask_t = sequence_mask(lengths, T)[:, :, None]  # (B, T, 1)
        bias = key_bias(lengths, T)  # (B, T) float32
        x = xs.to(self.dtype) * (self._output_size ** 0.5)
        if self.input_layer == "pe":
            pe = sinusoidal_encoding(T, self.input_size, device=xs.device)
            x = x + pe[None].to(self.dtype)
        x = self.encoders0[0](x, mask_t, bias, lengths, attn_mask)
        remat = self.remat and self.training and torch.is_grad_enabled()
        for layer in self.encoders:
            if remat:
                x = checkpoint(layer, x, mask_t, bias, lengths, attn_mask,
                               use_reentrant=False, preserve_rng_state=True)
            else:
                x = layer(x, mask_t, bias, lengths, attn_mask)
        if self.normalize_before:
            x = self.after_norm(x)
        return x, lengths
