"""emotion2vec: the data2vec-2.0 audio encoder with its SER head, inference
path (port of funasr_tpu/models/emotion2vec/model.py; reference
funasr/models/emotion2vec/model.py:35, audio.py:23, base.py:156).

- ``local_encoder``: the wav2vec2 feature extractor in "layer_norm" mode, 7
  bias-free convs, each followed by a float32 layer norm (eps 1e-5) and the
  exact GELU (~50 Hz frames of 512 channels);
- ``project_features``: layer norm and a dense layer to ``dim``;
- ``relative_positional_encoder``: 5 grouped convs (k = 19, 16 groups,
  ``SAME`` padding: 9 on each side), each followed by an affine-free layer
  norm and the GELU, added to the projection;
- 10 learned extra tokens before the frames, a key-padding mask, and the
  symmetric ALiBi bias ``slope_h * max(scale_h, 0) * -|i - j|`` (zero on the
  extra tokens' rows and columns; the JAX ``symmetric_alibi`` padded, which
  the kernel computes from the head, query and key), whose slopes times
  scales are made on the device once a batch;
- ``context_encoder``: a layer norm, then ``prenet_depth`` post-norm
  AltBlocks; then ``depth`` AltBlocks (``blocks``); every AltAttention runs
  through ``ops/attention.py`` ``fused_attention`` with the ALiBi slopes
  (the float32 d = 64 kernel on the card: one launch a block);
- the extra tokens dropped, a masked mean over the valid frames, ``proj``
  to the emotion classes.

Everything computes in float32 (the JAX model has no other dtype; it takes
no int8 route); the convolutions run through cuDNN with TF32 off (the
port's rule for float32 convolutions).  ``Emotion2vec`` is the user-facing
model (``model.py:357`` of the JAX package): ``generate(wavs,
extract_embedding)`` normalizes each waveform (``normalize_wav``, on the
host in numpy as there), pads the batch to a multiple of 3200 samples and
returns ``{"labels", "scores"}`` (softmax) per waveform, with the pooled
embedding under ``"feats"`` when asked.

Parameter names are FunASR's torch names
(``modality_encoders.AUDIO.local_encoder.conv_layers.{i}.0``, ``...2.1``,
``project_features.1``/``.2``, ``relative_positional_encoder.{i+1}.0``,
``extra_tokens``, ``alibi_scale``, ``context_encoder.{blocks.{i},norm}``,
``blocks.{i}.{norm1,norm2,attn.qkv,attn.proj,mlp.fc1,mlp.fc2}``, ``proj``),
the layout ``funasr_tpu/convert.py`` ``emotion2vec_from_torch`` reads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.device import cudnn_float32, fetch_async, fetched, resolve_device, upload
from funasr_torch.models.paraformer.model import init_random_
from funasr_torch.models.sanm import LayerNormF32
from funasr_torch.ops import attention as A
from funasr_torch.ops.masks import key_bias, sequence_mask
from funasr_torch.registry import tables

DEFAULT_EMOTIONS = (
    "angry", "disgusted", "fearful", "happy", "neutral", "other", "sad",
    "surprised", "unknown",
)

# wav2vec2 / data2vec-2.0 audio feature extractor layout (template.yaml
# feature_encoder_spec): (dim, kernel, stride) -- ~50 Hz frame rate
CONV_LAYERS = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
               (512, 3, 2), (512, 2, 2), (512, 2, 2))
PAD_MULTIPLE = 3200  # generate() pads a batch to a multiple of this many samples


def alibi_slopes(heads: int) -> np.ndarray:
    """ALiBi head slopes (a copy of funasr_tpu/models/emotion2vec/model.py:51,
    reference base.py:486 ``get_slopes``)."""

    def pow2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * start ** i for i in range(n)]

    if math.log2(heads).is_integer():
        return np.asarray(pow2(heads))
    closest = 2 ** math.floor(math.log2(heads))
    extra = pow2(2 * closest)[0::2][: heads - closest]
    return np.asarray(pow2(closest) + extra)


def normalize_wav(wav: np.ndarray) -> np.ndarray:
    """Per-utterance layer norm of the raw waveform (reference model.py:232
    ``F.layer_norm(source, source.shape)``), in numpy as the JAX package."""
    mean = wav.mean()
    var = wav.var()
    return (wav - mean) / np.sqrt(var + 1e-5)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


class _TransposeLast(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(-2, -1)


class _Gelu(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _gelu(x)


class ConvFeatureExtractor(nn.Module):
    """(B, N) raw audio -> (B, C, T): each conv (no bias) -> layer norm over
    the channels (float32, eps 1e-5) -> exact GELU; fairseq's
    ``conv_layers.{i}`` = (conv, dropout, (transpose, layer norm, transpose),
    GELU)."""

    def __init__(self, layers=CONV_LAYERS):
        super().__init__()
        blocks, cin = [], 1
        for c, k, s in layers:
            blocks.append(nn.Sequential(
                nn.Conv1d(cin, c, k, stride=s, bias=False), nn.Identity(),
                nn.Sequential(_TransposeLast(), LayerNormF32(c, eps=1e-5), _TransposeLast()),
                _Gelu()))
            cin = c
        self.conv_layers = nn.ModuleList(blocks)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :].to(torch.float32)
        with cudnn_float32():
            for block in self.conv_layers:
                x = block(x)
        return x


class AltAttention(nn.Module):
    """qkv -> attention with ALiBi and a key bias (``fused_attention``) ->
    proj (timm AltAttention, emotion2vec modules.py:244)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, kbias: torch.Tensor, slopes: torch.Tensor,
                extra: int) -> torch.Tensor:
        C = x.shape[-1]
        qkv = self.qkv(x)
        q = qkv[..., :C] * ((C // self.num_heads) ** -0.5)
        ctx = A.fused_attention(q, qkv[..., C:2 * C], qkv[..., 2 * C:], kbias, self.num_heads,
                                alibi_slopes=slopes, extra=extra)
        return self.proj(ctx)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(_gelu(self.fc1(x)))


class AltBlock(nn.Module):
    """Post-norm AltBlock: ``x += attn(x); r = norm1(x); x = norm2(r +
    mlp(r))`` (timm_modules.py:225, layer_norm_first=False)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.attn = AltAttention(dim, num_heads)
        self.norm1 = LayerNormF32(dim, eps=1e-5)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.norm2 = LayerNormF32(dim, eps=1e-5)

    def forward(self, x, kbias, slopes, extra):
        r = self.norm1(x + self.attn(x, kbias, slopes, extra))
        return self.norm2(r + self.mlp(r))


class _BlockEncoder(nn.Module):
    def __init__(self, dim, depth, num_heads, mlp_ratio):
        super().__init__()
        self.blocks = nn.ModuleList([AltBlock(dim, num_heads, mlp_ratio) for _ in range(depth)])
        self.norm = LayerNormF32(dim, eps=1e-5)


class AudioEncoder(nn.Module):
    """The AUDIO modality encoder: extractor, projection, positional convs,
    extra tokens, ALiBi scale and the prenet (``context_encoder``)."""

    def __init__(self, dim, prenet_depth, n_head, mlp_ratio, num_extra_tokens=10,
                 conv_pos_depth=5, conv_pos_width=95, conv_pos_groups=16,
                 conv_layers=CONV_LAYERS):
        super().__init__()
        self.local_encoder = ConvFeatureExtractor(conv_layers)
        c = conv_layers[-1][0]
        self.project_features = nn.Sequential(_TransposeLast(), LayerNormF32(c, eps=1e-5),
                                              nn.Linear(c, dim))
        k = max(3, conv_pos_width // conv_pos_depth)
        self.pos_pad = ((k - 1) // 2, k // 2)  # SAME
        self.relative_positional_encoder = nn.Sequential(_TransposeLast(), *[
            nn.Sequential(nn.Conv1d(dim, dim, k, groups=conv_pos_groups))
            for _ in range(conv_pos_depth)])
        self.extra_tokens = nn.Parameter(torch.zeros(1, num_extra_tokens, dim))
        self.alibi_scale = nn.Parameter(torch.ones(1, 1, n_head, 1, 1))
        self.context_encoder = _BlockEncoder(dim, prenet_depth, n_head, mlp_ratio)


@tables.register("model_classes", "Emotion2vec")
class Emotion2vec(nn.Module):
    """The SER model on ``device`` (default: the GPU, raising without one;
    ``"cpu"`` only when asked): ``forward(wav, wav_lengths)`` -> (logits,
    pooled), :meth:`run` the device program of a batch, :meth:`generate` the
    user-facing call.  ``ffn`` (the legacy surface) sets the MLP width
    instead of ``mlp_ratio``; other keywords are accepted and ignored, as
    the JAX constructor does."""

    def __init__(self, labels: Sequence[str] = DEFAULT_EMOTIONS, dim: int = 768,
                 depth: int = 8, prenet_depth: int = 4, n_head: int = 12,
                 mlp_ratio: float = 4.0, normalize: bool = True, ffn: Optional[int] = None,
                 device=None, **kwargs):
        if "params" in kwargs:
            raise NotImplementedError("Emotion2vec: load weights with load_state_dict "
                                      "(convert.emotion2vec_from_jax for a flax tree)")
        super().__init__()
        self.labels = list(labels)
        self.normalize = normalize
        self.n_head = n_head
        if ffn is not None:
            mlp_ratio = ffn / dim
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.modality_encoders = nn.ModuleDict(
                {"AUDIO": AudioEncoder(dim, prenet_depth, n_head, mlp_ratio)})
            self.blocks = nn.ModuleList([AltBlock(dim, n_head, mlp_ratio)
                                         for _ in range(depth)])
            self.proj = nn.Linear(dim, len(self.labels))
        self.register_buffer("slopes", upload(alibi_slopes(n_head).astype(np.float32),
                                              self.device), persistent=False)
        self.eval()

    def init_weights_(self, generator: torch.Generator) -> "Emotion2vec":
        """Seeded random weights: ``init_random_``'s rule, then the JAX
        initial ALiBi scale (ones), so every head keeps its bias."""
        init_random_(self, generator)
        with torch.no_grad():
            self.modality_encoders["AUDIO"].alibi_scale.fill_(1.0)
        return self

    def frame_lengths(self, wav_lengths: torch.Tensor) -> torch.Tensor:
        n = wav_lengths.to(torch.int64)
        for _, k, s in CONV_LAYERS:
            n = torch.div(n - k, s, rounding_mode="floor") + 1
        return n.clamp(min=0)

    def forward(self, wav: torch.Tensor, wav_lengths: torch.Tensor,
                return_frames: bool = False):
        """(B, N) float32 audio, (B,) lengths -> (logits (B, classes),
        pooled (B, dim)); with ``return_frames`` also the frames (B, T, dim)
        without the extra tokens and their lengths."""
        enc = self.modality_encoders["AUDIO"]
        feats = enc.local_encoder(wav)
        flens = self.frame_lengths(wav_lengths)
        x = enc.project_features(feats)
        pos = x.transpose(1, 2)
        with cudnn_float32():
            for block in enc.relative_positional_encoder[1:]:
                conv = block[0]
                pos = F.conv1d(F.pad(pos, enc.pos_pad), conv.weight, conv.bias,
                               groups=conv.groups)
                pos = _gelu(F.layer_norm(pos.transpose(1, 2), (pos.shape[1],),
                                         eps=1e-5).transpose(1, 2))
        x = x + pos.transpose(1, 2)

        B, T, D = x.shape
        ex = enc.extra_tokens.shape[1]
        slopes = self.slopes * enc.alibi_scale.reshape(-1).clamp(min=0)
        x = torch.cat([enc.extra_tokens.expand(B, ex, D), x], dim=1)
        kbias = key_bias(flens + ex, T + ex)
        x = enc.context_encoder.norm(x)
        for block in list(enc.context_encoder.blocks) + list(self.blocks):
            x = block(x, kbias, slopes, ex)
        x = x[:, ex:]
        m = sequence_mask(flens, T)[..., None]
        pooled = (x * m).sum(dim=1) / m.sum(dim=1).clamp(min=1.0)
        logits = self.proj(pooled)
        if return_frames:
            return logits, pooled, x, flens
        return logits, pooled

    @torch.inference_mode()
    def run(self, wav: torch.Tensor, wav_lengths: torch.Tensor):
        """The device program of a packed batch: (softmax scores, pooled)."""
        logits, pooled = self(wav, wav_lengths)
        return torch.softmax(logits.to(torch.float32), dim=-1), pooled

    def pack(self, wavs: Sequence[np.ndarray]):
        """-> (B, N) float32 batch on the device, N the longest waveform
        padded to a multiple of 3200 samples, each row normalized
        (``normalize``), and its (B,) int64 lengths."""
        lens = np.array([len(w) for w in wavs], np.int64)
        pad = PAD_MULTIPLE * ((int(lens.max()) + PAD_MULTIPLE - 1) // PAD_MULTIPLE)
        batch = np.zeros((len(wavs), pad), np.float32)
        for i, w in enumerate(wavs):
            w = np.asarray(w, np.float32)
            batch[i, : len(w)] = normalize_wav(w) if self.normalize else w
        return upload(batch, self.device), upload(lens, self.device)

    def generate(self, wavs: Sequence[np.ndarray],
                 extract_embedding: bool = False) -> List[Dict[str, Any]]:
        if not len(wavs):
            return []
        scores, pooled = fetched(*fetch_async(self.run(*self.pack(wavs))))
        scores, pooled = scores.numpy(), pooled.numpy()
        out = []
        for i in range(len(wavs)):
            r: Dict[str, Any] = {"labels": self.labels, "scores": scores[i].tolist()}
            if extract_embedding:
                r["feats"] = pooled[i]
            out.append(r)
        return out

