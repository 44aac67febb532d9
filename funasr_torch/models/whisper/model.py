"""Whisper (port of funasr_tpu/models/whisper/model.py; reference
funasr/models/whisper/model.py:20 wraps OpenAI checkpoints by size).

The JAX package drives HF's flax graph
(``transformers/models/whisper/modeling_flax_whisper.py``); the port has its
own ``nn.Module`` of the same arithmetic, with openai-whisper's parameter
names, so an openai ``.pt`` checkpoint's ``model_state_dict`` is the
port's state dict:

- encoder: ``conv1`` (k = 3, pad 1) -> GELU -> ``conv2`` (k = 3, stride 2,
  pad 1) -> GELU -> + ``positional_embedding`` (the sinusoid table HF
  initialises, carried as a weight) -> pre-LN blocks (``attn_ln`` ->
  self-attention -> residual; ``mlp_ln`` -> ``mlp.0`` -> exact-erf GELU ->
  ``mlp.2`` -> residual) -> ``ln_post``;
- decoder: ``token_embedding`` + learned ``positional_embedding`` -> blocks
  (causal self-attention over a preallocated KV cache, ``cross_attn`` over
  the encoder states, the MLP) -> ``ln`` -> logits ``h @
  token_embedding.T`` (tied) in the compute dtype.

Every attention (encoder self, decoder self over the cache, cross) runs
through ``ops/attention.py`` ``fused_attention`` (the head-size-64 kernel on
the card, its twin on the CPU): q is divided by sqrt(d) in the compute
dtype before the call, as flax's ``dot_product_attention_weights`` does.
The decoder's self-attention reads the whole (B, n0 + max_tokens, D) cache
with a key bias of 0 for keys <= step and -1e30 past it (flax masks with
the dtype's lowest value: both give exp 0).  The cross-attention K/V are
projected once a batch; HF recomputes them every step with the same
arithmetic.

Compute dtype follows flax's ``dtype=`` (bf16 serving): Dense and conv
weights and the embeddings are stored in it, layer norms compute in float32
and round to it, each dot rounds to it before its bias is added.
``greedy_decode`` is the JAX package's ``lax.scan`` step rule as a host loop
of fixed length with the argmax on the device and no host sync until the
caller reads the tokens.
"""

from __future__ import annotations

import functools
import math
import os
from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.device import cudnn_float32, resolve_device, upload
from funasr_torch.frontends import whisper_frontend  # noqa: F401  (registers the frontend)
from funasr_torch.models.sanm import Dense, LayerNormF32, dot, rounded_once
from funasr_torch.ops import attention as A
from funasr_torch.registry import tables


def _size(d_model, layers, heads, **extra):
    # FFN width is 4*d_model in every released Whisper; WhisperConfig's
    # default (1536) only matches tiny, so spell it out per size
    return dict(d_model=d_model, encoder_layers=layers,
                encoder_attention_heads=heads, decoder_layers=layers,
                decoder_attention_heads=heads,
                encoder_ffn_dim=4 * d_model, decoder_ffn_dim=4 * d_model,
                **extra)


SIZES = {
    "tiny": _size(384, 4, 6),
    "base": _size(512, 6, 8),
    "small": _size(768, 12, 12),
    "medium": _size(1024, 24, 16),
    "large-v3": _size(1280, 32, 20, num_mel_bins=128, vocab_size=51866),
}

# HF WhisperConfig's defaults for the fields the graph reads
CONFIG_DEFAULTS = dict(
    vocab_size=51865, num_mel_bins=80, d_model=384, encoder_layers=4,
    encoder_attention_heads=6, decoder_layers=4, decoder_attention_heads=6,
    encoder_ffn_dim=1536, decoder_ffn_dim=1536, max_source_positions=1500,
    max_target_positions=448, decoder_start_token_id=50257, eos_token_id=50256,
    bos_token_id=50256, pad_token_id=50256)


def whisper_config(**overrides) -> SimpleNamespace:
    """HF WhisperConfig's defaults with ``overrides`` (its field names); a
    field the port's graph does not read raises."""
    unknown = set(overrides) - set(CONFIG_DEFAULTS)
    if unknown:
        raise ValueError(f"whisper_config: unsupported fields {sorted(unknown)} "
                         f"(known: {sorted(CONFIG_DEFAULTS)})")
    return SimpleNamespace(**{**CONFIG_DEFAULTS, **overrides})


def config_from_dims(dims) -> SimpleNamespace:
    """openai-whisper ``dims`` -> config, with the special-token ids of
    funasr_tpu/convert.py ``whisper_from_openai_pt``: multilingual vocabs
    (n_vocab >= 51865) start at 50258 and end at 50257; English-only ones
    keep HF's defaults."""
    d = int(dims["n_audio_state"])
    n_vocab = int(dims["n_vocab"])
    tok = (dict(bos_token_id=50257, eos_token_id=50257, pad_token_id=50257,
                decoder_start_token_id=50258) if n_vocab >= 51865 else {})
    return whisper_config(
        vocab_size=n_vocab, num_mel_bins=int(dims["n_mels"]), d_model=d,
        encoder_layers=int(dims["n_audio_layer"]),
        encoder_attention_heads=int(dims["n_audio_head"]),
        decoder_layers=int(dims["n_text_layer"]),
        decoder_attention_heads=int(dims["n_text_head"]),
        encoder_ffn_dim=4 * d, decoder_ffn_dim=4 * d,
        max_source_positions=int(dims["n_audio_ctx"]),
        max_target_positions=int(dims["n_text_ctx"]), **tok)


def dims_of(config) -> dict:
    """The openai-whisper ``dims`` of a config (FFN widths 4 x d_model)."""
    if config.encoder_ffn_dim != 4 * config.d_model or \
            config.decoder_ffn_dim != 4 * config.d_model:
        raise ValueError("openai-whisper dims need FFN widths of 4 x d_model")
    return dict(n_mels=config.num_mel_bins, n_audio_ctx=config.max_source_positions,
                n_audio_state=config.d_model, n_audio_head=config.encoder_attention_heads,
                n_audio_layer=config.encoder_layers, n_vocab=config.vocab_size,
                n_text_ctx=config.max_target_positions, n_text_state=config.d_model,
                n_text_head=config.decoder_attention_heads,
                n_text_layer=config.decoder_layers)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """HF's ``sinusoidal_embedding_init`` (openai's ``sinusoids``): sin then
    cos over ``channels // 2`` timescales up to 10000, float32."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2, dtype=np.float32)).astype(np.float32)
    t = np.arange(length, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _conv(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=...)``: the convolution in ``dtype`` (on the CPU
    rounded once, ``sanm.rounded_once``), then its bias added in ``dtype``;
    float32 with TF32 off."""
    op = functools.partial(F.conv1d, stride=conv.stride, padding=conv.padding)
    with cudnn_float32():
        y = rounded_once(op, x.to(dtype), conv.weight.to(dtype))
    return y + conv.bias.to(dtype)[:, None]


class WhisperAttention(nn.Module):
    """openai-whisper ``MultiHeadAttention``: ``query``, ``key`` (no bias),
    ``value``, ``out``; the attention through ``fused_attention``."""

    def __init__(self, d_model: int, n_head: int, dtype: torch.dtype):
        super().__init__()
        self.n_head = n_head
        self.query = Dense(d_model, d_model, dtype=dtype)
        self.key = Dense(d_model, d_model, bias=False, dtype=dtype)
        self.value = Dense(d_model, d_model, dtype=dtype)
        self.out = Dense(d_model, d_model, dtype=dtype)
        # flax divides q by sqrt(d) rounded to the compute dtype
        d = d_model // n_head
        self.q_div = float(torch.tensor(math.sqrt(d), dtype=torch.float32).to(dtype))

    def forward(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_bias: torch.Tensor) -> torch.Tensor:
        q = self.query(x) / self.q_div
        return self.out(A.fused_attention(q, k, v, key_bias, self.n_head))


class Mlp(nn.Sequential):
    """``mlp.0`` -> exact-erf GELU -> ``mlp.2``."""

    def __init__(self, d_model: int, ffn: int, dtype: torch.dtype):
        super().__init__(Dense(d_model, ffn, dtype=dtype), nn.GELU(),
                         Dense(ffn, d_model, dtype=dtype))


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, ffn: int, dtype: torch.dtype):
        super().__init__()
        self.attn = WhisperAttention(d_model, n_head, dtype)
        self.attn_ln = LayerNormF32(d_model, dtype, eps=1e-5)
        self.mlp = Mlp(d_model, ffn, dtype)
        self.mlp_ln = LayerNormF32(d_model, dtype, eps=1e-5)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        h = self.attn_ln(x)
        x = x + self.attn(h, self.attn.key(h), self.attn.value(h), key_bias)
        return x + self.mlp(self.mlp_ln(x))


class DecoderBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int, ffn: int, dtype: torch.dtype):
        super().__init__()
        self.attn = WhisperAttention(d_model, n_head, dtype)
        self.attn_ln = LayerNormF32(d_model, dtype, eps=1e-5)
        self.cross_attn = WhisperAttention(d_model, n_head, dtype)
        self.cross_attn_ln = LayerNormF32(d_model, dtype, eps=1e-5)
        self.mlp = Mlp(d_model, ffn, dtype)
        self.mlp_ln = LayerNormF32(d_model, dtype, eps=1e-5)

    def forward(self, x: torch.Tensor, i: int, cache, cross, self_bias: torch.Tensor,
                cross_bias: torch.Tensor) -> torch.Tensor:
        """One token a row at position ``i``: its K/V written into ``cache``
        (k, v of (B, L, D)), then attention over the whole cache."""
        h = self.attn_ln(x)
        k_cache, v_cache = cache
        k_cache[:, i:i + 1] = self.attn.key(h)
        v_cache[:, i:i + 1] = self.attn.value(h)
        x = x + self.attn(h, k_cache, v_cache, self_bias)
        x = x + self.cross_attn(self.cross_attn_ln(x), cross[0], cross[1], cross_bias)
        return x + self.mlp(self.mlp_ln(x))


class AudioEncoder(nn.Module):
    def __init__(self, config, dtype: torch.dtype):
        super().__init__()
        D = config.d_model
        self.n_mels, self.n_ctx = config.num_mel_bins, config.max_source_positions
        self.dtype = dtype
        self.conv1 = nn.Conv1d(config.num_mel_bins, D, 3, padding=1, dtype=dtype)
        self.conv2 = nn.Conv1d(D, D, 3, stride=2, padding=1, dtype=dtype)
        self.register_buffer("positional_embedding",
                             torch.from_numpy(sinusoids(self.n_ctx, D)).to(dtype))
        self.blocks = nn.ModuleList(
            EncoderBlock(D, config.encoder_attention_heads, config.encoder_ffn_dim, dtype)
            for _ in range(config.encoder_layers))
        self.ln_post = LayerNormF32(D, dtype, eps=1e-5)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 2 n_ctx) log-mel -> (B, n_ctx, D) states."""
        if tuple(feats.shape[1:]) != (self.n_mels, 2 * self.n_ctx):
            raise ValueError(
                "input_features.shape[1:], must be equal to (num_mel_bins, "
                f"max_source_positions * 2) (got {tuple(feats.shape[1:])}, but should be "
                f"({self.n_mels}, {2 * self.n_ctx}))")
        dt = self.dtype
        x = F.gelu(_conv(feats, self.conv1, dt))
        x = F.gelu(_conv(x, self.conv2, dt))
        x = x.transpose(1, 2).contiguous() + self.positional_embedding.to(dt)
        bias = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            x = blk(x, bias)
        return self.ln_post(x)


class TextDecoder(nn.Module):
    def __init__(self, config, dtype: torch.dtype):
        super().__init__()
        D = config.d_model
        self.dtype = dtype
        self.token_embedding = nn.Embedding(config.vocab_size, D, dtype=dtype)
        self.positional_embedding = nn.Parameter(
            torch.zeros(config.max_target_positions, D, dtype=dtype))
        self.blocks = nn.ModuleList(
            DecoderBlock(D, config.decoder_attention_heads, config.decoder_ffn_dim, dtype)
            for _ in range(config.decoder_layers))
        self.ln = LayerNormF32(D, dtype, eps=1e-5)

    def start(self, enc: torch.Tensor, length: int) -> SimpleNamespace:
        """A batch's decode state for ``length`` positions: the zeroed KV
        caches, the cross-attention K/V of every block (projected once) and
        the causal key biases (step i's (B, length) rows: 0 up to key i,
        -1e30 past it)."""
        B, T, D = enc.shape
        dev = enc.device
        caches = [(torch.zeros((B, length, D), dtype=self.dtype, device=dev),
                   torch.zeros((B, length, D), dtype=self.dtype, device=dev))
                  for _ in self.blocks]
        cross = [(blk.cross_attn.key(enc), blk.cross_attn.value(enc)) for blk in self.blocks]
        pos = torch.arange(length, device=dev)
        causal = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e30)  # (L, L)
        return SimpleNamespace(caches=caches, cross=cross,
                               causal=causal[:, None].expand(length, B, length).contiguous(),
                               cross_bias=torch.zeros((B, T), dtype=torch.float32,
                                                      device=dev))

    def step(self, tokens: torch.Tensor, i: int, state: SimpleNamespace) -> torch.Tensor:
        """tokens (B,) at position ``i`` -> (B, vocab) logits in the compute
        dtype; writes position i of the caches."""
        dt = self.dtype
        x = (self.token_embedding(tokens) + self.positional_embedding[i].to(dt))[:, None]
        for blk, cache, cross in zip(self.blocks, state.caches, state.cross):
            x = blk(x, i, cache, cross, state.causal[i], state.cross_bias)
        return dot(self.ln(x)[:, 0], self.token_embedding.weight.to(dt))


class Whisper(nn.Module):
    """The graph: ``encoder`` and ``decoder`` with openai's names."""

    def __init__(self, config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = AudioEncoder(config, dtype)
        self.decoder = TextDecoder(config, dtype)


def init_weights_(module: Whisper, generator: torch.Generator) -> Whisper:
    """Seeded random weights, in place: LeCun-normal Dense and conv weights
    (fan-in = in x K), those that write into the residual stream (each
    block's ``attn.out``, ``cross_attn.out`` and ``mlp.2``) scaled by
    1/sqrt(2 x the stack's blocks), zero biases, unit/zero layer norms,
    token embeddings N(0, 0.02^2) and decoder positions N(0, 1); the
    encoder's sinusoid table kept.  Draws in float32 on ``generator``'s
    device.

    Greedy decoding at random weights needs this rule to be a test at all:
    with N(0, 1) token embeddings (or HF's init) it predicts the token it was
    fed, and with unscaled residual writes the stream outgrows the
    embeddings over 32 blocks, so every step predicts the same few tokens
    (measured on the CPU at D = 256 with 32 + 32 blocks, 4 windows of 16
    tokens: 2-4 distinct a row; with this rule 16 of 16)."""
    def normal_(p: torch.Tensor, std: float):
        p.copy_(torch.randn(p.shape, generator=generator, device=generator.device) * std)

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, (nn.Linear, nn.Conv1d)):
                normal_(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNormF32):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for stack in (module.encoder.blocks, module.decoder.blocks):
            for blk in stack:
                writes = [blk.attn.out, blk.mlp[2]] + (
                    [blk.cross_attn.out] if isinstance(blk, DecoderBlock) else [])
                for lin in writes:
                    lin.weight.mul_(1.0 / math.sqrt(2 * len(stack)))
        normal_(module.decoder.token_embedding.weight, 0.02)
        normal_(module.decoder.positional_embedding, 1.0)
    return module


def load_openai_checkpoint(path_or_ckpt):
    """An openai-whisper checkpoint (``{"dims", "model_state_dict"}``, a
    ``.pt`` path or the loaded dict) -> (config, state dict without the
    ``alignment_heads`` buffer, which the graph does not read)."""
    ckpt = path_or_ckpt
    if isinstance(ckpt, (str, os.PathLike)):
        ckpt = torch.load(ckpt, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state_dict", ckpt.get("state_dict"))
    sd = {k: v for k, v in sd.items() if k != "alignment_heads"}
    return config_from_dims(ckpt["dims"]), sd


@tables.register("model_classes", "Whisper")
@tables.register("model_classes", "WhisperWrap")
class WhisperWrap:
    """Whisper behind the JAX package's ``WhisperWrap`` contract: ``size``
    (one of :data:`SIZES`; an unknown size raises, where the JAX package
    builds tiny), ``model_path`` an openai ``.pt`` (a HF directory raises
    ``NotImplementedError``), else seeded random weights
    (:func:`init_weights_`, ``seed``) with ``config_overrides``."""

    def __init__(self, size: str = "tiny", model_path: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16, device=None, seed: int = 0,
                 config_overrides: Optional[dict] = None):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.size = size
        state = None
        if model_path and str(model_path).endswith(".pt"):
            self.config, state = load_openai_checkpoint(model_path)
        elif model_path:
            raise NotImplementedError(
                f"WhisperWrap: model_path {str(model_path)!r} is not an openai-whisper "
                ".pt; HF checkpoint directories are not ported (ROADMAP.md Queue 1)")
        else:
            if size not in SIZES:
                raise ValueError(f"WhisperWrap: unknown size {size!r}; SIZES has "
                                 f"{sorted(SIZES)}")
            self.config = whisper_config(**{**SIZES[size], **(config_overrides or {})})
        with torch.device(self.device):  # parameters made and drawn on the device
            self.model = Whisper(self.config, dtype).to(self.device).eval()
        if state is not None:
            self.model.load_state_dict(state, strict=True)
        else:
            init_weights_(self.model, torch.Generator(device=self.device).manual_seed(seed))
        self.model.requires_grad_(False)

    def checkpoint(self) -> dict:
        """The openai-whisper checkpoint of these weights, float32 on the host."""
        return {"dims": dims_of(self.config),
                "model_state_dict": {k: v.detach().to("cpu", torch.float32)
                                     for k, v in self.model.state_dict().items()}}

    @torch.no_grad()
    def encode(self, input_features: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) log-mel -> encoder states (B, 1500, D)."""
        return self.model.encoder(input_features.to(self.device))

    @torch.no_grad()
    def greedy_decode(self, input_features: torch.Tensor, max_tokens: int = 64,
                      forced_tokens: Optional[Sequence[int]] = None,
                      tokens: Optional[torch.Tensor] = None, return_logits: bool = False):
        """Device greedy decode -> (B, max_tokens) token ids on the device.

        ``n0 = 1 + len(forced_tokens)``; ``n0 + max_tokens - 1`` steps; inside
        the forced prefix the next input is the forced token, afterwards the
        argmax; the output is the predictions from step n0 - 1 on.  No eos
        stop and no host sync.  ``tokens`` (B, S) teacher-forces the decode:
        after the prefix step n0 + t is fed ``tokens[:, t]`` in place of the
        argmax (``max_tokens`` = S).  ``return_logits`` also returns each
        prediction's logits (B, max_tokens, vocab) in the compute dtype."""
        if tokens is not None:
            max_tokens = tokens.shape[1]
        start = [self.config.decoder_start_token_id] + [int(t) for t in forced_tokens or []]
        n0 = len(start)
        total = n0 + max_tokens
        if total > self.config.max_target_positions:
            raise ValueError(f"greedy_decode: {n0} prompt tokens + max_tokens {max_tokens} "
                             f"exceed max_target_positions {self.config.max_target_positions}")
        dec = self.model.decoder
        state = dec.start(self.encode(input_features), total)
        B = input_features.shape[0]
        steps = total - 1
        preds = torch.empty((B, steps), dtype=torch.int64, device=self.device)
        kept = (torch.empty((B, max_tokens, self.config.vocab_size), dtype=self.dtype,
                            device=self.device) if return_logits else None)
        tok = torch.full((B,), start[0], dtype=torch.int64, device=self.device)
        for i in range(steps):
            logits = dec.step(tok, i, state)
            pred = logits.argmax(-1)
            preds[:, i] = pred
            if kept is not None and i >= n0 - 1:
                kept[:, i - n0 + 1] = logits
            if i + 1 < n0:
                tok = torch.full((B,), start[i + 1], dtype=torch.int64, device=self.device)
            else:
                tok = pred if tokens is None else tokens[:, i + 1 - n0].to(self.device)
        return (preds[:, n0 - 1:], kept) if return_logits else preds[:, n0 - 1:]

    @torch.no_grad()
    def detect_language(self, input_features: torch.Tensor,
                        language_token_ids: Sequence[int]) -> torch.Tensor:
        """Whisper-style LID: the first decoder step's logits restricted to
        the language tokens -> (B, n_langs) float32 probabilities."""
        dec = self.model.decoder
        state = dec.start(self.encode(input_features), 1)
        B = input_features.shape[0]
        sot = torch.full((B,), self.config.decoder_start_token_id, dtype=torch.int64,
                         device=self.device)
        logits = dec.step(sot, 0, state)
        lang = upload(np.asarray(list(language_token_ids), np.int64), self.device)
        return torch.softmax(logits[:, lang].to(torch.float32), dim=-1)


@tables.register("model_classes", "WhisperLID")
class WhisperLID(WhisperWrap):
    """Whisper with language identification as a first-class output
    (reference funasr/models/whisper_lid): ``transcribe_with_lid`` returns
    (tokens, lang_probs)."""

    def __init__(self, *args, language_token_ids=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.language_token_ids = list(language_token_ids or [])

    @torch.no_grad()
    def transcribe_with_lid(self, input_features: torch.Tensor, max_tokens: int = 64):
        """Detect each row's language, then decode the rows of each detected
        language as one batch with its token forced: (tokens (B, max_tokens),
        probs (B, n_langs)), both on the device.  Grouping reads the
        detected languages back to the host, as the JAX package does."""
        if not self.language_token_ids:
            raise ValueError(
                "WhisperLID needs language_token_ids (the tokenizer ids of "
                "the <|xx|> language tokens) to detect languages")
        probs = self.detect_language(input_features, self.language_token_ids)
        best = probs.argmax(-1).cpu().numpy()
        lang_ids = np.asarray(self.language_token_ids)
        feats = input_features.to(self.device)
        out = None
        for lang in np.unique(best):
            idx = upload(np.nonzero(best == lang)[0], self.device)
            toks = self.greedy_decode(feats[idx], max_tokens=max_tokens,
                                      forced_tokens=[int(lang_ids[lang])])
            if out is None:
                out = torch.zeros((feats.shape[0],) + toks.shape[1:], dtype=toks.dtype,
                                  device=self.device)
            out[idx] = toks
        return out, probs


def _alias(name: str, target: str, **pinned):
    cls = tables.get("model_classes", target)

    def factory(*args, **conf):
        return cls(*args, **{**pinned, **conf})

    factory.__name__ = f"{target}[{name}]"
    tables.register("model_classes", name)(factory)


# the JAX package's registry aliases (funasr_tpu/registry_compat.py:52-63)
for _size_name in ("tiny", "tiny.en", "base", "base.en", "small", "small.en", "medium",
                   "medium.en", "large-v1", "large-v2", "large-v3", "large-v3-turbo"):
    _alias(f"Whisper-{_size_name}", "WhisperWrap", size=_size_name)
_alias("WhisperWarp", "WhisperWrap")
_alias("OpenAIWhisperModel", "WhisperWrap")
_alias("OpenAIWhisperLIDModel", "WhisperLID")
