"""Streaming Paraformer (port of funasr_tpu/models/paraformer_streaming/model.py;
reference funasr/models/paraformer_streaming/model.py:556 inference, :435
init_cache, :468 generate_chunk).

Per chunk of ``c`` LFR frames (chunk_size = (lookback, current, lookahead),
default (0, 10, 5): 600 ms):

  waveform chunk -> StreamingFrontend (fbank kernel) -> feature window
  [l + r cached frames | c new] -> encoder_chunk (KV caches, attention
  kernel) -> CIF over the window's first l + c frames (carried integrate
  state) -> decoder_chunk (FSMN tails, attention kernel) -> greedy tokens.

A window step is dispatched without a host sync: the window goes up from
pinned memory (``device.upload``), the window counters are host ints, and
the only read is of ``(n_tok, tokens)`` at its end, into pinned memory
behind an event (``device.fetch_async``), as the JAX step reads
``int(n_tok[0])``.  The model is the port's float32 :class:`Paraformer`
(given, or built from a FunASR-named state dict), so a checkpoint serves
the offline and the streaming path; the JAX package's decoders2 (FSMN-only
layers) are not run by its streaming step, and a model with them raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from funasr_torch.device import fetch_async, fetched, resolve_device, upload
from funasr_torch.frontends.streaming import StreamingFrontend
from funasr_torch.models.paraformer.model import Paraformer
from funasr_torch.models.paraformer_streaming import functional as SF
from funasr_torch.registry import tables


class StreamDeviceState(NamedTuple):
    enc: SF.EncChunkState
    cif: SF.CifState
    dec: SF.DecChunkState
    start_idx: int  # absolute LFR frame position of the window's new frames


@dataclass
class StreamCache:
    """Host-side per-stream cache (reference cache dict, model.py:435)."""

    frontend: Any
    device: StreamDeviceState
    feats_cache: np.ndarray  # (l + r, D_in) window overlap frames
    pending: np.ndarray  # feature frames not yet grouped into a chunk
    tokens: List[int] = field(default_factory=list)


def _module_dims(model: Paraformer) -> Dict[str, int]:
    enc, dec = model.encoder, model.decoder
    return dict(input_size=enc.input_size, d_model=enc.output_size(),
                n_head=enc.encoders0[0].n_head,
                enc_kernel=enc.encoders0[0].self_attn.fsmn_block.kernel_size[0],
                dec_kernel=dec.decoders[0].self_attn.fsmn_block.kernel_size[0],
                n_enc_layers=len(enc.encoders0) + len(enc.encoders),
                n_dec_layers=len(dec.decoders))


def _build_paraformer(state: Dict[str, torch.Tensor], dims: Dict[str, int],
                      tail_threshold: float, device) -> Paraformer:
    """A float32 Paraformer of ``dims`` holding ``state`` (FunASR names); the
    vocabulary and the FFN widths come from the state's shapes."""
    model = Paraformer(
        vocab_size=state["decoder.output_layer.weight"].shape[0],
        input_size=dims["input_size"],
        encoder_conf=dict(output_size=dims["d_model"], attention_heads=dims["n_head"],
                          linear_units=state["encoder.encoders0.0.feed_forward.w_1.weight"]
                          .shape[0], num_blocks=dims["n_enc_layers"],
                          kernel_size=dims["enc_kernel"]),
        decoder_conf=dict(attention_heads=dims["n_head"],
                          linear_units=state["decoder.decoders.0.feed_forward.w_1.weight"]
                          .shape[0], num_blocks=dims["n_dec_layers"],
                          att_layer_num=dims["n_dec_layers"], kernel_size=dims["dec_kernel"]),
        predictor_conf=dict(idim=dims["d_model"], tail_threshold=tail_threshold),
        device=device)
    model.load_state_dict(state, strict=True)
    return model


@tables.register("model_classes", "ParaformerStreaming")
class ParaformerStreaming:
    """A float32 Paraformer (``model``: the port's module, or its state dict
    with FunASR torch names) and the streaming step.  ``device=None`` means
    the card (raises without one unless ``device="cpu"``); a given module
    must sit on that device.  The dimensions default to Paraformer-large's
    and are checked against the module."""

    def __init__(
        self,
        model: Union[Paraformer, Dict[str, torch.Tensor]],
        input_size: int = 560,
        d_model: int = 512,
        n_head: int = 4,
        enc_kernel: int = 11,
        dec_kernel: int = 11,
        n_enc_layers: int = 50,
        n_dec_layers: int = 16,
        chunk_size=(0, 10, 5),
        encoder_chunk_look_back: int = 4,
        tail_threshold: float = 0.45,
        blank_id: int = 0,
        frontend: Optional[StreamingFrontend] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        dims = dict(input_size=input_size, d_model=d_model, n_head=n_head,
                    enc_kernel=enc_kernel, dec_kernel=dec_kernel,
                    n_enc_layers=n_enc_layers, n_dec_layers=n_dec_layers)
        if not isinstance(model, Paraformer):
            model = _build_paraformer(dict(model), dims, tail_threshold, self.device)
        if model.dtype != torch.float32 or model.quantize:
            raise ValueError("ParaformerStreaming: the streaming step is float32; pass a "
                             "float32 Paraformer without quantize")
        if next(model.parameters()).device != self.device:
            raise ValueError(f"ParaformerStreaming: the model is on "
                             f"{next(model.parameters()).device}, not {self.device}")
        if model.decoder.decoders2 is not None:
            raise NotImplementedError("ParaformerStreaming: decoders2 (FSMN-only "
                                      "decoder layers) are not run by the streaming step")
        wrong = {k: (v, dims[k]) for k, v in _module_dims(model).items() if v != dims[k]}
        if wrong:
            raise ValueError(f"ParaformerStreaming: model (has, given) differ: {wrong}")
        self.model = model
        self.input_size = input_size
        self.d_model = d_model
        self.dec_kernel = dec_kernel
        self.n_enc_layers = n_enc_layers
        self.n_dec_layers = n_dec_layers
        self.chunk_size = tuple(chunk_size)
        self.look_back = encoder_chunk_look_back
        self.tail_threshold = tail_threshold
        self.blank_id = blank_id
        self.frontend = frontend or StreamingFrontend(device=self.device)

        l, c, r = self.chunk_size
        self.window = l + r + c
        # window layout = [l + r cached | c new]: the reference
        # (cif_predictor.py:277) zeroes the lookback [0, l) always and the
        # lookahead [l + c, W) on non-final chunks -> fire region [l, l + c)
        self.max_tokens = c + r + 3  # carry + <= c + r final fires + tail
        self.kv_cache_len = max(self.look_back, 1) * c
        self.inv_ts = SF.streaming_inv_timescales(input_size, self.device)

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def _step(self, window: np.ndarray, state: StreamDeviceState, final_alpha: float,
              win_valid: int):
        """One window (W, D_in) on the device with no host sync: returns
        ((n_tok, tokens) being fetched, log_probs (1, U, V), state')."""
        l, c, r = self.chunk_size
        m = self.model
        x = upload(window[None], self.device)
        enc_out, enc_state = SF.encoder_chunk(
            m.encoder, x, state.enc, state.start_idx, win_valid, self.inv_ts,
            keep=l + c, overlap=l + r)
        alphas = SF.predictor_alphas(m.predictor, enc_out)
        # lookback always masked; lookahead masked unless final (the
        # reference keeps the trailing alphas on the last chunk); final-chunk
        # pad frames never fire
        fire = alphas.new_zeros((1, self.window))
        fire[:, l:win_valid if final_alpha > 0 else min(win_valid, l + c)] = 1.0
        alphas = alphas * fire
        # final tail pseudo-frame: ZERO hidden, alpha = tail_threshold
        # (reference cif_predictor.py:285-289)
        B = enc_out.shape[0]
        hidden_ext = torch.cat([enc_out, enc_out.new_zeros((B, 1, enc_out.shape[2]))], 1)
        alphas_ext = torch.cat([alphas, alphas.new_full((B, 1), final_alpha)], 1)
        embeds, n_tok, cif_state = SF.cif_chunk(hidden_ext, alphas_ext, state.cif,
                                                self.max_tokens)
        log_probs, dec_state = SF.decoder_chunk(m.decoder, embeds, n_tok, enc_out,
                                                state.dec, win_valid)
        tokens = torch.argmax(log_probs, dim=-1)
        out = fetch_async([torch.cat([n_tok[:, None].to(torch.int64), tokens], 1)])
        return out, log_probs, StreamDeviceState(enc_state, cif_state, dec_state,
                                                 state.start_idx + c)

    # ---------------------------------------------------------------- cache
    def init_cache(self) -> StreamCache:
        """A new stream (batch 1: a stream is one session)."""
        l, c, r = self.chunk_size
        dev = self.device
        state = StreamDeviceState(
            enc=SF.init_enc_state(self.n_enc_layers, 1, self.kv_cache_len, self.d_model,
                                  dev),
            cif=SF.init_cif_state(1, self.d_model, dev),
            dec=SF.init_dec_state(self.n_dec_layers, 1, self.dec_kernel, self.d_model,
                                  dev),
            start_idx=0)
        return StreamCache(
            frontend=self.frontend.init_state(),
            device=state,
            feats_cache=np.zeros((l + r, self.input_size), np.float32),
            pending=np.zeros((0, self.input_size), np.float32))

    def generate_chunk(self, cache: StreamCache, samples: np.ndarray,
                       is_final: bool = False) -> List[int]:
        """Feed waveform samples; returns newly decoded token ids."""
        l, c, r = self.chunk_size
        feats, cache.frontend = self.frontend.step(cache.frontend, samples, is_final)
        if len(feats):
            cache.pending = np.concatenate([cache.pending, feats], axis=0)

        new_tokens: List[int] = []
        while len(cache.pending) >= c:
            chunk, cache.pending = cache.pending[:c], cache.pending[c:]
            new_tokens += self._run_window(cache, chunk, final=False)
        if is_final and len(cache.pending) > 0:
            # pad the tail chunk with zeros to the fixed width; the pad
            # frames are masked out through win_valid (the reference's final
            # window is shorter instead)
            n_real = len(cache.pending)
            pad = np.zeros((c - n_real, self.input_size), np.float32)
            chunk = np.concatenate([cache.pending, pad], axis=0)
            cache.pending = cache.pending[:0]
            new_tokens += self._run_window(cache, chunk, final=True, n_real=n_real)
        elif is_final:
            # still flush the lookahead region with an empty final chunk
            # (reference tail_chunk: the window is just the cached overlap)
            chunk = np.zeros((c, self.input_size), np.float32)
            new_tokens += self._run_window(cache, chunk, final=True, n_real=0)
        cache.tokens += new_tokens
        return new_tokens

    def _run_window(self, cache: StreamCache, chunk: np.ndarray, final: bool,
                    n_real: Optional[int] = None) -> List[int]:
        l, c, r = self.chunk_size
        window = np.concatenate([cache.feats_cache, chunk], axis=0)
        cache.feats_cache = window[-(l + r):] if (l + r) else window[:0]
        win_valid = l + r + (c if n_real is None else n_real)
        out, _, cache.device = self._step(
            window, cache.device, self.tail_threshold if final else 0.0, win_valid)
        row = fetched(*out)[0][0].tolist()
        return [t for t in row[1:1 + row[0]] if t != self.blank_id]

    # ------------------------------------------------------------ inference
    def inference(self, waveform: np.ndarray, chunk_ms: int = 600,
                  tokenizer=None) -> Dict[str, Any]:
        """Convenience: run the whole stream chunk by chunk."""
        cache = self.init_cache()
        stride = int(16000 * chunk_ms / 1000)
        n = (len(waveform) + stride - 1) // stride
        for i in range(n):
            part = waveform[i * stride: (i + 1) * stride]
            self.generate_chunk(cache, part, is_final=(i == n - 1))
        ids = cache.tokens
        out = {"token_ids": ids}
        if tokenizer is not None:
            out["text"] = tokenizer.decode(ids)
        return out
