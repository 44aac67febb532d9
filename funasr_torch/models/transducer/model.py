"""Transducer (RNN-T) ASR, inference path (port of
funasr_tpu/models/transducer/model.py; reference funasr/models/transducer/:
``RNNTDecoder`` rnnt_decoder.py:15, ``JointNetwork`` joint_network.py:13).

Encoder (by default the Conformer, ``input_layer`` conv2d; the RWKV
encoder in ``models/rwkv.py`` ``RWKVBAT``) + an LSTM prediction network +
an additive joint, decoded greedily as the JAX ``greedy_decode`` does:

- the prediction network's state starts at zeros and consumes blank before
  the first frame (its output is the first ``g``);
- a loop over every frame of the padded encoder output, with
  ``max_symbols_per_frame`` emit attempts a frame: ``argmax`` of the joint
  (the first maximum), an emit only where the token is not blank, the frame
  is inside ``enc_lens`` and fewer than ``max_tokens`` were emitted; the
  prediction network advanced only where the row emitted.

The loop is fixed-shape tensor code (``torch.where``, no data-dependent
branch), so a batch's decode makes no host sync.  ``lin_enc`` of every frame
is computed once before the loop and ``lin_dec`` once per prediction step;
each row's values are those of the JAX joint on that row.

The LSTM runs in float32 whatever the model's dtype (flax's cell promotes
its bf16 embedding to its float32 parameters), with flax's order: ``(h Whh^T
+ b) + x Wih^T`` a gate (torch gate order i, f, g, o).  The joint runs in
the model's dtype; ``lin_dec`` has no bias.  Under ``quantize=True`` the
Conformer's projections follow the QDense rule (at D = 256 the FFNs' ``w_1``
take int8), while the joint, the LSTM and the embedding stay plain, as the
JAX ``nn.Dense``, ``nn.Embed`` and LSTM cell do.

Parameter names are FunASR's torch names: ``encoder.*``, ``decoder.embed``,
``decoder.rnn.{i}.weight_ih_l0`` (single-layer ``nn.LSTM`` modules, whose
weights the cell reads), ``joint_network.lin_enc``/``lin_dec``/``lin_out``:
the layout ``funasr_tpu/convert.py`` ``transducer_from_torch`` reads.  No
training loss.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from funasr_torch.device import resolve_device
from funasr_torch.models import conformer  # noqa: F401  (registers ConformerEncoder)
from funasr_torch.models.sanm import PlainDense, quantize_dense_layers
from funasr_torch.registry import tables

LstmState = List[Tuple[torch.Tensor, torch.Tensor]]  # (c, h) a layer


class RNNTDecoder(nn.Module):
    """The LSTM prediction network over a (blank-prepended) token history."""

    def __init__(self, vocab_size: int, embed_size: int = 256, hidden_size: int = 256,
                 num_layers: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_size = hidden_size
        self.dtype = dtype
        self.embed = nn.Embedding(vocab_size, embed_size)
        self.rnn = nn.ModuleList([
            nn.LSTM(embed_size if i == 0 else hidden_size, hidden_size, batch_first=True)
            for i in range(num_layers)])

    def init_state(self, batch: int, device=None) -> LstmState:
        z = torch.zeros((batch, self.hidden_size), dtype=torch.float32,
                        device=device or self.embed.weight.device)
        return [(z, z) for _ in self.rnn]

    def _cell(self, lstm: nn.LSTM, state: Tuple[torch.Tensor, torch.Tensor],
              x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        c, h = state
        gates = (F.linear(h, lstm.weight_hh_l0) + (lstm.bias_ih_l0 + lstm.bias_hh_l0)
                 + F.linear(x, lstm.weight_ih_l0))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        # flax's Embed rounds to the compute dtype; the cell computes in float32
        return self.embed.weight[tokens].to(self.dtype).to(torch.float32)

    def step(self, state: LstmState, token: torch.Tensor) -> Tuple[LstmState, torch.Tensor]:
        """One prediction step: (state, (B,) token) -> (state, (B, H) float32)."""
        x = self._embed(token)
        new_state = []
        for lstm, st in zip(self.rnn, state):
            c, x = self._cell(lstm, st, x)
            new_state.append((c, x))
        return new_state, x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, U) token ids -> (B, U, H) float32 prediction states, from the
        zero state."""
        state = self.init_state(tokens.shape[0], tokens.device)
        outs = []
        for u in range(tokens.shape[1]):
            state, g = self.step(state, tokens[:, u])
            outs.append(g)
        return torch.stack(outs, dim=1)


class JointNetwork(nn.Module):
    """``lin_out(tanh(lin_enc(enc) + lin_dec(dec)))`` in the model's dtype,
    ``lin_dec`` without a bias (joint_network.py:13)."""

    def __init__(self, vocab_size: int, encoder_size: int, decoder_size: int,
                 joint_size: int = 256, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.lin_enc = PlainDense(encoder_size, joint_size, **kw)
        self.lin_dec = PlainDense(decoder_size, joint_size, bias=False, **kw)
        self.lin_out = PlainDense(joint_size, vocab_size, **kw)

    def forward(self, enc: torch.Tensor, dec: torch.Tensor) -> torch.Tensor:
        """enc (..., De), dec (..., Dd) broadcastable -> (..., V)."""
        return self.lin_out(torch.tanh(self.lin_enc(enc) + self.lin_dec(dec)))


@tables.register("model_classes", "Transducer")
class Transducer(nn.Module):
    """Encoder + RNNTDecoder + JointNetwork on ``device`` (default: the GPU,
    raising without one; ``"cpu"`` only when asked)."""

    def __init__(self, vocab_size: int, input_size: int = 80,
                 encoder_conf: Optional[Dict[str, Any]] = None,
                 decoder_conf: Optional[Dict[str, Any]] = None,
                 joint_conf: Optional[Dict[str, Any]] = None, blank_id: int = 0,
                 ignore_id: int = -1, max_symbols_per_frame: int = 3,
                 dtype: torch.dtype = torch.float32, device=None, quantize: bool = False):
        """``ignore_id`` is a training setting that inference ignores."""
        super().__init__()
        self.vocab_size = vocab_size
        self.blank_id = blank_id
        self.max_symbols_per_frame = max_symbols_per_frame
        self.dtype = dtype
        self.quantize = quantize
        self._int8_ready = False
        param_dtype = torch.float32 if quantize else None
        with torch.device(resolve_device(device)):
            self.encoder = self.make_encoder(input_size, encoder_conf, dtype, param_dtype)
            self.decoder = RNNTDecoder(vocab_size, dtype=dtype, **dict(decoder_conf or {}))
            self.joint_network = JointNetwork(
                vocab_size, self.encoder.output_size(), self.decoder.hidden_size,
                dtype=dtype, param_dtype=param_dtype, **dict(joint_conf or {}))
        self.eval()
        self.register_load_state_dict_post_hook(Transducer._weights_changed)

    def make_encoder(self, input_size: int, encoder_conf: Optional[Dict[str, Any]],
                     dtype: torch.dtype, param_dtype: Optional[torch.dtype]) -> nn.Module:
        """The Conformer encoder, ``input_layer`` conv2d unless the config
        says otherwise (the RWKV-BAT subclass swaps in its encoder)."""
        conf = dict(encoder_conf or {})
        conf.setdefault("input_layer", "conv2d")
        return tables.get("encoder_classes", "ConformerEncoder")(
            input_size=input_size, dtype=dtype, param_dtype=param_dtype, **conf)

    @staticmethod
    def _weights_changed(module, incompatible_keys) -> None:
        module._int8_ready = False

    @torch.no_grad()
    def quantize_weights(self) -> "Transducer":
        """Build the int8 weights of the encoder's QDense projections from the
        current float32 parameters, once per model load (a ``quantize=True``
        model only)."""
        if not self.quantize:
            raise RuntimeError("quantize_weights() needs quantize=True")
        quantize_dense_layers(self)
        self._int8_ready = True
        return self

    def encode(self, speech: torch.Tensor, speech_lengths: torch.Tensor):
        if self.quantize and not self._int8_ready:
            raise RuntimeError(f"{type(self).__name__}(quantize=True): call "
                               "quantize_weights() after loading the weights")
        return self.encoder(speech, speech_lengths)

    def _blank_prefixed(self, tokens: torch.Tensor) -> torch.Tensor:
        blank = torch.full((tokens.shape[0], 1), self.blank_id, dtype=tokens.dtype,
                           device=tokens.device)
        return torch.cat([blank, tokens], dim=1)

    @torch.inference_mode()
    def logits_grid(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                    tokens: torch.Tensor):
        """The full (B, T, U + 1, V) joint grid over [blank] + tokens, and the
        encoder lengths (the tensor the RNN-T loss consumes)."""
        enc, enc_lens = self.encode(speech, speech_lengths)
        dec = self.decoder(self._blank_prefixed(tokens.to(torch.int64)))
        return self.joint_network(enc[:, :, None, :], dec[:, None, :, :]), enc_lens

    @torch.inference_mode()
    def greedy_decode(self, speech: torch.Tensor, speech_lengths: torch.Tensor,
                      max_tokens: int = 128, forced: Optional[torch.Tensor] = None,
                      return_decisions: bool = False):
        """Greedy decode -> (tokens (B, max_tokens) int64, zero past each
        row's count; counts (B,) int64), on the device, no host sync.

        ``forced`` (B, T, S) feeds the loop those decisions (frame t, attempt
        s) in place of its own argmaxes (teacher forcing, to hold two decodes
        to each other); ``return_decisions`` adds the argmaxes (B, T, S) and
        which attempts could emit (frame valid, cap not reached)."""
        enc, enc_lens = self.encode(speech, speech_lengths)
        B, T, _ = enc.shape
        S, dev = self.max_symbols_per_frame, enc.device
        jn, dec = self.joint_network, self.decoder
        state, g = dec.step(dec.init_state(B, dev),
                            torch.full((B,), self.blank_id, dtype=torch.int64, device=dev))
        enc_proj = jn.lin_enc(enc)  # (B, T, J)
        dec_proj = jn.lin_dec(g)
        valid = torch.arange(T, device=dev)[None, :] < enc_lens[:, None]  # (B, T)
        out = torch.zeros((B, max_tokens), dtype=torch.int64, device=dev)
        count = torch.zeros((B,), dtype=torch.int64, device=dev)
        picks, live = [], []
        for t in range(T):
            e_t, valid_t = enc_proj[:, t], valid[:, t]
            for s in range(S):
                tok = jn.lin_out(torch.tanh(e_t + dec_proj)).argmax(dim=-1)
                alive = valid_t & (count < max_tokens)
                if return_decisions:
                    picks.append(tok)
                    live.append(alive)
                if forced is not None:
                    tok = forced[:, t, s]
                emit = (tok != self.blank_id) & alive
                idx = count.clamp(max=max_tokens - 1)[:, None]
                out.scatter_(1, idx, torch.where(emit, tok, out.gather(1, idx)[:, 0])[:, None])
                count = count + emit
                new_state, new_g = dec.step(state, tok)
                keep = emit[:, None]
                state = [(torch.where(keep, nc, c), torch.where(keep, nh, h))
                         for (nc, nh), (c, h) in zip(new_state, state)]
                dec_proj = torch.where(keep, jn.lin_dec(new_g), dec_proj)
        if return_decisions:
            return (out, count, torch.stack(picks, 1).view(B, T, S),
                    torch.stack(live, 1).view(B, T, S))
        return out, count
