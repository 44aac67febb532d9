"""WebSocket ASR server speaking the reference JSON protocol (port of
funasr_tpu/runtime/websocket_server.py).

Protocol (reference runtime/docs/websocket_protocol.md, served in C++ by
runtime/websocket/bin/websocket-server-2pass.cpp):

client -> server: first a JSON config message
    {"mode": "offline"|"online"|"2pass", "wav_name": ..., "is_speaking":
     true, "chunk_size": [5,10,5], "hotwords": ..., "itn": ..., "audio_fs":
     16000, "wav_format": "pcm"}
then binary PCM16 frames; finally {"is_speaking": false}.

server -> client per result:
    {"mode": "offline"|"online"|"2pass-online"|"2pass-offline",
     "wav_name": ..., "text": ..., "is_final": ...,
     "timestamp": optional}

Messages, modes, field names and flush order are the JAX server's.  The
offline pass (``offline`` and ``2pass-offline``, at the end of the
utterance) is the port's ``AutoModel.generate`` behind a
``BatchingAutoModel``; the online partials come from the port's
``ParaformerStreaming``.  The asyncio loop only moves bytes and host state;
decoding runs in a thread executor so the event loop stays responsive.
``on_text``/``on_binary`` are the transport-agnostic protocol (what
``handle`` calls); ``serve()`` imports ``websockets`` when it is called and
raises ImportError where it is not installed.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict

import numpy as np

log = logging.getLogger(__name__)


class WsSession:
    def __init__(self, server: "AsrWebSocketServer"):
        self.server = server
        self.mode = "offline"
        self.wav_name = "demo"
        self.audio_fs = 16000
        self.itn = True
        self.buffer = bytearray()
        self.stream_cache = None  # streaming model cache (online/2pass)
        self.partial_tokens = []

    def config(self, msg: Dict[str, Any]):
        self.mode = msg.get("mode", self.mode)
        self.wav_name = msg.get("wav_name", self.wav_name)
        self.audio_fs = int(msg.get("audio_fs", self.audio_fs))
        self.itn = bool(msg.get("itn", self.itn))
        if self.mode in ("online", "2pass"):
            if self.server.streaming_model:
                self.stream_cache = self.server.streaming_model.init_cache()
            else:
                # no streaming model loaded: degrade to offline-at-end so
                # protocol-conformant clients still get a final result
                log.warning("mode %r requested but no streaming model is "
                            "loaded; falling back to offline decoding at "
                            "utterance end", self.mode)
                self.mode = "offline"


class AsrWebSocketServer:
    def __init__(self, auto_model, streaming_model=None, host="0.0.0.0",
                 port=10095, max_batch: int = 32, batch_wait_ms: float = 10.0):
        self.auto_model = auto_model  # funasr_torch AutoModel (offline path)
        self.streaming_model = streaming_model  # ParaformerStreaming or None
        self.host = host
        self.port = port
        # Cross-connection dynamic batching: concurrent offline decodes
        # coalesce into one padded device batch (runtime/batcher.py; the
        # reference server's decoder thread pool / Triton dynamic batching).
        if max_batch and max_batch > 1:
            from funasr_torch.runtime.batcher import BatchingAutoModel

            self.decode_model = BatchingAutoModel(
                auto_model, max_batch=max_batch, max_wait_ms=batch_wait_ms)
        else:
            self.decode_model = auto_model

    # ------------------------------------------------------------- decoding
    def _pcm_to_wave(self, pcm: bytes, fs: int) -> np.ndarray:
        wav = np.frombuffer(bytes(pcm), dtype="<i2").astype(np.float32) / 32768.0
        if fs != 16000:
            from funasr_torch.utils.audio import resample_linear

            wav = resample_linear(wav, fs, 16000)
        return wav

    def _decode_offline(self, sess: WsSession) -> Dict[str, Any]:
        wav = self._pcm_to_wave(bytes(sess.buffer), sess.audio_fs)
        if len(wav) < 400:
            return {"text": ""}
        res = self.decode_model.generate(wav, key=[sess.wav_name])
        return res[0] if res else {"text": ""}

    def _decode_online_chunk(self, sess: WsSession, pcm: bytes,
                             is_final: bool) -> str:
        wav = self._pcm_to_wave(pcm, sess.audio_fs)
        toks = self.server_tokens_to_text(
            self.streaming_model.generate_chunk(
                sess.stream_cache, wav, is_final=is_final
            )
        )
        return toks

    def server_tokens_to_text(self, token_ids) -> str:
        tok = getattr(self.auto_model.engine, "tokenizer", None)
        if tok is None:
            return " ".join(map(str, token_ids))
        return tok.decode(token_ids)

    # ------------------------------------------- transport-agnostic protocol
    def on_binary(self, sess: WsSession, payload: bytes) -> list:
        """One binary PCM frame -> JSON response strings to send."""
        if sess.mode != "online":
            # the PCM buffer feeds the offline pass only; pure online
            # streams would otherwise grow it without bound (~115 MB/h)
            sess.buffer.extend(payload)
        out = []
        if sess.mode in ("online", "2pass") and sess.stream_cache is not None:
            text = self._decode_online_chunk(sess, bytes(payload), False)
            if text:
                out.append(json.dumps({
                    "mode": "2pass-online" if sess.mode == "2pass"
                            else "online",
                    "wav_name": sess.wav_name,
                    "text": text,
                    "is_final": False,
                }, ensure_ascii=False))
        return out

    def on_text(self, sess: WsSession, message: str) -> list:
        """One JSON control message -> JSON response strings to send."""
        msg = json.loads(message)
        out = []
        if "mode" in msg or "wav_name" in msg or "audio_fs" in msg:
            sess.config(msg)
        if msg.get("is_speaking") is False:
            # utterance end: flush online, run offline pass
            if sess.mode in ("online", "2pass") and sess.stream_cache is not None:
                text = self._decode_online_chunk(sess, b"", True)
                # pure online: the is_final message must go out even with
                # empty text, else protocol clients wait forever
                if text or sess.mode == "online":
                    out.append(json.dumps({
                        "mode": "2pass-online" if sess.mode == "2pass"
                                else "online",
                        "wav_name": sess.wav_name,
                        "text": text, "is_final": sess.mode == "online",
                    }, ensure_ascii=False))
            if sess.mode in ("offline", "2pass"):
                result = self._decode_offline(sess)
                resp = {
                    "mode": "2pass-offline" if sess.mode == "2pass"
                            else "offline",
                    "wav_name": sess.wav_name,
                    "text": result.get("text", ""),
                    "is_final": True,
                }
                if "timestamp" in result:
                    resp["timestamp"] = result["timestamp"]
                if "sentence_info" in result:
                    resp["stamp_sents"] = result["sentence_info"]
                out.append(json.dumps(resp, ensure_ascii=False, default=str))
            sess.buffer = bytearray()
            if sess.mode in ("online", "2pass") and self.streaming_model:
                sess.stream_cache = self.streaming_model.init_cache()
        return out

    # ------------------------------------------------------------- handler
    async def handle(self, websocket):
        sess = WsSession(self)
        loop = asyncio.get_running_loop()
        try:
            async for message in websocket:
                if isinstance(message, (bytes, bytearray)):
                    responses = await loop.run_in_executor(
                        None, self.on_binary, sess, bytes(message))
                else:
                    responses = await loop.run_in_executor(
                        None, self.on_text, sess, message)
                for r in responses:
                    await websocket.send(r)
        except Exception:  # pragma: no cover - connection teardown
            log.exception("websocket session error")

    def warmup(self, seconds=(15, 30, 60), batch_sizes=(1,)):
        """Touch every path a live connection can take before listening.

        The reference C++ server finishes all model/session initialization
        before listening (funasr-wss-server.cpp); here the first call builds
        the CUDA kernels and the libraries' handles.  Runs each (batch,
        seconds) offline bucket, and — when a streaming model is attached —
        the online chunk step and its final flush (the two steps a 2pass
        session runs).
        """
        log.info("warming offline buckets: %s s x batch %s",
                 seconds, batch_sizes)
        self.auto_model.warmup(batch_sizes=batch_sizes, seconds=seconds)
        if self.streaming_model is not None:
            log.info("warming streaming chunk programs")
            sm = self.streaming_model
            cache = sm.init_cache()
            fs = getattr(getattr(sm, "frontend", None), "fs", 16000)
            chunk = np.zeros(int(0.6 * fs), np.float32)
            sm.generate_chunk(cache, chunk, is_final=False)
            sm.generate_chunk(cache, chunk, is_final=False)
            # a shorter tail runs the padded final chunk
            sm.generate_chunk(cache, chunk[: int(0.3 * fs)], is_final=True)
        log.info("warmup done")

    async def serve(self):
        import websockets

        async with websockets.serve(self.handle, self.host, self.port,
                                    max_size=None):
            log.info("ASR websocket server on ws://%s:%d", self.host, self.port)
            await asyncio.Future()

    def run(self, warmup_seconds=None):
        if warmup_seconds:
            self.warmup(seconds=warmup_seconds)
        asyncio.run(self.serve())


def build_streaming_model(cfg: Dict[str, Any], device=None):
    """ParaformerStreaming from a reference-shaped config.yaml (model:
    ParaformerStreaming + encoder/decoder confs + init_param weights, a
    FunASR-named state dict as ``AutoModel`` loads it); ``device=None``
    means the card."""
    from funasr_torch.auto.auto_model import _load_state
    from funasr_torch.frontends.streaming import StreamingFrontend
    from funasr_torch.models.paraformer_streaming.model import (
        ParaformerStreaming,
    )
    from funasr_torch.ops.fbank import load_cmvn_file

    enc = cfg.get("encoder_conf") or {}
    dec = cfg.get("decoder_conf") or {}
    state = _load_state(cfg)
    if state is None:
        raise ValueError(
            "streaming model config needs init_param (converted weights)")
    fe_conf = dict(cfg.get("frontend_conf") or {})
    cmvn_file = fe_conf.pop("cmvn_file", None) or cfg.get("cmvn_file")
    cmvn = load_cmvn_file(cmvn_file) if cmvn_file else None
    fe = StreamingFrontend(cmvn=cmvn, device=device, **fe_conf)
    return ParaformerStreaming(
        state,
        input_size=cfg.get("input_size",
                           fe.n_mels * fe.lfr_m),
        d_model=enc.get("output_size", 512),
        n_head=enc.get("attention_heads", 4),
        enc_kernel=enc.get("kernel_size", 11),
        dec_kernel=dec.get("kernel_size", 11),
        n_enc_layers=enc.get("num_blocks", 50),
        n_dec_layers=dec.get("num_blocks", 16),
        chunk_size=tuple(cfg.get("chunk_size", (0, 10, 5))),
        encoder_chunk_look_back=cfg.get("encoder_chunk_look_back", 4),
        frontend=fe,
        device=device,
    )


def main(argv=None):  # CLI: python -m funasr_torch.runtime.websocket_server
    import argparse

    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.config import load_config

    ap = argparse.ArgumentParser(prog="funasr-torch-server")
    ap.add_argument("--model", required=True)
    ap.add_argument("--vad-model", default=None)
    ap.add_argument("--punc-model", default=None)
    ap.add_argument("--streaming-model", default=None,
                    help="ParaformerStreaming config.yaml for online/2pass "
                         "modes (online falls back to offline without it)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=10095)
    ap.add_argument("--warmup-seconds", type=int, nargs="*", default=[15],
                    help="offline bucket lengths (s) to pre-compile before "
                         "accepting connections; empty disables")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    am = AutoModel(
        model=args.model,
        vad_model=args.vad_model,
        punc_model=args.punc_model,
    )
    streaming = (build_streaming_model(load_config(args.streaming_model))
                 if args.streaming_model else None)
    AsrWebSocketServer(am, streaming_model=streaming,
                       host=args.host, port=args.port).run(
        warmup_seconds=tuple(args.warmup_seconds))


if __name__ == "__main__":
    main()
