"""The port's serving runtime (``funasr_torch/runtime/``) on the CPU.

- The WebSocket server's protocol, driven through ``on_text``/``on_binary``
  (what ``handle`` calls for each message; no socket, no ``websockets``):
  the port's server and the JAX package's, each over its ``AutoModel`` on
  ``tests/test_websocket.py``'s ``ASR_CFG`` and a streaming model, every
  model on the same weights (jitted JAX inits; the port's through
  ``convert.paraformer_from_jax``), answer the same message sequences in
  ``offline``, ``online`` and ``2pass`` modes, one at 8 kHz (the server's
  ``resample_linear``), with the same JSON strings, message for message.
- ``DynamicBatcher``/``BatchingAutoModel``: the cases of
  ``tests/test_batcher.py`` against the port's copy.
"""

import json
import threading
import time
from concurrent.futures import wait

import numpy as np
import pytest

from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_tpu.runtime.websocket_server import AsrWebSocketServer as JaxServer
from funasr_torch import convert as C
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.runtime.batcher import BatchingAutoModel, DynamicBatcher
from funasr_torch.runtime.websocket_server import AsrWebSocketServer, WsSession
from tests.test_torch_pipeline import _save, _save_flax
from tests.test_torch_streaming import TINY, _streaming_pair, jax_paraformer_params
from tests.test_websocket import ASR_CFG, VOCAB
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX server, the port's) over AutoModels and streaming models that
    share their weights."""
    tmp = tmp_path_factory.mktemp("ws")
    conf = {k: ASR_CFG[k] for k in ("vocab_size", "input_size", "encoder_conf",
                                    "decoder_conf", "predictor_conf")}
    asr = jax_paraformer_params(conf, seed=3)
    jam = JaxAutoModel(model=dict(ASR_CFG, init_param=_save_flax(tmp / "j.npz",
                                                                  asr["params"])))
    pam = AutoModel(model=dict(ASR_CFG, init_param=_save(tmp / "p.npz",
                                                         C.paraformer_from_jax(asr))),
                    device="cpu")
    _, jsm, psm = _streaming_pair(jax_paraformer_params(dict(TINY, vocab_size=len(VOCAB)),
                                                        seed=4))
    pair = JaxServer(jam, streaming_model=jsm), AsrWebSocketServer(pam, streaming_model=psm)
    yield pair
    for srv in pair:
        srv.decode_model.close()


def pcm16(seconds, fs=16000, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    wav = 0.3 * np.sin(2 * np.pi * 220 * np.arange(n) / fs) + 0.05 * rng.standard_normal(n)
    return (np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes()


def converse(server, session, config, pcm, frame_bytes):
    """The messages of one utterance: config, PCM frames, end -> replies."""
    sess = session(server)
    out = server.on_text(sess, json.dumps(config))
    for i in range(0, len(pcm), frame_bytes):
        out += server.on_binary(sess, pcm[i:i + frame_bytes])
    return out + server.on_text(sess, json.dumps({"is_speaking": False}))


@pytest.mark.parametrize("mode, fs, seconds", [
    ("offline", 16000, 1.3), ("online", 16000, 2.2), ("2pass", 16000, 2.5),
    ("2pass", 8000, 1.9)])
def test_protocol_replies_equal_jax(servers, mode, fs, seconds, monkeypatch):
    """At 8 kHz both servers resample with the port's linear resampler: the
    JAX package takes its native windowed-sinc one where that library is
    built (the port does not carry it) and otherwise the linear one, which
    the port's equals here on the same PCM (the JAX one raises on the final
    flush's empty input, the port's returns no samples)."""
    from funasr_tpu.runtime.websocket_server import WsSession as JaxSession
    from funasr_tpu.utils import audio as JA
    from funasr_torch.utils import audio as PA

    jsrv, psrv = servers
    if fs != 16000:
        x = np.frombuffer(pcm16(seconds, fs, seed=fs), "<i2").astype(np.float32) / 32768.0
        with monkeypatch.context() as m:
            m.setattr(JA, "_native", lambda: None)
            np.testing.assert_array_equal(PA.resample_linear(x, fs, 16000),
                                          JA.resample_linear(x, fs, 16000))
        assert PA.resample_linear(x[:0], fs, 16000).shape == (0,)
        monkeypatch.setattr(JA, "resample_linear", PA.resample_linear)
    config = {"mode": mode, "wav_name": f"{mode}{fs}", "is_speaking": True,
              "wav_format": "pcm", "audio_fs": fs, "chunk_size": [5, 10, 5]}
    pcm = pcm16(seconds, fs, seed=fs)
    frame = 2 * fs * 600 // 1000  # 600 ms of PCM16
    want = converse(jsrv, JaxSession, config, pcm, frame)
    got = converse(psrv, WsSession, config, pcm, frame)
    assert got == want
    msgs = [json.loads(m) for m in got]
    assert msgs and msgs[-1]["is_final"] is True
    if mode == "2pass":
        assert [m["mode"] for m in msgs].count("2pass-offline") == 1
        assert any(m["mode"] == "2pass-online" and m["is_final"] is False for m in msgs)
    if mode == "online":
        assert all(m["mode"] == "online" for m in msgs) and len(msgs) > 1


def test_session_restarts_after_utterance_end(servers):
    """After ``is_speaking: false`` the stream cache starts over, so a second
    utterance on the same session gives the first one's replies."""
    _, psrv = servers
    sess = WsSession(psrv)
    config = json.dumps({"mode": "2pass", "wav_name": "again", "audio_fs": 16000})
    pcm = pcm16(1.5)
    replies = []
    for _ in range(2):
        out = psrv.on_text(sess, config)
        for i in range(0, len(pcm), 19200):
            out += psrv.on_binary(sess, pcm[i:i + 19200])
        replies.append(out + psrv.on_text(sess, json.dumps({"is_speaking": False})))
    assert replies[0] == replies[1] and sess.buffer == bytearray()


# ----------------------------------------------------- the batcher (port copy)
def slow_upper(items, **kwargs):
    time.sleep(0.02)  # a device batch: the same cost for 1 or N items
    return [str(x).upper() + kwargs.get("suffix", "") for x in items]


def test_batcher_coalesces_concurrent_requests():
    with DynamicBatcher(slow_upper, max_batch=16, max_wait_ms=30) as b:
        futs = [b.submit(f"req{i}") for i in range(16)]
        wait(futs, timeout=10)
        assert [f.result() for f in futs] == [f"REQ{i}" for i in range(16)]
    assert max(b.batch_sizes) > 1 and sum(b.batch_sizes) == 16


def test_batcher_order_under_threads():
    results = {}
    with DynamicBatcher(slow_upper, max_batch=8, max_wait_ms=5) as b:
        def client(i):
            results[i] = b.submit(f"x{i}").result(timeout=10)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
        assert not any(th.is_alive() for th in threads)
    assert results == {i: f"X{i}" for i in range(24)}


def test_batcher_groups_options():
    seen = []

    def record(items, **kw):
        seen.append(kw.get("suffix", ""))
        return [str(x) + kw.get("suffix", "") for x in items]

    with DynamicBatcher(record, max_batch=8, max_wait_ms=40) as b:
        fa = [b.submit(i, suffix="!") for i in range(3)]
        fb = [b.submit(i, suffix="?") for i in range(3)]
        assert [f.result(timeout=10) for f in fa] == ["0!", "1!", "2!"]
        assert [f.result(timeout=10) for f in fb] == ["0?", "1?", "2?"]
    assert set(seen) <= {"!", "?"}  # each batch homogeneous


def test_batcher_error_reaches_every_waiter():
    def boom(items, **kw):
        raise ValueError("device on fire")

    with DynamicBatcher(boom, max_batch=4, max_wait_ms=5) as b:
        for f in [b.submit(i) for i in range(4)]:
            with pytest.raises(ValueError, match="device on fire"):
                f.result(timeout=10)
        # the worker survives an erroring batch
        b._transcribe = slow_upper
        assert b.submit("ok").result(timeout=10) == "OK"


def test_batcher_max_batch():
    sizes = []

    def record(items, **kw):
        sizes.append(len(items))
        return list(items)

    with DynamicBatcher(record, max_batch=4, max_wait_ms=50) as b:
        wait([b.submit(i) for i in range(10)], timeout=10)
    assert max(sizes) <= 4 and sum(sizes) == 10


def test_batcher_submit_after_close_raises():
    b = DynamicBatcher(slow_upper, max_batch=4, max_wait_ms=5)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("late")


class _FakeAutoModel:
    """The ``generate()`` contract of the port's AutoModel (one dict a wav)."""

    def __init__(self):
        self.engine = None
        self.batch_sizes = []

    def generate(self, input, batch_size=16, **kw):
        wavs = input if isinstance(input, (list, tuple)) else [input]
        self.batch_sizes.append(len(wavs))
        time.sleep(0.01)
        return [{"text": f"len{len(w)}"} for w in wavs]


def test_batching_auto_model_facade():
    am = _FakeAutoModel()
    bam = BatchingAutoModel(am, max_batch=8, max_wait_ms=30)
    outs = {}
    try:
        def client(i):
            outs[i] = bam.generate(np.zeros(100 + i, np.float32), key=[f"k{i}"])[0]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
    finally:
        bam.close()
    assert outs == {i: {"text": f"len{100 + i}", "key": f"k{i}"} for i in range(8)}
    assert max(am.batch_sizes) > 1


def test_websocket_server_uses_batcher():
    am = _FakeAutoModel()
    srv = AsrWebSocketServer(am, max_batch=8)
    assert isinstance(srv.decode_model, BatchingAutoModel)
    srv.decode_model.close()
    assert AsrWebSocketServer(am, max_batch=1).decode_model is am
