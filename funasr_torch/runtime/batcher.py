"""Cross-request dynamic batching for serving (port of
funasr_tpu/runtime/batcher.py, pure Python, kept as its own copy).

The reference C++ runtime gets its throughput from concurrency around a
shared model: the websocket servers run a decoder thread pool over many
connections (runtime/websocket/bin/websocket-server.cpp:70 two io_context
pools; runtime/docs/benchmark_libtorch_cpp.md:24-31 shows the A10 pipeline
hitting RTF 0.0008 only at 10-20 concurrent tasks x batch 20), and the
Triton deployment (runtime/triton_gpu/) leans on Triton's dynamic batcher.

Here concurrent requests are coalesced into one ``transcribe``/``generate``
call, so the device runs one batch where it would run many small ones; the
batcher gathers the wavs, makes ONE call and scatters the results back to
the waiters.

Design: a plain worker thread + condition variable (the device work is
driven from host Python either way; asyncio servers hop through
``asubmit``).  Requests carrying different keyword arguments (timestamps
on/off, language, itn) are grouped so each device batch is homogeneous.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["DynamicBatcher", "BatchingAutoModel"]


def _group_key(kwargs: Dict[str, Any]) -> Tuple:
    """Hashable signature of a request's decode options."""
    return tuple(sorted((k, repr(v)) for k, v in kwargs.items()))


class _Request:
    __slots__ = ("item", "kwargs", "key", "future", "t_enq")

    def __init__(self, item, kwargs: Dict[str, Any]):
        self.item = item
        self.kwargs = kwargs
        self.key = _group_key(kwargs)
        self.future: Future = Future()
        self.t_enq = time.monotonic()


class DynamicBatcher:
    """Coalesce concurrent single-utterance requests into device batches.

    Parameters
    ----------
    transcribe:
        ``transcribe(items: list, **kwargs) -> list`` — one result per item,
        order-preserving (any engine ``transcribe`` or a ``generate``
        wrapper qualifies).
    max_batch:
        Hard cap per device batch (matches the serving bucket sizes).
    max_wait_ms:
        How long the first request in a batch may wait for company.  The
        tradeoff is the classic one: ~10 ms of added p50 latency buys
        near-linear throughput up to ``max_batch`` concurrent streams.
    """

    def __init__(self, transcribe: Callable[..., List],
                 max_batch: int = 32, max_wait_ms: float = 10.0):
        self._transcribe = transcribe
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._lock = threading.Condition()
        self._queue: List[_Request] = []
        self._closed = False
        self.batch_sizes: List[int] = []  # observability: per-batch sizes
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="funasr-torch-batcher")
        self._worker.start()

    # ------------------------------------------------------------- submit
    def submit(self, item, **kwargs) -> Future:
        """Enqueue one utterance; resolve to its single result dict."""
        req = _Request(item, kwargs)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.append(req)
            self._lock.notify()
        return req.future

    async def asubmit(self, item, **kwargs):
        """Awaitable submit for asyncio servers."""
        import asyncio

        return await asyncio.wrap_future(self.submit(item, **kwargs))

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker
    def _take_batch(self) -> Optional[List[_Request]]:
        """Block until a homogeneous batch is ready (or closed -> None)."""
        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait()
            if not self._queue:
                return None  # closed and drained
            # Group under the oldest request's option signature.
            head = self._queue[0]
            deadline = head.t_enq + self.max_wait_s

            def matching() -> List[_Request]:
                return [r for r in self._queue if r.key == head.key]

            while (len(matching()) < self.max_batch and not self._closed
                   and (left := deadline - time.monotonic()) > 0):
                self._lock.wait(timeout=left)
            batch = matching()[: self.max_batch]
            taken = set(map(id, batch))
            self._queue = [r for r in self._queue if id(r) not in taken]
            return batch

    def _run(self):
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            items = [r.item for r in batch]
            self.batch_sizes.append(len(batch))
            try:
                results = self._transcribe(items, **batch[0].kwargs)
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"transcribe returned {len(results)} results for "
                        f"{len(batch)} items")
            except Exception as e:  # propagate to every waiter
                for r in batch:
                    if not r.future.cancelled():
                        r.future.set_exception(e)
                continue
            for r, res in zip(batch, results):
                if not r.future.cancelled():
                    r.future.set_result(res)


class BatchingAutoModel:
    """``AutoModel.generate``-shaped facade over a :class:`DynamicBatcher`.

    Servers call ``generate(wav, key=[name])`` per connection exactly as
    they would on a bare AutoModel (websocket_server.py ``_decode_offline``);
    concurrent calls coalesce into one device batch.  The long-audio VAD
    pipeline path batches *segments* internally already, so batching is at
    the utterance level here, mirroring how the reference's server hands
    whole utterances to its decoder pool.
    """

    def __init__(self, auto_model, max_batch: int = 32,
                 max_wait_ms: float = 10.0):
        self.auto_model = auto_model
        self.engine = getattr(auto_model, "engine", None)

        def _run(wavs: Sequence, **kwargs) -> List[Dict]:
            return self.auto_model.generate(
                list(wavs), batch_size=len(wavs), **kwargs)

        self.batcher = DynamicBatcher(_run, max_batch=max_batch,
                                      max_wait_ms=max_wait_ms)

    def generate(self, input, key: Optional[List[str]] = None, **kwargs):
        items = input if isinstance(input, (list, tuple)) else [input]
        futs = [self.batcher.submit(x, **kwargs) for x in items]
        out = []
        for i, f in enumerate(futs):
            r = f.result() or {"text": ""}
            if key is not None and i < len(key):
                r["key"] = key[i]
            out.append(r)
        return out

    def close(self):
        self.batcher.close()
