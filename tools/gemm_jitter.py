#!/usr/bin/env python3
"""Spread of ``chip_smoke.py``'s int8 GEMM speed bar, on one NVIDIA GPU.

    python3 tools/gemm_jitter.py [--runs N] [--windows W] [--host]

``chip_smoke.py`` holds each served int8 GEMM shape to ``LIB_BAR`` x
``torch._int_mm`` by one CUDA-event window of 10 back-to-back calls each
(``cuda_ms``).  At the small shapes both calls take about as long on the
host as on the card, so the window also reads the host.  This script:

1. runs ``chip_smoke.py``'s own ``check_int8_gemm`` ``--runs`` times in
   this process and counts the runs whose bar failed, and at which shape;
2. then, at every served shape, takes ``--windows`` pairs of windows as
   ``cuda_ms`` takes them (the kernel's, then ``_int_mm``'s), and records
   for each window its event time, the host's time to issue its calls and
   the Python garbage collections that ran inside it (``gc.callbacks``);
   half the pairs with the collector on, half with it off;
3. times each call by CUDA graph (``graph_ms``: the card alone) and the
   host's time a call (300 calls back to back);
4. with ``--host``, only this: the host's time a call of the wrapper and of
   its parts at the RWKV decoder's w_2 shape: the Python before the C
   entry (the entry replaced by a stub), the C entry alone (the launch)
   and ``torch._int_mm``.

Prints one JSON object a shape and, last, a summary.  Helpers and shapes
come from ``chip_smoke.py`` beside this directory.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """``chip_smoke.py`` of this checkout as a module (its helpers)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class GcLog:
    """Start times and generations of the collections since ``mark``."""

    def __init__(self):
        self.events, self._t = [], 0.0
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        now = time.perf_counter()
        if phase == "start":
            self._t = now
        else:
            self.events.append((self._t, now, info["generation"]))

    def mark(self):
        self.events.clear()


def window(torch, fn, gclog, iters=10, warmup=2):
    """``chip_smoke.cuda_ms``'s window, with the host's issue time and the
    collections inside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    gclog.mark()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    gcs = [(round((b - a) * 1e3, 4), g) for a, b, g in gclog.events]
    return start.elapsed_time(end) / iters, host, gcs


def host_ms(torch, fn, calls=300):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return out


def host_parts(torch, S, G, cuda_build) -> dict:
    """The host's time a call (ms) of the int8 GEMM wrapper and its parts."""
    M, K, N, _ = next(s for s in S.GEMM_SHAPES if s[3] == "RWKV decoder's fused FFN w_2")
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
    sa = torch.rand(M, generator=gen, device="cuda") * 0.01
    sb = torch.rand(N, generator=gen, device="cuda") * 0.01
    bias = torch.randn(N, generator=gen, device="cuda")
    bt = b.t()
    out = {"shape": f"({M}, {K}, {N})"}
    wrapper = lambda: G.int8_gemm(a, sa, b, sb, bias=bias)
    out["wrapper"] = [host_ms(torch, wrapper) for _ in range(5)]
    out["torch._int_mm"] = [host_ms(torch, lambda: torch._int_mm(a, bt)) for _ in range(5)]
    calls = []
    stub = lambda packed: calls.append(packed) or 0
    # checkouts before the lean wrapper bind the entry on every call
    real_function, real_forward = cuda_build.function, getattr(G, "_FORWARD", None)
    fn = real_function("int8_gemm", "int8_gemm_forward", G._ARGTYPES)
    cuda_build.function = lambda *args: stub
    if real_forward is not None:
        G._FORWARD = stub
    try:
        out["python before the C entry"] = [host_ms(torch, wrapper) for _ in range(5)]
    finally:
        cuda_build.function = real_function
        if real_forward is not None:
            G._FORWARD = real_forward
    keep = a.new_empty((M, N))  # the C entry alone writes here
    args = list(G.struct.unpack("23q", calls[-1]))
    args[15] = keep.data_ptr()
    packed = G._PACK(*args)
    out["C entry alone"] = [host_ms(torch, lambda: fn(packed)) for _ in range(5)]

    def spin(us=15.0):
        end = time.perf_counter() + us * 1e-6
        while time.perf_counter() < end:
            pass

    # the card idles between launches here, as it does behind the wrapper
    out["spin 15 us"] = [host_ms(torch, spin) for _ in range(3)]
    out["spin 15 us + C entry"] = [host_ms(torch, lambda: (spin(), fn(packed)))
                                   for _ in range(3)]
    out["spin 15 us + _int_mm"] = [host_ms(torch, lambda: (spin(), torch._int_mm(a, bt)))
                                   for _ in range(3)]
    out["refuse_autograd"] = [host_ms(torch, lambda: cuda_build.refuse_autograd(
        "int8_gemm", a, sa, b, sb, bias, None, None)) for _ in range(3)]
    out["check_args"] = [host_ms(torch, lambda: G.check_args(a, sa, b, sb, bias))
                         for _ in range(3)]
    out["new_empty"] = [host_ms(torch, lambda: a.new_empty((M, N))) for _ in range(3)]
    o = a.new_empty((M, N))
    out["slice"] = [host_ms(torch, lambda: o[:, :N]) for _ in range(3)]
    out["stream"] = [host_ms(torch, lambda: G.stream(0)) for _ in range(3)]
    out["graph_ms wrapper"] = S.graph_ms(wrapper)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args(argv)

    import torch

    S = smoke()
    sys.path.insert(0, ROOT)
    from funasr_torch.ops import cuda_build
    from funasr_torch.ops import int8_gemm as G

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    cuda_build.build(["int8_gemm"])
    torch.set_grad_enabled(False)
    if args.host:
        print(json.dumps(host_parts(torch, S, G, cuda_build)), flush=True)
        return 0
    gclog = GcLog()

    failed = []
    for run in range(args.runs):
        try:
            S.check_int8_gemm(torch, G)
        except RuntimeError as exc:
            failed.append((run, str(exc)))
    print(json.dumps({"check_int8_gemm runs": args.runs, "failed": failed}), flush=True)

    summary = []
    gen = torch.Generator(device="cuda").manual_seed(1)
    for M, K, N, where in S.GEMM_SHAPES:
        if where.startswith("edge") or not (K % 8 == 0 and N % 8 == 0):
            continue
        a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
        b = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
        sa = torch.rand(M, generator=gen, device="cuda") * 0.01
        sb = torch.rand(N, generator=gen, device="cuda") * 0.01
        bias = torch.randn(N, generator=gen, device="cuda")
        fns = {"kernel": lambda: G.int8_gemm(a, sa, b, sb, bias=bias),
               "lib": lambda: torch._int_mm(a, b.t())}
        rec = {"shape": f"{where} ({M}, {K}, {N})"}
        for collector in ("gc on", "gc off"):
            (gc.enable if collector == "gc on" else gc.disable)()
            pairs = []
            for _ in range(args.windows // 2):
                pairs.append({k: window(torch, fn, gclog) for k, fn in fns.items()})
            gc.enable()
            ms = [p["kernel"][0] for p in pairs]
            lib = [p["lib"][0] for p in pairs]
            over = [i for i, p in enumerate(pairs)
                    if p["kernel"][0] > S.LIB_BAR * p["lib"][0]]
            rec[collector] = {
                "kernel event_ms min/median/max": [min(ms), statistics.median(ms), max(ms)],
                "lib event_ms min/median/max": [min(lib), statistics.median(lib), max(lib)],
                "kernel host_ms in window median/max": [
                    statistics.median(p["kernel"][1] for p in pairs),
                    max(p["kernel"][1] for p in pairs)],
                "pairs over the bar": len(over),
                "over the bar (kernel ms, host ms, gcs; lib ms)": [
                    (pairs[i]["kernel"][0], pairs[i]["kernel"][1], pairs[i]["kernel"][2],
                     pairs[i]["lib"][0]) for i in over],
                "windows with a collection": sum(bool(p[k][2]) for p in pairs for k in fns),
            }
        rec["kernel graph_ms"] = S.graph_ms(fns["kernel"])
        rec["lib graph_ms"] = S.graph_ms(fns["lib"])
        rec["kernel host_ms a call"] = host_ms(torch, fns["kernel"])
        rec["lib host_ms a call"] = host_ms(torch, fns["lib"])
        print(json.dumps(rec), flush=True)
        summary.append((where, rec["gc on"]["pairs over the bar"],
                        rec["gc off"]["pairs over the bar"], rec["kernel graph_ms"],
                        rec["kernel host_ms a call"], rec["lib host_ms a call"]))
    print("shape | over the bar, gc on | gc off | kernel graph_ms | kernel host_ms | "
          "lib host_ms")
    for row in summary:
        print(" | ".join(str(v) for v in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
