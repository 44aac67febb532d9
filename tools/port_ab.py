#!/usr/bin/env python3
"""A/B of the PyTorch/CUDA port between checkouts, on one NVIDIA GPU.

    python3 tools/port_ab.py [--only ffn|gemm|attn] LABEL=DIR [LABEL=DIR ...]

Runs one process per argument, in the order given (for two checkouts:
parent, change, change, parent), each importing ``funasr_torch`` from its
DIR and building that checkout's kernels there.  Every process times the
same seeded inputs, so the numbers of two checkouts compare within one
call on one card:

- B=64 x 15 s batches (half the rows cut to 12 s, 128 tokens: the program
  of ``bench.py``), CUDA events around 5 back-to-back batches after 2
  warm-ups, three times: Paraformer-large bf16 (``ParaformerEngine.run``;
  it runs no int8 kernel, so it reads the host's speed), int8
  (``quantize=True``) and BiCif Paraformer-large int8 with the opt-in
  routes (``BiCifEngine.run_ts``).  These spans include the host;
- the fbank kernel on those batches' waveforms, by CUDA graph;
- the int8 SANM layer, decoder layer (memory quantized once) and FFN at
  ``chip_smoke.py``'s main shapes, by events (host included) and by CUDA
  graph (device time alone, ``graph_ms``);
- the rowquant kernel at the int8 layers' row-quantize shapes and the int8
  GEMM at the FFN's two contractions, by CUDA graph.
- the bf16 and float32 FFN (``ops/ffn.py`` ``fused_ffn``) at (16384, 512)
  -> 2048 -> 512 on ``chip_smoke.py``'s seeded inputs, by CUDA graph;
  ``--only ffn`` times this alone (each process then takes seconds);
- the int8 GEMM at ``chip_smoke.py``'s decoder q/out shape beside
  ``torch._int_mm``: the host's time a call (300 calls back to back),
  ``chip_smoke.py``'s CUDA-event time (the time its speed bar holds, five
  readings) and CUDA graph; ``--only gemm`` times this alone;
- the beam's CTC prefix step (``ops/beam_search.py`` ``ctc_prefix_step``)
  at B=32 x 15 s (K=10, W=16, T=383), by CUDA graph, and the Conformer
  beam's B=32 x 15 s batch (``HybridEngine.run``, as ``chip_smoke.py``
  builds it): CUDA events around each of 5 batches after 2 warm-ups (the
  host's time included), then ``torch.profiler`` over one batch for its
  kernel total, its CTC prefix kernel's time and its kernel launches per
  decode step;
- the float32 attention (``ops/attention.py`` ``fused_attention``) at each
  served shape of its four instances, by events and by CUDA graph, beside
  ``scaled_dot_product_attention`` on the same inputs (with the ALiBi
  shape's (B, H, T, T) float bias): d = 128 at the encoder's (64, 256,
  512) and the decoder's cross-attention, the streaming window step (15
  queries over 55 keys); d = 64 at the 256-wide models' (32, 256, 256) and
  Whisper large-v3's three shapes; d = 32 at punctuation's (54, 208, 256);
  ALiBi at emotion2vec base's (8, 759, 768); at the streaming step also
  the host's time a call (300 calls back to back); ``--only attn`` times
  this alone.

Prints one JSON object per process and, last, a table of the medians.
Helpers and shapes come from ``chip_smoke.py`` beside this directory.
"""

from __future__ import annotations

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


def batch_times(torch, S, run, repeats=3):
    return [S.cuda_ms(run, iters=5) for _ in range(repeats)]


def ffn_times(torch, S, FF) -> dict:
    """The bf16 and float32 FFN at the encoder FFN's shape, by CUDA graph,
    on check_ffn's first inputs of each dtype."""
    M, K, H, N = S.FFN_SHAPES[0]
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for dtype, dn in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        w1 = (torch.randn((H, K), generator=gen, device="cuda") * K ** -0.5).to(dtype)
        w2 = (torch.randn((N, H), generator=gen, device="cuda") * H ** -0.5).to(dtype)
        b1 = 0.1 * torch.randn(H, generator=gen, device="cuda")
        b2 = 0.1 * torch.randn(N, generator=gen, device="cuda")
        out[f"fused_ffn {dn} graph_ms"] = S.graph_ms(lambda: FF.fused_ffn(x, w1, b1, w2, b2))
    return out


def gemm_times(torch, S, G) -> dict:
    """The int8 GEMM (scales and bias, float32 out) and ``torch._int_mm`` at
    the decoder's q/out shape, on check_int8_gemm's inputs of that shape.
    There the wrapper's host time, not the kernel, sets the pace of calls
    made back to back, so the host's time a call is read beside the
    CUDA-event time of ``chip_smoke.py``'s speed bar and the device time."""
    M, K, N, _ = next(s for s in S.GEMM_SHAPES if s[3] == "decoder q, out")
    gen = torch.Generator(device="cuda").manual_seed(1)
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (N, K), generator=gen, device="cuda", dtype=torch.int8)
    sa = torch.rand(M, generator=gen, device="cuda") * 0.01
    sb = torch.rand(N, generator=gen, device="cuda") * 0.01
    bias = torch.randn(N, generator=gen, device="cuda")
    bt = b.t()
    runs = {"int8_gemm": lambda: G.int8_gemm(a, sa, b, sb, bias=bias),
            "torch._int_mm": lambda: torch._int_mm(a, bt)}
    out = {}
    for name, fn in runs.items():
        host = []
        for _ in range(3):
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(300):
                fn()
            host.append((time.perf_counter() - t0) / 300 * 1e3)
            torch.cuda.synchronize()
        out[f"{name} ({M}, {K}) x ({N}, {K}) host_ms"] = host
        out[f"{name} ({M}, {K}) x ({N}, {K}) event_ms"] = [S.cuda_ms(fn) for _ in range(5)]
        out[f"{name} ({M}, {K}) x ({N}, {K}) graph_ms"] = S.graph_ms(fn)
    return out


def attn_times(torch, S, A) -> dict:
    """The float32 attention and SDPA at the served shapes, on seeded
    inputs (k and v column slices of one projection), by events and CUDA
    graph."""
    import torch.nn.functional as F

    from funasr_torch.models.emotion2vec.model import alibi_slopes

    gen = torch.Generator(device="cuda").manual_seed(23)
    out = {}
    # (name, B, U, T, H, d, valid keys a row, ALiBi extra tokens or None)
    e2v = [759, 700, 640, 555, 460, 300, 160, 110]
    for name, B, U, T, H, d, lens, extra in (
            ("d128 encoder self (64, 256, 512)", 64, 256, 256, 4, 128, [250, 200] * 32, None),
            ("d128 decoder cross (64, 128, 512) over 256", 64, 128, 256, 4, 128,
             [250, 200] * 32, None),
            ("d128 streaming step (1, 15, 512) over 55", 1, 15, 55, 4, 128, [55], None),
            ("d64 encoder self (32, 256, 256)", 32, 256, 256, 4, 64, [250, 200] * 16, None),
            ("d64 whisper encoder self (8, 1500, 1280)", 8, 1500, 1500, 20, 64, [1500] * 8, None),
            ("d64 whisper cross (8, 1, 1280) over 1500", 8, 1, 1500, 20, 64, [1500] * 8, None),
            ("d64 whisper cache (8, 1, 1280) over 33 of 65", 8, 1, 65, 20, 64, [33] * 8, None),
            ("d32 punctuation (54, 208, 256)", 54, 208, 208, 8, 32, None, None),
            ("d64 ALiBi emotion2vec (8, 759, 768)", 8, 759, 759, 12, 64, e2v, 10)):
        D = H * d
        qkv = torch.randn((B, T, 3 * D), generator=gen, device="cuda")
        k, v = qkv[..., D:2 * D], qkv[..., 2 * D:]
        q = torch.randn((B, U, D), generator=gen, device="cuda") * d ** -0.5
        n = (torch.randint(1, T + 1, (B,), generator=gen, device="cuda") if lens is None
             else torch.tensor(lens, device="cuda"))
        bias = torch.where(torch.arange(T, device="cuda")[None] < n[:, None], 0.0, -1e30)
        kw, mask = {}, bias[:, None, None, :]
        if extra is not None:
            kw = dict(alibi_slopes=torch.as_tensor(alibi_slopes(H), dtype=torch.float32,
                                                   device="cuda") * 0.8, extra=extra)
            mask = (mask + A.alibi_bias(kw["alibi_slopes"], U, T, extra)[None]).contiguous()
        run = lambda: A.fused_attention(q, k, v, bias, H, **kw)  # noqa: E731
        q4, k4, v4 = (x.unflatten(-1, (H, d)).transpose(1, 2) for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, attn_mask=mask, scale=1.0)
        out[f"attn f32 {name} event_ms"] = [S.cuda_ms(run, iters=20, warmup=5)
                                            for _ in range(3)]
        out[f"attn f32 {name} graph_ms"] = S.graph_ms(run)
        if B == 1:  # the wrapper's host time a call, where the host sets the pace
            host = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(300):
                    run()
                host.append((time.perf_counter() - t0) / 300 * 1e3)
            torch.cuda.synchronize()
            out[f"attn f32 {name} host_ms"] = host
        out[f"attn f32 {name} sdpa event_ms"] = [S.cuda_ms(sdpa, iters=20, warmup=5)
                                                 for _ in range(3)]
        out[f"attn f32 {name} sdpa graph_ms"] = S.graph_ms(sdpa)
        del mask
    return out


def one(label: str, tree: str, only: str = "") -> dict:
    import numpy as np
    import torch

    S = smoke()
    sys.path.insert(0, os.path.abspath(tree))
    from funasr_torch.ops import attention as A
    from funasr_torch.ops import cuda_build
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import int8_gemm as G

    t0 = time.time()
    cuda_build.build({"ffn": ["ffn"], "gemm": ["int8_gemm"],
                      "attn": ["attention"]}.get(only, cuda_build.SOURCES))
    out = {"label": label, "tree": tree, "build_s": time.time() - t0}
    torch.backends.cuda.matmul.allow_tf32 = False
    if only == "attn":
        out.update(attn_times(torch, S, A))
        return out
    if only != "gemm":
        out.update(ffn_times(torch, S, FF))
    if only != "ffn":
        out.update(gemm_times(torch, S, G))
    if only:
        return out

    from funasr_torch.auto.engines import BiCifEngine, FrontendConfig, ParaformerEngine
    from funasr_torch.models.bicif_paraformer.model import BiCifParaformer
    from funasr_torch.models.paraformer.model import Paraformer, init_random_
    from funasr_torch.ops import decoder_layer as DL
    from funasr_torch.ops import fbank_kernel as FK
    from funasr_torch.ops import rowquant as RQ
    from funasr_torch.ops import sanm_layer as SL
    from funasr_torch.ops.masks import key_bias
    from funasr_torch.tokenizer.char_tokenizer import CharTokenizer

    fl = S.FLAGSHIP
    tok = CharTokenizer(["<blank>", "<s>", "</s>"]
                        + [chr(0x4E00 + i) for i in range(fl["vocab_size"] - 4)] + ["<unk>"])
    B, N = 64, 15 * S.FS
    lens = np.full((B,), N, np.int64)
    lens[1::2] = int(N * 0.8)
    base = S.waveform(np.random.default_rng(0), N, 300.0)
    wav = torch.from_numpy(np.stack([base * (np.arange(N) < n) for n in lens])
                           .astype(np.float32)).cuda()
    lens_d = torch.from_numpy(lens.astype(np.int32)).cuda()
    out["fbank graph_ms"] = S.graph_ms(lambda: FK.fused_fbank(wav, lens_d))

    f32 = Paraformer(**fl, dtype=torch.float32)
    init_random_(f32, torch.Generator(device="cuda").manual_seed(2024))
    bf16 = Paraformer(**fl, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict(), strict=True)
    i8 = Paraformer(**fl, dtype=torch.bfloat16, quantize=True)
    i8.load_state_dict(f32.state_dict(), strict=True)
    i8.quantize_weights()
    del f32
    engines = {"bf16": ParaformerEngine(bf16, FrontendConfig(), tok),
               "int8": ParaformerEngine(i8, FrontendConfig(), tok)}
    mt = engines["int8"]._max_tokens(N)
    for name, eng in engines.items():
        out[f"{name}_batch_ms"] = batch_times(torch, S, lambda: eng.run(wav, lens_d, mt))
    del engines, bf16, i8
    bc = BiCifParaformer(**fl, dtype=torch.float32)
    init_random_(bc, torch.Generator(device="cuda").manual_seed(2026))
    bi8 = BiCifParaformer(**fl, dtype=torch.bfloat16, quantize=True, qmm=True, int8_attn=True)
    bi8.load_state_dict(bc.state_dict(), strict=True)
    del bc
    eng = BiCifEngine(bi8.quantize_weights(), FrontendConfig(), tok)
    out["bicif_on_batch_ms"] = batch_times(torch, S, lambda: eng.run_ts(wav, lens_d, mt))
    del eng, bi8
    torch.cuda.empty_cache()

    # the beam's CTC prefix step at its B=32 x 15 s shape, by CUDA graph (the
    # parent's: its unfused composition), and the B=32 x 15 s beam batch
    from funasr_torch.ops import beam_search as TB

    a = S.step_inputs(torch, torch.Generator(device="cuda").manual_seed(6), 32, 10, 16, 383,
                      S.CONFORMER_HYBRID["vocab_size"])
    out["ctc_prefix_step graph_ms"] = S.graph_ms(lambda: TB.ctc_prefix_step(*a, False, 0))
    del a
    _, beam = S.beam_engine(torch)
    rng = np.random.default_rng(1)
    wav_b, lens_b = beam._pack([S.waveform(rng, N, 150.0 + 7 * i) for i in range(32)])
    run = lambda: beam.run(wav_b, lens_b)
    out["beam_batch_ms"] = [S.cuda_ms(run, iters=1, warmup=2 if i == 0 else 0)
                            for i in range(5)]
    steps = run().steps
    prof = S.profile(torch, run, None, statistics.median(out["beam_batch_ms"]), "beam")
    out.update({"beam kernels_ms": prof["kernels total"],
                "beam ctc prefix kernel_ms": prof.get("ctc prefix kernel", 0.0),
                "beam_steps": steps,
                "beam kernel launches_per_step": prof["kernel launches"] / steps})
    del beam, run
    torch.cuda.empty_cache()

    # the int8 layers at chip_smoke.py's main shapes
    D, NH, LEFT = 512, 4, 5
    sanm_w, dec_w, ffn_w = S.int8_layer_weights(torch, SL, DL, FF)
    gen = torch.Generator(device="cuda").manual_seed(4)
    T, U = 256, 128
    fl_d = torch.tensor([250, 200] * 32, device="cuda", dtype=torch.int32)
    tl_d = torch.tensor([110, 90] * 32, device="cuda", dtype=torch.int32)
    x = torch.randn((B, T, D), generator=gen, device="cuda").to(torch.bfloat16)
    tgt = torch.randn((B, U, D), generator=gen, device="cuda").to(torch.bfloat16)
    mem = torch.randn((B, T, D), generator=gen, device="cuda").to(torch.bfloat16)
    kb = key_bias(fl_d, T)
    mq = DL.quantize_memory(mem)
    x2 = x.reshape(B * T, D)
    layers = {"sanm_layer": lambda: SL.fused_sanm_layer(x, fl_d, sanm_w, NH, LEFT, kb),
              "decoder_layer": lambda: DL.fused_decoder_layer(tgt, mem, tl_d, fl_d, dec_w,
                                                              NH, LEFT, kb, mq),
              "ffn": lambda: FF.fused_ffn_int8(x2, ffn_w)}
    for name, fn in layers.items():
        out[f"{name}_event_ms"] = S.cuda_ms(fn)
        out[f"{name}_graph_ms"] = S.graph_ms(fn, iters=10, replays=3)

    # rowquant at the int8 layers' row-quantize shapes
    rq_shapes = {"memory (16384, 512) bf16": (16384, 512, torch.bfloat16, False),
                 "LN1 (16384, 512) bf16 + LN": (16384, 512, torch.bfloat16, True),
                 "hid (16384, 2048) f32": (16384, 2048, torch.float32, False),
                 "decoder (8192, 512) f32 + LN": (8192, 512, torch.float32, True),
                 "decoder (8192, 2048) f32 + LN": (8192, 2048, torch.float32, True)}
    for name, (M, W, dt, norm) in rq_shapes.items():
        xr = (torch.randn((M, W), generator=gen, device="cuda") * 2).to(dt)
        ln = ((1 + 0.1 * torch.randn(W, generator=gen, device="cuda"),
               0.1 * torch.randn(W, generator=gen, device="cuda")) if norm else None)
        out[f"rowquant {name} graph_ms"] = S.graph_ms(lambda: RQ.rowquant(xr, ln))

    # the int8 GEMM alone at the FFN's contractions (the rows quantized
    # beforehand)
    q1, s1 = RQ.rowquant(x2)
    hid = torch.relu(torch.randn((B * T, 4 * D), generator=gen, device="cuda"))
    q2, s2 = RQ.rowquant(hid)
    gemms = {"FFN w1 (16384, 512) -> 2048 + relu":
             lambda: G.int8_gemm(q1, s1, ffn_w.w1, ffn_w.s1, bias=ffn_w.b1, relu=True),
             "FFN w2 (16384, 2048) -> 512 bf16":
             lambda: G.int8_gemm(q2, s2, ffn_w.w2, ffn_w.s2, bias=ffn_w.b2,
                                 out_dtype=torch.bfloat16)}
    for name, fn in gemms.items():
        out[f"int8_gemm {name} graph_ms"] = S.graph_ms(fn)
    return out


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--one":
        print(json.dumps(one(argv[1], argv[2], argv[3] if len(argv) > 3 else "")), flush=True)
        return 0
    only = ""
    if argv[:1] == ["--only"] and len(argv) > 1:
        only, argv = argv[1], argv[2:]
    if not argv or any("=" not in a for a in argv):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    rows = []
    for arg in argv:
        label, tree = arg.split("=", 1)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", label, tree,
                               only], capture_output=True, text=True, timeout=1500)
        if proc.returncode:
            print(proc.stdout[-4000:] + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        rows.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    keys = [k for k in rows[0] if k.endswith(("_ms", "_per_step"))]
    print("metric | " + " | ".join(r["label"] for r in rows))
    for k in keys:
        vals = [statistics.median(r[k]) if isinstance(r[k], list) else r[k] for r in rows]
        print(f"{k} | " + " | ".join(f"{v:.4f}" for v in vals))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
