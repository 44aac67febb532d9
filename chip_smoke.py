#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

Run from the root of a checkout:

    python3 chip_smoke.py [--profile DIR]

Phases (any failure exits non-zero; nothing is caught and skipped):

1. print the card's name and power limit, build the CUDA kernels from
   ``funasr_torch/csrc`` with ``nvcc`` for ``sm_90a`` (one process per
   source, in parallel);
2. hold each kernel against its plain PyTorch twin on the card at the main
   path's shapes (fbank at 64 x 15 s, ragged, with and without the energy
   column; encoder self-attention and decoder cross-attention in bf16 and
   float32) and time kernel, twin and, for attention, the library call
   ``scaled_dot_product_attention`` (a yardstick the port never calls);
3. build full-width Paraformer-large (vocab 8404, 50 + 16 layers, D=512)
   with seeded random weights and serve three batches of mixed 2-15 s
   requests through ``ParaformerEngine.transcribe`` in bf16, with the
   kernels' launch counters set to 0 just before and read just after;
   run the same weights in float32 with kernels and with plain twins and
   compare log-probs, tokens and token lengths; time the bf16 device
   program at B=64 x 15 s (the shape of ``bench.py``);
4. print one ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

``--profile DIR`` also writes a ``torch.profiler`` table of one B=64 x 15 s
batch to ``DIR/profile_e2e.txt`` and prints device time by kernel group and
the share of the batch's device span spent in kernels.
Without CUDA, or without the rest of the repository beside it, the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

FBANK_TOL = 1e-3  # log-mel and dB, abs (the JAX package's "highest" bar)
ATTN_TOL = {"float32": 1e-4, "bfloat16": 3e-2}  # abs, output in that dtype
E2E_F32_LOGP_TOL = 1e-2  # kernels vs twins through 66 float32 layers
E2E_F32_MIN_AGREE = 0.99  # greedy-token agreement, kernels vs twins

FLAGSHIP = dict(  # __graft_entry__.py:13 _flagship (Paraformer-large)
    vocab_size=8404, input_size=560,
    encoder_conf=dict(output_size=512, attention_heads=4, linear_units=2048,
                      num_blocks=50, dropout_rate=0.1,
                      attention_dropout_rate=0.1, kernel_size=11,
                      sanm_shfit=0),
    decoder_conf=dict(attention_heads=4, linear_units=2048, num_blocks=16,
                      att_layer_num=16, kernel_size=11, sanm_shfit=0,
                      dropout_rate=0.1, self_attention_dropout_rate=0.1,
                      src_attention_dropout_rate=0.1),
    predictor_conf=dict(idim=512, threshold=1.0, l_order=1, r_order=1,
                        tail_threshold=0.45),
    lsm_weight=0.1, length_normalized_loss=True, predictor_weight=1.0,
    predictor_bias=1, sampling_ratio=0.75,
)
FS = 16000


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fbank_ops_per_frame(n_mels: int, with_energy: bool) -> float:
    """Least float32 operations of kaldi log-mel fbank for one 400-sample
    frame, whatever the algorithm: DC removal, preemphasis and window (5
    per sample), a 512-point real FFT (2.5 N log2 N), the power spectrum (3
    per bin), the mel bank's nonzeros (2 each; each bin feeds at most two
    triangles), one log per mel bin, and with the energy column one FMA per
    sample and a log.  The kernel's dense (400, 512) operator product is
    far more work (2 x 400 x 512 per frame) than the function needs."""
    import numpy as np

    from funasr_torch.ops.fbank import kaldi_mel_banks

    mel_nnz = int(np.count_nonzero(kaldi_mel_banks(n_mels, 512, float(FS))[:256]))
    ops = 5 * 400 + 2.5 * 512 * np.log2(512) + 3 * 256 + 2 * mel_nnz + n_mels
    return float(ops + (2 * 400 + 1 if with_energy else 0))


def waveform(rng, n: int, f0: float):
    import numpy as np

    t = np.arange(n) / FS
    return (0.1 * np.sin(2 * np.pi * f0 * t)
            + 0.05 * np.sin(2 * np.pi * 2.7 * f0 * t)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


# ------------------------------------------------------------------ phase 2
def check_fbank(torch, FK, rng):
    import numpy as np

    B, N = 64, 15 * FS
    lens = np.where(np.arange(B) % 2 == 0, N,
                    rng.integers(2 * FS, N, B)).astype(np.int32)
    wav = np.zeros((B, N), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = waveform(rng, int(n), 150.0 + 5 * i)
    wav_d = torch.from_numpy(wav).cuda()
    lens_d = torch.from_numpy(lens).cuda()
    T = (N - 400) // 160 + 1
    cases = []
    for with_energy in (False, True):
        got = FK.fused_fbank(wav_d, lens_d, with_energy=with_energy)
        want = FK.fbank_ref(wav_d, lens_d, with_energy=with_energy)
        torch.cuda.synchronize()
        check(torch.equal(got[1], want[1]), "fbank frame lengths")
        err = max(float((g - w).abs().max()) for g, w in
                  zip((got[0],) + got[2:], (want[0],) + want[2:]))
        check(bool(all(torch.isfinite(g).all() for g in (got[0],) + got[2:])),
              "fbank output finite")
        check(err <= FBANK_TOL, f"fbank(with_energy={with_energy}) max err "
              f"{err} > {FBANK_TOL}")
        ms = cuda_ms(lambda: FK.fused_fbank(wav_d, lens_d, with_energy=with_energy))
        plain = cuda_ms(lambda: FK.fbank_ref(wav_d, lens_d, with_energy=with_energy),
                        iters=5)
        n_out = 80 + (1 if with_energy else 0)
        nbytes = B * N * 4 + B * T * n_out * 4 + 2 * B * 4  # + lengths in, out
        ops = B * T * fbank_ops_per_frame(80, with_energy)
        bnd, by = bound_ms(nbytes, ops, "float32")
        case = dict(case=f"B=64 x 15 s ragged, with_energy={with_energy}",
                    max_abs_err=err, tolerance=FBANK_TOL, ms=ms, plain_ms=plain,
                    library_ms=None, bound_ms=bnd, bound_by=by)
        log(f"fbank {case}")
        cases.append(case)
    return cases


def check_attention(torch, A):
    import torch.nn.functional as F

    cases = []
    B, H, d, D = 64, 4, 128, 512
    T = 256  # 15 s -> 250 LFR frames -> padded to 256
    # the B=64 batch of bench.py: 15 s rows (250 frames), every other row
    # 12 s (200 frames); ragged lengths are held in check_edges
    lens = torch.full((B,), 250, device="cuda")
    lens[1::2] = 200
    bias = (1.0 - (torch.arange(T, device="cuda")[None] < lens[:, None]).float()) * -1e30
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, U, kv_cols in (("encoder self-attention", T, 3 * D),
                             ("decoder cross-attention", 128, 2 * D)):
        for dtype in (torch.bfloat16, torch.float32):
            dn = "bfloat16" if dtype == torch.bfloat16 else "float32"
            # k, v are column slices of the fused projection, as in the model
            proj = torch.randn((B, T, kv_cols), generator=gen, device="cuda").to(dtype)
            k, v = proj[..., -2 * D:-D], proj[..., -D:]
            q = (torch.randn((B, U, D), generator=gen, device="cuda").to(dtype)
                 * d ** -0.5)
            got = A.fused_attention(q, k, v, bias, H)
            want = A.attention_ref(q, k, v, bias, H)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            check(bool(torch.isfinite(got).all()), f"attention {name} finite")
            check(err <= ATTN_TOL[dn], f"attention {name} {dn} max err {err} "
                  f"> {ATTN_TOL[dn]}")
            ms = cuda_ms(lambda: A.fused_attention(q, k, v, bias, H))
            plain = cuda_ms(lambda: A.attention_ref(q, k, v, bias, H), iters=5)
            q4 = q.view(B, U, H, d).transpose(1, 2)
            k4 = k.unflatten(-1, (H, d)).transpose(1, 2)
            v4 = v.unflatten(-1, (H, d)).transpose(1, 2)
            mask = bias[:, None, None, :].to(dtype)
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=1.0))
            # q, out and the bias in full; k, v and both products only for
            # the valid keys: a padded key contributes exactly nothing
            n_keys = float(lens.clamp(max=T).sum())
            el = q.element_size()
            nbytes = el * (2 * B * U * D + 2 * n_keys * D) + 4 * B * T
            ops = 4.0 * U * D * n_keys
            bnd, by = bound_ms(nbytes, ops, dn)
            case = dict(case=f"{name} q({B},{U},{D}) kv({B},{T},{D}) {dn}, "
                             "keys 250/200",
                        max_abs_err=err, tolerance=ATTN_TOL[dn], ms=ms,
                        plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
            log(f"attention {case}")
            cases.append(case)
    return cases


def check_edges(torch, FK, A, rng):
    """Shapes the main path does not reach at 15 s: ragged tiles (T, U not
    multiples of the kernels' 32/64 tiles), one frame, a row with no valid
    key, eight heads, strided k/v.  Returns the largest error seen."""
    import numpy as np

    worst = 0.0
    for B, N in ((3, 16000 + 123), (1, 400), (2, 560)):
        lens = np.minimum(N, rng.integers(300, N + 1, B)).astype(np.int32)
        wav = torch.from_numpy(rng.standard_normal((B, N)).astype(np.float32)
                               * 0.1).cuda()
        lens_d = torch.from_numpy(lens).cuda()
        for with_energy in (False, True):
            got = FK.fused_fbank(wav, lens_d, with_energy=with_energy)
            want = FK.fbank_ref(wav, lens_d, with_energy=with_energy)
            check(torch.equal(got[1], want[1]), "fbank edge frame lengths")
            err = max(float((g - w).abs().max()) for g, w in
                      zip((got[0],) + got[2:], (want[0],) + want[2:]))
            check(err <= FBANK_TOL, f"fbank edge B={B} N={N} err {err}")
            worst = max(worst, err)
    for window in ("hanning", "povey", "rectangular"):  # another operator
        got = FK.fused_fbank(wav, lens_d, window=window)
        want = FK.fbank_ref(wav, lens_d, window=window)
        err = float((got[0] - want[0]).abs().max())
        check(err <= FBANK_TOL, f"fbank edge window={window} err {err}")
        worst = max(worst, err)
    for B, U, T, H, d in ((3, 37, 250, 4, 128), (2, 1, 1, 4, 128),
                          (3, 100, 300, 8, 128), (2, 64, 63, 2, 128)):
        gen = torch.Generator(device="cuda").manual_seed(U * T)
        D = H * d
        lens = torch.from_numpy(rng.integers(1, T + 1, B)).cuda()
        lens[-1] = 0  # no valid key: uniform weights in kernel and twin
        bias = (1.0 - (torch.arange(T, device="cuda")[None] < lens[:, None])
                .float()) * -1e30
        for dtype in (torch.bfloat16, torch.float32):
            kv = torch.randn((B, T, 2 * D), generator=gen,
                             device="cuda").to(dtype)
            k, v = kv.split(D, dim=-1)
            q = (torch.randn((B, U, D), generator=gen, device="cuda").to(dtype)
                 * d ** -0.5)
            got = A.fused_attention(q, k, v, bias, H)
            want = A.attention_ref(q, k, v, bias, H)
            dn = "bfloat16" if dtype == torch.bfloat16 else "float32"
            err = float((got.float() - want.float()).abs().max())
            check(err <= ATTN_TOL[dn],
                  f"attention edge B={B} U={U} T={T} H={H} d={d} {dn} err {err}")
            worst = max(worst, err)
    torch.cuda.synchronize()
    log(f"edge shapes: fbank (3 shapes, 4 windows) and attention (4 shapes x 2 dtypes) "
        f"within tolerance, worst abs err {worst:.3e}")
    return worst


# ------------------------------------------------------------------ phase 3
@contextlib.contextmanager
def plain_twins(FK, A):
    """Route the model through the kernels' plain twins (reference run)."""
    saved = FK.fused_fbank, A.fused_attention
    FK.fused_fbank, A.fused_attention = FK.fbank_ref, A.attention_ref
    try:
        yield
    finally:
        FK.fused_fbank, A.fused_attention = saved


def end_to_end(torch, rng, FK, A, profile_dir, card):
    import numpy as np

    from funasr_torch.auto.engines import FrontendConfig, ParaformerEngine
    from funasr_torch.models.paraformer.model import Paraformer, init_random_
    from funasr_torch.tokenizer.char_tokenizer import CharTokenizer

    t0 = time.time()
    f32 = Paraformer(**FLAGSHIP, dtype=torch.float32)
    init_random_(f32, torch.Generator(device="cuda").manual_seed(2024))
    bf16 = Paraformer(**FLAGSHIP, dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict(), strict=True)
    n_params = sum(p.numel() for p in f32.parameters())
    tokens = (["<blank>", "<s>", "</s>"]
              + [chr(0x4E00 + i) for i in range(FLAGSHIP["vocab_size"] - 4)]
              + ["<unk>"])
    tok = CharTokenizer(tokens)
    engine = ParaformerEngine(bf16, FrontendConfig(), tok)
    engine32 = ParaformerEngine(f32, FrontendConfig(), tok)
    log(f"e2e: Paraformer-large {n_params / 1e6:.1f} M params built in "
        f"{time.time() - t0:.1f} s")

    batches = []
    for size in (8, 16, 5):
        n = rng.integers(2 * FS, 15 * FS + 1, size)
        batches.append([waveform(rng, int(m), float(rng.uniform(100, 400)))
                        for m in n])
    engine.transcribe(batches[0][:2])  # warm-up (cuBLAS/cuDNN handles)
    torch.cuda.synchronize()

    # ---- the main path: counters at 0 just before, read just after
    FK.fused_fbank.launches = 0
    A.fused_attention.launches = 0
    t0 = time.time()
    results = [engine.transcribe(b) for b in batches]
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    launches = {"fbank": FK.fused_fbank.launches,
                "attention": A.fused_attention.launches}
    log(f"e2e: served {sum(map(len, batches))} requests in 3 batches in "
        f"{serve_s:.3f} s; kernel launches {launches}")
    check(launches["fbank"] == len(batches), "fbank kernel launched per batch")
    check(launches["attention"] == len(batches) * (50 + 16),
          "attention kernel launched in every encoder and decoder layer")
    for batch, res in zip(batches, results):
        check(len(res) == len(batch), "one result per request")
        check(all(isinstance(r.get("text"), str) for r in res),
              "every result has a text")
    log(f"e2e: sample texts {[r['text'][:12] for r in results[0][:3]]}")

    # ---- float32 on the card: kernels vs plain twins on the same weights
    b = batches[1]
    wav_d, lens_d = engine32._pack(b)
    max_tokens = engine32._max_tokens(wav_d.shape[1])

    def logits(eng):
        feats, flens = eng.frontend.device_features(wav_d, lens_d)
        return eng.module.inference_logits(feats, flens, max_tokens=max_tokens)

    lp_k, tl_k, pred_k = logits(engine32)
    with plain_twins(FK, A):
        lp_r, tl_r, pred_r = logits(engine32)
    lp_b, tl_b, _ = logits(engine)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lp_k).all()), "float32 log-probs finite")
    check(lp_k.shape == (len(b), max_tokens, FLAGSHIP["vocab_size"]),
          f"log-prob shape {tuple(lp_k.shape)}")
    check(torch.equal(tl_k, tl_r), f"float32 token lengths kernels {tl_k.tolist()}"
          f" vs twins {tl_r.tolist()}")
    valid = (torch.arange(max_tokens, device="cuda")[None] < tl_k[:, None])
    logp_err = float((lp_k - lp_r).abs()[valid].max())
    agree = float((lp_k.argmax(-1) == lp_r.argmax(-1))[valid].float().mean())
    peaks_equal = bool(torch.equal(pred_k.peaks, pred_r.peaks))
    bvalid = valid & (torch.arange(max_tokens, device="cuda")[None] < tl_b[:, None])
    agree_bf16 = float((lp_b.argmax(-1) == lp_k.argmax(-1))[bvalid].float().mean())
    log(f"e2e float32 kernels vs twins: max |dlogp| {logp_err:.3e} "
        f"(tol {E2E_F32_LOGP_TOL}), token agreement {agree:.5f}, token "
        f"lengths equal, peaks equal {peaks_equal}; bf16 vs float32 token "
        f"agreement {agree_bf16:.5f}, token lengths equal "
        f"{bool(torch.equal(tl_b, tl_k))}")
    check(logp_err <= E2E_F32_LOGP_TOL, "float32 log-probs kernels vs twins")
    check(agree >= E2E_F32_MIN_AGREE, "float32 token agreement")
    e2e = dict(f32_logp_max_abs_diff=logp_err, f32_token_agreement=agree,
               f32_peaks_equal=peaks_equal, bf16_vs_f32_token_agreement=agree_bf16,
               serve_3_batches_s=serve_s)

    # ---- throughput: B=64 x 15 s, half the rows at 12 s (bench.py)
    B, N = 64, 15 * FS
    lens = np.full((B,), N, np.int64)
    lens[1::2] = int(N * 0.8)
    base = waveform(np.random.default_rng(0), N, 300.0)
    wav = np.stack([base * (np.arange(N) < n) for n in lens]).astype(np.float32)
    wav_d = torch.from_numpy(wav).cuda()
    lens_d = torch.from_numpy(lens.astype(np.int32)).cuda()
    max_tokens = engine._max_tokens(N)
    ms = cuda_ms(lambda: engine.run(wav_d, lens_d, max_tokens), iters=5)
    audio_s = float(lens.sum()) / FS
    wavs = [w[:n] for w, n in zip(wav, lens)]
    t0 = time.time()
    engine.transcribe(wavs)
    host_s = time.time() - t0
    e2e.update(batch_ms=ms, audio_s_per_s=audio_s / (ms / 1e3),
               transcribe_b64_s=host_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"e2e bf16 B=64 x 15 s (bench.py shape): device program {ms:.2f} ms "
        f"-> {audio_s / (ms / 1e3):.1f} audio-s/s on {card}; transcribe() "
        f"incl. host {host_s * 1e3:.1f} ms")
    if profile_dir:
        e2e["profile"] = profile(torch, engine, wav_d, lens_d, max_tokens,
                                 profile_dir, ms)
    return launches, e2e


def profile(torch, engine, wav_d, lens_d, max_tokens, out_dir, batch_ms):
    """Device kernel time by group for one B=64 x 15 s batch, and the share
    of the batch's device span (``batch_ms``, CUDA events) spent in kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    engine.run(wav_d, lens_d, max_tokens)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        engine.run(wav_d, lens_d, max_tokens)
        torch.cuda.synchronize()
    events = p.key_averages()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_e2e.txt"), "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=60))
    groups = {}
    for ev in events:  # kernels only: a CPU op's device time repeats them
        if ev.device_type != DeviceType.CUDA or not ev.self_device_time_total:
            continue
        name = ev.key.lower()
        if "attention_kernel" in name:
            g = "attention kernel"
        elif "fbank_kernel" in name:
            g = "fbank kernel"
        elif any(s in name for s in ("gemm", "nvjet", "cutlass", "xmma")):
            g = "gemm"
        elif "conv_depthwise" in name:
            g = "depthwise conv"
        elif "layer_norm" in name:
            g = "layer norm"
        elif "copy" in name:
            g = "copy / cast"
        elif "elementwise" in name:
            g = "elementwise"
        else:
            g = "other"
        groups[g] = groups.get(g, 0.0) + ev.self_device_time_total / 1e3
    busy = sum(groups.values())
    groups["kernels total"] = busy
    groups["kernel share of batch_ms"] = busy / batch_ms
    log(f"profile device ms by group: {json.dumps(groups, sort_keys=True)}")
    return groups


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler table of one batch here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from funasr_torch.ops import attention as A
    from funasr_torch.ops import cuda_build
    from funasr_torch.ops import fbank_kernel as FK

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 means float32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    t0 = time.time()
    logs = cuda_build.build()
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"nvcc {name}: {line.strip()}")
    log(f"built {sorted(logs) or 'nothing (cached)'} in {time.time() - t0:.1f} s")

    rng = np.random.default_rng(0)
    t0 = time.time()
    fbank_cases = check_fbank(torch, FK, rng)
    attn_cases = check_attention(torch, A)
    check_edges(torch, FK, A, rng)
    log(f"kernel checks done in {time.time() - t0:.1f} s")

    t0 = time.time()
    launches, e2e = end_to_end(torch, rng, FK, A, args.profile, smi)
    log(f"end to end done in {time.time() - t0:.1f} s")
    log(f"e2e summary {json.dumps(e2e, sort_keys=True)}")

    def entry(name, source, replaces, main_case, cases):
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches[name], shape=main_case["case"],
                    tolerance=main_case["tolerance"],
                    **{k: main_case[k] for k in keys}, cases=cases)

    kernels = [
        entry("fbank", "funasr_torch/csrc/fbank.cu",
              "funasr_tpu/ops/fbank_pallas.py:97", fbank_cases[0], fbank_cases),
        entry("attention", "funasr_torch/csrc/attention.cu",
              "funasr_tpu/ops/attention_pallas.py:37", attn_cases[0], attn_cases),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
