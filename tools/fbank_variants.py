#!/usr/bin/env python3
"""Where the fbank kernel's time goes, on one NVIDIA GPU.

    python3 tools/fbank_variants.py

Builds ``funasr_torch/csrc/fbank.cu`` and copies of it with one step cut
out or changed by a text substitution (``VARIANTS``), each with ``nvcc``
into ``build/fbank_variants/`` (one process per copy, in parallel), and
times each launch alone (CUDA events around 20 launches, the C entry point
called directly) at ``chip_smoke.py``'s served input, B=64 x 15 s, 80
mels, in three rounds of turns.  A copy that cuts a step computes wrong
features: its time bounds that step's share, and its distance to the
kernel's output is printed only to show that the cut took effect.  Then
prints the distance of the kernel, of its float32 twin and of the float32
cuFFT route to the float64 exact value (``chip_smoke.fbank_fft_route``) at
the served input and at a plainer one (one 150 Hz sine over noise, every
row 15 s), and, last, a JSON object of the times.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "fbank_variants")
# steps 2-4 (preprocess, FFT, split) skipped: the mel reads stale power
_SKIP_FFT = [
    ("    // 2. preprocess: lane n2 holds z[16 r + n2] in register r",
     "    if (n_tiles < 0) {\n    // 2. preprocess: lane n2 holds z[16 r + n2] in register r"),
    ("    __syncthreads();\n\n    // 5. sparse mel", "    }\n    __syncthreads();\n\n    // 5. sparse mel"),
]
VARIANTS = {
    "kernel": [],
    "float32 log": [(
        "s_out[fm * n_mels + j] = (float)log(fmax(s, 1.1920928955078125e-07));",
        "s_out[fm * n_mels + j] = logf(fmaxf((float)s, 1.1920928955078125e-07f));")],
    "one mel term (no mel loop)": [(
        "for (int i = 0; i < len; ++i) s = fma(w[i], p[i], s);",
        "s = w[0] * p[0] + len;")],
    "no pass-1 twiddle loads": [(
        "const double wr = s_tw[k1 * 16 + ln], wi = s_tw[256 + k1 * 16 + ln];",
        "const double wr = 1.0 + k1, wi = 0.5;")],
    "no split twiddle loads": [(
        "const double wr = s_split[k], wi = s_split[256 + k];",
        "const double wr = 1.0 + k, wi = 0.5;")],
    "a block a tile (not persistent)": [(
        "  const int grid = n_tiles < grid_cap ? (int)n_tiles : grid_cap;",
        "  const int grid = (int)n_tiles;")],
    **{f"{k} blocks an SM": [(
        "    grid_cap = sms * (per_sm > 0 ? per_sm : 1);",
        f"    grid_cap = sms * {k};")] for k in (2, 3, 4)},
    "no FFT phases (stage, mel, store)": _SKIP_FFT,
    "no FFT, mel or log (stage, store)": _SKIP_FFT + [(
        "      double s = 0.0;\n      for (int i = 0; i < len; ++i) s = fma(w[i], p[i], s);\n"
        "      s_out[fm * n_mels + j] = (float)log(fmax(s, 1.1920928955078125e-07));",
        "      s_out[fm * n_mels + j] = (float)len + (float)p[0] + (float)w[0];")],
}


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import chip_smoke as S
    from funasr_torch.ops import cuda_build
    from funasr_torch.ops import fbank_kernel as FK

    if not torch.cuda.is_available():
        print("fbank_variants: no CUDA device visible", file=sys.stderr)
        return 2
    src = open(os.path.join(ROOT, "funasr_torch", "csrc", "fbank.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in fbank.cu")
            text = text.replace(old, new)
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"libv{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        fn = ctypes.CDLL(so).fbank_forward
        fn.argtypes, fn.restype = FK._ARGTYPES, ctypes.c_int
        fns[name] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)

    rng = np.random.default_rng(0)  # chip_smoke.check_fbank's input
    B, N = 64, 15 * S.FS
    lens = np.where(np.arange(B) % 2 == 0, N, rng.integers(2 * S.FS, N, B))
    wav = np.zeros((B, N), np.float32)
    for i, n in enumerate(lens):
        wav[i, :n] = S.waveform(rng, int(n), 150.0 + 5 * i)
    wav = torch.from_numpy(wav).cuda()
    T = (N - 400) // 160 + 1
    tab, idx = FK._kernel_device_tables(wav.device, 80, "hamming")
    feats = torch.empty((B, T, 80), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ref, times = None, {}
    for rnd in range(3):
        for name, fn in fns.items():
            def call():
                S.check(fn(wav.data_ptr(), B, N, T, tab.data_ptr(), idx.data_ptr(), 80,
                           feats.data_ptr(), None, stream) == 0, f"{name} launch")
            ms = S.cuda_ms(call, iters=20, warmup=3)
            if ref is None:
                ref = feats.clone()
            times.setdefault(name, []).append(ms)
            print(f"{name:34s} round {rnd} ms {ms:.4f} "
                  f"max |out - kernel| {float((feats - ref).abs().max()):.3e}", flush=True)
    t = np.arange(N) / S.FS
    plain = (0.1 * np.sin(2 * np.pi * 150.0 * t)[None]
             + 0.02 * np.random.default_rng(1).standard_normal((B, N))).astype(np.float32)
    full = torch.full((B,), N, dtype=torch.int32, device="cuda")
    for name, x, ln in (("served input", wav, torch.from_numpy(lens.astype(np.int32)).cuda()),
                        ("one sine over noise", torch.from_numpy(plain).cuda(), full)):
        exact = S.fbank_fft_route(torch, x, torch.float64)
        dist = {k: float((v.double() - exact).abs().max()) for k, v in (
            ("kernel", FK.fused_fbank(x, ln)[0]), ("twin", FK.fbank_ref(x, ln)[0]),
            ("float32 cuFFT route", S.fbank_fft_route(torch, x, torch.float32)))}
        print(f"{name}: max |log-mel - float64 exact| {dist}", flush=True)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
