#!/usr/bin/env python3
"""Where the bf16 FFN kernel's time goes, on one NVIDIA GPU.

    python3 tools/ffn_variants.py

Builds ``funasr_torch/csrc/ffn.cu`` and copies of it with one part cut out
by a text substitution (``VARIANTS``), each with ``nvcc`` into
``build/ffn_variants/`` (one process per copy, in parallel), and times each
by CUDA graph (``chip_smoke.graph_ms``: the ``fused_ffn`` wrapper calls
captured in a graph, the copy's entry point swapped into the wrapper, with
the ring depth of the run in place of the plan's) at
``chip_smoke.py``'s main shape, (16384, 512) -> 2048 -> 512 bf16, in three
rounds of turns, beside two ``F.linear`` and a relu.  The kernel itself is
also timed with rings of 4 to 7 slots.  A copy that cuts a part computes
wrong output: its time bounds the rest's share, and its distance to the
twin is printed only to show that the cut took effect.  Prints one JSON
object a timing and, last, a JSON object of the medians.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ffn_variants")
_GEMM1 = ("for (int k = 0; k < BK / 32; ++k) mma_n64(a1, da + 2 * k, db + 2 * k, (kb | k) != 0);",
          ";")
_GEMM2 = [("              mma_n128(acc[%d], da + 2 * k, db + 2 * k, (c | j | k) != 0);" % h,
           "              ;") for h in (0, 1)]
# the producer completes each slot's barrier without loading it
_NO_LOADS = ("        i8w::mbar_expect_tx(&full[s], SLOT + b1_bytes);\n"
             "        if (b1_src) bulk_load(b1_dst, b1_src, b1_bytes, &full[s]);\n",
             "        i8w::mbar_arrive(&full[s]);\n        ring.advance();\n        return s;\n")
VARIANTS = {
    "kernel": [],
    "no products (the weight stream alone)": [_GEMM1] + _GEMM2,
    "no weight loads (the products alone)": [_NO_LOADS],
    "no first product": [_GEMM1],
    "no second product": _GEMM2,
}


def build() -> dict:
    sys.path.insert(0, ROOT)
    from funasr_torch.ops import cuda_build

    src = open(os.path.join(cuda_build.CSRC, "ffn.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"variant {name!r}: text not found: {a!r}")
            text = text.replace(a, b)
        path = os.path.join(OUT, f"ffn_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"libffn_{i}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC),
               "-o", lib, path]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {name} failed:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ffn_variants: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from funasr_torch.ops import cuda_build
    from funasr_torch.ops import ffn as FF
    from funasr_torch.ops import int8_gemm as G

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    libs = build()
    torch.backends.cuda.matmul.allow_tf32 = False
    M, K, H, N = S.FFN_SHAPES[0]
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
    w1 = (torch.randn((H, K), generator=gen, device="cuda") * K ** -0.5).to(dt)
    w2 = (torch.randn((N, H), generator=gen, device="cuda") * H ** -0.5).to(dt)
    b1 = 0.1 * torch.randn(H, generator=gen, device="cuda")
    b2 = 0.1 * torch.randn(N, generator=gen, device="cuda")
    want = FF.ffn_ref(x, w1, b1, w2, b2)
    b1d, b2d = b1.to(dt), b2.to(dt)
    plan = FF.ffn_plan(M, K, H, N, dt, G.sm_count(0))
    key = ("ffn", "ffn_forward")
    real = cuda_build.function(*key, FF._ARGTYPES)
    runs = [(name, plan.stages) for name in libs]
    runs += [(f"kernel, {st} ring slots", st) for st in range(FF.MIN_STAGES, plan.stages)]
    times = {}
    for rnd in range(3):
        times.setdefault("two F.linear and a relu", []).append(
            S.graph_ms(lambda: F.linear(torch.relu(F.linear(x, w1, b1d)), w2, b2d)))
        for name, stages in runs:
            lib = libs[name.split(",")[0]]
            fn = lib.ffn_forward
            fn.argtypes, fn.restype = FF._ARGTYPES, ctypes.c_int
            # the entry's arguments end (stages, grid, smem, stream)
            cuda_build._bound[key] = lambda *a, fn=fn, st=stages: fn(
                *a[:-4], st, a[-3], FF.bf16_smem(K, st), a[-1])
            got = FF.fused_ffn(x, w1, b1, w2, b2)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            t = S.graph_ms(lambda: FF.fused_ffn(x, w1, b1, w2, b2))
            cuda_build._bound[key] = real
            times.setdefault(name, []).append(t)
            print(json.dumps(dict(round=rnd, variant=name, stages=stages, graph_ms=t,
                                  max_abs_err=err)), flush=True)
    print(json.dumps({"card": smi, "median_graph_ms":
                      {k: statistics.median(v) for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
