"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``funasr_torch/csrc/<name>.cu`` is compiled on its own into
``build/kernels/lib<name>-<hash>.so`` under the checkout (a directory that
``.gitignore`` lists) with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The hash covers every source under ``csrc/`` and the flags, so an edited
kernel is rebuilt and a stale library is never loaded.  ``build()`` starts
one ``nvcc`` per missing library, all at once, and waits for them;
``library(name)`` builds on first use and caches the loaded handle for the
life of the process, and ``function`` binds an entry point's ctypes
signature once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("fbank", "attention", "int8_gemm", "rowquant", "fsmn", "ctc_prefix", "qmm",
           "ffn", "wkv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library among ``names`` in parallel.

    Returns ``{name: compiler log}`` (the ``-Xptxas -v`` register and
    shared-memory report) for the libraries built by this call; raises
    with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: another process never loads half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name``, with ``argtypes``
    and an ``int`` return type, bound once per process."""
    fn = _bound.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _bound[(name, symbol)] = fn
    return fn


def refuse_autograd(fn: str, *inputs) -> None:
    """Raise when grad mode is on and any tensor among ``inputs`` (or inside
    a tuple of them, such as a layer's weights) requires grad: a kernel
    wrapper has no backward, and a result it computed would silently cut
    the graph.  Every wrapper calls this first, on every device; with grad
    mode off it costs one call."""
    if not torch.is_grad_enabled():
        return
    for t in inputs:
        if getattr(t, "requires_grad", False) or (isinstance(t, tuple) and any(
                getattr(x, "requires_grad", False) for x in t)):
            raise RuntimeError(f"{fn}: an input requires grad, and the kernel has no "
                               "backward; call it under torch.no_grad(), or use the "
                               "module's training path")


def check(status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
