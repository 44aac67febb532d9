"""CLI: dataset CMVN statistics on the fbank kernel (port of
funasr_tpu/bin/compute_audio_cmvn.py; reference
funasr/bin/compute_audio_cmvn.py)::

    python -m funasr_torch.bin.compute_audio_cmvn --train-jsonl train.jsonl \\
        --output am.mvn

Accumulates the mean and variance of the LFR features (fbank kernel, dither
0 -> LFR) over a jsonl corpus, in float64 on the device, and writes a
kaldi-style ``am.mvn`` (negated means, inverse standard deviations).  Runs on
the card; ``--device cpu`` takes the kernel's plain twin.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch


def write_kaldi_mvn(path: str, means: np.ndarray, istd: np.ndarray) -> None:
    d = len(means)
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"<Nnet>\n<Splice> {d} {d}\n[ 0 ]\n")
        f.write(f"<AddShift> {d} {d}\n")
        f.write("<LearnRateCoef> 0 [ " + " ".join(f"{m:.8f}" for m in means) + " ]\n")
        f.write(f"<Rescale> {d} {d}\n")
        f.write("<LearnRateCoef> 0 [ " + " ".join(f"{v:.8f}" for v in istd) + " ]\n")
        f.write("</Nnet>\n")


def compute_cmvn(train_jsonl: str, n_mels: int = 80, lfr_m: int = 7, lfr_n: int = 6,
                 max_utts: int = 0, device=None):
    """-> (mean, istd, frames) of the corpus's LFR features, float64 numpy."""
    from funasr_torch.datasets.index_ds import IndexDSJsonl
    from funasr_torch.device import resolve_device, upload
    from funasr_torch.ops import fbank as F
    from funasr_torch.ops import fbank_kernel as FK
    from funasr_torch.utils.audio import load_audio

    dev = resolve_device(device)
    ids = IndexDSJsonl(train_jsonl)
    dim = n_mels * lfr_m
    total = torch.zeros(dim, dtype=torch.float64, device=dev)
    total_sq = torch.zeros(dim, dtype=torch.float64, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    recs = ids.contents[:max_utts] if max_utts else ids.contents
    for rec in recs:
        wav = load_audio(rec["source"])
        feats, flens = FK.fused_fbank(upload(wav[None].astype(np.float32), dev),
                                      upload(np.asarray([len(wav)], np.int32), dev),
                                      num_mel_bins=n_mels)
        lfr, lfr_lens = F.apply_lfr(feats, flens, lfr_m, lfr_n)
        valid = (torch.arange(lfr.shape[1], device=dev) < lfr_lens[0])[:, None]
        x = torch.where(valid, lfr[0], 0.0).to(torch.float64)
        total += x.sum(dim=0)
        total_sq += (x * x).sum(dim=0)
        n += lfr_lens[0]
    frames = int(n)
    mean = (total / max(frames, 1)).cpu().numpy()
    var = (total_sq / max(frames, 1)).cpu().numpy() - mean ** 2
    return mean, 1.0 / np.sqrt(np.maximum(var, 1e-8)), frames


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m funasr_torch.bin.compute_audio_cmvn")
    ap.add_argument("--train-jsonl", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--n-mels", type=int, default=80)
    ap.add_argument("--lfr-m", type=int, default=7)
    ap.add_argument("--lfr-n", type=int, default=6)
    ap.add_argument("--max-utts", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    mean, istd, frames = compute_cmvn(args.train_jsonl, args.n_mels, args.lfr_m, args.lfr_n,
                                      args.max_utts, args.device)
    # am.mvn stores negated means (applied as (x + means) * vars)
    write_kaldi_mvn(args.output, -mean, istd)
    print(f"wrote {args.output}: {frames} frames, dim {len(mean)}")


if __name__ == "__main__":
    main()
