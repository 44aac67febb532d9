"""Tiny synthetic training data: tone-burst wavs and toy targets (copy of
examples/smoke/make_data.py)::

    python -m funasr_torch.bin.make_smoke_data <dir>

writes 16 utterances of 2-4 tone bursts (one of five tones a token, 0.3 s
each, 16 kHz) as ``<dir>/utt*.wav`` with ``<dir>/wav.scp`` and
``<dir>/text``; the seed is fixed, so every run writes the same data."""

import os
import sys
import wave

import numpy as np


def write_wav(path, wav, fs=16000):
    pcm = np.clip(wav * 32767, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(pcm.tobytes())


def main(out):
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(0)
    fs = 16000
    vocab = ["一", "二", "三", "四", "五"]
    tones = [300.0, 440.0, 620.0, 780.0, 950.0]
    with open(os.path.join(out, "wav.scp"), "w", encoding="utf-8") as ws, \
            open(os.path.join(out, "text"), "w", encoding="utf-8") as ts:
        for i in range(16):
            n_tok = int(rng.integers(2, 5))
            toks = rng.integers(0, len(vocab), n_tok)
            segs = []
            for t in toks:
                dur = int(fs * 0.3)
                tt = np.arange(dur) / fs
                segs.append(0.3 * np.sin(2 * np.pi * tones[t] * tt))
            wav = np.concatenate(segs) + 0.01 * rng.standard_normal(
                sum(len(s) for s in segs))
            key = f"utt{i:03d}"
            path = os.path.join(out, f"{key}.wav")
            write_wav(path, wav, fs)
            ws.write(f"{key} {path}\n")
            ts.write(f"{key} {''.join(vocab[t] for t in toks)}\n")


if __name__ == "__main__":
    main(sys.argv[1])
