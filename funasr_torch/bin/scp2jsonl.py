"""wav.scp (+ text) -> jsonl manifest (copy of funasr_tpu/bin/scp2jsonl.py;
reference funasr/datasets/audio_datasets/scp2jsonl.py)::

    python -m funasr_torch.bin.scp2jsonl --scp_file_list wav.scp text \\
        --jsonl_file_out train.jsonl

Each output line: {"key", "source", "source_len", "target", "target_len"}.
``source_len`` is the waveform length in samples when the wav header is
readable (a RIFF header peek, no decode), else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import struct
from typing import Dict, Optional


def _read_kv(path: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(maxsplit=1)
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def _wav_num_samples(path: str) -> Optional[int]:
    try:
        with open(path, "rb") as f:
            hdr = f.read(12)
            if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
                return None
            channels = bits = 1
            while True:
                ch = f.read(8)
                if len(ch) < 8:
                    return None
                cid, csz = ch[:4], struct.unpack("<I", ch[4:])[0]
                if cid == b"fmt ":
                    body = f.read(csz)
                    channels = struct.unpack("<H", body[2:4])[0]
                    bits = struct.unpack("<H", body[14:16])[0]
                elif cid == b"data":
                    return csz // max(1, (bits // 8) * channels)
                else:
                    f.seek(csz + (csz & 1), 1)
    except OSError:
        return None


def scp2jsonl(scp_file: str, out_file: str,
              text_file: Optional[str] = None) -> int:
    wavs = _read_kv(scp_file)
    texts = _read_kv(text_file) if text_file else {}
    n = 0
    with open(out_file, "w", encoding="utf-8") as f:
        for key, src in wavs.items():
            n_samp = _wav_num_samples(src) if os.path.exists(src) else None
            tgt = texts.get(key, "")
            rec = {"key": key, "source": src,
                   "source_len": n_samp if n_samp else 1,
                   "target": tgt, "target_len": (len(tgt.split()) if " " in tgt else len(tgt))}
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
            n += 1
    return n


def main(argv=None):  
    ap = argparse.ArgumentParser(prog="python -m funasr_torch.bin.scp2jsonl")
    ap.add_argument("--scp_file_list", nargs="+", required=True,
                    help="wav.scp [text.txt]")
    ap.add_argument("--jsonl_file_out", required=True)
    args = ap.parse_args(argv)
    scp = args.scp_file_list[0]
    text = args.scp_file_list[1] if len(args.scp_file_list) > 1 else None
    n = scp2jsonl(scp, args.jsonl_file_out, text)
    print(f"wrote {n} records to {args.jsonl_file_out}")


if __name__ == "__main__":
    main()
