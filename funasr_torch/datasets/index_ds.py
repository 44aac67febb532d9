"""Index datasets: jsonl manifests -> [{key, source, target, source_len,
target_len}] (copy of funasr_tpu/datasets/index_ds.py; reference
funasr/datasets/audio_datasets/index_ds.py:16 ``IndexDSJsonlRankFull``)."""

from __future__ import annotations

import json
from typing import Any, Dict, List, Union

from funasr_torch.registry import tables


@tables.register("index_ds_classes", "IndexDSJsonl")
@tables.register("index_ds_classes", "IndexDSJsonlRankFull")
class IndexDSJsonl:
    """Loads one or more jsonl files; every rank holds the full index
    (rank sharding happens in the batch sampler)."""

    def __init__(self, path: Union[str, List[str]], **kwargs):
        paths = [path] if isinstance(path, str) else list(path)
        self.contents: List[Dict[str, Any]] = []
        for p in paths:
            with open(p, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    norm = dict(rec)  # keep extra fields
                    norm.update({
                        "key": rec.get("key", str(len(self.contents))),
                        "source": rec["source"],
                        "target": rec.get("target", ""),
                        "source_len": int(rec.get("source_len", 1)),
                        "target_len": int(rec.get("target_len", 0)),
                    })
                    self.contents.append(norm)

    def __len__(self):
        return len(self.contents)

    def __getitem__(self, i):
        return self.contents[i]
