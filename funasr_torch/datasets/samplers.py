"""Distributed length-bucketed batch samplers (copy of
funasr_tpu/datasets/samplers.py).

Re-implements the semantics of the reference's sampler family
(funasr/datasets/audio_datasets/samplers.py:40-439,
espnet_samplers.py:31): epoch-seeded shuffle, buffer-window sort by length,
token-budget greedy batching, rank sharding, ``set_epoch`` and
``start_step`` mid-epoch resume.

Each emitted batch carries a *padded shape* drawn from a quantized grid
(``shape_grid``), so the device sees a small, bounded set of shapes; the
same lengths and seed give the JAX package's batches in its order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

import numpy as np

from funasr_torch.registry import tables


def quantize_length(n: int, grid: Sequence[int]) -> int:
    """Round ``n`` up to the smallest grid value >= n (last value clamps)."""
    for g in grid:
        if n <= g:
            return g
    return grid[-1]


def default_grid(max_len: int, steps: int = 8) -> List[int]:
    """Geometric shape grid from max_len/2^steps .. max_len."""
    grid = [max_len]
    v = max_len
    for _ in range(steps):
        v = int(math.ceil(v / 1.3))
        grid.append(v)
    return sorted(set(grid))


@dataclass
class Batch:
    indices: List[int]
    pad_source_len: int  # padded source length (samples or frames)
    pad_target_len: int  # padded target length (tokens)


@tables.register("batch_sampler_classes", "BatchSampler")
@tables.register("batch_sampler_classes", "DynamicBatchSampler")
class DynamicBatchSampler:
    """Token-budget batching over length-sorted shuffle buffers.

    Args:
      source_lens / target_lens: per-example lengths from the index ds.
      batch_type: "example" (fixed count) or "length"/"token" (budget on
        padded source+target length, reference samplers.py:324).
      batch_size: count or token budget.
      buffer_size: window size for local length sort (bucketing).
      rank / world_size: this host's shard.
      shape_grid: optional quantization grids (source, target).
    """

    def __init__(
        self,
        source_lens: Sequence[int],
        target_lens: Sequence[int],
        batch_type: str = "length",
        batch_size: int = 6000,
        buffer_size: int = 500,
        rank: int = 0,
        world_size: int = 1,
        shuffle: bool = True,
        drop_last: bool = False,
        source_grid: Optional[Sequence[int]] = None,
        target_grid: Optional[Sequence[int]] = None,
        max_source_len: int = 100000,
        max_target_len: int = 500,
        seed: int = 0,
        **kwargs,
    ):
        self.source_lens = np.asarray(source_lens, np.int64)
        self.target_lens = np.asarray(target_lens, np.int64)
        self.batch_type = batch_type
        self.batch_size = int(batch_size)
        self.buffer_size = int(buffer_size)
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.start_step = 0
        keep = (self.source_lens <= max_source_len) & (
            self.target_lens <= max_target_len
        )
        self.valid_indices = np.nonzero(keep)[0]
        self.source_grid = (
            sorted(source_grid)
            if source_grid
            else default_grid(int(self.source_lens[self.valid_indices].max(initial=1)))
        )
        self.target_grid = (
            sorted(target_grid)
            if target_grid
            else default_grid(int(self.target_lens[self.valid_indices].max(initial=1)))
        )

    def set_epoch(self, epoch: int, start_step: int = 0):
        self.epoch = epoch
        self.start_step = start_step

    def _batches(self) -> List[Batch]:
        idx = self.valid_indices.copy()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        batches: List[Batch] = []
        for start in range(0, len(idx), self.buffer_size):
            window = idx[start : start + self.buffer_size]
            window = window[np.argsort(self.source_lens[window], kind="stable")]
            cur: List[int] = []
            cur_max_s = 0
            cur_max_t = 0
            for i in window:
                s = int(self.source_lens[i])
                t = int(self.target_lens[i])
                new_max_s = max(cur_max_s, s)
                new_max_t = max(cur_max_t, t)
                if self.batch_type == "example":
                    over = len(cur) >= self.batch_size
                else:
                    over = (new_max_s + new_max_t) * (len(cur) + 1) > self.batch_size
                if cur and over:
                    batches.append(self._finalize(cur, cur_max_s, cur_max_t))
                    cur, cur_max_s, cur_max_t = [], 0, 0
                    new_max_s, new_max_t = s, t
                cur.append(int(i))
                cur_max_s, cur_max_t = new_max_s, new_max_t
            if cur:
                batches.append(self._finalize(cur, cur_max_s, cur_max_t))
        return batches

    def _finalize(self, indices, max_s, max_t) -> Batch:
        return Batch(
            indices=list(indices),
            pad_source_len=quantize_length(max_s, self.source_grid),
            pad_target_len=quantize_length(max_t, self.target_grid),
        )

    def __iter__(self) -> Iterator[Batch]:
        batches = self._batches()
        # rank-shard whole batches round-robin (reference samplers rank slice)
        mine = batches[self.rank :: self.world_size]
        n = min(
            len(batches[r :: self.world_size]) for r in range(self.world_size)
        ) if self.world_size > 1 else len(mine)
        mine = mine[:n]  # keep ranks in lockstep
        return iter(mine[self.start_step :])

    def __len__(self):
        batches = self._batches()
        if self.world_size > 1:
            return min(
                len(batches[r :: self.world_size]) for r in range(self.world_size)
            )
        return len(batches)

