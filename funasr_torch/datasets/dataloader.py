"""Per-epoch batch iteration with ``data_split_num`` re-batching (copy of
funasr_tpu/bin/train.py:17-63 ``iter_split_batches``; reference
funasr/datasets/dataloader_entry.py:83 ``build_iter``).

The reference's ``data_split_num`` slices a large jsonl list and rebuilds
the dataset per slice; here the index list stays resident and each epoch
is processed in N contiguous slices, each re-batched to full batch shapes.
``start_step`` resumes mid-epoch (the trainer's contract).
"""

from __future__ import annotations


def iter_split_batches(sampler, n_items: int, data_split_num: int, epoch: int,
                       start_step: int = 0):
    """Yield ``(indices, pad_source_len, pad_target_len)`` batches; with
    ``data_split_num > 1`` the dataset index range is processed in N
    contiguous slices per epoch, re-batched to full batch shapes within
    each slice.  ``start_step`` skips that many emitted batches of the whole
    epoch (the split path replays the slice iteration and drops the
    consumed prefix)."""
    if data_split_num <= 1:
        sampler.set_epoch(epoch, start_step)
        for b in sampler:
            yield list(b.indices), b.pad_source_len, b.pad_target_len
        return
    emitted = 0

    def emit(items):
        nonlocal emitted
        emitted += 1
        if emitted <= start_step:
            return None
        idx = [i for i, _, _ in items]
        return idx, max(s for _, s, _ in items), max(t for _, _, t in items)

    for split_i in range(data_split_num):
        sampler.set_epoch(epoch * data_split_num + split_i, 0)
        lo = n_items * split_i // data_split_num
        hi = n_items * (split_i + 1) // data_split_num
        pending = []  # (index, pad_source_len, pad_target_len) per item
        for b in sampler:
            idx = [i for i in b.indices if lo <= i < hi]
            if not idx:
                continue
            pending.extend((i, b.pad_source_len or 0, b.pad_target_len or 0) for i in idx)
            target = len(b.indices)
            while len(pending) >= target:
                take, pending = pending[:target], pending[target:]
                out = emit(take)
                if out is not None:
                    yield out
        if pending:
            out = emit(pending)
            if out is not None:
                yield out

