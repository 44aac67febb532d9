"""CLI: train a Paraformer on the card (port of funasr_tpu/bin/train.py;
reference funasr/bin/train.py:40)::

    python -m funasr_torch.bin.train --config conf.yaml \\
        --train-jsonl train.jsonl --valid-jsonl valid.jsonl \\
        --output-dir exp ++frontend_conf.cmvn_file=am.mvn

config and ``++key=value`` overrides -> tokenizer, frontend, ``Paraformer``
(float32 parameters, compute ``dtype`` from the config's ``dtype``, float32
by default; seeded random weights, or ``init_param``) -> dataset and sampler
-> optimizer -> :class:`~funasr_torch.train.trainer.Trainer` ->
``<output-dir>/model.avg.pt``, the n-best average as a FunASR-layout state
dict that ``AutoModel(model=conf, init_param=...)`` serves.  Checkpoints go
to ``<output-dir>/ckpt`` (a rerun resumes from the latest), the statistics
read at each log and validation to ``<output-dir>/train_log.jsonl``.

Features are computed on the device for every batch (fbank kernel -> LFR ->
CMVN, ``FrontendConfig.featurize``).  With ``accum_grad`` N each sampler
batch is split into N micro-batches (its rows padded to a multiple of N by
repeating the last, :func:`micro_rows`).  The config's ``seed`` fixes every random draw: the
initial weights, dropout, the sampler's noise and the batch order.

Only the ``Paraformer`` class trains; another model class, and the
multi-chip options ``--model-parallel > 1``, ``--fsdp`` and
``--pipeline-parallel``, raise ``NotImplementedError`` (ROADMAP.md,
Queue 1).  Runs on the card; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Any, Dict, List, Optional

import torch

_DTYPES = {"float32": torch.float32, "fp32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def parse_overrides(tokens: List[str]) -> Dict[str, Any]:
    """``++a.b=value`` tokens -> a nested dict, each value read as YAML
    (funasr_tpu/bin/inference.py:20)."""
    import yaml

    out: Dict[str, Any] = {}
    for t in tokens:
        if not t.startswith("++") or "=" not in t:
            raise SystemExit(f"bad override {t!r}; expected ++key.path=value")
        k, v = t[2:].split("=", 1)
        node = out
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(v)
    return out


def build_frontend(cfg: Dict[str, Any], device):
    """The config's frontend on ``device``, its ``dither`` kept (training
    features; ``FrontendConfig.featurize``)."""
    from funasr_torch.auto.engines import FrontendConfig
    from funasr_torch.ops.fbank import load_cmvn_file

    conf = dict(cfg.get("frontend_conf") or {})
    cmvn_file = conf.pop("cmvn_file", None) or cfg.get("cmvn_file")
    cmvn = load_cmvn_file(cmvn_file) if cmvn_file and os.path.exists(cmvn_file) else None
    return FrontendConfig(cmvn=cmvn, device=device, **conf)


def micro_rows(idx: List[int], n: int) -> List[int]:
    """A sampler batch's indices padded to a multiple of ``n`` by repeating
    the last, for :func:`split_micro`.  The JAX CLI passes the unsplit batch
    to a step that scans its leading axis as the ``accum_grad`` axis, and
    fails there (ROADMAP.md, Queue 3)."""
    idx = list(idx)
    while len(idx) % n:
        idx.append(idx[-1])
    return idx


def split_micro(batch: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """(B, ...) tensors -> (n, B / n, ...)."""
    if n == 1:
        return batch
    return {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}


def main(argv: Optional[List[str]] = None):
    """Train; returns the :class:`~funasr_torch.train.trainer.Trainer`
    (its ``state`` and the ``history`` of logged statistics)."""
    ap = argparse.ArgumentParser(prog="python -m funasr_torch.bin.train")
    ap.add_argument("--config", required=True, help="model/train yaml")
    ap.add_argument("--train-jsonl", required=True)
    ap.add_argument("--valid-jsonl", default=None)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--pipeline-parallel", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--max-epoch", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from funasr_torch.auto.auto_model import _build_tokenizer, _load_state
    from funasr_torch.config import deep_update, load_config
    from funasr_torch.datasets.dataloader import iter_split_batches
    from funasr_torch.datasets.dataset import AudioDataset
    from funasr_torch.datasets.index_ds import IndexDSJsonl
    from funasr_torch.datasets.samplers import DynamicBatchSampler
    from funasr_torch.device import resolve_device
    from funasr_torch.models.paraformer.model import Paraformer, init_random_
    from funasr_torch.train.checkpoint import CheckpointManager
    from funasr_torch.train.optim import build_optimizer
    from funasr_torch.train.train_step import (create_train_state, make_eval_step,
                                               make_train_step)
    from funasr_torch.train.trainer import Trainer

    for flag, on in (("--model-parallel > 1", args.model_parallel > 1), ("--fsdp", args.fsdp),
                     ("--pipeline-parallel", args.pipeline_parallel > 0)):
        if on:
            raise NotImplementedError(f"{flag}: multi-chip training is not ported "
                                      "(ROADMAP.md, Queue 1: training)")
    cfg = load_config(args.config)
    deep_update(cfg, parse_overrides(args.overrides))
    name = cfg.get("model", "Paraformer")
    if name != "Paraformer":
        raise NotImplementedError(f"training {name!r} is not ported; only Paraformer trains "
                                  "(ROADMAP.md, Queue 1: training of the other model classes)")
    train_conf = cfg.get("train_conf") or {}
    device = resolve_device(args.device)
    seed = int(cfg.get("seed", 0))
    torch.manual_seed(seed)
    if device.type == "cuda":
        torch.cuda.set_device(device)

    tokenizer = _build_tokenizer(cfg)
    frontend = build_frontend(cfg, device)
    vocab = cfg.get("vocab_size") or tokenizer.get_vocab_size()
    input_size = cfg.get("input_size", frontend.n_mels * frontend.lfr_m)
    model = Paraformer(vocab_size=vocab, input_size=input_size,
                       encoder_conf=cfg.get("encoder_conf"),
                       decoder_conf=cfg.get("decoder_conf"),
                       predictor_conf=cfg.get("predictor_conf"),
                       dtype=_DTYPES[cfg.get("dtype", "float32")],
                       param_dtype=torch.float32, device=device,
                       **(cfg.get("model_conf") or {}))
    state_in = _load_state(cfg)
    if state_in is None:
        init_random_(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict(state_in, strict=True)

    ds = AudioDataset(IndexDSJsonl(args.train_jsonl), tokenizer=tokenizer, fs=frontend.fs)
    ds_conf = cfg.get("dataset_conf") or {}
    sampler = DynamicBatchSampler(
        ds.source_lens(), ds.target_lens(),
        batch_type=ds_conf.get("batch_type", "length"),
        batch_size=ds_conf.get("batch_size", 16000 * 60),
        buffer_size=ds_conf.get("buffer_size", 500),
        shuffle=ds_conf.get("shuffle", True), seed=seed)

    tx, _ = build_optimizer(cfg.get("optim", "adam"), cfg.get("optim_conf"),
                            cfg.get("scheduler", "warmuplr"), cfg.get("scheduler_conf"),
                            grad_clip=train_conf.get("grad_clip", 5.0))
    state = create_train_state(model, tx)
    accum = int(train_conf.get("accum_grad", 1))
    ckpt = CheckpointManager(os.path.join(args.output_dir, "ckpt"),
                             keep_nbest=train_conf.get("keep_nbest_models", 10))
    trainer = Trainer(make_train_step(model, tx, accum_grad=accum), make_eval_step(model), ckpt,
                      max_epoch=args.max_epoch or train_conf.get("max_epoch", 100),
                      validate_interval=train_conf.get("validate_interval", 5000),
                      save_checkpoint_interval=train_conf.get("save_checkpoint_interval", 5000),
                      log_interval=train_conf.get("log_interval", 50), seed=seed)
    state = trainer.resume(state)
    data_split_num = max(1, int(ds_conf.get("data_split_num", 1)))

    def build_iter(epoch: int, start_step: int):
        for idx, psrc, ptgt in iter_split_batches(sampler, len(ds), data_split_num, epoch,
                                                  start_step):
            batch = ds.collate([ds[i] for i in micro_rows(idx, accum)], psrc, ptgt)
            yield split_micro(frontend.featurize(batch), accum)

    valid_iter = None
    if args.valid_jsonl:
        vds = AudioDataset(IndexDSJsonl(args.valid_jsonl), tokenizer=tokenizer, fs=frontend.fs)
        vsampler = DynamicBatchSampler(vds.source_lens(), vds.target_lens(),
                                       batch_type="example", batch_size=8, shuffle=False)

        def valid_iter():
            for b in vsampler:
                yield frontend.featurize(vds.collate([vds[i] for i in b.indices],
                                                     b.pad_source_len, b.pad_target_len),
                                         train=False)

    trainer.state = trainer.run(state, build_iter, valid_iter)
    with open(os.path.join(args.output_dir, "train_log.jsonl"), "a", encoding="utf-8") as f:
        for rec in trainer.history:
            f.write(json.dumps(rec) + "\n")
    if ckpt.latest_step() is not None:
        avg = ckpt.average_nbest(train_conf.get("avg_nbest_model", 10))
        params = state.named_parameters(avg.to(state.params.device))
        sd = {k: v.detach().to("cpu", copy=True)
              for k, v in model.state_dict().items()}
        sd.update({k: v.detach().to("cpu", copy=True) for k, v in params.items()})
        torch.save(sd, os.path.join(args.output_dir, "model.avg.pt"))
    return trainer


if __name__ == "__main__":
    main()
