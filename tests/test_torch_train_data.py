"""The port's training data path, checkpoints, resume and ``bin.train``
against the JAX package, on the CPU.

Batches, collated arrays, the ``data_split_num`` re-batching and the
checkpoint manager's kept steps are held equal to the JAX package's;
averaged parameters to 1e-7 (both average in float64 and round to float32);
training features (fbank -> LFR -> CMVN) to the fbank tests' atol 1e-3 /
rtol 1e-4; CMVN means to the same atol 1e-3 and inverse deviations to rtol
1e-3 (their E[x^2] - mean^2 amplifies the features' differences).  A run resumed mid-epoch from a
checkpoint ends on exactly the parameters, moments and step of the
uninterrupted run.  ``bin.train`` trains a tiny Paraformer on generated
wavs and writes a ``model.avg.pt`` that the port's ``AutoModel`` serves.
"""

import json
import os
import wave

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.bin import compute_audio_cmvn as jax_cmvn
from funasr_tpu.bin.train import iter_split_batches as jax_split
from funasr_tpu.datasets.dataset import AudioDataset as JaxAudioDataset
from funasr_tpu.datasets.index_ds import IndexDSJsonl as JaxIndex
from funasr_tpu.datasets.samplers import DynamicBatchSampler as JaxSampler
from funasr_tpu.ops import fbank as JF
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxChar
from funasr_tpu.train.checkpoint import CheckpointManager as JaxCkpt
from funasr_torch.auto.engines import FrontendConfig
from funasr_torch.bin import compute_audio_cmvn, train as bin_train
from funasr_torch.datasets.dataloader import iter_split_batches
from funasr_torch.datasets.dataset import AudioDataset
from funasr_torch.datasets.index_ds import IndexDSJsonl
from funasr_torch.datasets.samplers import DynamicBatchSampler
from funasr_torch.ops.fbank import load_cmvn_file
from funasr_torch.tokenizer.char_tokenizer import CharTokenizer
from funasr_torch.train.checkpoint import CheckpointManager
from funasr_torch.utils.audio import load_audio
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOKENS = ["<blank>", "<s>", "</s>", "a", "b", "c", "d", "<unk>"]
TINY_YAML = """model: Paraformer
model_conf: {{sampling_ratio: 0.75, lsm_weight: 0.1, predictor_bias: 1}}
input_size: 560
vocab_size: 8
seed: 3
encoder_conf: {{output_size: 16, attention_heads: 2, linear_units: 32, num_blocks: 2,
  kernel_size: 3, dropout_rate: 0.1}}
decoder_conf: {{attention_heads: 2, linear_units: 32, num_blocks: 2, att_layer_num: 2,
  kernel_size: 3, dropout_rate: 0.1}}
predictor_conf: {{idim: 16, threshold: 1.0, l_order: 1, r_order: 1, tail_threshold: 0.45}}
frontend_conf: {{fs: 16000, n_mels: 80, lfr_m: 7, lfr_n: 6, window: hamming, dither: 0.0,
  cmvn_file: {cmvn}}}
tokenizer: CharTokenizer
tokenizer_conf: {{token_list: [{tokens}]}}
train_conf: {{max_epoch: 1, keep_nbest_models: 2, avg_nbest_model: 2, log_interval: 1,
  save_checkpoint_interval: 2, validate_interval: 2, accum_grad: {accum}, grad_clip: 5.0}}
optim: adamw
optim_conf: {{lr: 0.002}}
scheduler: warmuplr
scheduler_conf: {{warmup_steps: 4}}
dataset_conf: {{batch_type: example, batch_size: {batch}}}
"""


def _write_wav(path, wav):
    pcm = np.clip(wav * 32767, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eight tone-burst wavs (0.4-1.0 s) with 1-4 letter targets, their
    jsonl and a CMVN file computed by the port."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    recs = []
    for i in range(8):
        n_tok = 1 + i % 4
        toks = rng.integers(0, 4, n_tok)
        wav = np.concatenate([0.3 * np.sin(2 * np.pi * (300 + 170 * t) * np.arange(
            1600 + 800 * (i % 3)) / 16000) for t in toks])
        wav = wav + 0.01 * rng.standard_normal(len(wav))
        _write_wav(d / f"u{i}.wav", wav)
        text = "".join("abcd"[t] for t in toks)
        recs.append({"key": f"u{i}", "source": str(d / f"u{i}.wav"), "source_len": len(wav),
                     "target": text, "target_len": len(text)})
    jsonl = d / "train.jsonl"
    jsonl.write_text("".join(json.dumps(r) + "\n" for r in recs))
    cmvn = d / "am.mvn"
    compute_audio_cmvn.main(["--train-jsonl", str(jsonl), "--output", str(cmvn),
                             "--device", "cpu"])
    return d, jsonl, cmvn


# ------------------------------------------------------------- the data
def test_index_dataset_and_collate_match_jax(corpus):
    _, jsonl, _ = corpus
    ti, ji = IndexDSJsonl(str(jsonl)), JaxIndex(str(jsonl))
    assert ti.contents == ji.contents
    tds = AudioDataset(ti, tokenizer=CharTokenizer(TOKENS))
    jds = JaxAudioDataset(ji, tokenizer=JaxChar(TOKENS))
    assert tds.source_lens() == jds.source_lens() and tds.target_lens() == jds.target_lens()
    items = [1, 6, 3]
    for pads in ((None, None), (20000, 9)):
        got = tds.collate([tds[i] for i in items], *pads)
        want = jds.collate([jds[i] for i in items], *pads)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError, match="below the longest"):
        tds.collate([tds[i] for i in items], 100)


@pytest.mark.parametrize("kw", [
    dict(batch_type="example", batch_size=3, shuffle=True),
    dict(batch_type="length", batch_size=900, buffer_size=7, shuffle=True, seed=5),
    dict(batch_type="length", batch_size=2000, shuffle=False, max_source_len=380),
    dict(batch_type="example", batch_size=4, world_size=2, rank=1)])
def test_sampler_batches_match_jax(kw):
    rng = np.random.default_rng(1)
    src = rng.integers(50, 400, 40).tolist()
    tgt = rng.integers(1, 30, 40).tolist()
    port, ref = DynamicBatchSampler(src, tgt, **kw), JaxSampler(src, tgt, **kw)
    assert len(port) == len(ref)
    for epoch, start in ((0, 0), (1, 0), (3, 2)):
        port.set_epoch(epoch, start)
        ref.set_epoch(epoch, start)
        assert [vars(b) for b in port] == [vars(b) for b in ref]


@pytest.mark.parametrize("split,start", [(1, 0), (2, 0), (3, 0), (3, 4)])
def test_split_rebatching_matches_jax(split, start):
    rng = np.random.default_rng(2)
    lens = rng.integers(10, 90, 23).tolist()
    mk = lambda cls: cls(lens, lens, batch_type="example", batch_size=4, seed=1)
    got = list(iter_split_batches(mk(DynamicBatchSampler), 23, split, 1, start))
    want = list(jax_split(mk(JaxSampler), 23, split, 1, start))
    assert got == want and got


# ------------------------------------------------------------ features
def test_training_features_match_jax(corpus):
    """``FrontendConfig.featurize``: the fbank kernel's twin here -> LFR ->
    CMVN, no padding, as the JAX CLI's ``featurize`` (bin/train.py:144-160)."""
    d, jsonl, cmvn_path = corpus
    ds = AudioDataset(IndexDSJsonl(str(jsonl)), tokenizer=CharTokenizer(TOKENS))
    batch = ds.collate([ds[i] for i in (0, 4, 5)])
    cmvn = load_cmvn_file(str(cmvn_path))
    got = FrontendConfig(cmvn=cmvn).featurize(batch)
    feats, flens = JF.fbank(jnp.asarray(batch["speech"]), jnp.asarray(batch["speech_lengths"]),
                            num_mel_bins=80)
    feats, flens = JF.apply_lfr(feats, flens, 7, 6)
    want = np.asarray(JF.apply_cmvn(feats, cmvn))
    np.testing.assert_array_equal(got["speech_lengths"].numpy(), np.asarray(flens))
    assert got["speech"].shape == want.shape
    for i, n in enumerate(np.asarray(flens)):
        np.testing.assert_allclose(got["speech"][i, :n].numpy(), want[i, :n], atol=1e-3,
                                   rtol=1e-4)
    np.testing.assert_array_equal(got["text"].numpy(), batch["text"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        FrontendConfig(cmvn=cmvn, dither=1.0).featurize(batch)
    FrontendConfig(cmvn=cmvn, dither=1.0).featurize(batch, train=False)


def test_cmvn_statistics_match_jax(corpus, tmp_path):
    _, jsonl, cmvn_path = corpus
    jax_cmvn.main(["--train-jsonl", str(jsonl), "--output", str(tmp_path / "jax.mvn")])
    got, want = load_cmvn_file(str(cmvn_path)), load_cmvn_file(str(tmp_path / "jax.mvn"))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-3)  # the features' bar
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)  # measured 1.7e-4


# ---------------------------------------------------------- checkpoints
def test_checkpoint_nbest_and_average_match_jax(tmp_path):
    """The same saves (an unscored one, repeats, ties) into both managers:
    the same steps kept after each, the same best and latest steps, and the
    same n-best average."""
    rng = np.random.default_rng(3)
    port = CheckpointManager(str(tmp_path / "port"), keep_nbest=2, metric="loss",
                             higher_better=False)
    ref = JaxCkpt(str(tmp_path / "jax"), keep_nbest=2, metric="loss", higher_better=False)
    for step, score in ((2, 3.0), (4, None), (6, 1.5), (6, 1.5), (8, 2.0), (10, 1.0), (12, 4.0)):
        w = rng.standard_normal(6).astype(np.float32)
        port.save(step, {"params": torch.from_numpy(w)}, extra={"epoch": 0}, val_metric=score)
        ref.save(step, {"params": {"w": jnp.asarray(w)}}, extra={"epoch": 0},
                 val_metric=score)
        assert port.all_steps() == sorted(ref._mgr.all_steps()), step
        assert port.latest_step() == ref.latest_step()
        assert port.best_step() == ref.best_step()
    got = port.average_nbest(2)
    want = ref.average_nbest(2, params_of=lambda p: p["state"]["params"])["w"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    assert port.restore(10)["extra"] == {"epoch": 0}
    again = CheckpointManager(str(tmp_path / "port"), keep_nbest=2, metric="loss",
                              higher_better=False)
    assert again.best_step() == 10


# ---------------------------------------------------------- the trainer
def _write_config(d, cmvn, accum=1, batch=4):
    path = d / f"tiny_{accum}_{batch}.yaml"
    path.write_text(TINY_YAML.format(cmvn=cmvn, tokens=", ".join(TOKENS), accum=accum,
                                     batch=batch))
    return path


def test_resume_mid_epoch_is_bit_equal(corpus, tmp_path, monkeypatch):
    """``bin.train`` for two epochs of four steps (batches of 2 split into
    two micro-batches), and the same run stopped after step 3 and restarted:
    the restart resumes from step 2 (epoch 0, step 2 in the epoch) and ends
    on the same parameters, moments and step, bit for bit."""
    d, jsonl, cmvn = corpus
    cfg = _write_config(tmp_path, cmvn, accum=2, batch=2)
    args = ["--config", str(cfg), "--train-jsonl", str(jsonl), "--device", "cpu",
            "--max-epoch", "2"]
    whole = bin_train.main(args + ["--output-dir", str(tmp_path / "a")])

    from funasr_torch.train import trainer as T
    real_step = T.Trainer.run

    class Stop(Exception):
        pass

    def run_until_3(self, state, build_iter, valid_iter=None):
        def cut(epoch, start):
            for i, b in enumerate(build_iter(epoch, start)):
                if i == 3:
                    raise Stop
                yield b
        return real_step(self, state, cut, valid_iter)

    monkeypatch.setattr(T.Trainer, "run", run_until_3)
    with pytest.raises(Stop):
        bin_train.main(args + ["--output-dir", str(tmp_path / "b")])
    monkeypatch.setattr(T.Trainer, "run", real_step)
    assert CheckpointManager(str(tmp_path / "b" / "ckpt")).latest_step() == 2
    resumed = bin_train.main(args + ["--output-dir", str(tmp_path / "b")])
    assert (resumed.start_epoch, resumed.start_step) == (0, 2)
    assert int(whole.state.step) == int(resumed.state.step) == 8
    assert torch.equal(whole.state.params, resumed.state.params)
    for k, v in whole.state.opt_state.items():
        assert torch.equal(v, resumed.state.opt_state[k]), k


def test_bin_train_writes_a_model_automodel_serves(corpus, tmp_path):
    """Train one epoch (dropout, the sampler, adamw, validation and
    checkpoints every 2 steps), then serve ``model.avg.pt`` through the
    port's ``AutoModel``: the weights load strictly and decode to the same
    tokens as the averaged parameters in a directly built model; the JAX
    converter takes the state dict back."""
    from funasr_tpu.convert import paraformer_from_torch
    from funasr_torch.auto.auto_model import AutoModel
    from funasr_torch.models.paraformer.model import Paraformer

    d, jsonl, cmvn = corpus
    cfg = _write_config(tmp_path, cmvn)
    out = tmp_path / "exp"
    trainer = bin_train.main(["--config", str(cfg), "--train-jsonl", str(jsonl),
                              "--valid-jsonl", str(jsonl), "--output-dir", str(out),
                              "--device", "cpu"])
    log = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    train_losses = [r["loss"] for r in log if "loss" in r]
    assert len(train_losses) == 2 and all(np.isfinite(train_losses))
    assert [r["step"] for r in log if "valid_loss" in r] == [2, 2]
    sd = torch.load(out / "model.avg.pt", weights_only=True)
    assert set(sd) == set(trainer.state.model.state_dict())
    steps = CheckpointManager(str(out / "ckpt")).all_steps()
    assert steps == [2]
    am = AutoModel(model=str(cfg), init_param=str(out / "model.avg.pt"), device="cpu")
    wav = load_audio(str(d / "u3.wav"))
    rec = am.generate(wav)[0]
    direct = Paraformer(vocab_size=8, input_size=560, device="cpu",
                        **{k: v for k, v in am.main_cfg.items()
                           if k in ("encoder_conf", "decoder_conf", "predictor_conf")})
    direct.load_state_dict(sd)
    feats, flens = am.engine.frontend.device_features(torch.from_numpy(wav)[None],
                                                      torch.tensor([len(wav)]))
    toks, tlens, _ = direct.greedy_decode(feats, flens, 16)
    assert dict(rec, key=None) == dict(am.engine._host_results(1, toks, tlens)[0], key=None)
    tree = paraformer_from_torch({k: v.numpy() for k, v in sd.items()})["params"]
    assert {"encoder", "decoder", "predictor"} <= set(tree)


@pytest.mark.parametrize("extra,error", [
    (["--fsdp"], NotImplementedError), (["--model-parallel", "2"], NotImplementedError),
    (["--pipeline-parallel", "2"], NotImplementedError), (["++model=SenseVoiceSmall"],
                                                          NotImplementedError),
    ([], RuntimeError)])
def test_bin_train_refuses_what_is_not_ported(corpus, tmp_path, monkeypatch, extra, error):
    """Multi-chip options and other model classes raise naming ROADMAP; with
    no GPU and no ``--device cpu`` the entry point raises."""
    d, jsonl, cmvn = corpus
    cfg = _write_config(tmp_path, cmvn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--config", str(cfg), "--train-jsonl", str(jsonl), "--output-dir",
            str(tmp_path / "x")] + extra
    with pytest.raises(error, match="ROADMAP" if error is NotImplementedError else "no GPU"):
        bin_train.main(args)
    assert not os.path.exists(tmp_path / "x")
