"""CTC-alignment timestamps of the port's CTC/attention hybrid
(``_HybridModel.decode_beam_align``, ``HybridEngine.transcribe(
with_timestamp=True)`` and ``AutoModel`` with a VAD) against the JAX package
on the CPU.

The tiny Conformers of ``tests/test_torch_conformer.py`` (the model) and
``tests/test_torch_beam.py`` (the engine: its jitted-init fixture, 80 mels),
BatchNorm statistics perturbed, float32; inputs from numpy seeds.

- ``decode_beam_align``: tokens and lengths equal, scores within the beam
  tests' 1e-4, every hypothesis's alignment equal to JAX's frame for frame
  (JAX aligns all K; the port's ``nbest`` rows equal JAX's first rows).
- ``HybridEngine.transcribe(nbest=3, with_timestamp=True, vad_offsets=...)``:
  the records equal the JAX engine's (text, ``timestamp``, ``raw_tokens``
  and ``tokens`` of every n-best entry; scores within ``test_torch_beam.py``'s
  1e-3: the two frontends agree to 1e-3), the 1-best equal to ``nbest[0]``.
- ``AutoModel(Conformer, FSMN-VAD, CT-Transformer).generate`` of
  ``tests/test_torch_vad.py``'s recording: the record (text, ``timestamp``,
  ``sentence_info``) equals the JAX ``AutoModel``'s.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from funasr_tpu.auto.auto_model import AutoModel as JaxAutoModel
from funasr_torch import convert as C
from funasr_torch.auto import engines as TE
from funasr_torch.auto.auto_model import AutoModel
from funasr_torch.models.transformer.model import Conformer
from tests.test_torch_beam import ENGINE_CONF, TOKENS, engines, wavs  # noqa: F401
from tests.test_torch_conformer import CONF, jax_variables
from tests.test_torch_pipeline import (PUNC_CFG, VAD_CFG, _port_frontend, _save, _save_flax,
                                       _save_variables)
from tests.test_torch_vad import CONF as VAD_CONF, calibrated_params, init_params, recording
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCORE_TOL = 1e-4  # test_torch_beam.py's float32 bar
ENGINE_SCORE_TOL = 1e-3  # test_torch_beam.py's engine bar


def test_decode_beam_align_matches_jax():
    jm, variables = jax_variables()
    tm = Conformer(**CONF, device="cpu")
    tm.load_state_dict(C.hybrid_from_jax(variables), strict=True)
    rng = np.random.default_rng(5)
    B, T = 3, 60
    speech = rng.standard_normal((B, T, 20)).astype(np.float32)
    lens = np.array([T, T - 9, T - 23], np.int32)
    kw = dict(beam=4, maxlen=12, decoding_ctc_weight=0.3)
    run = jax.jit(functools.partial(jm.apply, method=jm.decode_beam_align, **kw))
    w_tok, w_len, w_score, w_align, w_el = map(np.asarray, run(
        variables, jnp.asarray(speech), jnp.asarray(lens)))
    x, xl = torch.from_numpy(speech), torch.from_numpy(lens)
    got = tm.decode_beam_align(x, xl, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), w_tok)
    np.testing.assert_array_equal(got.lengths.numpy(), w_len)
    np.testing.assert_allclose(got.scores.numpy(), w_score, rtol=0, atol=SCORE_TOL)
    np.testing.assert_array_equal(got.enc_lens.numpy(), w_el)
    assert got.align.shape == w_align.shape == (B, 4, 14)
    np.testing.assert_array_equal(got.align.numpy(), w_align)
    assert w_len.max() >= 3 and (w_align != 0).sum() >= 5  # labels placed on frames
    # each aligned hypothesis collapses to its tokens
    for b in range(B):
        for k in range(4):
            row = w_align[b, k, : w_el[b]].tolist()
            lab = [t for i, t in enumerate(row) if t and (i == 0 or row[i - 1] != t)]
            assert len(lab) <= w_len[b, k]
    two = tm.decode_beam_align(x, xl, nbest=2, **kw)
    np.testing.assert_array_equal(two.align.numpy(), w_align[:, :2])
    assert two.steps == got.steps > 0


def test_engine_timestamps_match_jax(engines, wavs):  # noqa: F811
    jax_engine, port_engine, _ = engines
    offsets = [0, 800, 12345]
    want = jax_engine.transcribe(wavs, nbest=3, with_timestamp=True, vad_offsets=offsets)
    got = port_engine.transcribe(wavs, nbest=3, with_timestamp=True, vad_offsets=offsets)
    strip = lambda r: {k: v for k, v in r.items() if k not in ("score", "nbest")}
    n_stamps = 0
    for g, w in zip(got, want):
        assert strip(g) == strip(w)
        assert [strip(h) for h in g["nbest"]] == [strip(h) for h in w["nbest"]]
        np.testing.assert_allclose([h["score"] for h in g["nbest"]],
                                   [h["score"] for h in w["nbest"]], atol=ENGINE_SCORE_TOL)
        assert g["timestamp"] == g["nbest"][0]["timestamp"]
        assert g["score"] == g["nbest"][0]["score"]
        for h in g["nbest"]:
            assert len(h["timestamp"]) == len(h["raw_tokens"])
            n_stamps += len(h["timestamp"])
    assert n_stamps >= 6 and got[2]["timestamp"][0][0] >= offsets[2]
    one = port_engine.transcribe(wavs, with_timestamp=True)
    assert [r["timestamp"] for r in one] == [
        [[a - o, b - o] for a, b in r["timestamp"]] for r, o in zip(got, offsets)]


def test_generate_with_vad_matches_jax(tmp_path, engines):  # noqa: F811
    from funasr_tpu.models.ct_transformer.model import CTTransformerModel
    from tests.test_torch_punc import jax_params

    _, _, variables = engines
    cfg = dict(model="Conformer", tokenizer_conf={"token_list": TOKENS},
               frontend_conf=dict(n_mels=80, lfr_m=1, lfr_n=1),
               decoding_conf=dict(beam_size=3, maxlenratio_tokens=8), **ENGINE_CONF)
    vad = calibrated_params(init_params(VAD_CONF, 0)[1], VAD_CONF, _port_frontend())
    punc = jax_params(CTTransformerModel(**{k: v for k, v in PUNC_CFG.items()
                                            if k in ("vocab_size", "embed_unit", "att_unit",
                                                     "encoder_conf")}), 0)
    jam = JaxAutoModel(
        model=dict(cfg, init_param=_save_variables(tmp_path / "j_asr.npz", variables)),
        vad_model=dict(VAD_CFG, init_param=_save_flax(tmp_path / "j_vad.npz", vad["params"])),
        punc_model=dict(PUNC_CFG, init_param=_save_flax(tmp_path / "j_punc.npz",
                                                        punc["params"])))
    am = AutoModel(
        model=dict(cfg, init_param=_save(tmp_path / "asr.npz",
                                         C.hybrid_from_jax(variables))),
        vad_model=dict(VAD_CFG, init_param=_save(tmp_path / "vad.npz",
                                                 C.fsmn_vad_from_jax(vad))),
        punc_model=dict(PUNC_CFG, init_param=_save(tmp_path / "punc.npz",
                                                   C.ct_transformer_from_jax(punc))),
        device="cpu")
    assert isinstance(am.engine, TE.HybridEngine)
    wav = recording(0)
    want = jam.generate(wav, key=["h"])[0]
    got = am.generate(wav, key=["h"])[0]
    assert got == want
    assert got["text"] and got["timestamp"] and got["sentence_info"]
    ts = got["timestamp"]
    assert all(0 <= b <= e <= len(wav) // 16 for b, e in ts)
