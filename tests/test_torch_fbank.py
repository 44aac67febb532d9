"""Port frontend (funasr_torch/ops/fbank.py, ops/fbank_kernel.py) against
the JAX package on the CPU.

Tolerances: log-mel features atol 1e-3 / rtol 1e-4 and decibels atol 1e-3,
the JAX package's own bar for its fbank kernel in "highest" precision
(tests/test_fbank_pallas.py); tables, LFR, CMVN and padding are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.ops import fbank as JF
from funasr_torch.ops import fbank as TF
from funasr_torch.ops import fbank_kernel as FK
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _wav(rng, lengths, n=None):
    n = n or max(lengths)
    wav = np.zeros((len(lengths), n), np.float32)
    for i, m in enumerate(lengths):
        wav[i, :m] = rng.standard_normal(m).astype(np.float32) * 0.1
    return wav, np.asarray(lengths, np.int32)


def test_tables_match_jax_exactly():
    np.testing.assert_array_equal(TF.kaldi_mel_banks(80, 512, 16000.0),
                                  JF.kaldi_mel_banks(80, 512, 16000.0))
    for a, b in zip(TF._dft_matrices(400, 512), JF._dft_matrices(400, 512)):
        np.testing.assert_array_equal(a, b)
    for w in ("hamming", "hanning", "povey", "rectangular"):
        np.testing.assert_array_equal(TF._window(w, 400), JF._window(w, 400))
    from funasr_tpu.ops.fbank_pallas import _fused_dft

    np.testing.assert_array_equal(FK.fused_dft(), _fused_dft()[:400])


@pytest.mark.parametrize("n", [0, 399, 400, 559, 560, 16000])
def test_num_fbank_frames(n):
    want = JF.num_fbank_frames(n, 400, 160)
    assert TF.num_fbank_frames(n, 400, 160) == want
    got = TF.num_fbank_frames(torch.tensor([n]), 400, 160)
    assert int(got[0]) == want


def test_plain_fbank_matches_jax(rng):
    wav, lens = _wav(rng, [16000, 9000, 4100])
    want, want_lens = JF.fbank(jnp.asarray(wav), jnp.asarray(lens), dither=0.0)
    got, got_lens = TF.fbank(torch.from_numpy(wav), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("with_energy", [False, True])
def test_fbank_ref_matches_pallas_interpret(rng, with_energy):
    from jax.experimental.pallas import tpu as pltpu

    from funasr_tpu.ops.fbank_pallas import fbank_pallas

    wav, lens = _wav(rng, [16000, 9000])
    with pltpu.force_tpu_interpret_mode():
        want = fbank_pallas(jnp.asarray(wav), jnp.asarray(lens), tile_t=32,
                            precision="highest", with_energy=with_energy)
    got = FK.fbank_ref(torch.from_numpy(wav), torch.from_numpy(lens),
                       with_energy=with_energy)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4,
                               atol=1e-3)
    if with_energy:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   atol=1e-3)


def test_fused_fbank_on_cpu_is_the_twin(rng):
    wav, lens = _wav(rng, [8000, 5000])
    before = FK.fused_fbank.launches
    got = FK.fused_fbank(torch.from_numpy(wav), torch.from_numpy(lens),
                         with_energy=True)
    want = FK.fbank_ref(torch.from_numpy(wav), torch.from_numpy(lens),
                        with_energy=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert FK.fused_fbank.launches == before  # no kernel on the CPU


_WINDOWS = ("hamming", "hanning", "povey", "rectangular")


@pytest.mark.parametrize("window", _WINDOWS)
def test_fbank_ref_matches_plain_fbank(rng, window):
    """The fused-operator twin computes the plain kaldi chain, whatever the
    window: the window is one more factor of the operator."""
    wav, lens = _wav(rng, [12000, 6400])
    a, la = FK.fbank_ref(torch.from_numpy(wav), torch.from_numpy(lens),
                         window=window)
    b, lb = TF.fbank(torch.from_numpy(wav), torch.from_numpy(lens),
                     window_type=window)
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("window", _WINDOWS)
def test_frontend_fbank_matches_jax_for_every_window(rng, window):
    """Every 16 kHz window goes through the kernel wrapper (its twin on the
    CPU) and agrees with the JAX package's plain fbank."""
    from funasr_torch.auto.engines import FrontendConfig

    wav, lens = _wav(rng, [16000, 7000])
    before = FK.fused_fbank.launches
    got, got_lens = FrontendConfig(window=window).raw_fbank(
        torch.from_numpy(wav), torch.from_numpy(lens))
    want, want_lens = JF.fbank(jnp.asarray(wav), jnp.asarray(lens), dither=0.0,
                               window_type=window)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    assert FK.fused_fbank.launches == before  # no kernel on the CPU


def test_frontend_other_rate_runs_only_on_the_cpu(rng):
    """The kernel's frames are 16 kHz ones: an 8 kHz frontend uses the plain
    fbank on the CPU and raises for a tensor anywhere else."""
    from funasr_torch.auto.engines import FrontendConfig

    fe = FrontendConfig(fs=8000)
    wav, lens = _wav(rng, [8000, 3000])
    got, got_lens = fe.raw_fbank(torch.from_numpy(wav), torch.from_numpy(lens))
    want, want_lens = TF.fbank(torch.from_numpy(wav), torch.from_numpy(lens),
                               fs=8000)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_lens, want_lens, rtol=0, atol=0)
    with pytest.raises(ValueError):
        fe.raw_fbank(torch.empty((1, 8000), device="meta"),
                     torch.empty((1,), dtype=torch.int32, device="meta"))


def test_raw_fbank_slice_at_hop_aligned_offset(rng):
    """A slice of the fbank grid at a 160-aligned offset equals fbank of
    the sliced waveform (funasr_tpu/auto/engines.py:83-90): the long-audio
    pipeline relies on it."""
    from funasr_torch.auto.engines import FrontendConfig

    fe = FrontendConfig()
    wav = (rng.standard_normal((1, 32000)) * 0.1).astype(np.float32)
    full, _ = fe.raw_fbank(torch.from_numpy(wav), torch.tensor([32000]))
    for off, n in ((160 * 17, 9600), (160 * 60, 16000)):
        part, plens = fe.raw_fbank(torch.from_numpy(wav[:, off:off + n]),
                                   torch.tensor([n]))
        f0 = off // 160
        np.testing.assert_array_equal(part.numpy()[0],
                                      full.numpy()[0, f0:f0 + part.shape[1]])
        assert int(plens[0]) == part.shape[1]


@pytest.mark.parametrize("m,n", [(7, 6), (5, 3), (1, 1)])
def test_lfr_cmvn_pad_match_jax_exactly(rng, m, n):
    feats = rng.standard_normal((3, 37, 8)).astype(np.float32)
    flens = np.array([37, 20, 1], np.int32)
    want, want_lens = JF.apply_lfr(jnp.asarray(feats), jnp.asarray(flens), m, n)
    got, got_lens = TF.apply_lfr(torch.from_numpy(feats),
                                 torch.from_numpy(flens), m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    cmvn = rng.standard_normal((2, 8 * m)).astype(np.float32)
    np.testing.assert_array_equal(
        TF.apply_cmvn(got, torch.from_numpy(cmvn)).numpy(),
        np.asarray(JF.apply_cmvn(want, jnp.asarray(cmvn))))
    np.testing.assert_array_equal(TF.pad_frames(got, 16).numpy(),
                                  np.asarray(JF.pad_frames(want, 16)))


def test_load_cmvn_file_matches_jax(tmp_path):
    means = " ".join(f"{v:.4f}" for v in np.linspace(-3, 3, 6))
    stds = " ".join(f"{v:.4f}" for v in np.linspace(0.1, 1, 6))
    path = tmp_path / "am.mvn"
    path.write_text(
        "<Nnet>\n<Splice> 6 6\n[ 0 ]\n<AddShift> 6 6\n"
        f"<LearnRateCoef> 0 [ {means} ]\n<Rescale> 6 6\n"
        f"<LearnRateCoef> 0 [ {stds} ]\n</Nnet>\n")
    np.testing.assert_array_equal(TF.load_cmvn_file(str(path)),
                                  JF.load_cmvn_file(str(path)))
