"""The fbank kernel's decomposition (funasr_torch/csrc/fbank.cu) on the CPU.

The kernel cannot run here, so a float64 numpy model of its steps, reading
the host tables it reads (``fbank_kernel.kernel_tables``), is held against
the dense float64 operator and ``numpy.fft.rfft``:

- preprocessing of lane n2's sample pairs (32 n1 + 2 n2, +1) as the
  complex input z[16 n1 + n2] = x[2n] + i x[2n+1];
- two 16-point radix-2 passes (decimation in frequency, bins in
  bit-reversed registers) with the host twiddle W256^(n2 k1) between them;
- the split step X[k] = E[k] + W512^k O[k];
- the ranged mel bank and the log.

Tolerances: the spectrum within 1e-9 of each frame's largest bin (float64
rounding of a 512-point transform is about 1e-15 of it); the log-mel
within 1e-9 of the float64 dense route; the served-like signal within
1e-4 of the exact value (chip_smoke.py's bar for the kernel) and within
1e-3 of the float32 twin (``FBANK_TOL``).
"""

import numpy as np
import pytest
import torch

from funasr_torch.ops import fbank_kernel as FK
from funasr_torch.ops.fbank import LOG_EPS, _window, kaldi_mel_banks
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the float64 table's layout, as the TAB_* offsets of csrc/fbank.cu
TAB_TW, TAB_SPLIT, TAB_MEL = 400, 400 + 512, 400 + 1024
WINDOWS = ("hamming", "hanning", "povey", "rectangular")
BITREV4 = np.array([int(f"{r:04b}"[::-1], 2) for r in range(16)])


def fft16_dif(x):
    """The kernel's ``fft16`` on the last axis: natural order in, register
    r holds bin bitrev4(r) out."""
    x = x.copy()
    span = 8
    while span >= 1:
        for start in range(0, 16, 2 * span):
            for j in range(span):
                a, b = start + j, start + j + span
                d = x[..., a] - x[..., b]
                x[..., a] = x[..., a] + x[..., b]
                x[..., b] = d * np.exp(-2j * np.pi * j * (8 // span) / 16)
        span //= 2
    return x


def kernel_model(frames, n_mels, window):
    """float64 model of the kernel on (nF, 400) raw frames in [-1, 1] ->
    spectrum X (nF, 256), power, log-mel (nF, n_mels) and dB (nF,)."""
    tab, idx = FK.kernel_tables(n_mels, window)
    win = tab[:TAB_TW]
    tw = tab[TAB_TW:TAB_TW + 256] + 1j * tab[TAB_TW + 256:TAB_SPLIT]
    split = tab[TAB_SPLIT:TAB_SPLIT + 256] + 1j * tab[TAB_SPLIT + 256:TAB_MEL]
    lo, n, off = idx[:n_mels], idx[n_mels:2 * n_mels], idx[2 * n_mels:]
    w = tab[TAB_MEL:]

    s = frames.astype(np.float64) * 32768.0
    n2, r = np.arange(16)[:, None], np.arange(16)[None, :]  # (lane, register)
    i0 = 32 * r + 2 * n2
    valid = i0 < 400
    i0 = np.where(valid, i0, 0)
    a = np.where(valid, s[:, i0], 0.0)
    c = np.where(valid, s[:, i0 + 1], 0.0)
    mean = (a + c).sum(axis=(1, 2))[:, None, None] / 400
    energy = (a * a + c * c).sum(axis=(1, 2))
    prev = s[:, np.maximum(i0 - 1, 0)] - mean
    z = np.where(valid, win[i0] * ((a - mean) - 0.97 * prev)
                 + 1j * win[i0 + 1] * ((c - mean) - 0.97 * (a - mean)), 0)
    y = fft16_dif(z) * tw[BITREV4[None, :] * 16 + n2]  # lane n2, bin k1
    buf = np.empty_like(y)
    buf[:, :, BITREV4] = y  # [frame, n2, k1]
    z2 = fft16_dif(buf.transpose(0, 2, 1))  # lane k1, register -> k2
    Z = np.empty((len(frames), 256), complex)
    Z[:, (np.arange(16)[:, None] + 16 * BITREV4[None, :]).ravel()] = \
        z2.reshape(len(frames), 256)
    k = np.arange(256)
    A, Bc = Z, np.conj(Z[:, (256 - k) % 256])
    X = 0.5 * (A + Bc) + split * (-0.5j * (A - Bc))
    power = X.real ** 2 + X.imag ** 2
    mel = np.stack([power[:, lo[j]:lo[j] + n[j]] @ w[off[j]:off[j] + n[j]]
                    for j in range(n_mels)], axis=1)
    feats = np.log(np.maximum(mel, LOG_EPS))
    return X, power, feats, 10.0 * np.log(energy + 1e-6) / np.log(10.0)


def preprocessed(frames, window):
    """kaldi preprocessing of raw frames in float64, the plain way."""
    x = frames.astype(np.float64) * 32768.0
    x = x - x.mean(axis=1, keepdims=True)
    x = x - 0.97 * np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    return x * _window(window, 400)


def frame_set(rng, kind):
    t = np.arange(400) / 16000
    voiced = (0.1 * np.sin(2 * np.pi * 155 * t) + 0.05 * np.sin(2 * np.pi * 418 * t)
              + 0.02 * rng.standard_normal((3, 400)))
    if kind == "full":
        return voiced.astype(np.float32)
    if kind == "partly zero":  # an utterance ends inside the frame
        voiced[:, 150:] = 0.0
        return voiced.astype(np.float32)
    return np.zeros((2, 400), np.float32)


@pytest.mark.parametrize("n_mels", [23, 40, 80, 128])
def test_mel_ranges_rebuild_the_bank(n_mels):
    bank = kaldi_mel_banks(n_mels, 512, 16000.0)[:256]
    lo, n, off, w = FK.mel_ranges(n_mels)
    dense = np.zeros_like(bank)
    for j in range(n_mels):
        dense[lo[j]:lo[j] + n[j], j] = w[off[j]:off[j] + n[j]]
        assert np.all(w[off[j]:off[j] + n[j]] != 0)  # contiguous
    np.testing.assert_array_equal(dense, bank)
    assert off[-1] + n[-1] == w.size == np.count_nonzero(bank) <= 512
    assert np.count_nonzero(bank, axis=1).max() <= 2


def test_twiddle_layout():
    tw, split = FK.twiddles()
    k1, n2 = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    np.testing.assert_allclose(tw.reshape(16, 16),
                               np.exp(-2j * np.pi * k1 * n2 / 256), rtol=0, atol=1e-15)
    np.testing.assert_allclose(split, np.exp(-1j * np.pi * np.arange(256) / 256),
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("n_mels", [40, 80])
def test_kernel_table_layout(n_mels):
    tab, idx = FK.kernel_tables(n_mels, "povey")
    lo, n, off, w = FK.mel_ranges(n_mels)
    assert tab.dtype == np.float64 and idx.dtype == np.int32
    np.testing.assert_array_equal(tab[:TAB_TW], _window("povey", 400))
    np.testing.assert_array_equal(tab[TAB_MEL:], w)
    np.testing.assert_array_equal(idx, np.concatenate([lo, n, off]))


@pytest.mark.parametrize("kind", ["full", "partly zero", "all zero"])
@pytest.mark.parametrize("window", WINDOWS)
def test_kernel_model_matches_dense_operator_and_rfft(rng, window, kind):
    frames = frame_set(rng, kind)
    X, power, feats, db = kernel_model(frames, 80, window)
    ri = (frames.astype(np.float64) * 32768.0) @ FK.fused_dft64(window)
    want = ri[:, :256] + 1j * ri[:, 256:]
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(X - want) <= 1e-9 * scale)
    spec = np.fft.rfft(preprocessed(frames, window), n=512)[:, :256]
    assert np.all(np.abs(X - spec) <= 1e-9 * scale)
    mel = kaldi_mel_banks(80, 512, 16000.0)[:256]
    want_feats = np.log(np.maximum((want.real ** 2 + want.imag ** 2) @ mel, LOG_EPS))
    np.testing.assert_allclose(feats, want_feats, rtol=0, atol=1e-9)
    e = (frames.astype(np.float64) * 32768.0) ** 2
    np.testing.assert_allclose(db, 10 * np.log10(e.sum(axis=1) + 1e-6), rtol=1e-12)
    if kind == "all zero":
        assert np.all(X == 0) and np.all(feats == np.float64(np.log(LOG_EPS)))


@pytest.mark.parametrize("window", ["hamming", "rectangular"])
def test_kernel_model_meets_the_chip_bars(rng, window):
    """A voiced row with low noise, as chip_smoke.py's served input: the
    float64 model is within 1e-4 of the exact value and within FBANK_TOL
    (1e-3) of the float32 twin."""
    t = np.arange(16000) / 16000
    wav = (0.1 * np.sin(2 * np.pi * 150 * t) + 0.05 * np.sin(2 * np.pi * 405 * t)
           + 0.02 * rng.standard_normal(16000)).astype(np.float32)
    frames = np.lib.stride_tricks.sliding_window_view(wav, 400)[::160]
    _, _, feats, db = kernel_model(frames, 80, window)
    spec = np.fft.rfft(preprocessed(frames, window), n=512)[:, :256]
    mel = kaldi_mel_banks(80, 512, 16000.0)[:256]
    exact = np.log(np.maximum((np.abs(spec) ** 2) @ mel, LOG_EPS))
    assert np.abs(feats - exact).max() <= 1e-4
    twin = FK.fbank_ref(torch.from_numpy(wav[None]), torch.tensor([16000]),
                        with_energy=True, window=window)
    assert np.abs(feats.astype(np.float32) - twin[0][0].numpy()).max() <= 1e-3
    assert np.abs(db.astype(np.float32) - twin[2][0].numpy()).max() <= 1e-3


def test_served_arguments_pass_check_args():
    FK.check_args(torch.zeros((64, 240000)), 80, "hamming")
    FK.check_args(torch.zeros((1, 16)), 256, "rectangular")


@pytest.mark.parametrize("wav,n_mels,window", [
    (torch.zeros((2, 16000), dtype=torch.float64), 80, "hamming"),
    (torch.zeros((2, 16000), dtype=torch.bfloat16), 80, "hamming"),
    (torch.zeros(16000), 80, "hamming"),
    (torch.zeros((1, 2, 16000)), 80, "hamming"),
    (torch.zeros((2, 16000)), 257, "hamming"),
    (torch.zeros((2, 16000)), 0, "hamming"),
    (torch.zeros((2, 16000)), 80, "blackman"),
], ids=["float64", "bf16", "rank 1", "rank 3", "n_mels 257", "n_mels 0",
        "unknown window"])
def test_check_args_raises(wav, n_mels, window):
    with pytest.raises(ValueError):
        FK.check_args(wav, n_mels, window)


@pytest.mark.parametrize("with_energy", [False, True])
def test_fewer_samples_than_a_frame(with_energy):
    """N = 399: no frame (T = 0), as the kernel's wrapper returns it."""
    out = FK.fused_fbank(torch.zeros((2, 399)), torch.tensor([399, 200]),
                         num_mel_bins=40, with_energy=with_energy)
    assert out[0].shape == (2, 0, 40) and out[0].dtype == torch.float32
    assert out[1].tolist() == [0, 0]
    if with_energy:
        assert out[2].shape == (2, 0)
