"""The port's timestamp tools (``funasr_torch/utils/timestamp_tools.py``, a
copy of funasr_tpu/utils/timestamp_tools.py) against their own single-row
form and against the JAX package's, on the CPU.

All of it is float64 numpy on the host, so every comparison is exact.  The
one deliberate change, the batch form's per-row slice sums, makes
``ts_prediction_lfr6_batch`` equal to ``ts_prediction_lfr6_standard`` per
row by construction; the fuzz below also holds rows whose alphas are all
equal or sit on a 1/64 grid (prefix sums landing on the same values, fire
counts that tie with the token count).
"""

import numpy as np
import pytest

from funasr_tpu.utils import timestamp_tools as JT
from funasr_torch.utils import timestamp_tools as TT
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _tracks(rng, case):
    """One padded batch of BiCif-style upsampled tracks, as the JAX
    package's batch fuzz builds them, plus tie rows; padding is poisoned."""
    B = int(rng.integers(1, 9))
    T = int(rng.integers(24, 300))
    alphas = rng.uniform(0.0, 0.2, (B, T))
    peaks = np.zeros((B, T))
    lens = rng.integers(12, T + 1, B)
    toks, offs = [], []
    for i in range(B):
        m = int(lens[i])
        n_tok = int(rng.integers(0, max(m // 4, 2)))
        kind = (case + i) % 7
        if kind == 0 and n_tok:  # exact fire count inside [:m]
            k = min(n_tok + 1, m - 2)
            if k > 0:
                peaks[i, np.sort(rng.choice(np.arange(1, m - 1), k, replace=False))] = 1.0
        elif kind == 1:  # mismatch: the batched renorm refire
            peaks[i, rng.choice(m, size=min(3, m), replace=False)] = 1.0
        elif kind == 2:  # sparse: over-long splits, no renorm
            peaks[i, np.arange(0, m, 13)[: max(n_tok + 1, 2)]] = 1.0
            alphas[i] = 0.0
        elif kind == 3:  # degenerate: < 2 fires
            if rng.random() < 0.5:
                peaks[i, int(rng.integers(m))] = 1.0
            alphas[i] = 0.0
        elif kind == 5:  # ties: every alpha equal
            alphas[i] = 0.125
        elif kind == 6:  # ties: alphas on a 1/64 grid, one fire short
            alphas[i] = rng.integers(0, 13, T) / 64.0
            k = min(n_tok, m - 2)
            if k > 0:
                peaks[i, np.sort(rng.choice(np.arange(1, m - 1), k, replace=False))] = 1.0
        # kind 4: no fires at all, the alphas drive the refire
        peaks[i, m:] = 1.0
        chars = [f"c{j}" for j in range(n_tok)]
        if rng.random() < 0.3:
            chars.append("</s>")
        toks.append(chars)
        offs.append(int(rng.choice([0, 120, 5000])))
    return alphas, peaks, toks, lens, offs


@pytest.mark.parametrize("seed", [11, 12])
def test_batch_equals_single_per_row_and_jax_batch(seed):
    rng = np.random.default_rng(seed)
    for case in range(40):
        alphas, peaks, toks, lens, offs = _tracks(rng, case)
        got = TT.ts_prediction_lfr6_batch(alphas, peaks, toks, lens, offs)
        for i, row in enumerate(got):
            m = int(lens[i])
            _, want = TT.ts_prediction_lfr6_standard(
                alphas[i, :m].copy(), peaks[i, :m].copy(), list(toks[i]),
                vad_offset=offs[i], build_text=False)
            assert row == want, (case, i, row, want)
        assert got == JT.ts_prediction_lfr6_batch(alphas, peaks, toks, lens, offs), case


def test_single_form_matches_jax_and_scalar_fuzz():
    rng = np.random.default_rng(7)
    for case in range(120):
        T = int(rng.integers(12, 400))
        n_tok = int(rng.integers(1, max(T // 4, 2)))
        alphas = rng.uniform(0.0, 0.2, T)
        peaks = np.zeros(T)
        if case % 3 == 0:
            k = min(n_tok + 1, T - 2)
            peaks[np.sort(rng.choice(np.arange(1, T - 1), k, replace=False))] = 1.0
        elif case % 3 == 1:
            peaks[rng.choice(T, size=min(3, T), replace=False)] = 1.0
        chars = [f"c{i}" for i in range(n_tok)]
        off = int(rng.choice([0, 120, 5000]))
        want = JT.ts_prediction_lfr6_standard(alphas.copy(), peaks.copy(), list(chars),
                                              vad_offset=off)
        assert TT.ts_prediction_lfr6_standard(alphas.copy(), peaks.copy(), list(chars),
                                              vad_offset=off) == want
        assert TT._ts_prediction_lfr6_scalar(alphas.copy(), peaks.copy(), list(chars),
                                             vad_offset=off) == want


def test_cif_peaks_stamps_and_sentences_match_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        T = int(rng.integers(5, 60))
        peaks = rng.random(T) < 0.3
        alphas = rng.uniform(0, 1, T)
        toks = [f"t{i}" for i in range(int(rng.integers(0, T)))]
        got = TT.ts_from_cif_peaks(peaks, alphas, toks, vad_offset=40)
        assert got == JT.ts_from_cif_peaks(peaks, alphas, toks, vad_offset=40)
        punc = rng.integers(0, 6, len(toks)).tolist()
        assert (TT.timestamp_sentence(punc, got[1], toks)
                == JT.timestamp_sentence(punc, got[1], toks))
