"""The fused links of the int8 layer chains, on the CPU: the int8 GEMM's
row-quantizing entry (``funasr_torch/ops/int8_gemm.py`` ``int8_gemm_rq``:
the SANM layer's ctx -> wout, the row quantize in the A producer and the
FSMN in the epilogue) and the decoder layer's ``fsmn_ln``
(``ops/fsmn.py``).

The kernels run only on the card, where ``chip_smoke.py`` holds them bit
for bit against these twins.  Here: each twin equals the building blocks
it replaces (``rowquant_ref`` + ``fsmn_ref`` + ``int8_gemm_ref``) bit for
bit; the band plan fits the H100's shared memory and covers every tile
once at the served K and at the edges; the FSMN epilogue's row mapping
(each warp's 16 rows, their halo in its buffer, (b, t) = divmod(m, T)),
replayed in plain PyTorch, gives ``fsmn_ref``'s bits on tiles that
straddle utterances; the argument checks raise on what the kernels do not
take.  The layer twins against the JAX kernels are
``test_torch_sanm_layer.py``, ``_decoder_layer`` and ``_ffn_int8``.
"""

import numpy as np
import pytest
import torch

from funasr_torch.ops import fsmn as FS
from funasr_torch.ops import int8_gemm as G
from funasr_torch.ops import rowquant as RQ
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMS = 132  # the H100 SXM


def _rng_tensor(rng, *shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)


def _weights(rng, N, K):
    w8 = torch.from_numpy(rng.integers(-127, 128, (N, K)).astype(np.int8))
    sw = torch.from_numpy((0.01 * rng.random(N)).astype(np.float32))
    return w8, sw


def _fsmn_case(rng, B, T, N, lengths, K=11, left=5):
    qkv = _rng_tensor(rng, B, T, 3 * N)
    return G.Fsmn(qkv[..., 2 * N:], torch.tensor(lengths), _rng_tensor(rng, K, N, scale=0.3),
                  left)


@pytest.mark.parametrize("K", [16, 512, 560, 640])
@pytest.mark.parametrize("res_dtype", [None, torch.float32, torch.bfloat16])
def test_rq_twin_is_rowquant_fsmn_then_gemm(K, res_dtype):
    rng = np.random.default_rng(K)
    B, T, N = 3, 37, 48
    x = _rng_tensor(rng, B * T, K, scale=3.0)
    x[5] = 0  # an all-zero row: scale 1e-8 * f32(1/127)
    w8, sw = _weights(rng, N, K)
    bias = _rng_tensor(rng, N)
    res = None if res_dtype is None else _rng_tensor(rng, B * T, N, dtype=res_dtype)
    fs = _fsmn_case(rng, B, T, N, [37, 20, 0])
    got = G.int8_gemm_rq(x, w8, sw, fs, bias=bias, res=res)  # CPU: the twin
    q, s = RQ.rowquant_ref(x, form="mul")
    mem = FS.fsmn_ref(fs.v, fs.lengths, fs.taps, fs.left).reshape(B * T, N)
    want = G.int8_gemm_ref(q, s, w8, sw, bias=bias, res=res, add=mem)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert float(s[5]) == np.float32(np.float32(1e-8) * np.float32(1 / 127))
    assert not q[5].any()


@pytest.mark.parametrize("res_dtype", [None, torch.float32, torch.bfloat16])
def test_fsmn_ln_twin_is_norm_then_fsmn(res_dtype):
    rng = np.random.default_rng(11)
    B, U, D, K = 3, 37, 64, 11
    h = _rng_tensor(rng, B, U, D, scale=2.0)
    ln = (1 + _rng_tensor(rng, D, scale=0.1), _rng_tensor(rng, D, scale=0.1))
    lengths = torch.tensor([37, 1, 0])
    taps = _rng_tensor(rng, K, D, scale=0.3)
    res = None if res_dtype is None else _rng_tensor(rng, B, U, D, dtype=res_dtype)
    got = FS.fsmn_ln(h, ln, lengths, taps, 5, res=res)
    y = RQ.rowquant_ref(h.reshape(B * U, D), ln, quantize=False).view(B, U, D)
    assert torch.equal(got, FS.fsmn_ref(y, lengths, taps, 5, res=res))


@pytest.mark.parametrize("T,lengths", [(128, [110, 90]), (37, [37, 1, 0]), (1, [1, 0]),
                                       (16, [16, 15]), (17, [17, 16])])
def test_fsmn_ln_blocks_match_the_twin(T, lengths):
    """``fsmn_ln``'s blocks, replayed in plain PyTorch: 16 frames and the
    halo staged with zeros outside the utterance, each row normed and
    multiplied by its length mask once, then the taps outer over the
    frames; the twin's bits."""
    rng = np.random.default_rng(T)
    B, D, K, left, frames = len(lengths), 16, 11, 5, 16
    h = _rng_tensor(rng, B, T, D, scale=2.0)
    ln = (1 + _rng_tensor(rng, D, scale=0.1), _rng_tensor(rng, D, scale=0.1))
    taps = _rng_tensor(rng, K, D, scale=0.3)
    res = _rng_tensor(rng, B, T, D, dtype=torch.bfloat16)
    y = RQ.rowquant_ref(h.reshape(B * T, D), ln, quantize=False).view(B, T, D)
    got = torch.empty(B, T, D)
    for b in range(B):
        L = lengths[b]
        for t0 in range(0, T, frames):
            staged = torch.zeros(frames + K - 1, D)
            for r in range(frames + K - 1):
                s = t0 - left + r
                if 0 <= s < T:
                    staged[r] = y[b, s] * (1.0 if s < L else 0.0)
            for i in range(min(frames, T - t0)):
                acc = staged[i + left]
                for j in range(K):
                    acc = acc + taps[j] * staged[i + j]
                got[b, t0 + i] = res[b, t0 + i].float() + acc * (1.0 if t0 + i < L else 0.0)
    want = FS.fsmn_ln_ref(h, ln, torch.tensor(lengths), taps, left, res=res)
    assert torch.equal(got, want)


# (M, K, N) of the SANM wout at B=64 x 15 s (16384 frames), then edges
RQ_SHAPES = [(16384, 512, 512), (37, 512, 512), (1, 512, 512), (37, 16, 8), (750, 512, 512),
             (1000, 560, 1536), (12256, 256, 2048), (8192, 640, 1024), (256, 128, 4096)]


@pytest.mark.parametrize("M,K,N", RQ_SHAPES)
def test_rq_plan_fits_and_covers_every_tile_once(M, K, N):
    p = G.rq_plan(M, N, K, SMS)
    assert p.smem <= G.MAX_SMEM == 232448 and p.smem == G.rq_smem(p.stages, K)
    assert 2 <= p.stages <= 8 and G.rq_smem(p.stages + 1, K) > G.MAX_SMEM or p.stages == 8
    seen = [(m0, n0) for b in range(p.grid) for m0, ns in G.rq_schedule(p, b) for n0 in ns]
    want = {(m, n) for m in range(0, M, G.RQ_BM) for n in range(0, N, G.RQ_BN)}
    assert len(seen) == len(set(seen)) and set(seen) == want
    assert 1 <= p.grid <= SMS


def test_rq_max_k_is_the_widest_band_that_fits():
    """Two weight stages and both warpgroups' staged v beside a 128-row
    band: K = 640 fits, the next whole stage (768) does not."""
    assert G.rq_smem(2, G.RQ_MAX_K) <= G.MAX_SMEM < G.rq_smem(2, G.RQ_MAX_K + 16)
    assert G.rq_plan(16384, 512, 512, SMS).stages == 3


def test_rq_schedule_starts_each_unit_at_its_own_tile():
    """Unit u begins at its tile u mod count, so the SMs' first epilogues
    write different columns."""
    p = G.rq_plan(16384, 512, 512, SMS)
    firsts = [G.rq_schedule(p, b)[0][1][0] for b in range(p.grid)]
    assert len(set(firsts)) == p.tiles_n


def _fsmn_by_rows(v2, lengths, taps, left, T, M, rows=64):
    """The epilogue's FSMN, replayed tile by tile from ``G.fsmn_rows``: each
    warpgroup's staged v rows and halo, the twin's float32 steps in its
    order, one column vector at a time."""
    K, D = taps.shape
    out = torch.zeros(M, D)
    for m0 in range(0, M, rows):
        staged = torch.zeros(rows + K - 1, D)
        for r in range(rows + K - 1):
            if 0 <= m0 - left + r < M:
                staged[r] = v2[m0 - left + r]
        for i, taps_of_row in enumerate(G.fsmn_rows(T, left, K, m0, rows, M=M)):
            m = m0 + i
            b, t = divmod(m, T)
            L = int(lengths[b])
            valid = 1.0 if t < L else 0.0
            acc = staged[i + left] * valid
            by_j = {r - i: (r, src, s) for r, src, s in taps_of_row}
            for j in range(K):
                if j in by_j:
                    r, src, s = by_j[j]
                    assert 0 <= r < rows + K - 1 and src == m + j - left and src // T == b
                    vm = staged[r] * (1.0 if s < L else 0.0)
                else:
                    vm = torch.zeros(D)
                acc = acc + taps[j] * vm
            out[m] = acc * valid
    return out


@pytest.mark.parametrize("T,lengths", [(250, [250, 200, 0]), (37, [37, 1, 20, 0, 36]),
                                       (1, [1, 0, 1, 1, 1, 0, 1])])
def test_fsmn_epilogue_rows_match_fsmn_ref(T, lengths):
    """Warp tiles of 16 rows straddle utterances (T = 250, 37) or hold many
    (T = 1); the last tile is ragged; lengths of 0 and 1."""
    rng = np.random.default_rng(T)
    B, D, K, left = len(lengths), 8, 11, 5
    M = B * T
    v = _rng_tensor(rng, B, T, D)
    taps = _rng_tensor(rng, K, D, scale=0.3)
    lens = torch.tensor(lengths)
    got = _fsmn_by_rows(v.reshape(M, D), lens, taps, left, T, M)
    assert torch.equal(got, FS.fsmn_ref(v, lens, taps, left).reshape(M, D))


def test_fsmn_rows_halo_stays_in_the_staged_tile():
    for T in (250, 37, 1, 64, 65):
        for m0 in range(0, 3 * T + 64, 64):
            for taps in G.fsmn_rows(T, 5, 11, m0):
                assert all(0 <= r < 64 + 10 for r, _, _ in taps)


def _rq_args(M=64, K=32, N=48, T=32, **kw):
    qkv = torch.zeros(M // T, T, 3 * N)
    args = dict(x=torch.zeros(M, K), w8=torch.zeros((N, K), dtype=torch.int8),
                sw=torch.ones(N), fsmn=G.Fsmn(qkv[..., 2 * N:], torch.tensor([T, 5][:M // T]),
                                              torch.zeros(11, N), 5))
    args.update(kw)
    return args


def test_rq_check_args_accepts_served_operands():
    G.check_rq_args(**_rq_args(), res=torch.zeros(64, 48, dtype=torch.bfloat16),
                    bias=torch.zeros(48))
    G.check_rq_args(**_rq_args(x=torch.zeros(64, 96)[:, 32:64]))  # a 16-byte aligned slice
    G.check_rq_args(**_rq_args(K=G.RQ_MAX_K, w8=torch.zeros((48, G.RQ_MAX_K),
                                                             dtype=torch.int8),
                               x=torch.zeros(64, G.RQ_MAX_K)))


@pytest.mark.parametrize("bad", ["k_not_16", "k_over_max", "misaligned_rows", "x_bf16",
                                 "w_shape", "res_shape", "bias_shape", "fsmn_taps",
                                 "fsmn_left", "fsmn_rows", "fsmn_lengths", "fsmn_v_stride",
                                 "fsmn_v_misaligned"])
def test_rq_check_args_raises(bad):
    fs = _rq_args()["fsmn"]
    kw = {"k_not_16": _rq_args(x=torch.zeros(64, 40), w8=torch.zeros((48, 40),
                                                                     dtype=torch.int8)),
          "k_over_max": _rq_args(x=torch.zeros(64, G.RQ_MAX_K + 16),
                                 w8=torch.zeros((48, G.RQ_MAX_K + 16), dtype=torch.int8)),
          "misaligned_rows": _rq_args(x=torch.zeros(64, 34)[:, :32]),  # 136-byte rows
          "x_bf16": _rq_args(x=torch.zeros(64, 32, dtype=torch.bfloat16)),
          "w_shape": _rq_args(w8=torch.zeros((48, 16), dtype=torch.int8)),
          "res_shape": dict(_rq_args(), res=torch.zeros(48, 64)),
          "bias_shape": dict(_rq_args(), bias=torch.zeros(64)),
          "fsmn_taps": _rq_args(fsmn=fs._replace(taps=torch.zeros(18, 48))),
          "fsmn_left": _rq_args(fsmn=fs._replace(left=11)),
          "fsmn_rows": _rq_args(M=60, x=torch.zeros(60, 32)),
          "fsmn_lengths": _rq_args(fsmn=fs._replace(lengths=torch.tensor([32]))),
          "fsmn_v_stride": _rq_args(fsmn=fs._replace(v=torch.zeros(2, 32, 50)[..., :48])),
          # a v one column into its rows: not 16-byte aligned
          "fsmn_v_misaligned": _rq_args(
              fsmn=fs._replace(v=torch.zeros(2, 32, 3 * 48)[..., 97:145]))
          }[bad]
    with pytest.raises(ValueError):
        G.check_rq_args(**kw)


@pytest.mark.parametrize("which", ["int8_gemm_rq", "fsmn_ln"])
def test_new_wrappers_refuse_other_devices(which):
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if which == "int8_gemm_rq":
            G.int8_gemm_rq(m(4, 16), m(8, 16, dt=torch.int8), m(8),
                           G.Fsmn(m(1, 4, 8), m(1, dt=torch.int32), m(11, 8), 5))
        else:
            FS.fsmn_ln(m(2, 8, 16), (m(16), m(16)), m(2, dt=torch.int32), m(3, 16), 1)
