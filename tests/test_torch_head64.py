"""The head-size-64 attention of the port (``ops/attention.py``:
``fused_attention`` and the int8 layers' exact-sum entries
``attention_f32ctx`` / ``attention_i8qk``; ``ops/sanm_layer.py`` and
``ops/decoder_layer.py`` at D = 256 with 4 heads) against the JAX package
on the CPU.

The JAX package runs no Pallas kernel at d = 64 (its attention, SANM layer
and decoder layer gates want head sizes of 128), so its serving reference
there is its XLA path:

- ``attention_ref`` (the fused kernel's twin) against the attention of
  ``MultiHeadedAttentionSANM`` as the JAX package computes it on the CPU
  (q scaled by d^-0.5, ``einsum`` scores, ``masked_softmax``, p cast to v's
  dtype, ``einsum``), float32, ragged keys: within 1e-5.
- ``attention_f32ctx_ref`` and ``attention_i8qk_ref`` round q, k, v and p to
  bf16 by contract (and quantize q and k to int8 in the second), so against
  that float32 XLA path they are held to the bf16 / int8 bars: 2^-7 and
  2^-4 of max|v|.
- The bodies of the TPU kernels themselves do run at d = 64 in interpret
  mode: ``sanm_layer_pallas.fused_sanm_layer`` (both the bf16-score and the
  ``int8_attn`` route) and the decoder layer's ``_fused_decoder_layer``,
  with no change to the JAX package, at D = 256, 4 heads.  The port's
  twins (``sanm_layer_ref``, ``decoder_layer_ref``; their attention is
  ``attention_f32ctx_ref`` / ``attention_i8qk_ref``) are held to them with
  ``tests/test_torch_sanm_layer.py``'s and
  ``tests/test_torch_decoder_layer.py``'s bars.
- The exact twins' bits do not depend on the order of the head dimension
  (their sums are float64), which is what lets the card's kernel be
  bit-equal to them at d = 64 as at 128.
- The wrappers take d = 64 (``HEAD_SIZES``, ``EXACT_HEAD_SIZES``) and count
  launches by head size; any other d raises.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.models.paraformer.decoder import _fused_decoder_layer
from funasr_tpu.models.sanm import masked_softmax as jax_masked_softmax
from funasr_tpu.ops import sanm_layer_pallas as JSL
from funasr_torch.ops import attention as A
from funasr_torch.ops import decoder_layer as DL
from funasr_torch.ops import sanm_layer as SL
from tests import test_torch_decoder_layer as TDL
from tests import test_torch_sanm_layer as TSL
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

D, NH, d = 256, 4, 64
F32_TOL = 1e-5


def _inputs(B=3, U=40, T=56, lengths=(56, 33, 7), seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = n(B, U, D), n(B, T, D), n(B, T, D)
    lengths = np.array(lengths, np.int32)
    return q, k, v, lengths


def _jax_xla_attention(q, k, v, lengths):
    """MultiHeadedAttentionSANM's XLA attention (sanm.py:165-182 of the JAX
    package) on float32 q (already scaled), k, v and a key mask."""
    B, U, _ = q.shape
    T = k.shape[1]
    heads = lambda x, n: jnp.asarray(x).reshape(B, n, NH, d).transpose(0, 2, 1, 3)
    scores = jnp.einsum("bhid,bhjd->bhij", heads(q, U), heads(k, T),
                        precision=jax.lax.Precision.HIGHEST)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)[:, None, None, :]
    attn = jax_masked_softmax(scores, jnp.asarray(mask))
    ctx = jnp.einsum("bhij,bhjd->bhid", attn, heads(v, T), precision=jax.lax.Precision.HIGHEST)
    return np.asarray(ctx.transpose(0, 2, 1, 3).reshape(B, U, D))


def _bias(lengths, T):
    return torch.from_numpy(np.where(np.arange(T)[None, :] < lengths[:, None], 0.0,
                                     -1e30).astype(np.float32))


def test_attention_ref_d64_matches_jax_xla():
    q, k, v, lengths = _inputs()
    qs = q * np.float32(d ** -0.5)
    want = _jax_xla_attention(qs, k, v, lengths)
    t = torch.from_numpy
    got = A.attention_ref(t(qs), t(k), t(v), _bias(lengths, k.shape[1]), NH).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)
    assert got.shape == (3, 40, D)


@pytest.mark.parametrize("name,bar", [("f32ctx", 2.0 ** -7), ("i8qk", 2.0 ** -4)])
def test_exact_twins_d64_near_jax_xla(name, bar):
    q, k, v, lengths = _inputs(seed=1)
    # the v rows past the lengths are zeroed by the int8 layers (masked v)
    vm = v * (np.arange(v.shape[1])[None, :, None] < lengths[:, None, None])
    want = _jax_xla_attention(q * np.float32(d ** -0.5), k, vm, lengths)
    t = torch.from_numpy
    ref = getattr(A, f"attention_{name}_ref")
    got = ref(t(q), t(k), t(v), _bias(lengths, k.shape[1]), NH, d ** -0.5,
              t(lengths)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=bar * np.abs(v).max(), rtol=0)
    assert (got != want).mean() > 0.5  # bf16 operands: another function than float32


@pytest.mark.parametrize("name", ["f32ctx", "i8qk"])
def test_exact_twins_d64_bits_do_not_depend_on_head_dim_order(name):
    q, k, v, lengths = _inputs(B=2, U=24, T=40, lengths=(40, 19), seed=2)
    perm = np.random.default_rng(3).permutation(d)
    cols = np.concatenate([h * d + perm for h in range(NH)])  # each head's dims permuted
    t = torch.from_numpy
    ref = getattr(A, f"attention_{name}_ref")
    bias = _bias(lengths, k.shape[1])
    out = ref(t(q), t(k), t(v), bias, NH, d ** -0.5, t(lengths)).numpy()
    qp, kp, vp = (np.ascontiguousarray(x[..., cols]) for x in (q, k, v))
    outp = ref(t(qp), t(kp), t(vp), bias, NH, d ** -0.5, t(lengths)).numpy()
    np.testing.assert_array_equal(outp, out[..., cols])


# ---- the TPU kernels' bodies at d = 64, interpret mode

def _jax_sanm(p, x, lengths, int8_attn):
    j = jnp.asarray
    out = JSL.fused_sanm_layer(
        j(x).astype(jnp.bfloat16), j(lengths), (j(p["ln1"][0]), j(p["ln1"][1])),
        j(p["wqkv"]), j(p["bqkv"]), j(p["fsmn"]), j(p["wout"]), j(p["bout"]),
        (j(p["ln2"][0]), j(p["ln2"][1])), j(p["w1"]), j(p["b1"]), j(p["w2"]),
        j(p["b2"]), n_head=NH, left=TSL.LEFT, right=TSL.K - 1 - TSL.LEFT, interpret=True,
        int8_attn=int8_attn)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("int8_attn", [False, True], ids=["bf16_scores", "int8_scores"])
@pytest.mark.parametrize("T,lengths", [(64, [64, 51, 17]), (40, [40, 1, 33])])
def test_sanm_layer_d64_matches_pallas_interpret(T, lengths, int8_attn):
    p = TSL._params(T)
    rng = np.random.default_rng(T + 1)
    lengths = np.array(lengths, np.int32)
    x = rng.standard_normal((len(lengths), T, D)).astype(np.float32)
    want = _jax_sanm(p, x, lengths, int8_attn)
    got = SL.fused_sanm_layer(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(lengths),
                              TSL._weights(p), NH, TSL.LEFT, int8_attn=int8_attn)
    got = got.float().numpy()
    valid = np.arange(T)[None, :, None] < lengths[:, None, None]
    tol = 2.0 ** -6 * np.abs(want * valid).max()
    np.testing.assert_allclose(got * valid, want * valid, rtol=0, atol=tol)
    assert ((got != want) & valid).sum() <= 0.02 * valid.sum() * D


def test_decoder_layer_d64_matches_pallas_interpret():
    U, T, tl, ml = 32, 48, np.array([32, 20, 0], np.int32), np.array([48, 30, 17], np.int32)
    p = TDL._params(U + T)
    rng = np.random.default_rng(U * T)
    x = rng.standard_normal((3, U, D)).astype(np.float32)
    memory = rng.standard_normal((3, T, D)).astype(np.float32)
    j = jnp.asarray
    lnj = lambda key: (j(p[key][0]), j(p[key][1]))
    want = np.asarray(_fused_decoder_layer(
        j(x).astype(jnp.bfloat16), j(memory).astype(jnp.bfloat16), j(tl), j(ml),
        lnj("ln1"), (j(p["w1"]), j(p["b1"]), lnj("lnf"), j(p["w2"])), lnj("ln2"),
        j(p["fsmn"]), lnj("ln3"),
        (j(p["wq"]), j(p["bq"]), j(p["wkv"]), j(p["bkv"]), j(p["wout"]), j(p["bout"])),
        n_head=NH, left=TDL.LEFT, right=TDL.K - 1 - TDL.LEFT, interpret=True
    ).astype(jnp.float32))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = DL.fused_decoder_layer(bf(x), bf(memory), torch.from_numpy(tl), torch.from_numpy(ml),
                                 TDL._weights(p), NH, TDL.LEFT).float().numpy()
    valid = np.arange(U)[None, :, None] < tl[:, None, None]
    tol = 2.0 ** -6 * np.abs(want * valid).max()
    np.testing.assert_allclose(got * valid, want * valid, rtol=0, atol=tol)
    assert ((got != want) & valid).sum() <= 0.15 * valid.sum() * D


# ---- the wrappers

def test_wrappers_take_head_size_64_and_refuse_others():
    assert 64 in A.HEAD_SIZES and A.EXACT_HEAD_SIZES == (64, 128)
    assert set(A.fused_attention.launches_by_head) == set(A.HEAD_SIZES)
    for fn in (A.attention_f32ctx, A.attention_i8qk):
        assert set(fn.launches_by_head) == set(A.EXACT_HEAD_SIZES)
    q = torch.zeros((1, 4, D))
    bias = torch.zeros((1, 4))
    A._check_qkv("t", q, q, q, bias, NH, A.EXACT_HEAD_SIZES)  # d = 64
    A._check_qkv("t", q, q, q, bias, 8, A.HEAD_SIZES)  # d = 32
    for n_head, sizes in ((8, A.EXACT_HEAD_SIZES), (16, A.HEAD_SIZES), (3, A.HEAD_SIZES)):
        with pytest.raises(ValueError, match="head size"):
            A._check_qkv("t", q, q, q, bias, n_head, sizes)


def test_cpu_wrappers_at_d64_are_the_twins_and_count_nothing():
    q, k, v, lengths = _inputs(B=2, U=8, T=12, lengths=(12, 5), seed=4)
    t = torch.from_numpy
    bias = _bias(lengths, 12)
    before = (A.fused_attention.launches, dict(A.attention_f32ctx.launches_by_head),
              dict(A.attention_i8qk.launches_by_head))
    np.testing.assert_array_equal(A.fused_attention(t(q), t(k), t(v), bias, NH).numpy(),
                                  A.attention_ref(t(q), t(k), t(v), bias, NH).numpy())
    for name in ("f32ctx", "i8qk"):
        got = getattr(A, f"attention_{name}")(t(q), t(k), t(v), bias, NH, 0.125, t(lengths))
        want = getattr(A, f"attention_{name}_ref")(t(q), t(k), t(v), bias, NH, 0.125,
                                                   t(lengths))
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert before == (A.fused_attention.launches, A.attention_f32ctx.launches_by_head,
                      A.attention_i8qk.launches_by_head)


# ---- the int8 layers' GEMMs at D = 256 (B = 32 x 15 s: 32 x 250 rows; the
# decoder's 32 x 128 tokens)

@pytest.mark.parametrize("M,K,N", [(8000, 256, 768), (8000, 256, 256), (8000, 256, 2048),
                                   (8000, 2048, 256), (4096, 256, 256), (4096, 256, 512)])
def test_gemm_plans_at_d256_cover_every_tile_once(M, K, N):
    from tests.test_torch_int8_gemm_plan import _gemm_covers

    _gemm_covers(M, N, K)


@pytest.mark.parametrize("M", [8000, 7750])
def test_rq_plan_at_d256_covers_every_tile_once_with_the_fsmn(M):
    """The SANM wout at D = 256 (N = K = 256, the FSMN's 11 taps in its
    epilogue): the plan fits, covers every tile once, and the arguments the
    layer passes are taken."""
    from funasr_torch.ops import int8_gemm as G

    p = G.rq_plan(M, 256, 256, 132)
    seen = [(m0, n0) for b in range(p.grid) for m0, ns in G.rq_schedule(p, b) for n0 in ns]
    assert len(seen) == len(set(seen)) == p.bands * p.tiles_n
    assert set(seen) == {(m, n) for m in range(0, M, G.RQ_BM) for n in (0, 128)}
    assert p.smem <= G.MAX_SMEM and p.grid <= 132
    B = M // 250
    x = torch.zeros((M, D))
    v = torch.zeros((B, 250, 3 * D))[..., 2 * D:]  # the QKV output's v columns
    w8, sw = torch.zeros((D, D), dtype=torch.int8), torch.ones(D)
    G.check_rq_args(x, w8, sw, G.Fsmn(v, torch.full((B,), 250), torch.zeros((11, D)), 5),
                    bias=torch.zeros(D), res=torch.zeros((M, D)))
