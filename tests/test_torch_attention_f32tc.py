"""The float32 attention kernel's arithmetic, emulated in numpy on the CPU.

``csrc/attention.cu`` ``attention_kernel_f32`` runs both products of the
float32 attention on the tensor cores: each operand is split once into two
tf32 values, ``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (rounded as
``cvt.rna.tf32.f32`` rounds: to nearest, ties away from zero), and a product
is ``hi hi + hi lo + lo hi`` accumulated in float32 by three ``mma.sync``
m16n8k8 tf32; one pass over the keys with an online softmax; each tile's
``p v`` in a fresh accumulator folded into O by a float32 FMA; the loop
stops at the last key whose bias is above -1e30.  The card is needed to run
the kernel; these tests run its arithmetic: :func:`kernel_f32` repeats it
step by step, with an mma modelled as exact products summed with its
accumulator and rounded once toward zero (how NVIDIA's tensor cores round
their sums: the conservative model).

- the emulation against the float64 attention, the port's twin
  ``attention_ref`` and the JAX package's ``AltAttention``, at d = 128, 64
  and 32, with and without emotion2vec's ALiBi and extra tokens, on ragged
  key masks (a row with one valid key, one with none), within
  ``SPLIT_TOL``, a tenth of the float32 bar;
- one tf32 product instead of three misses the float32 bar
  (``ATTN_TOL_F32``) at the same inputs: why the split is needed;
- the relabelling of keys within an 8-key step (S's accumulator is p's A
  operand) and of d within 16 columns leaves the products unchanged;
- the fresh accumulator of each tile drifts less than one chain of mma
  over every key;
- every served caller's float32 q, k, v pass the wrapper's 16-byte
  alignment check (the kernel stages 16-byte rows), a shifted k does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.models.emotion2vec import model as JE
from funasr_torch.ops import attention as A
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATTN_TOL_F32 = 1e-4  # chip_smoke.ATTN_TOL["float32"], the kernel's bar on the card
SPLIT_TOL = 1e-5  # the emulated split arithmetic against float64 and the twins
LOG2E = np.float32(1.4426950408889634)
DEAD_BIAS = np.float32(-1e30)
F32, F64 = np.float32, np.float64


def tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 does (the kernel's two integer
    operations), held in a float32."""
    bits = np.ascontiguousarray(x, F32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def split(x):
    x = np.asarray(x, F32)
    hi = tf32(x)
    return hi, tf32(x - hi)


def rz32(x):
    """float64 -> float32 rounded toward zero."""
    r = x.astype(F32)
    up = np.abs(r.astype(F64)) > np.abs(x)
    r[up] = np.nextafter(r[up], F32(0))
    return r


def mma(acc, a, b):
    """acc (..., M, N) float32 plus a (..., M, 8) b (..., 8, N): the products
    exact, summed with acc, rounded once toward zero."""
    return rz32(acc.astype(F64) + a.astype(F64) @ b.astype(F64))


def mma_split(acc, a, b, single=False):
    """acc + a b as the kernel's mma_split (or one tf32 product)."""
    ah, al = split(a)
    bh, bl = split(b)
    if single:
        return mma(acc, ah, bh)
    acc = mma(acc, ah, bl)
    acc = mma(acc, al, bh)
    return mma(acc, ah, bh)


def k_steps(d):
    """The d columns of each 8-deep k-step of q k^T: k-steps 2c and 2c + 1
    take columns 16c + 4t + {0, 1} and {2, 3}, t < 4."""
    out = []
    for c in range(d // 16):
        for e in (0, 2):
            out.append([16 * c + 4 * t + e + x for t in range(4) for x in (0, 1)])
    return out


def kernel_f32(q, k, v, bias, n_head, slopes=None, extra=0, single=False, chain=False):
    """attention_kernel_f32 on numpy float32 q (B, U, H d), k/v (B, T, H d),
    bias (B, T); ``slopes`` (H,) adds the ALiBi term; ``single`` takes one
    tf32 product for each split; ``chain`` accumulates p v in O directly."""
    B, U, D = q.shape
    T = k.shape[1]
    H, d = n_head, D // n_head
    BK = 32 if d == 128 else 64
    qh, kh, vh = (x.reshape(B, -1, H, d).transpose(0, 2, 1, 3) for x in (q, k, v))
    u = np.arange(U)[:, None]
    out = np.empty((B, H, U, d), F32)
    for b in range(B):
        live = np.nonzero(bias[b] > DEAD_BIAS)[0]
        kend = T if live.size == 0 else live[-1] + 1
        m = np.full((H, U), -np.inf, F32)
        l = np.zeros((H, U), F32)
        o = np.zeros((H, U, d), F32)
        for k0 in range(0, kend, BK):
            keys = np.arange(k0, k0 + BK)
            ok = keys < T
            kt = np.zeros((H, BK, d), F32)  # rows past T are zero-filled
            vt = np.zeros((H, BK, d), F32)
            kt[:, ok], vt[:, ok] = kh[b][:, keys[ok]], vh[b][:, keys[ok]]
            s = np.zeros((H, U, BK), F32)
            for cols in k_steps(d):
                s = mma_split(s, qh[b][:, :, cols], kt[:, :, cols].transpose(0, 2, 1), single)
            s = s + np.where(ok, bias[b][np.minimum(keys, T - 1)], F32(-np.inf)).astype(F32)
            if slopes is not None:
                j = keys[None, :]
                dist = np.abs(u - j).astype(F32)
                term = np.where((u < extra) | (j < extra), F32(0),
                                -(slopes[:, None, None] * dist)).astype(F32)
                s = s + term
            mn = np.maximum(m, s.max(-1))
            with np.errstate(invalid="ignore"):
                alpha = np.where(m == -np.inf, F32(0), np.exp2((m - mn) * LOG2E)).astype(F32)
            mref = np.where(mn == -np.inf, F32(0), mn).astype(F32)
            p = np.exp2((s - mref[..., None]) * LOG2E).astype(F32)
            l = (l * alpha + p.sum(-1, dtype=F32)).astype(F32)
            m = mn
            if chain:
                o = (o * alpha[..., None]).astype(F32)
                for j8 in range(BK // 8):
                    o = mma_split(o, p[..., 8 * j8:8 * j8 + 8], vt[:, 8 * j8:8 * j8 + 8], single)
                continue
            pv = np.zeros((H, U, d), F32)
            for j8 in range(BK // 8):
                pv = mma_split(pv, p[..., 8 * j8:8 * j8 + 8], vt[:, 8 * j8:8 * j8 + 8], single)
            o = (o.astype(F64) * alpha[..., None].astype(F64) + pv).astype(F32)  # fmaf
        out[b] = o * (F32(1) / l)[..., None]
    return out.transpose(0, 2, 1, 3).reshape(B, U, D)


def attention_f64(q, k, v, bias, n_head, slopes=None, extra=0):
    """The float64 attention of the kernel's contract."""
    B, U, D = q.shape
    T = k.shape[1]
    d = D // n_head
    qh, kh, vh = (x.astype(F64).reshape(B, -1, n_head, d).transpose(0, 2, 1, 3)
                  for x in (q, k, v))
    s = qh @ kh.transpose(0, 1, 3, 2) + bias.astype(F64)[:, None, None, :]
    if slopes is not None:
        u, j = np.arange(U)[:, None], np.arange(T)[None, :]
        term = -(slopes.astype(F64)[:, None, None] * np.abs(u - j))
        s = s + np.where((u < extra) | (j < extra), 0.0, term)[None]
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return (p @ vh).transpose(0, 2, 1, 3).reshape(B, U, D)


def inputs(d, alibi, B=3, T=75, H=2, seed=0):
    """Self-attention over T positions (emotion2vec-like: 10 extra tokens,
    ragged keys, scale-0.8 ALiBi slopes) with k and v column slices of one
    projection; row 1 has one valid key, the last row none."""
    rng = np.random.default_rng(seed + d + 7 * alibi)
    D = H * d
    qkv = rng.standard_normal((B, T, 3 * D)).astype(F32)
    q = qkv[..., :D] * F32(d ** -0.5)
    k, v = qkv[..., D:2 * D], qkv[..., 2 * D:]
    lens = np.array([T, 1] + [int(rng.integers(2, T))] * (B - 3) + [0])[:B]
    bias = np.where(np.arange(T)[None] < lens[:, None], F32(0), DEAD_BIAS).astype(F32)
    slopes = (JE.alibi_slopes(H) * 0.8).astype(F32) if alibi else None
    return q, k, v, bias, H, slopes, (10 if alibi else 0)


def torch_ref(q, k, v, bias, H, slopes, extra):
    t = torch.from_numpy
    return A.attention_ref(t(q), t(np.ascontiguousarray(k)), t(np.ascontiguousarray(v)),
                           t(bias), H, None if slopes is None else t(slopes), extra).numpy()


@pytest.mark.parametrize("d", [128, 64, 32])
@pytest.mark.parametrize("alibi", [False, True], ids=["plain", "alibi"])
def test_split_emulation_matches_float64_and_the_twin(d, alibi):
    q, k, v, bias, H, slopes, extra = inputs(d, alibi)
    got = kernel_f32(q, k, v, bias, H, slopes, extra)
    want = attention_f64(q, k, v, bias, H, slopes, extra)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= SPLIT_TOL
    np.testing.assert_allclose(got, torch_ref(q, k, v, bias, H, slopes, extra),
                               atol=SPLIT_TOL, rtol=0)
    # the row with no valid key: uniform weights over all T keys
    np.testing.assert_allclose(got[-1], np.broadcast_to(v[-1].astype(F64).mean(0), got[-1].shape),
                               atol=SPLIT_TOL, rtol=0)


@pytest.mark.parametrize("d", [128, 64, 32])
def test_single_tf32_product_misses_the_float32_bar(d):
    q, k, v, bias, H, slopes, extra = inputs(d, True)
    want = attention_f64(q, k, v, bias, H, slopes, extra)
    split_err = np.abs(kernel_f32(q, k, v, bias, H, slopes, extra) - want).max()
    single_err = np.abs(kernel_f32(q, k, v, bias, H, slopes, extra, single=True) - want).max()
    assert split_err <= SPLIT_TOL < ATTN_TOL_F32 < single_err


@pytest.mark.parametrize("d", [128, 64, 32])
def test_split_emulation_matches_jax_alt_attention(d):
    """JAX ``AltAttention`` (qkv, ALiBi padded for 10 extra tokens, a ragged
    key mask, proj) at 2 heads of d: its qkv projection through the
    emulated kernel and its proj reproduce its output."""
    H, B, T, ex = 2, 2, 75, 10
    C = H * d
    rng = np.random.default_rng(d)
    x = rng.standard_normal((B, T, C)).astype(F32)
    mask = np.arange(T)[None] < np.array([T, T - 29])[:, None]
    alibi = np.pad(JE.symmetric_alibi(T - ex, H).astype(F32),
                   ((0, 0), (ex, 0), (ex, 0)))[None]
    mod = JE.AltAttention(C, H)
    params = mod.init(jax.random.PRNGKey(d), jnp.asarray(x), jnp.asarray(alibi),
                      jnp.asarray(mask))
    want, state = mod.apply(params, jnp.asarray(x), jnp.asarray(alibi), jnp.asarray(mask),
                            capture_intermediates=True)
    qkv = np.asarray(state["intermediates"]["qkv"]["__call__"][0])
    q = qkv[..., :C] * F32(d ** -0.5)
    k, v = qkv[..., C:2 * C], qkv[..., 2 * C:]
    bias = np.where(mask, F32(0), DEAD_BIAS).astype(F32)
    slopes = JE.alibi_slopes(H).astype(F32)
    ctx = kernel_f32(q, k, v, bias, H, slopes, ex)
    proj = jax.tree_util.tree_map(np.asarray, params["params"]["proj"])
    got = ctx.astype(F64) @ proj["kernel"].astype(F64) + proj["bias"]
    np.testing.assert_allclose(got, np.asarray(want), atol=SPLIT_TOL, rtol=0)
    np.testing.assert_allclose(ctx, torch_ref(q, k, v, bias, H, slopes, ex), atol=SPLIT_TOL,
                               rtol=0)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The kernel's two integer operations give tf32 rounded to nearest,
    ties away from zero (cvt.rna), carry into the exponent included; hi +
    lo is x to within 2^-22 |x|."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-30, 30, 4096))).astype(F32)
    ties = (np.float32(1.0) + np.arange(1, 64, dtype=F32) * np.float32(2.0 ** -11))  # k odd: halfway cases
    x = np.concatenate([x, ties, -ties, [F32(2.0 - 2.0 ** -23), F32(1.0 - 2.0 ** -24)]]).astype(F32)
    mant, ex = np.frexp(x.astype(F64))  # |mant| in [0.5, 1): 11 bits kept
    want = np.sign(mant) * np.floor(np.abs(mant) * 2.0 ** 11 + 0.5) * 2.0 ** (ex - 11)
    np.testing.assert_array_equal(tf32(x).astype(F64), want)
    hi, lo = split(x)
    assert (np.abs(x.astype(F64) - hi - lo) <= 2.0 ** -22 * np.abs(x)).all()
    assert (tf32(hi) == hi).all() and (tf32(lo) == lo).all()


def test_key_relabelling_keeps_p_v():
    """S's B column n is key (n >> 1) + 4 (n & 1): the accumulator of lane
    (g, t) holds, at columns 2t and 2t + 1, keys t and t + 4, which are p's
    A-operand columns t and t + 4 in the order the kernel passes them
    ({c0, c2, c1, c3}); and permuting an 8-key step's p columns with V's rows
    (or q's and k's d columns) leaves the product unchanged."""
    key_of_col = [(n >> 1) + 4 * (n & 1) for n in range(8)]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        acc = [(g, key_of_col[2 * t]), (g, key_of_col[2 * t + 1]),
               (g + 8, key_of_col[2 * t]), (g + 8, key_of_col[2 * t + 1])]
        a_operand = [(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)]  # (row, key)
        assert [acc[i] for i in (0, 2, 1, 3)] == a_operand
    rng = np.random.default_rng(2)
    p = rng.integers(-8, 9, (16, 8)).astype(F64)
    vv = rng.integers(-8, 9, (8, 32)).astype(F64)
    perm = np.array(key_of_col)
    np.testing.assert_array_equal(p[:, perm] @ vv[perm], p @ vv)
    cols = np.concatenate(k_steps(64))
    assert sorted(cols) == list(range(64))
    qq = rng.integers(-8, 9, (16, 64)).astype(F64)
    kk = rng.integers(-8, 9, (64, 64)).astype(F64)
    np.testing.assert_array_equal(qq[:, cols] @ kk[:, cols].T, qq @ kk.T)
    # and the emulated kernel, which runs both relabellings, at a tile edge
    q, k, v, bias, H, slopes, extra = inputs(32, False, B=3, T=9)
    np.testing.assert_allclose(kernel_f32(q, k, v, bias, H), attention_f64(q, k, v, bias, H),
                               atol=SPLIT_TOL, rtol=0)


def test_fresh_tile_accumulator_drifts_less_than_one_chain():
    """Over 768 keys (12 tiles) the p v chain of 3 x 96 mma into one
    accumulator, each rounded toward zero, drifts; the kernel's fresh
    accumulator a tile, folded by a float32 FMA, stays closer to float64."""
    q, k, v, bias, H, slopes, extra = inputs(64, False, B=1, T=768, H=2, seed=5)
    want = attention_f64(q, k, v, bias, H)
    fresh = np.abs(kernel_f32(q, k, v, bias, H) - want).max()
    chain = np.abs(kernel_f32(q, k, v, bias, H, chain=True) - want).max()
    assert fresh <= SPLIT_TOL and 2 * fresh < chain


def served_layout(name):
    """q, k, v (float32) as each served caller hands them to fused_attention."""
    z = torch.zeros
    if name == "SANM linear_q_k_v split":
        q, k, v = z((2, 37, 3 * 512)).split(512, dim=-1)
        return q * 0.1, k, v
    if name == "decoder linear_k_v split":
        k, v = z((2, 37, 2 * 512)).split(512, dim=-1)
        return z((2, 5, 512)), k, v
    if name == "streaming [cache | window] (1, 55, 1024)":
        full = torch.cat([z((1, 40, 1024)), torch.cat([z((1, 15, 512)), z((1, 15, 512))], -1)], 1)
        return z((1, 15, 512)), full[..., :512], full[..., 512:]
    if name == "emotion2vec qkv (8, 759, 2304)":
        qkv = z((8, 759, 3 * 768))
        return qkv[..., :768] * 0.125, qkv[..., 768:1536], qkv[..., 1536:]
    cache = z((8, 65, 1280))  # Whisper's preallocated self-attention cache
    return z((8, 1, 1280)), cache, cache


@pytest.mark.parametrize("name", ["SANM linear_q_k_v split", "decoder linear_k_v split",
                                  "streaming [cache | window] (1, 55, 1024)",
                                  "emotion2vec qkv (8, 759, 2304)", "Whisper cache (8, 65, 1280)"])
def test_served_float32_layouts_pass_the_alignment_check(name):
    """The float32 kernel stages 16-byte rows: every served caller's q, k, v
    pass the wrapper's check, and the same k a float32 off raises."""
    q, k, v = served_layout(name)
    A._check_aligned("fused_attention", q, k, v)
    shifted = torch.zeros((k.shape[0], k.shape[1], k.shape[2] + 1))[..., 1:]
    with pytest.raises(ValueError, match="fused_attention"):
        A._check_aligned("fused_attention", q, shifted, v)
