"""``decoder_layer_ref`` (funasr_torch/ops/decoder_layer.py) against the TPU
kernel path ``decoder._fused_decoder_layer`` (decoder_layer_pallas ``_call``)
run in interpret mode on the CPU.

One set of float32 parameters from a numpy seed, bf16 target and memory,
ragged token and memory lengths, a token length of 0 and a memory length
of 0 (uniform attention over the unmasked memory on both sides).  Same
tolerance and reason as tests/test_torch_sanm_layer.py: on valid rows
atol 2^-6 * max|out| (two bf16 ulps at the output's magnitude).  Here the
FSMN comes after the FFN, so one int8 rounding tie that lands apart in
the FFN spreads to up to 11 rows (the taps), one ulp each: at most 15 % of
the valid elements differ at all.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.models.paraformer.decoder import _fused_decoder_layer
from funasr_torch.ops import decoder_layer as DL
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

D, H, NH, K = 256, 256, 2, 11
LEFT = (K - 1) // 2


def _params(seed):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    ln = lambda w: (1 + 0.1 * n(w), 0.1 * n(w))
    return dict(ln1=ln(D), w1=n(D, H) / np.sqrt(D), b1=0.1 * n(H), lnf=ln(H),
                w2=n(H, D) / np.sqrt(H), ln2=ln(D), fsmn=0.3 * n(K, 1, D),
                ln3=ln(D), wq=n(D, D) / np.sqrt(D), bq=0.1 * n(D),
                wkv=n(D, 2 * D) / np.sqrt(D), bkv=0.1 * n(2 * D),
                wout=n(D, D) / np.sqrt(D), bout=0.1 * n(D))


def _jax(p, x, memory, tl, ml):
    j = jnp.asarray
    lnj = lambda k: (j(p[k][0]), j(p[k][1]))
    out = _fused_decoder_layer(
        j(x).astype(jnp.bfloat16), j(memory).astype(jnp.bfloat16), j(tl), j(ml),
        lnj("ln1"), (j(p["w1"]), j(p["b1"]), lnj("lnf"), j(p["w2"])), lnj("ln2"),
        j(p["fsmn"]), lnj("ln3"),
        (j(p["wq"]), j(p["bq"]), j(p["wkv"]), j(p["bkv"]), j(p["wout"]),
         j(p["bout"])),
        n_head=NH, left=LEFT, right=K - 1 - LEFT, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _weights(p):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    lnt = lambda k: (t(p[k][0]), t(p[k][1]))
    return DL.quantize_decoder_layer(
        lnt("ln1"), t(p["w1"].T), t(p["b1"]), lnt("lnf"), t(p["w2"].T), lnt("ln2"),
        t(np.transpose(p["fsmn"], (2, 1, 0))), lnt("ln3"), t(p["wq"].T), t(p["bq"]),
        t(p["wkv"].T), t(p["bkv"]), t(p["wout"].T), t(p["bout"]))


def _port(w, x, memory, tl, ml):
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    out = DL.fused_decoder_layer(bf(x), bf(memory), torch.from_numpy(tl),
                                 torch.from_numpy(ml), w, NH, LEFT)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("U,T,tl,ml", [(24, 40, [24, 17, 0], [40, 29, 0]),
                                       (16, 64, [9, 16], [1, 64])])
def test_decoder_layer_ref_matches_pallas_interpret(U, T, tl, ml):
    p = _params(U + T)
    rng = np.random.default_rng(U * T)
    tl, ml = np.array(tl, np.int32), np.array(ml, np.int32)
    x = rng.standard_normal((len(tl), U, D)).astype(np.float32)
    memory = rng.standard_normal((len(tl), T, D)).astype(np.float32)
    want = _jax(p, x, memory, tl, ml)
    got = _port(_weights(p), x, memory, tl, ml)
    valid = np.arange(U)[None, :, None] < tl[:, None, None]
    tol = 2.0 ** -6 * np.abs(want * valid).max()
    np.testing.assert_allclose(got * valid, want * valid, rtol=0, atol=tol)
    assert ((got != want) & valid).sum() <= 0.15 * max(valid.sum(), 1) * D
    assert np.isfinite(got).all()


def test_decoder_layer_weights_match_jax_quantization():
    from funasr_tpu.ops.quant import quantize_rows

    p = _params(1)
    w = _weights(p)
    for name, scale in (("w1", "s1"), ("w2", "s2"), ("wq", "sq"), ("wkv", "skv"),
                        ("wout", "sout")):
        q, s = quantize_rows(jnp.asarray(p[name]), axis=0)
        np.testing.assert_array_equal(getattr(w, name).numpy(), np.asarray(q).T)
        np.testing.assert_array_equal(getattr(w, scale).numpy(), np.asarray(s)[0])


def test_memory_quantized_once_gives_the_same_layer():
    """A decoder stack row-quantizes the memory once per batch and passes it
    to every layer: the layer's output is bit-equal to quantizing inside."""
    p = _params(7)
    rng = np.random.default_rng(7)
    tl, ml = np.array([16, 5], np.int32), np.array([40, 12], np.int32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    x = bf(rng.standard_normal((2, 16, D)).astype(np.float32))
    memory = bf(rng.standard_normal((2, 40, D)).astype(np.float32))
    w = _weights(p)
    args = (x, memory, torch.from_numpy(tl), torch.from_numpy(ml), w, NH, LEFT)
    inside = DL.fused_decoder_layer(*args)
    outside = DL.fused_decoder_layer(*args, None, DL.quantize_memory(memory))
    assert torch.equal(inside, outside)
