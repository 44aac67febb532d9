"""``sanm_layer_ref`` (funasr_torch/ops/sanm_layer.py) against the TPU kernel
``sanm_layer_pallas.fused_sanm_layer`` run in interpret mode on the CPU.

One set of float32 parameters from a numpy seed (flax layout on the JAX
side, ``nn.Linear``/``Conv1d`` layout in the port), bf16 input, ragged
lengths.  The two compute the same float32 steps; they differ where the
port sums the layer-norm statistics in float64 and XLA orders the
attention sums and fuses multiply-adds its own way, which moves an int8
rounding tie now and then.  Tolerance on valid rows: atol 2^-6 * max|out|
(two bf16 ulps at the output's magnitude), and at most 2 % of the
elements differ at all.  Padded rows are not part of the contract.  The
same bars hold with ``int8_attn`` (int8 q.k scores with outer-product
scales, sanm_layer_pallas.py:112-117) on the same inputs: the scores are
exact int32 sums on both sides.  There one moved tie in a key's row
quantize shifts that key's score for every query of the utterance, so the
share of differing elements varies more from seed to seed (up to 8 % on
other seeds, always within the atol bar).

T = 264 is past the JAX package's VMEM gate for its fused layer at the
served width (``sanm_layer_pallas.supported``: T > 256 at D = 512 sends the
JAX package to its XLA module path), while the port stays fused at every
length: the case holds the port's fused layer to the TPU kernel's function
there too.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.ops import sanm_layer_pallas as JSL
from funasr_torch.ops import sanm_layer as SL
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

D, H, NH, K = 256, 512, 2, 11
LEFT = (K - 1) // 2


def _params(seed):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(
        ln1=(1 + 0.1 * n(D), 0.1 * n(D)), wqkv=n(D, 3 * D) / np.sqrt(D),
        bqkv=0.1 * n(3 * D), fsmn=0.3 * n(K, 1, D), wout=n(D, D) / np.sqrt(D),
        bout=0.1 * n(D), ln2=(1 + 0.1 * n(D), 0.1 * n(D)),
        w1=n(D, H) / np.sqrt(D), b1=0.1 * n(H), w2=n(H, D) / np.sqrt(H),
        b2=0.1 * n(D))


def _jax(p, x, lengths, int8_attn=False):
    j = jnp.asarray
    out = JSL.fused_sanm_layer(
        j(x).astype(jnp.bfloat16), j(lengths), (j(p["ln1"][0]), j(p["ln1"][1])),
        j(p["wqkv"]), j(p["bqkv"]), j(p["fsmn"]), j(p["wout"]), j(p["bout"]),
        (j(p["ln2"][0]), j(p["ln2"][1])), j(p["w1"]), j(p["b1"]), j(p["w2"]),
        j(p["b2"]), n_head=NH, left=LEFT, right=K - 1 - LEFT, interpret=True,
        int8_attn=int8_attn)
    return np.asarray(out.astype(jnp.float32))


def _weights(p):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return SL.quantize_sanm_layer(
        (t(p["ln1"][0]), t(p["ln1"][1])), t(p["wqkv"].T), t(p["bqkv"]),
        t(np.transpose(p["fsmn"], (2, 1, 0))), t(p["wout"].T), t(p["bout"]),
        (t(p["ln2"][0]), t(p["ln2"][1])), t(p["w1"].T), t(p["b1"]), t(p["w2"].T),
        t(p["b2"]))


def _port(w, x, lengths, int8_attn=False):
    out = SL.fused_sanm_layer(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(lengths), w, NH, LEFT, int8_attn=int8_attn)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("T,lengths", [(64, [64, 51, 17]), (40, [40, 1, 33]),
                                       (264, [264, 201, 37])])
def test_sanm_layer_ref_matches_pallas_interpret(T, lengths):
    p = _params(T)
    rng = np.random.default_rng(T + 1)
    lengths = np.array(lengths, np.int32)
    x = rng.standard_normal((len(lengths), T, D)).astype(np.float32)
    want = _jax(p, x, lengths)
    got = _port(_weights(p), x, lengths)
    valid = np.arange(T)[None, :, None] < lengths[:, None, None]
    tol = 2.0 ** -6 * np.abs(want * valid).max()
    np.testing.assert_allclose(got * valid, want * valid, rtol=0, atol=tol)
    assert ((got != want) & valid).sum() <= 0.02 * valid.sum() * D


@pytest.mark.parametrize("T,lengths", [(64, [64, 51, 17]), (40, [40, 1, 33])])
def test_sanm_layer_int8_attn_ref_matches_pallas_interpret(T, lengths):
    p = _params(T)
    rng = np.random.default_rng(T + 1)
    lengths = np.array(lengths, np.int32)
    x = rng.standard_normal((len(lengths), T, D)).astype(np.float32)
    want = _jax(p, x, lengths, int8_attn=True)
    w = _weights(p)
    got = _port(w, x, lengths, int8_attn=True)
    valid = np.arange(T)[None, :, None] < lengths[:, None, None]
    tol = 2.0 ** -6 * np.abs(want * valid).max()
    np.testing.assert_allclose(got * valid, want * valid, rtol=0, atol=tol)
    assert ((got != want) & valid).sum() <= 0.02 * valid.sum() * D
    # the int8 scores are another function than the bf16 ones
    assert (_port(w, x, lengths) != got).any()


def test_sanm_layer_weights_match_jax_quantization():
    from funasr_tpu.ops.quant import quantize_rows

    p = _params(3)
    w = _weights(p)
    for name, scale in (("wqkv", "sqkv"), ("wout", "sout"), ("w1", "s1"),
                        ("w2", "s2")):
        q, s = quantize_rows(jnp.asarray(p[name]), axis=0)
        np.testing.assert_array_equal(getattr(w, name).numpy(), np.asarray(q).T)
        np.testing.assert_array_equal(getattr(w, scale).numpy(), np.asarray(s)[0])
    np.testing.assert_array_equal(w.taps.numpy(), p["fsmn"][:, 0, :])


def test_valid_rows_do_not_depend_on_padding():
    """As tests/test_sanm_layer_pallas.py:71: garbage in the padded rows
    must not reach a valid row (key mask, masked v, FSMN mask)."""
    T = 48
    p = _params(5)
    w = _weights(p)
    rng = np.random.default_rng(6)
    lengths = np.array([48, 30, 7], np.int32)
    x = rng.standard_normal((3, T, D)).astype(np.float32)
    pad = np.arange(T)[None, :, None] >= lengths[:, None, None]
    x2 = np.where(pad, x + 10 * rng.standard_normal(x.shape).astype(np.float32), x)
    valid = ~pad
    np.testing.assert_array_equal(_port(w, x, lengths) * valid,
                                  _port(w, x2, lengths) * valid)


def test_empty_utterance_row_is_finite():
    T = 16
    w = _weights(_params(7))
    x = np.random.default_rng(8).standard_normal((2, T, D)).astype(np.float32)
    out = _port(w, x, np.array([T, 0], np.int32))
    assert np.isfinite(out).all()
