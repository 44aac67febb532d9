"""The port's CAM++ (``funasr_torch/models/campplus``), its clustering backend
and ``SpkEngine`` against the JAX package on the CPU.

- CAM++, float32: a narrow model with three dense blocks (``CONF``),
  initialised in JAX with its BatchNorm statistics drawn away from (0, 1),
  carried over by ``convert.campplus_from_jax``: embeddings within
  ``EMB_RTOL`` x max|emb| of JAX's at 148 frames (a 1.5 s chunk), 98
  frames (1 s) and an odd 233 (the head's stride-2 convs and the TDNN's
  stride 2 at odd lengths, the segment pooling's short tail); the
  converter round-trips through ``funasr_tpu.convert.campplus_from_torch``.
- ``SpkEngine``: the same embeddings as the JAX engine's for chunks of two
  lengths, in input order, within ``ENGINE_RTOL`` x max|emb|: the port's
  fbank twin and the JAX package's plain fbank differ in float32 rounding
  (``tests/test_torch_fbank.py``), which the layers carry on.
- Clustering: the port's own k-means (numpy) against the JAX package's
  ``sklearn.cluster.KMeans``: equal labels on separable synthetic speakers
  (2, 3 and 4 of them, with the count estimated and given), under 20
  chunks, a ``merge_by_cos`` merge, and ``sv_chunk`` / ``distribute_spk``
  on the JAX tests' cases.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from funasr_tpu.models.campplus import cluster as JC
from funasr_tpu.models.campplus.model import CAMPPlus as JaxCAMPPlus
from funasr_torch.convert import campplus_from_jax
from funasr_torch.models.campplus import cluster as TC
from funasr_torch.models.campplus.model import CAMPPlus
from tests.test_torch_vad import built_once
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CONF = dict(feat_dim=80, embedding_size=24, growth_rate=8, bn_size=2, init_channels=16,
            blocks=((2, 3, 1), (3, 3, 2), (2, 3, 2)))
EMB_RTOL = 1e-4
ENGINE_RTOL = 1e-3


def init_campplus(conf=CONF, seed=0):
    """Jitted JAX init; batch statistics drawn away from mean 0, var 1."""
    return built_once(("init_campplus", repr(conf), seed),
                      lambda: _init_campplus_uncached(conf, seed))


def _init_campplus_uncached(conf=CONF, seed=0):
    jm = JaxCAMPPlus(**conf)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 150, conf["feat_dim"]))))(
        jax.random.PRNGKey(seed))
    v = jax.tree_util.tree_map(np.array, v)
    rng = np.random.default_rng(seed)

    def draw(node):
        for k, x in node.items():
            if isinstance(x, dict):
                draw(x)
            elif k == "mean":
                node[k] = rng.normal(0.0, 0.1, x.shape).astype(np.float32)
            else:
                node[k] = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)

    draw(v["batch_stats"])
    return jm, v


@pytest.fixture(scope="module")
def models():
    jm, v = init_campplus()
    tm = CAMPPlus(**CONF, device="cpu")
    tm.load_state_dict(campplus_from_jax(v), strict=True)
    return jm, v, tm


@pytest.mark.parametrize("frames", [148, 98, 233])
def test_embeddings_match_jax(models, frames):
    jm, v, tm = models
    x = np.random.default_rng(frames).standard_normal((3, frames, 80)).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    got = tm(torch.from_numpy(x))
    assert got.shape == (3, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EMB_RTOL * np.abs(want).max())
    # two inputs' embeddings lie far further apart than the tolerance
    assert np.abs(want[0] - want[1]).max() > 10 * EMB_RTOL * np.abs(want).max()


def test_convert_round_trips_through_jax_converter(models):
    from funasr_tpu.convert import campplus_from_torch

    _, v, tm = models
    back = campplus_from_torch({k: x.numpy() for k, x in tm.state_dict().items()})
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(x) for k, x in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(v), flat(back)
    assert set(want) == set(got)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_published_widths():
    """The defaults are the published CAM++: 80 mels in, 192 out, blocks of
    12, 24 and 16 layers (512 channels after the last transit)."""
    tm = CAMPPlus(device="cpu")
    assert len(tm.xvector["block1"]) == 12 and len(tm.xvector["block2"]) == 24
    assert len(tm.xvector["block3"]) == 16
    assert tm.xvector["dense"].linear.weight.shape == (192, 1024, 1)
    assert tm.xvector["block2"]["tdnnd1"].cam_layer.linear_local.dilation == (2,)
    assert tm.head.conv2.stride == (2, 1)
    assert sum(p.numel() for p in tm.parameters()) > 6_000_000


def test_spk_engine_matches_jax(models):
    from funasr_tpu.auto.engines import SpkEngine as JaxSpkEngine
    from funasr_torch.auto.engines import SpkEngine

    jm, v, tm = models
    rng = np.random.default_rng(2)
    n15, n1 = 24000, 16000
    wavs = []
    for i in range(5):
        n = n15 if i != 2 else n1
        f0 = 180.0 + 60.0 * i
        wavs.append((0.2 * np.sin(2 * np.pi * f0 * np.arange(n) / 16000)
                     + 0.02 * rng.standard_normal(n)).astype(np.float32))
    want = JaxSpkEngine(jm, v).embed(wavs)
    got = SpkEngine(tm).embed(wavs)
    assert got.shape == want.shape == (5, 24)
    np.testing.assert_allclose(got, want, rtol=0, atol=ENGINE_RTOL * np.abs(want).max())
    assert SpkEngine(tm).embed([]).shape == (0, 0)


# ------------------------------------------------------------- clustering
def speakers(k, n=60, dim=32, spread=0.3, seed=0):
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((k, dim))
    lab = rng.integers(0, k, n)
    return (cents[lab] + spread * rng.standard_normal((n, dim))).astype(np.float32)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("oracle", [False, True])
def test_cluster_labels_match_jax(k, oracle):
    emb = speakers(k, seed=k)
    num = k if oracle else None
    want = JC.ClusterBackend()(emb, oracle_num=num)
    got = TC.ClusterBackend()(emb, oracle_num=num)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == k and got[0] == 0


def test_cluster_preset_count_and_few_chunks():
    emb = speakers(3, seed=9)
    for num in (1, 2, 3):
        np.testing.assert_array_equal(TC.ClusterBackend()(emb, oracle_num=num),
                                      JC.ClusterBackend()(emb, oracle_num=num))
    assert (TC.ClusterBackend()(emb, oracle_num=1) == 0).all()
    few = speakers(3, n=19, seed=1)
    assert (TC.ClusterBackend()(few) == 0).all() and (TC.ClusterBackend()(few, 3) == 0).all()
    assert len(TC.ClusterBackend()(np.zeros((0, 8)))) == 0


def test_cluster_merge_by_cos():
    """Two nearby blobs whose centroid cosine exceeds merge_thr collapse into
    one speaker; ``merge_by_cos`` alone merges the closest pair first."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal(16).astype(np.float32)
    a = base + 0.05 * rng.standard_normal((15, 16)).astype(np.float32)
    b = base + 0.05 * rng.standard_normal((15, 16)).astype(np.float32)
    emb = np.concatenate([a, b + 0.2], axis=0)
    got = TC.ClusterBackend(merge_thr=0.78)(emb)
    np.testing.assert_array_equal(got, JC.ClusterBackend(merge_thr=0.78)(emb))
    assert len(set(got.tolist())) == 1
    far = speakers(3, n=30, seed=5)
    labels = np.repeat([2, 0, 1], 10).astype(np.int32)
    for thr in (0.99, -1.0):
        np.testing.assert_array_equal(TC.ClusterBackend().merge_by_cos(far, labels, thr),
                                      JC.ClusterBackend().merge_by_cos(far, labels, thr))
    assert TC.ClusterBackend().merge_by_cos(far, labels, 0.99).tolist()[::10] == [0, 1, 2]


def test_kmeans_finds_the_least_inertia():
    """The port's k-means against scikit-learn's on blobs: the same
    partition, and restarts that keep the lowest inertia."""
    from sklearn.cluster import KMeans

    x = speakers(4, n=80, dim=6, spread=0.4, seed=3).astype(np.float64)
    got = TC.kmeans(x, 4)
    want = KMeans(n_clusters=4, n_init=10, random_state=0).fit(x).labels_
    relabel = lambda lab: TC._in_order_of_appearance(np.asarray(lab))
    np.testing.assert_array_equal(relabel(got), relabel(want))
    assert TC.kmeans(x, 4).tolist() == got.tolist()  # seeded: the same run
    ident = np.repeat(np.eye(3), 4, axis=0)  # coincident points
    assert len(set(TC.kmeans(ident, 3).tolist())) == 3


def test_sv_chunk_and_distribute_match_jax():
    fs = 16000
    for seg in ([0.0, 3.0, np.zeros(3 * fs, np.float32)],
                [1.25, 3.25, np.arange(2 * fs, dtype=np.float32)],
                [4.0, 4.5, np.ones(fs // 2, np.float32)]):
        want, got = JC.sv_chunk(seg, fs=fs), TC.sv_chunk(seg, fs=fs)
        assert [c[:2] for c in got] == [c[:2] for c in want]
        assert all(np.array_equal(a[2], b[2]) and len(a[2]) == int(1.5 * fs)
                   for a, b in zip(got, want))
    assert TC.sv_chunk([0.0, 2.0, np.arange(2 * fs)], fs=fs)[-1][0] == 0.5
    sents = [{"start": 0, "end": 1000}, {"start": 2000, "end": 3000},
             {"start": 5000, "end": 5100}]
    sd = [[0, 1500, 0], [1500, 3000, 1]]
    want = JC.distribute_spk([dict(s) for s in sents], sd)
    got = TC.distribute_spk([dict(s) for s in sents], sd)
    assert got == want and [s["spk"] for s in got] == [0, 1, 0]
