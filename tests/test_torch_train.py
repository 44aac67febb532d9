"""The port's Paraformer training step against the JAX package, on the CPU.

A tiny Paraformer (V=24, D=16, 2 heads, 2 encoder + 1+1+1 decoder layers,
dropout 0) gets seeded random weights once in the port; they go to the JAX
package through ``funasr_tpu.convert.paraformer_from_torch`` and back
through ``funasr_torch.convert.paraformer_from_jax``, and the JAX gradient
trees through the same map.  Inputs come from numpy with a seed.  Tolerances, float32 (summation
order differs between XLA and PyTorch):

- losses and statistics rtol 1e-5; ``grad_norm`` rtol 1e-5;
- gradients: every parameter within 1e-5 of JAX's, relative to that
  parameter's largest JAX gradient;
- parameters after three ``accum_grad=2`` steps (adam, warmuplr, clip 5):
  within 5e-5, except the key projections' biases:
  softmax is invariant to them, their true gradient is 0 and both packages
  hold float noise there, which Adam scales to about one learning rate a
  step, so they are held to the sum of the three steps' learning rates;
- the bf16-compute step: the measured bars stated at its test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from funasr_tpu import losses as JL
from funasr_tpu.convert import paraformer_from_torch
from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu.train import optim as JO
from funasr_tpu.train.train_step import create_train_state as jax_state
from funasr_tpu.train.train_step import make_train_step as jax_make_step
from funasr_torch import losses as TL
from funasr_torch.convert import paraformer_from_jax
from funasr_torch.models.paraformer.model import (Paraformer, add_eos, glancing_swap,
                                                  init_random_)
from funasr_torch.ops import attention as A
from funasr_torch.train import optim as TO
from funasr_torch.train.train_step import create_train_state, make_train_step
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

V, IN, D = 24, 16, 16
ENC = dict(output_size=D, attention_heads=2, linear_units=32, num_blocks=2,
           kernel_size=3, dropout_rate=0.0)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=2, att_layer_num=1,
           kernel_size=3, dropout_rate=0.0)
PRED = dict(idim=D, l_order=1, r_order=1, tail_threshold=0.45, dropout=0.0)
CONF = dict(vocab_size=V, input_size=IN, encoder_conf=ENC, decoder_conf=DEC,
            predictor_conf=PRED)
ACC, B, T, U = 2, 3, 24, 5
OPT = dict(lr=0.01)
SCHED = dict(warmup_steps=3)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ACC, B, T, IN)).astype(np.float32)
    xl = np.array([[24, 19, 11], [22, 24, 16]], np.int32)
    y = rng.integers(3, V, (ACC, B, U)).astype(np.int32)
    yl = np.array([[5, 3, 4], [2, 5, 5]], np.int32)
    for a in range(ACC):
        for b in range(B):
            y[a, b, yl[a, b]:] = -1
    return dict(speech=x, speech_lengths=xl, text=y, text_lengths=yl)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jax_init():
    """Seeded random weights, built by the port and carried to the JAX tree by
    ``funasr_tpu.convert.paraformer_from_torch`` (no JAX init to compile);
    the tree holds the decoder's token embedding."""
    tm = Paraformer(**CONF, device="cpu")
    init_random_(tm, torch.Generator().manual_seed(0))
    return paraformer_from_torch({k: v.numpy() for k, v in tm.state_dict().items()})


def _port(params, sampling_ratio=0.0, **kw):
    tm = Paraformer(**CONF, sampling_ratio=sampling_ratio, device="cpu", **kw)
    tm.load_state_dict(paraformer_from_jax(params), strict=True)
    return tm


@pytest.fixture(scope="module")
def jax_steps(jax_init):
    """Three float32 ``accum_grad=2`` JAX steps (adam, warmuplr, clip 5) and
    a fourth on a NaN batch, with their statistics."""
    jm = JaxParaformer(**CONF, sampling_ratio=0.0)
    tx, _ = JO.build_optimizer("adam", OPT, "warmuplr", SCHED, grad_clip=5.0)
    step = jax.jit(jax_make_step(jm, tx, accum_grad=2))
    state, stats = jax_state(jax_init, tx), []
    for i in range(3):
        state, st = step(state, _batch(), jax.random.PRNGKey(i))
        stats.append({k: float(v) for k, v in st.items()})
    bad = _batch()
    bad["speech"][1, 0, 3, 2] = np.nan
    after, st = step(state, bad, jax.random.PRNGKey(3))
    to_np = lambda s: jax.tree_util.tree_map(np.asarray, s)
    return to_np(state), stats, to_np(after), {k: float(v) for k, v in st.items()}


# ---------------------------------------------------------------- losses
@pytest.mark.parametrize("smoothing,normalize", [(0.0, False), (0.1, False), (0.1, True),
                                                 (0.3, True)])
def test_label_smoothing_loss(smoothing, normalize):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 6, 11)).astype(np.float32) * 3
    tgt = rng.integers(0, 11, (3, 6)).astype(np.int32)
    tgt[1, 4:] = -1
    tgt[2, 1:] = -1
    want = JL.label_smoothing_loss(logits, tgt, -1, smoothing, normalize)
    got = TL.label_smoothing_loss(_t(logits), _t(tgt), -1, smoothing, normalize)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_accuracy_and_mae_loss():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((4, 5, 7)).astype(np.float32)
    tgt = rng.integers(0, 7, (4, 5)).astype(np.int32)
    tgt[0, 2:] = -1
    tgt[:, 0] = np.argmax(logits[:, 0], -1)
    assert TL.th_accuracy(_t(logits), _t(tgt)).item() == float(JL.th_accuracy(logits, tgt))
    tl = np.array([4, 7, 1, 0], np.int32)
    pl = rng.uniform(0, 8, 4).astype(np.float32)
    for norm in (False, True):
        np.testing.assert_allclose(TL.mae_length_loss(_t(tl), _t(pl), norm).item(),
                                   float(JL.mae_length_loss(tl, pl, norm)), rtol=1e-6)


def test_ctc_loss_matches_optax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 12, 9)).astype(np.float32)
    lens = np.array([12, 9, 7], np.int32)
    tgt = rng.integers(1, 9, (3, 4)).astype(np.int32)
    tl = np.array([4, 2, 3], np.int32)
    for b in range(3):
        tgt[b, tl[b]:] = -1
    want = float(jax.jit(JL.ctc_loss)(logits, lens, tgt, tl))
    got = TL.ctc_loss(_t(logits), _t(lens), _t(tgt), _t(tl)).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ------------------------------------------------------ schedules, updates
@pytest.mark.parametrize("name,conf", [
    ("warmuplr", dict(warmup_steps=7)), ("noamlr", dict(model_size=64, warmup_steps=5)),
    ("tri_stage", dict(total_steps=40, phase_ratio=(0.1, 0.3, 0.6))), ("constant", {})])
def test_schedules_match_jax(name, conf):
    jax_sched = JO.SCHEDULER_BUILDERS[name](2e-3, conf)
    port_sched = TO.SCHEDULER_BUILDERS[name](2e-3, conf)
    for step in (0, 1, 3, 4, 7, 12, 16, 39, 55):
        want = float(jax_sched(jnp.asarray(step, jnp.int32)))
        got = port_sched(torch.tensor(step, dtype=torch.int32)).item()
        np.testing.assert_allclose(got, want, rtol=2e-7, err_msg=f"{name} at {step}")


@pytest.mark.parametrize("optim,conf,clip", [
    ("adam", dict(lr=0.05), 5.0), ("fairseq_adam", dict(lr=0.05, b2=0.98), 0.5),
    ("adamw", dict(lr=0.05, weight_decay=0.1), 5.0), ("adamw", dict(lr=0.05), 0.0),
    ("sgd", dict(lr=0.1), 1.0), ("sgd", dict(lr=0.1, momentum=0.9, nesterov=True), 5.0)])
def test_optimizer_updates_match_optax(optim, conf, clip):
    """Three updates of the optax chain and of the port's, from the same
    parameters and gradients (one clipped step, one not)."""
    rng = np.random.default_rng(4)
    p = rng.standard_normal(40).astype(np.float32)
    jtx, _ = JO.build_optimizer(optim, conf, "warmuplr", dict(warmup_steps=2), clip)
    ttx, _ = TO.build_optimizer(optim, conf, "warmuplr", dict(warmup_steps=2), clip)
    jp, js = jnp.asarray(p), jtx.init(jnp.asarray(p))
    tp = _t(p)
    ts = ttx.init(tp)
    for scale in (3.0, 0.01, 1.0):
        g = (rng.standard_normal(40) * scale).astype(np.float32)
        ju, js = jtx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(_t(g), ts, tp)
        tp = tp + tu
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    assert int(ts["count"]) == 3


def test_global_norm_sums_pairwise():
    """The clip's norm over 3M float32 elements within 1e-6 of float64 (the
    CPU's ``vector_norm`` sums in sequence and drifts with the count)."""
    g = torch.randn(3_000_000, generator=torch.Generator().manual_seed(0)) * 1e-2
    want = g.double().norm().item()
    assert abs(TO.global_norm(g).item() - want) <= 1e-6 * want


def test_optimizer_defaults_are_optax():
    tx, _ = TO.build_optimizer("adamw", dict(lr=1e-3))
    assert tx.weight_decay == 1e-4 and tx.grad_clip == 5.0
    with pytest.raises(TypeError, match="unexpected"):
        TO.build_optimizer("adam", dict(lr=1e-3, weight_decay=0.1))
    with pytest.raises(KeyError):
        TO.build_optimizer("lamb")


# ------------------------------------------------------ the training forward
@pytest.fixture(scope="module")
def ctc_grads(jax_init):
    """``jax.value_and_grad`` of the JAX training forward (dropout 0, sampler
    off) with a CTC head (``ctc_weight`` 0.3) on micro-batch 0, and the
    port's state dict of the same weights."""
    tm = Paraformer(**CONF, ctc_weight=0.3, device="cpu")
    init_random_(tm.ctc, torch.Generator().manual_seed(1))
    sd = dict(paraformer_from_jax(jax_init), **{k: v for k, v in tm.state_dict().items()
                                                 if k.startswith("ctc.")})
    params = paraformer_from_torch({k: v.numpy() for k, v in sd.items()})
    jm = JaxParaformer(**CONF, ctc_weight=0.3, sampling_ratio=0.0)
    b = {k: v[0] for k, v in _batch().items()}

    def loss_fn(p):
        return jm.apply(p, b["speech"], b["speech_lengths"], b["text"], b["text_lengths"],
                        deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1), "sampler": jax.random.PRNGKey(2)})

    (_, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    jstats = {k: float(v) for k, v in jstats.items()}
    return sd, b, jstats, paraformer_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))


def _port_ctc(sd):
    tm = Paraformer(**CONF, ctc_weight=0.3, sampling_ratio=0.0, device="cpu")
    tm.load_state_dict(sd, strict=True)
    return tm.train()


def test_training_forward_and_gradients_match_jax(ctc_grads):
    """loss, stats and every parameter's gradient, the CTC head's included,
    against ``jax.value_and_grad`` (dropout 0, sampler off)."""
    sd, b, jstats, want = ctc_grads
    tm = _port_ctc(sd)
    loss, stats = tm(*(_t(b[k]) for k in ("speech", "speech_lengths", "text",
                                          "text_lengths")))
    loss.backward()
    assert set(stats) == set(jstats) == {"loss_att", "loss_pre", "loss_ctc", "acc", "loss",
                                         "batch_size"}
    for k in stats:
        np.testing.assert_allclose(stats[k].item(), jstats[k], rtol=1e-5, err_msg=k)
    for name, p in tm.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(want[name].numpy()).max(), 1e-3)
        np.testing.assert_allclose(g, want[name].numpy(), atol=1e-5 * scale, rtol=0,
                                   err_msg=name)


def test_ctc_branch_loss_matches_jax(ctc_grads):
    """``ctc_weight`` 0.3: CTC on the raw targets (not the eos-extended
    ones), ``0.3 ctc + 0.7 att + pre`` as JAX composes it, and no CTC term
    without the head."""
    sd, b, jstats, _ = ctc_grads
    args = [_t(b[k]) for k in ("speech", "speech_lengths", "text", "text_lengths")]
    with torch.no_grad():
        _, st = _port_ctc(sd)(*args)
        tm = Paraformer(**CONF, sampling_ratio=0.0, device="cpu")
        tm.load_state_dict({k: v for k, v in sd.items() if not k.startswith("ctc.")})
        _, plain = tm.train()(*args)
        enc, enc_lens = tm.encode(args[0], args[1])
        ctc = TL.ctc_loss(_port_ctc(sd).ctc.ctc_lo(enc), enc_lens, args[2], args[3])
    np.testing.assert_allclose(st["loss_ctc"].item(), ctc.item(), rtol=1e-6)
    want = 0.3 * jstats["loss_ctc"] + 0.7 * jstats["loss_att"] + jstats["loss_pre"]
    np.testing.assert_allclose(st["loss"].item(), want, rtol=1e-5)
    assert "loss_ctc" not in plain
    np.testing.assert_allclose(plain["loss"].item(), jstats["loss_att"] + jstats["loss_pre"],
                               rtol=1e-5)


def test_glancing_sampler_matches_jax_given_its_noise(jax_init, monkeypatch):
    """``_glm_sampler`` on the same encoder output and CIF embeddings, the
    port fed the uniform noise JAX draws (its sampler key, the first
    ``make_rng("sampler")`` of the call): the same swapped positions, so the
    same semantic embeddings and first-pass logits."""
    jm = JaxParaformer(**CONF, sampling_ratio=0.75)
    rng = np.random.default_rng(5)
    enc = rng.standard_normal((4, T, D)).astype(np.float32)
    enc_lens = np.array([24, 20, 13, 9], np.int32)
    text = rng.integers(3, V, (4, 9)).astype(np.int32)
    tlens = np.array([9, 6, 8, 3], np.int32)
    for i, n in enumerate(tlens):
        text[i, n:] = -1
    ys, ys_lens = add_eos(_t(text), _t(tlens), 2)
    acoustic = rng.standard_normal((4, ys.shape[1], D)).astype(np.float32)
    rngs = {"sampler": jax.random.PRNGKey(9), "dropout": jax.random.PRNGKey(9)}
    key = jm.apply(jax_init, method=lambda m: m.make_rng("sampler"), rngs=rngs)
    noise = _t(np.asarray(jax.random.uniform(key, tuple(ys.shape))))
    jsem, jlogits = jax.jit(lambda p, *a: jm.apply(p, *a, method=JaxParaformer._glm_sampler,
                                                   rngs=rngs))(
        jax_init, enc, enc_lens, ys.numpy(), ys_lens.numpy(), acoustic)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: noise)
    tm = _port(jax_init, sampling_ratio=0.75).train()
    with torch.no_grad():
        sem, logits = tm._glm_sampler(_t(enc), _t(enc_lens), ys, ys_lens, _t(acoustic))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(sem.numpy(), np.asarray(jsem), atol=1e-6)
    nonpad = ys != -1
    swap = glancing_swap(noise, nonpad, torch.tensor([3, 0, 5, 1], dtype=torch.int32))
    assert swap.sum(-1).tolist() == [3, 0, 5, 1] and not (swap & ~nonpad).any()
    grid = ys_lens.numpy()[:, None] > np.arange(ys.shape[1])
    assert (sem.numpy() != acoustic * grid[:, :, None]).any()  # some embeddings swapped


# -------------------------------------------------------------- train steps
def test_three_accumulated_steps_match_jax(jax_init, jax_steps):
    jstate, jstats, _, _ = jax_steps
    tm = _port(jax_init)
    tx, schedule = TO.build_optimizer("adam", OPT, "warmuplr", SCHED, grad_clip=5.0)
    state = create_train_state(tm, tx)
    step = make_train_step(tm, tx, accum_grad=2)
    batch = {k: _t(v) for k, v in _batch().items()}
    for i in range(3):
        state, stats = step(state, batch, i)
        for k in ("loss", "loss_att", "loss_pre", "acc", "grad_norm", "finite"):
            np.testing.assert_allclose(stats[k].item(), jstats[i][k], rtol=1e-5, err_msg=k)
    assert int(state.step) == 3 and int(state.opt_state["count"]) == 3
    lr_sum = sum(schedule(torch.tensor(c)).item() for c in range(3))
    want = paraformer_from_jax(jstate.params)
    for name, p in tm.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith(("linear_q_k_v.bias", "linear_k_v.bias")):
            k = slice(D, 2 * D) if name.endswith("q_k_v.bias") else slice(0, D)
            assert np.abs(got[k] - ref[k]).max() <= 1.01 * lr_sum, name
            got, ref = np.delete(got, np.r_[k]), np.delete(ref, np.r_[k])
        np.testing.assert_allclose(got, ref, atol=5e-5, rtol=0, err_msg=name)


def test_nonfinite_step_is_skipped_as_in_jax(jax_init, jax_steps):
    """A NaN in one micro-batch: parameters, moments and the optimizer count
    stay; ``step`` advances; ``grad_norm`` is NaN and ``finite`` 0, in both."""
    jstate, _, jafter, jst = jax_steps
    assert np.isnan(jst["grad_norm"]) and jst["finite"] == 0.0
    for a, b in zip(jax.tree_util.tree_leaves(jstate.params),
                    jax.tree_util.tree_leaves(jafter.params)):
        np.testing.assert_array_equal(a, b)
    assert int(jafter.step) == int(jstate.step) + 1
    tm = _port(jax_init)
    tx, _ = TO.build_optimizer("adam", OPT, "warmuplr", SCHED, grad_clip=5.0)
    state = create_train_state(tm, tx)
    step = make_train_step(tm, tx, accum_grad=2)
    state, _ = step(state, {k: _t(v) for k, v in _batch().items()}, 0)
    before = {k: v.clone() for k, v in state.opt_state.items()}
    params = state.params.clone()
    bad = _batch()
    bad["speech"][1, 0, 3, 2] = np.nan
    state, stats = step(state, {k: _t(v) for k, v in bad.items()}, 1)
    assert torch.isnan(stats["grad_norm"]) and stats["finite"].item() == 0.0
    assert torch.equal(state.params, params) and int(state.step) == 2
    for k, v in before.items():
        assert torch.equal(state.opt_state[k], v), k
    assert all(torch.equal(p, q) for p, q in zip(
        tm.parameters(), state.named_parameters(params).values()))


def test_bf16_compute_step_against_jax(jax_init):
    """bf16 compute on float32 parameters, one ``accum_grad=2`` step (sgd,
    lr 0.1, clip 5, so the update is the clipped gradient): the port and JAX
    round their bf16 activations differently, so the bar is measured.  The
    loss within 5e-3 and ``grad_norm`` within 2e-2 relative (measured 5.3e-4
    and 2.0e-3); the whole update within 15 % of JAX's in 2-norm (measured
    12.9 %; float32 steps agree to 1e-5)."""
    jm = JaxParaformer(**CONF, sampling_ratio=0.0, dtype=jnp.bfloat16)
    conf = dict(lr=0.1)
    jtx, _ = JO.build_optimizer("sgd", conf, "constant", {}, grad_clip=5.0)
    jstate, jst = jax.jit(jax_make_step(jm, jtx, accum_grad=2))(
        jax_state(jax_init, jtx), _batch(), jax.random.PRNGKey(0))
    tm = _port(jax_init, dtype=torch.bfloat16, param_dtype=torch.float32)
    tx, _ = TO.build_optimizer("sgd", conf, "constant", {}, grad_clip=5.0)
    state = create_train_state(tm, tx)
    start = state.params.clone()
    state, st = make_train_step(tm, tx, accum_grad=2)(
        state, {k: _t(v) for k, v in _batch().items()}, 0)
    np.testing.assert_allclose(st["loss"].item(), float(jst["loss"]), rtol=5e-3)
    np.testing.assert_allclose(st["grad_norm"].item(), float(jst["grad_norm"]), rtol=2e-2)
    want = paraformer_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    jax_update = torch.cat([want[n].reshape(-1) for n, _ in tm.named_parameters()]) - start
    port_update = state.params - start
    rel = (torch.linalg.vector_norm(port_update - jax_update)
           / torch.linalg.vector_norm(jax_update)).item()
    assert rel < 0.15, rel


def test_step_refuses_parameters_cut_off_from_the_state(jax_init):
    """A parameter reallocated after ``create_train_state`` (here as
    ``model.half().float()`` would) no longer aliases ``TrainState.params``:
    the step raises instead of updating a tensor the forward never reads."""
    tm = _port(jax_init)
    tx, _ = TO.build_optimizer("sgd", dict(lr=0.1), "constant", {}, grad_clip=5.0)
    state = create_train_state(tm, tx)
    step = make_train_step(tm, tx, accum_grad=2)
    assert all(p.data_ptr() == v.data_ptr()
               for p, v in zip(tm.parameters(), state.named_parameters().values()))
    w = tm.decoder.output_layer.weight
    w.data = w.data.clone()
    with pytest.raises(RuntimeError, match="no longer a view of TrainState.params"):
        step(state, {k: _t(v) for k, v in _batch().items()}, 0)
    assert int(state.step) == 0


def test_cli_accum_split_against_the_jax_step(jax_init):
    """``bin.train`` with ``accum_grad`` 2 pads a 3-row sampler batch to 4
    rows by repeating the last and feeds the step (2, 2, ...) micro-batches.
    The JAX CLI hands its step the unsplit batch, whose scan takes the rows
    as the accumulation axis and fails (ROADMAP.md, Queue 3)."""
    from funasr_torch.bin.train import micro_rows, split_micro

    assert micro_rows([4, 1, 7], 2) == [4, 1, 7, 7]
    assert micro_rows([4, 1], 2) == [4, 1] and micro_rows([5], 1) == [5]
    rows = micro_rows([0, 1, 2], 2)
    micro = split_micro({k: _t(v[0][rows]) for k, v in _batch().items()}, 2)
    assert micro["speech"].shape == (2, 2, T, IN) and micro["text"].shape == (2, 2, U)
    for m, r in ((0, 0), (0, 1), (1, 0), (1, 1)):
        np.testing.assert_array_equal(micro["speech"][m, r].numpy(),
                                      _batch()["speech"][0, min(2 * m + r, 2)])
    jm = JaxParaformer(**CONF, sampling_ratio=0.0)
    tx, _ = JO.build_optimizer("sgd", dict(lr=0.1), "constant", {}, grad_clip=5.0)
    unsplit = {k: v[0] for k, v in _batch().items()}  # one 3-row sampler batch
    with pytest.raises(ValueError, match="leading axis"):
        jax_make_step(jm, tx, accum_grad=2)(jax_state(jax_init, tx), unsplit,
                                            jax.random.PRNGKey(0))


# ------------------------------------------------------------- the routes
def test_training_takes_plain_attention_and_eval_the_kernel_path(jax_init, monkeypatch):
    """In ``train()`` mode no kernel wrapper runs (the kernel has no
    backward); in ``eval()`` under ``no_grad`` the attention wrapper does, in
    every encoder layer and every cross-attention."""
    calls = []
    real = A.fused_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(A, "fused_attention", spy)
    tm = _port(jax_init).train()
    b = {k: _t(v[0]) for k, v in _batch().items()}
    loss, _ = tm(b["speech"], b["speech_lengths"], b["text"], b["text_lengths"])
    loss.backward()
    assert calls == []
    tm.eval()
    with torch.no_grad():
        eval_loss, _ = tm(b["speech"], b["speech_lengths"], b["text"], b["text_lengths"])
    assert len(calls) == ENC["num_blocks"] + DEC["att_layer_num"]
    np.testing.assert_allclose(eval_loss.item(), loss.item(), rtol=1e-5)
    tm.train()
    with pytest.raises(RuntimeError, match="fused_attention: an input requires grad"):
        tm.eval()
        tm(b["speech"], b["speech_lengths"], b["text"], b["text_lengths"])


def test_remat_repeats_the_dropout_masks(jax_init):
    """``remat=True`` recomputes the encoder layers in the backward pass
    with the forward's RNG state: with dropout on, the same loss and
    gradients as without it."""
    conf = dict(encoder_conf=dict(ENC, dropout_rate=0.3, attention_dropout_rate=0.2))
    b = {k: _t(v[0]) for k, v in _batch().items()}
    grads = []
    for remat in (False, True):
        tm = Paraformer(**dict(CONF, **conf), sampling_ratio=0.75, device="cpu")
        tm.encoder.remat = remat
        tm.load_state_dict(paraformer_from_jax(jax_init))
        tm.train()
        torch.manual_seed(11)
        loss, _ = tm(b["speech"], b["speech_lengths"], b["text"], b["text_lengths"],
                     generator=torch.Generator().manual_seed(3))
        loss.backward()
        grads.append((loss.item(), [p.grad.clone() for p in tm.parameters()
                                    if p.grad is not None]))
    assert grads[0][0] == grads[1][0]
    for g0, g1 in zip(grads[0][1], grads[1][1]):
        torch.testing.assert_close(g1, g0, rtol=0, atol=0)


def test_int8_weights_and_other_models_refuse_training(jax_init):
    tm = Paraformer(**CONF, quantize=True, device="cpu")
    tm.load_state_dict(paraformer_from_jax(jax_init))
    tm.quantize_weights().train()
    b = {k: _t(v[0]) for k, v in _batch().items()}
    with pytest.raises(RuntimeError, match="for serving"):
        tm(b["speech"], b["speech_lengths"], b["text"], b["text_lengths"])
    san = Paraformer(**CONF, decoder_name="ParaformerSANDecoder", device="cpu").train()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        san(b["speech"], b["speech_lengths"], b["text"], b["text_lengths"])
