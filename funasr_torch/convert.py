"""Flax variables -> FunASR torch ``state_dict`` for the port's models.

The inverses of funasr_tpu/convert.py ``paraformer_from_torch`` (:205),
``bicif_paraformer_from_torch`` (:228), ``scama_from_torch`` (:669),
``contextual_paraformer_from_torch`` (:238), ``seaco_paraformer_from_torch``
(:292), ``conformer_from_torch`` (:398) with ``_std_transformer_decoder_tree``
(:1383), ``fsmn_vad_from_torch`` (:332), ``whisper_from_openai_pt`` (:1133),
``ct_transformer_from_torch`` (:385), ``sense_voice_from_torch`` (:481),
``campplus_from_torch`` (:517), ``transducer_from_torch`` (:717) and
``emotion2vec_from_torch`` (:849), written for the port (no import of the JAX
package): each takes the flax tree with numpy leaves and returns the state
dict that the port's model (and a reference FunASR ``model.pt``) uses:

- Dense ``kernel (in, out)`` -> Linear ``weight (out, in)`` (transpose),
- FSMN ``(K, 1, D)`` -> depthwise Conv1d ``(D, 1, K)``,
- CIF ``cif_conv1d (K, Din, Dout)`` -> Conv1d ``(Dout, Din, K)``,
- LayerNorm ``scale/bias`` -> ``weight/bias``,
- scanned stacks ``(L, ...)`` -> ``encoders.{i}.*`` / ``decoders.{i}.*``,
- the VAD's FSMN memory ``(K, 1, D)`` -> depthwise Conv2d ``(D, 1, K, 1)``,
- an embedding table ``embedding`` -> ``weight``,
- Conv2d ``(kh, kw, in, out)`` -> ``(out, in, kh, kw)``, BatchNorm running
  statistics from the ``batch_stats`` collection,
- BiCif ``upsample_cnn (u, Din, Dout)`` -> ConvTranspose1d ``(Din, Dout, u)``,
  flax ``OptimizedLSTMCell`` gates -> ``nn.LSTM`` ``weight_ih/hh_l{n}``
  (flax keeps one bias per gate, in the hidden-side dense layer: it goes to
  ``bias_ih_l{n}``, and ``bias_hh_l{n}`` is zeros),
- flax Conv ``(k, in, out)`` / ``(kh, kw, in, out)`` -> torch
  ``(out, in, k)`` / ``(out, in, kh, kw)`` (CAM++).

An inference-only flax tree has no decoder embedding (only the training
sampler uses it); the state dict then carries zeros for
``decoder.embed.0.weight`` so strict loading works.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


def _dense(sd, prefix: str, node: Mapping, bias: bool = True):
    sd[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
    if bias and "bias" in node:
        sd[f"{prefix}.bias"] = _t(node["bias"])


def _norm(sd, prefix: str, node: Mapping):
    sd[f"{prefix}.weight"] = _t(node["scale"])
    sd[f"{prefix}.bias"] = _t(node["bias"])


def _fsmn(sd, name: str, kernel):
    sd[name] = _t(np.transpose(np.asarray(kernel), (2, 1, 0)))  # (K,1,D)->(D,1,K)


def _unstack(tree: Mapping, i: int) -> Dict[str, Any]:
    return {k: (_unstack(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in tree.items()}


def _num_layers(tree: Mapping) -> int:
    leaf = tree
    while isinstance(leaf, Mapping):
        leaf = next(iter(leaf.values()))
    return int(np.asarray(leaf).shape[0])


def _enc_layer(sd, p: str, node: Mapping):
    att = node["self_attn"]
    _dense(sd, f"{p}.self_attn.linear_q_k_v", att["linear_q_k_v"])
    _fsmn(sd, f"{p}.self_attn.fsmn_block.weight", att["fsmn_block"])
    _dense(sd, f"{p}.self_attn.linear_out", att["linear_out"])
    _dense(sd, f"{p}.feed_forward.w_1", node["feed_forward"]["w_1"])
    _dense(sd, f"{p}.feed_forward.w_2", node["feed_forward"]["w_2"])
    _norm(sd, f"{p}.norm1", node["norm1"])
    _norm(sd, f"{p}.norm2", node["norm2"])


def _dec_layer(sd, p: str, node: Mapping):
    ff = node["feed_forward"]
    _dense(sd, f"{p}.feed_forward.w_1", ff["w_1"])
    _norm(sd, f"{p}.feed_forward.norm", ff["norm"])
    _dense(sd, f"{p}.feed_forward.w_2", ff["w_2"], bias=False)
    _norm(sd, f"{p}.norm1", node["norm1"])
    if "self_attn" in node:
        _fsmn(sd, f"{p}.self_attn.fsmn_block.weight",
              node["self_attn"]["fsmn_block"])
        _norm(sd, f"{p}.norm2", node["norm2"])
    if "src_attn" in node:
        src = node["src_attn"]
        _dense(sd, f"{p}.src_attn.linear_q", src["linear_q"])
        _dense(sd, f"{p}.src_attn.linear_k_v", src["linear_k_v"])
        _dense(sd, f"{p}.src_attn.linear_out", src["linear_out"])
        _norm(sd, f"{p}.norm3", node["norm3"])


def _encoder(sd, prefix: str, enc: Mapping):
    """A SANM encoder tree (``encoders0``, the scanned ``encoders``,
    ``after_norm``) -> ``{prefix}.*``."""
    _enc_layer(sd, f"{prefix}.encoders0.0", enc["encoders0"])
    if "encoders" in enc:
        for i in range(_num_layers(enc["encoders"])):
            _enc_layer(sd, f"{prefix}.encoders.{i}", _unstack(enc["encoders"], i))
    _norm(sd, f"{prefix}.after_norm", enc["after_norm"])


def paraformer_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (with ``'batch_stats'`` for a Conformer
    encoder), or the bare tree, of funasr_tpu's Paraformer -> the port's
    float32 ``state_dict``.  The encoder is read from its parameters (SANM,
    or a hybrid's encoder: the aishell Paraformer-Conformer's), the decoder
    too (SANM, or the SAN decoder's Transformer layers), the predictor
    (CIF, or E-Paraformer's PIF with its ``sigma`` and ``bias``); a
    ``ctc_lo`` in the tree goes to ``ctc.ctc_lo``."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    enc = tree["encoder"]
    if "encoders0" in enc:
        _encoder(sd, "encoder", enc)
    else:
        _hybrid_encoder(sd, enc, params.get("batch_stats", {}).get("encoder", {}))

    _predictor(sd, "predictor", tree["predictor"])

    dec = tree["decoder"]
    _decoder(sd, "decoder", dec, np.asarray(dec["output_layer"]["kernel"]).shape[1])
    if "ctc_lo" in tree:
        _dense(sd, "ctc.ctc_lo", tree["ctc_lo"])
    return sd


def scama_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """funasr_tpu's SCAMA -> the port's float32 ``state_dict``: the
    Paraformer's layout key for key (funasr_tpu/convert.py:669
    ``scama_from_torch``), the ``FsmnDecoderSCAMAOpt``'s token embedding as
    ``decoder.embed.0.weight`` and a ``ctc_lo`` as ``ctc.ctc_lo``."""
    return paraformer_from_jax(params)


def _predictor(sd, p: str, pred: Mapping):
    """A CIF predictor tree, or E-Paraformer's PIF (a depthwise alpha conv
    (K, 1, D), ``sigma`` and ``bias``) -> ``{p}.*``."""
    if "sigma" in pred:
        _fsmn(sd, f"{p}.cif_conv1d.weight", pred["cif_conv1d"])
        sd[f"{p}.sigma"] = _t(pred["sigma"])
        sd[f"{p}.bias"] = _t(pred["bias"])
    else:
        sd[f"{p}.cif_conv1d.weight"] = _t(
            np.transpose(np.asarray(pred["cif_conv1d"]), (2, 1, 0)))
    sd[f"{p}.cif_conv1d.bias"] = _t(pred["cif_conv1d_bias"])
    _dense(sd, f"{p}.cif_output", pred["cif_output"])


def e_paraformer_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """funasr_tpu's EParaformer (PIF predictor, SAN decoder) -> the port's
    float32 ``state_dict``, as :func:`paraformer_from_jax`; its CTC head is
    always built (``ctc_weight`` 0.5), so a tree without one (an inference
    init never runs it) gives zeros for ``ctc.ctc_lo``."""
    sd = paraformer_from_jax(params)
    if "ctc.ctc_lo.weight" not in sd:
        vocab, d = sd["decoder.output_layer.weight"].shape
        sd["ctc.ctc_lo.weight"] = torch.zeros((vocab, d))
        sd["ctc.ctc_lo.bias"] = torch.zeros(vocab)
    return sd


def _decoder(sd, prefix: str, dec: Mapping, vocab: int):
    """A ``ParaformerSANMDecoder`` or ``ParaformerSANDecoder`` tree ->
    ``{prefix}.*``; an absent embedding (an inference tree) becomes zeros
    of (vocab, D)."""
    if "decoders3" not in dec:  # the SAN decoder: Transformer layers
        for i in range(_num_layers(dec["decoders"])):
            _transformer_decoder_layer(sd, f"{prefix}.decoders.{i}",
                                       _unstack(dec["decoders"], i))
        dec = dict(dec, decoders={})
    for stack in ("decoders", "decoders2"):
        if dec.get(stack):
            for i in range(_num_layers(dec[stack])):
                _dec_layer(sd, f"{prefix}.{stack}.{i}", _unstack(dec[stack], i))
    if "decoders3" in dec:
        _dec_layer(sd, f"{prefix}.decoders3.0", dec["decoders3"])
    _norm(sd, f"{prefix}.after_norm", dec["after_norm"])
    if "output_layer" in dec:
        _dense(sd, f"{prefix}.output_layer", dec["output_layer"])
    if "embed" in dec:
        sd[f"{prefix}.embed.0.weight"] = _t(dec["embed"]["embedding"])
    else:
        sd[f"{prefix}.embed.0.weight"] = torch.zeros(
            (vocab, np.asarray(dec["after_norm"]["scale"]).shape[0]))


def _lstm_cell(sd, prefix: str, suffix: str, cell: Mapping):
    """One flax ``OptimizedLSTMCell`` -> ``nn.LSTM`` weights ``*{suffix}``."""
    gates = ("i", "f", "g", "o")
    stack = lambda kind: np.concatenate(
        [np.asarray(cell[f"{kind}{g}"]["kernel"]).T for g in gates])
    bias = np.concatenate([np.asarray(cell[f"h{g}"]["bias"]) for g in gates])
    sd[f"{prefix}.weight_ih{suffix}"] = _t(stack("i"))
    sd[f"{prefix}.weight_hh{suffix}"] = _t(stack("h"))
    sd[f"{prefix}.bias_ih{suffix}"] = _t(bias)
    sd[f"{prefix}.bias_hh{suffix}"] = torch.zeros(bias.shape)


def bicif_paraformer_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (or the bare tree) of funasr_tpu's
    BiCifParaformer -> the port's float32 ``state_dict``: the Paraformer
    keys plus the V3 head (``predictor.upsample_cnn``, ``cif_output2`` and,
    for "cnn_blstm", ``predictor.blstm``).  Each flax ``OptimizedLSTMCell``
    (input kernels ``i{g}``, hidden kernels and biases ``h{g}``) becomes
    torch's gate-stacked ``weight_ih_l0``/``weight_hh_l0`` in the order
    i, f, g, o, its summed bias in ``bias_ih_l0`` and zeros in
    ``bias_hh_l0``."""
    tree = params.get("params", params)
    sd = paraformer_from_jax(tree)
    pred = tree["predictor"]
    sd["predictor.upsample_cnn.weight"] = _t(
        np.transpose(np.asarray(pred["upsample_cnn"]), (1, 2, 0)))
    sd["predictor.upsample_cnn.bias"] = _t(pred["upsample_cnn_bias"])
    _dense(sd, "predictor.cif_output2", pred["cif_output2"])
    for name, suffix in (("blstm_fwd", ""), ("blstm_bwd", "_reverse")):
        if name in pred:
            _lstm_cell(sd, "predictor.blstm", f"_l0{suffix}", pred[name])
    return sd


def seaco_paraformer_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (or the bare tree) of funasr_tpu's
    SeacoParaformer -> the port's float32 ``state_dict``: the BiCif keys,
    the 2-layer ``bias_encoder`` LSTM (``OptimizedLSTMCell_{n}`` ->
    ``weight_ih/hh_l{n}``, the bias in ``bias_ih_l{n}``), the
    ``seaco_decoder`` (no output layer; its unused embedding zeros) and
    ``hotword_output_layer``."""
    tree = params.get("params", params)
    sd = bicif_paraformer_from_jax(tree)
    n = 0
    while f"OptimizedLSTMCell_{n}" in tree["bias_encoder"]:
        _lstm_cell(sd, "bias_encoder", f"_l{n}", tree["bias_encoder"][f"OptimizedLSTMCell_{n}"])
        n += 1
    vocab = np.asarray(tree["hotword_output_layer"]["kernel"]).shape[1]
    _decoder(sd, "seaco_decoder", tree["seaco_decoder"], vocab)
    _dense(sd, "hotword_output_layer", tree["hotword_output_layer"])
    return sd


def contextual_paraformer_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (or the bare tree) of funasr_tpu's
    ContextualParaformer -> the port's float32 ``state_dict``: the
    Paraformer keys (the ``att_layer_num - 1`` stacked ``decoders``), the
    ``decoder.last_decoder`` layer, the bias attention under FunASR's names
    (flax ``bias_norm`` -> ``decoder.bias_decoder.norm3``, ``bias_decoder``
    -> ``decoder.bias_decoder.src_attn``), the Dense ``bias_output`` as the
    (D, 2D, 1) Conv1d weight, the 1-layer ``bias_encoder`` LSTM and
    ``bias_embed``."""
    tree = params.get("params", params)
    sd = paraformer_from_jax(tree)
    dec = tree["decoder"]
    _dec_layer(sd, "decoder.last_decoder", dec["last_decoder"])
    _norm(sd, "decoder.bias_decoder.norm3", dec["bias_norm"])
    for name in ("linear_q", "linear_k_v", "linear_out"):
        _dense(sd, f"decoder.bias_decoder.src_attn.{name}", dec["bias_decoder"][name])
    sd["decoder.bias_output.weight"] = _t(np.asarray(dec["bias_output"]["kernel"]).T[..., None])
    _lstm_cell(sd, "bias_encoder", "_l0", tree["bias_encoder"]["OptimizedLSTMCell_0"])
    if "bias_embed" in tree:
        sd["bias_embed.weight"] = _t(tree["bias_embed"]["embedding"])
    return sd


def sense_voice_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (or the bare tree) of funasr_tpu's
    SenseVoiceSmall -> the port's float32 ``state_dict``: the SANM encoder
    with its ``tp_encoders`` stack and ``tp_norm`` under ``encoder.``, the
    prompt table ``embed.weight`` (16, input_size) and ``ctc.ctc_lo``."""
    tree = params.get("params", params)
    enc = tree["encoder"]
    sd: Dict[str, torch.Tensor] = {}
    _encoder(sd, "encoder", enc)
    if "tp_encoders" in enc:
        for i in range(_num_layers(enc["tp_encoders"])):
            _enc_layer(sd, f"encoder.tp_encoders.{i}", _unstack(enc["tp_encoders"], i))
    _norm(sd, "encoder.tp_norm", enc["tp_norm"])
    sd["embed.weight"] = _t(tree["embed"]["embedding"])
    _dense(sd, "ctc.ctc_lo", tree["ctc_lo"])
    return sd


def fsmn_vad_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (or the bare tree) of funasr_tpu's VAD scorer
    (``models/fsmn_vad/encoder.py FSMN``) -> the port's FSMN ``state_dict``
    (FunASR's names: ``in_linear1.linear``, ``fsmn.{i}.linear.linear``,
    ``fsmn.{i}.fsmn_block.conv_left`` (D, 1, K, 1), ``fsmn.{i}.affine.linear``,
    ``out_linear1.linear``, ``out_linear2.linear``)."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}
    conv = lambda k: _t(np.transpose(np.asarray(k), (2, 1, 0))[..., None])  # (K,1,D)->(D,1,K,1)
    for name in ("in_linear1", "in_linear2", "out_linear1", "out_linear2"):
        _dense(sd, f"{name}.linear", tree[name])
    i = 0
    while f"fsmn_{i}" in tree:
        node = tree[f"fsmn_{i}"]
        _dense(sd, f"fsmn.{i}.linear.linear", node["linear"], bias=False)
        sd[f"fsmn.{i}.fsmn_block.conv_left.weight"] = conv(node["conv_left"])
        if "conv_right" in node:
            sd[f"fsmn.{i}.fsmn_block.conv_right.weight"] = conv(node["conv_right"])
        _dense(sd, f"fsmn.{i}.affine.linear", node["affine"])
        i += 1
    return sd


def ct_transformer_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (or the bare tree) of funasr_tpu's
    ``CTTransformer`` -> the port's float32 ``state_dict``: ``embed.weight``,
    the SANM encoder under ``encoder.``, the projection ``decoder``."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {"embed.weight": _t(tree["embed"]["embedding"])}
    _encoder(sd, "encoder", tree["encoder"])
    _dense(sd, "decoder", tree["decoder"])
    return sd


def _mha(sd, p: str, node: Mapping):
    for q in ("linear_q", "linear_k", "linear_v", "linear_out"):
        _dense(sd, f"{p}.{q}", node[q])


def _rel_mha(sd, p: str, att: Mapping):
    _mha(sd, p, att)
    _dense(sd, f"{p}.linear_pos", att["linear_pos"], bias=False)
    sd[f"{p}.pos_bias_u"] = _t(att["pos_bias_u"])
    sd[f"{p}.pos_bias_v"] = _t(att["pos_bias_v"])


def _ffn(sd, p: str, node: Mapping):
    _dense(sd, f"{p}.w_1", node["w_1"])
    _dense(sd, f"{p}.w_2", node["w_2"])


def _conformer_layer(sd, p: str, node: Mapping, stats: Mapping):
    _ffn(sd, f"{p}.feed_forward", node["feed_forward"])
    _ffn(sd, f"{p}.feed_forward_macaron", node["feed_forward_macaron"])
    for nm in ("norm_ff", "norm_mha", "norm_conv", "norm_final", "norm_ff_macaron"):
        _norm(sd, f"{p}.{nm}", node[nm])
    _rel_mha(sd, f"{p}.self_attn", node["self_attn"])
    cm, c = f"{p}.conv_module", node["conv_module"]
    for pw in ("pointwise_conv1", "pointwise_conv2"):  # (in, out) -> (out, in, 1)
        sd[f"{cm}.{pw}.weight"] = _t(np.asarray(c[pw]["kernel"]).T[..., None])
        sd[f"{cm}.{pw}.bias"] = _t(c[pw]["bias"])
    _fsmn(sd, f"{cm}.depthwise_conv.weight", c["depthwise_conv"])  # (K,1,D)->(D,1,K)
    sd[f"{cm}.depthwise_conv.bias"] = _t(c["depthwise_conv_bias"])
    _norm(sd, f"{cm}.norm", c["norm"])
    bn = stats["conv_module"]["norm"]
    sd[f"{cm}.norm.running_mean"] = _t(bn["mean"])
    sd[f"{cm}.norm.running_var"] = _t(bn["var"])
    sd[f"{cm}.norm.num_batches_tracked"] = torch.tensor(0)


def _transformer_layer(sd, p: str, node: Mapping, stats: Mapping):
    _mha(sd, f"{p}.self_attn", node["self_attn"])
    _ffn(sd, f"{p}.feed_forward", node["feed_forward"])
    _norm(sd, f"{p}.norm1", node["norm1"])
    _norm(sd, f"{p}.norm2", node["norm2"])


def _cgmlp(sd, p: str, node: Mapping):
    _dense(sd, f"{p}.channel_proj1.0", node["channel_proj1"])
    _norm(sd, f"{p}.csgu.norm", node["csgu"]["norm"])
    _fsmn(sd, f"{p}.csgu.conv.weight", node["csgu"]["conv"])  # (K,1,C)->(C,1,K)
    sd[f"{p}.csgu.conv.bias"] = _t(node["csgu"]["conv_bias"])
    _dense(sd, f"{p}.channel_proj2", node["channel_proj2"])


def _branchformer_layer(sd, p: str, node: Mapping, stats: Mapping):
    for nm in ("norm_mha", "norm_mlp", "norm_final"):
        _norm(sd, f"{p}.{nm}", node[nm])
    _rel_mha(sd, f"{p}.attn", node["attn"])
    _cgmlp(sd, f"{p}.cgmlp", node["cgmlp"])
    _dense(sd, f"{p}.merge_proj", node["merge_proj"])


def _ebranchformer_layer(sd, p: str, node: Mapping, stats: Mapping):
    _branchformer_layer(sd, p, node, stats)
    for jax_name, name in (("1", "_macaron"), ("2", "")):
        _norm(sd, f"{p}.norm_ff{name}", node[f"norm_ff{jax_name}"])
        _ffn(sd, f"{p}.feed_forward{name}", node[f"feed_forward{jax_name}"])
    kernel = np.asarray(node["merge_conv"])  # (K, 1, 2D), no bias in the JAX package
    _fsmn(sd, f"{p}.depthwise_conv_fusion.weight", kernel)
    sd[f"{p}.depthwise_conv_fusion.bias"] = torch.zeros(kernel.shape[-1])


def _transformer_decoder_layer(sd, p: str, node: Mapping):
    for att in ("self_attn", "src_attn"):
        _mha(sd, f"{p}.{att}", node[att])
    _ffn(sd, f"{p}.feed_forward", node["feed_forward"])
    for nm in ("norm1", "norm2", "norm3"):
        _norm(sd, f"{p}.{nm}", node[nm])


def _rwkv_decoder_layer(sd, p: str, node: Mapping):
    tm, a = node["self_attn"], f"{p}.self_attn"
    for mu in ("k", "v", "r"):
        sd[f"{a}.time_mix_{mu}"] = _t(tm[f"mu_{mu}"])
    for jax_name, name in (("key", "key"), ("value", "value"), ("recept", "receptance"),
                           ("output", "output")):
        _dense(sd, f"{a}.{name}", tm[jax_name], bias=False)
    sd[f"{a}.time_decay"] = _t(tm["time_decay"])
    sd[f"{a}.time_first"] = _t(tm["time_first"])
    _mha(sd, f"{p}.src_attn", node["src_attn"])
    _ffn(sd, f"{p}.feed_forward", node["feed_forward"])
    for nm in ("norm1", "norm2", "norm3"):
        _norm(sd, f"{p}.{nm}", node[nm])


def _encoder_layer_fn(layers: Mapping):
    """The layer converter of a scanned encoder stack, by its parameters."""
    if "conv_module" in layers:
        return _conformer_layer
    if "feed_forward1" in layers:
        return _ebranchformer_layer
    if "cgmlp" in layers:
        return _branchformer_layer
    return _transformer_layer


def _subsampling(sd, enc: Mapping):
    """Conv2dSubsampling: the output Linear reads the flattened (channel,
    frequency) features freq-major in flax (f * C + c) and channel-major in
    torch (c * F + f), so its input axis is permuted
    (funasr_tpu/convert.py:420)."""
    emb = enc["embed"]
    for j, t in (("conv0", "encoder.embed.conv.0"), ("conv1", "encoder.embed.conv.2")):
        sd[f"{t}.weight"] = _t(np.transpose(np.asarray(emb[j]["kernel"]), (3, 2, 0, 1)))
        sd[f"{t}.bias"] = _t(emb[j]["bias"])
    C = np.asarray(emb["conv1"]["kernel"]).shape[-1]
    k = np.asarray(emb["out"]["kernel"])  # (F * C, D), freq-major rows
    F = k.shape[0] // C
    k = k.reshape(F, C, -1).transpose(1, 0, 2).reshape(C * F, -1)
    sd["encoder.embed.out.0.weight"] = _t(k.T)
    sd["encoder.embed.out.0.bias"] = _t(emb["out"]["bias"])


def _hybrid_encoder(sd, enc: Mapping, enc_stats: Mapping):
    """A Conformer, Transformer, Branchformer or E-Branchformer encoder tree
    (its ``batch_stats`` subtree beside it) -> ``encoder.*``."""
    if "conv0" in enc["embed"]:
        _subsampling(sd, enc)
    else:
        _dense(sd, "encoder.embed.0", enc["embed"])
        if "embed_norm" in enc:
            _norm(sd, "encoder.embed.1", enc["embed_norm"])
    layer = _encoder_layer_fn(enc["encoders"])
    layer_stats = enc_stats.get("encoders", {})
    for i in range(_num_layers(enc["encoders"])):
        layer(sd, f"encoder.encoders.{i}", _unstack(enc["encoders"], i),
              _unstack(layer_stats, i) if layer_stats else {})
    _norm(sd, "encoder.after_norm", enc["after_norm"])


def hybrid_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': ...}`` (with ``'batch_stats'`` for a Conformer) of one of
    funasr_tpu's CTC/attention hybrids -> the port's float32 ``state_dict``.

    The encoder is read from its parameters: SANM, Conformer, Transformer,
    Branchformer or E-Branchformer, with the conv2d subsampling or the
    linear input layer (``embed.0``, and the Transformer's ``embed.1`` layer
    norm); the decoder: Transformer, or RWKV when its self-attention holds a
    ``time_decay``.  ``ctc_lo`` goes to ``ctc.ctc_lo``."""
    tree, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    enc = tree["encoder"]
    if "encoders0" in enc:  # the SANM hybrid
        _encoder(sd, "encoder", enc)
    else:
        _hybrid_encoder(sd, enc, stats.get("encoder", {}))

    dec = tree["decoder"]
    dec_layer = (_rwkv_decoder_layer if "time_decay" in dec["decoders"]["self_attn"]
                 else _transformer_decoder_layer)
    sd["decoder.embed.0.weight"] = _t(dec["embed"]["embedding"])
    for i in range(_num_layers(dec["decoders"])):
        dec_layer(sd, f"decoder.decoders.{i}", _unstack(dec["decoders"], i))
    _norm(sd, "decoder.after_norm", dec["after_norm"])
    _dense(sd, "decoder.output_layer", dec["output_layer"])
    _dense(sd, "ctc.ctc_lo", tree["ctc_lo"])
    return sd


def campplus_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` of funasr_tpu's CAMPPlus -> the
    port's (and FunASR's) float32 ``state_dict``: ``head.*`` (the FCM),
    ``xvector.tdnn`` / ``block{i}.tdnnd{j}`` / ``transit{i}`` /
    ``out_nonlinear`` / ``dense`` (funasr_tpu/convert.py:517 inverted)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def node(tree, path):
        for k in path.split("/"):
            tree = tree.get(k, {})
        return tree

    def conv2d(t, jp):
        k = np.asarray(node(params, jp)["kernel"])  # (kh, kw, in, out)
        sd[f"{t}.weight"] = _t(np.transpose(k, (3, 2, 0, 1)))

    def conv1d(t, jp):
        p = node(params, jp)
        sd[f"{t}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (2, 1, 0)))
        if "bias" in p:
            sd[f"{t}.bias"] = _t(p["bias"])

    def bn(t, jp):
        p = node(params, jp)
        if "scale" in p:
            sd[f"{t}.weight"] = _t(p["scale"])
            sd[f"{t}.bias"] = _t(p["bias"])
        s = node(stats, jp)
        sd[f"{t}.running_mean"] = _t(s["mean"])
        sd[f"{t}.running_var"] = _t(s["var"])
        sd[f"{t}.num_batches_tracked"] = torch.tensor(0)

    conv2d("head.conv1", "head/conv1")
    bn("head.bn1", "head/bn1")
    for stage in (1, 2):
        for i in (0, 1):
            p, jp = f"head.layer{stage}.{i}", f"head/layer{stage}_{i}"
            for j in (1, 2):
                conv2d(f"{p}.conv{j}", f"{jp}/conv{j}")
                bn(f"{p}.bn{j}", f"{jp}/bn{j}")
            if "shortcut_conv" in node(params, jp):
                conv2d(f"{p}.shortcut.0", f"{jp}/shortcut_conv")
                bn(f"{p}.shortcut.1", f"{jp}/shortcut_bn")
    conv2d("head.conv2", "head/conv2")
    bn("head.bn2", "head/bn2")

    conv1d("xvector.tdnn.linear", "tdnn_conv")
    bn("xvector.tdnn.nonlinear.batchnorm", "tdnn_bn")
    bi = 1
    while f"transit{bi}_linear" in params:
        li = 1
        while f"block{bi}_tdnnd{li}" in params:
            p, jp = f"xvector.block{bi}.tdnnd{li}", f"block{bi}_tdnnd{li}"
            bn(f"{p}.nonlinear1.batchnorm", f"{jp}/bn1")
            conv1d(f"{p}.linear1", f"{jp}/linear1")
            bn(f"{p}.nonlinear2.batchnorm", f"{jp}/bn2")
            for c in ("linear_local", "linear1", "linear2"):
                conv1d(f"{p}.cam_layer.{c}", f"{jp}/cam_layer/{c}")
            li += 1
        bn(f"xvector.transit{bi}.nonlinear.batchnorm", f"transit{bi}_bn")
        conv1d(f"xvector.transit{bi}.linear", f"transit{bi}_linear")
        bi += 1
    bn("xvector.out_nonlinear.batchnorm", "out_bn")
    # Dense (in, out) -> the kernel-1 conv (out, in, 1)
    sd["xvector.dense.linear.weight"] = _t(
        np.asarray(params["dense_linear"]["kernel"]).T[..., None])
    bn("xvector.dense.nonlinear.batchnorm", "dense_bn")
    return sd


_WHISPER_ATTN = (("self_attn", "attn"), ("encoder_attn", "cross_attn"))
_WHISPER_PROJ = (("q_proj", "query"), ("k_proj", "key"), ("v_proj", "value"),
                 ("out_proj", "out"))
_WHISPER_NORMS = (("self_attn_layer_norm", "attn_ln"), ("encoder_attn_layer_norm", "cross_attn_ln"),
                  ("final_layer_norm", "mlp_ln"))


def whisper_from_jax(params: Mapping, config) -> Dict[str, torch.Tensor]:
    """HF flax Whisper params (``{"model": {"encoder", "decoder"}}``, numpy
    leaves; what funasr_tpu's ``WhisperWrap`` holds) -> the port's
    openai-whisper ``state_dict`` (``encoder.blocks.{i}.attn.query`` ...,
    ``decoder.token_embedding``), float32.  Flax Dense ``(in, out)`` ->
    ``(out, in)``, Conv ``(K, in, out)`` -> ``(out, in, K)``, LayerNorm
    ``scale`` -> ``weight``, embeddings ``embedding`` -> the table.
    ``config`` (HF's or the port's) gives the layer counts.  The inverse is
    funasr_tpu/convert.py ``whisper_from_openai_pt``."""
    tree = params.get("params", params)["model"]
    sd: Dict[str, torch.Tensor] = {}

    def conv(t, node):
        sd[f"{t}.weight"] = _t(np.transpose(np.asarray(node["kernel"]), (2, 1, 0)))
        sd[f"{t}.bias"] = _t(node["bias"])

    def block(t, node, attns):
        for jn, tn in attns:
            for jp, tp in _WHISPER_PROJ:
                _dense(sd, f"{t}.{tn}.{tp}", node[jn][jp])
        for jn, tn in _WHISPER_NORMS:
            if jn in node:
                _norm(sd, f"{t}.{tn}", node[jn])
        _dense(sd, f"{t}.mlp.0", node["fc1"])
        _dense(sd, f"{t}.mlp.2", node["fc2"])

    enc, dec = tree["encoder"], tree["decoder"]
    conv("encoder.conv1", enc["conv1"])
    conv("encoder.conv2", enc["conv2"])
    sd["encoder.positional_embedding"] = _t(enc["embed_positions"]["embedding"])
    for i in range(config.encoder_layers):
        block(f"encoder.blocks.{i}", enc["layers"][str(i)], _WHISPER_ATTN[:1])
    _norm(sd, "encoder.ln_post", enc["layer_norm"])
    sd["decoder.token_embedding.weight"] = _t(dec["embed_tokens"]["embedding"])
    sd["decoder.positional_embedding"] = _t(dec["embed_positions"]["embedding"])
    for i in range(config.decoder_layers):
        block(f"decoder.blocks.{i}", dec["layers"][str(i)], _WHISPER_ATTN)
    _norm(sd, "decoder.ln", dec["layer_norm"])
    return sd


def _transducer_heads(sd, tree: Mapping):
    """The RNN-T prediction network (``decoder.embed``, one single-layer
    ``nn.LSTM`` ``decoder.rnn.{i}`` a flax ``lstm{i}``) and the joint
    network (``lin_dec`` without a bias)."""
    dec = tree["decoder"]
    sd["decoder.embed.weight"] = _t(dec["embed"]["embedding"])
    i = 0
    while f"lstm{i}" in dec:
        _lstm_cell(sd, f"decoder.rnn.{i}", "_l0", dec[f"lstm{i}"]["cell"])
        i += 1
    joint = tree["joint_network"]
    _dense(sd, "joint_network.lin_enc", joint["lin_enc"])
    _dense(sd, "joint_network.lin_dec", joint["lin_dec"], bias=False)
    _dense(sd, "joint_network.lin_out", joint["lin_out"])


def transducer_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` of funasr_tpu's ``Transducer`` (the
    Conformer encoder) -> the port's float32 ``state_dict``: the inverse of
    funasr_tpu/convert.py ``transducer_from_torch`` (:717)."""
    tree = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    _hybrid_encoder(sd, tree["encoder"], variables.get("batch_stats", {}).get("encoder", {}))
    _transducer_heads(sd, tree)
    return sd


def rwkv_bat_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params'}`` of funasr_tpu's ``RWKVBAT`` -> the port's float32
    ``state_dict`` (RWKV-4 names: ``encoder.blocks.{i}.{ln1,att,ln2,ffn}``;
    the JAX package has no torch converter for this encoder)."""
    tree = variables["params"]
    enc = tree["encoder"]
    sd: Dict[str, torch.Tensor] = {}
    _dense(sd, "encoder.embed", enc["embed"])
    _norm(sd, "encoder.ln_in", enc["ln_in"])
    for i in range(_num_layers(enc["blocks"])):
        node, p = _unstack(enc["blocks"], i), f"encoder.blocks.{i}"
        _norm(sd, f"{p}.ln1", node["ln1"])
        _norm(sd, f"{p}.ln2", node["ln2"])
        att, ffn = node["att"], node["ffn"]
        for mu in ("k", "v", "r"):
            sd[f"{p}.att.time_mix_{mu}"] = _t(att[f"mu_{mu}"])
        sd[f"{p}.att.time_decay"] = _t(att["time_decay"])
        sd[f"{p}.att.time_first"] = _t(att["time_first"])
        for jax_name, name in (("key", "key"), ("value", "value"), ("recept", "receptance"),
                               ("output", "output")):
            _dense(sd, f"{p}.att.{name}", att[jax_name], bias=False)
        for mu in ("k", "r"):
            sd[f"{p}.ffn.time_mix_{mu}"] = _t(ffn[f"mu_{mu}"])
        for jax_name, name in (("key", "key"), ("recept", "receptance"), ("value", "value")):
            _dense(sd, f"{p}.ffn.{name}", ffn[jax_name], bias=False)
    _norm(sd, "encoder.ln_out", enc["ln_out"])
    _transducer_heads(sd, tree)
    return sd


def _alt_block(sd, p: str, node: Mapping):
    _norm(sd, f"{p}.norm1", node["norm1"])
    _norm(sd, f"{p}.norm2", node["norm2"])
    _dense(sd, f"{p}.attn.qkv", node["attn"]["qkv"])
    _dense(sd, f"{p}.attn.proj", node["attn"]["proj"])
    _dense(sd, f"{p}.mlp.fc1", node["fc1"])
    _dense(sd, f"{p}.mlp.fc2", node["fc2"])


def emotion2vec_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params'}`` of funasr_tpu's ``Emotion2vecModule`` -> the port's
    ``Emotion2vec`` ``state_dict``: the inverse of funasr_tpu/convert.py
    ``emotion2vec_from_torch`` (:849); flax Conv ``(k, in, out)`` ->
    ``(out, in, k)``."""
    tree = params["params"]
    A = "modality_encoders.AUDIO"
    conv = lambda k: _t(np.transpose(np.asarray(k), (2, 1, 0)))  # noqa: E731
    sd: Dict[str, torch.Tensor] = {}
    le = tree["local_encoder"]
    i = 0
    while f"conv{i}" in le:
        sd[f"{A}.local_encoder.conv_layers.{i}.0.weight"] = conv(le[f"conv{i}"]["kernel"])
        _norm(sd, f"{A}.local_encoder.conv_layers.{i}.2.1", le[f"ln{i}"])
        i += 1
    _norm(sd, f"{A}.project_features.1", tree["project_ln"])
    _dense(sd, f"{A}.project_features.2", tree["project_proj"])
    i = 0
    while f"pos_conv{i}" in tree:
        sd[f"{A}.relative_positional_encoder.{i + 1}.0.weight"] = conv(
            tree[f"pos_conv{i}"]["kernel"])
        sd[f"{A}.relative_positional_encoder.{i + 1}.0.bias"] = _t(tree[f"pos_conv{i}"]["bias"])
        i += 1
    sd[f"{A}.extra_tokens"] = _t(tree["extra_tokens"])
    sd[f"{A}.alibi_scale"] = _t(tree["alibi_scale"])
    for stack, prefix in (("prenet_blocks", f"{A}.context_encoder.blocks"),
                          ("blocks", "blocks")):
        blocks = tree[stack]["block"]
        for i in range(_num_layers(blocks)):
            _alt_block(sd, f"{prefix}.{i}", _unstack(blocks, i))
    _norm(sd, f"{A}.context_encoder.norm", tree["context_norm"])
    _dense(sd, "proj", tree["proj"])
    return sd
