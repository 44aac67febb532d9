"""Flax params -> FunASR torch ``state_dict`` for the port's Paraformer.

The inverse of funasr_tpu/convert.py ``paraformer_from_torch`` (:205),
written for the port (no import of the JAX package): it takes the
``{'params': ...}`` tree with numpy leaves and returns the state dict that
``funasr_torch.models.paraformer.model.Paraformer`` (and a reference
FunASR ``model.pt``) uses:

- Dense ``kernel (in, out)`` -> Linear ``weight (out, in)`` (transpose),
- FSMN ``(K, 1, D)`` -> depthwise Conv1d ``(D, 1, K)``,
- CIF ``cif_conv1d (K, Din, Dout)`` -> Conv1d ``(Dout, Din, K)``,
- LayerNorm ``scale/bias`` -> ``weight/bias``,
- scanned stacks ``(L, ...)`` -> ``encoders.{i}.*`` / ``decoders.{i}.*``.

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


def paraformer_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{'params': tree}`` (or the bare tree) of funasr_tpu's Paraformer
    -> the port's float32 ``state_dict``."""
    tree = params.get("params", params)
    sd: Dict[str, torch.Tensor] = {}

    enc = tree["encoder"]
    _enc_layer(sd, "encoder.encoders0.0", enc["encoders0"])
    if "encoders" in enc:
        for i in range(_num_layers(enc["encoders"])):
            _enc_layer(sd, f"encoder.encoders.{i}", _unstack(enc["encoders"], i))
    _norm(sd, "encoder.after_norm", enc["after_norm"])

    pred = tree["predictor"]
    sd["predictor.cif_conv1d.weight"] = _t(
        np.transpose(np.asarray(pred["cif_conv1d"]), (2, 1, 0)))
    sd["predictor.cif_conv1d.bias"] = _t(pred["cif_conv1d_bias"])
    _dense(sd, "predictor.cif_output", pred["cif_output"])

    dec = tree["decoder"]
    for stack in ("decoders", "decoders2"):
        if stack in dec:
            for i in range(_num_layers(dec[stack])):
                _dec_layer(sd, f"decoder.{stack}.{i}", _unstack(dec[stack], i))
    _dec_layer(sd, "decoder.decoders3.0", dec["decoders3"])
    _norm(sd, "decoder.after_norm", dec["after_norm"])
    _dense(sd, "decoder.output_layer", dec["output_layer"])
    if "embed" in dec:
        sd["decoder.embed.0.weight"] = _t(dec["embed"]["embedding"])
    else:
        vocab, d = np.asarray(dec["output_layer"]["kernel"]).shape[::-1]
        sd["decoder.embed.0.weight"] = torch.zeros((vocab, d))
    return sd
