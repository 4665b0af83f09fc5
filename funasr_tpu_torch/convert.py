"""JAX parameters -> the port's ``state_dict``.

The inverse of ``funasr_tpu/convert/torch_to_jax.py``'s ``convert_paraformer`` (the
BiCif predictor's head, the PIF predictor and the CTC head included, ``:154-192``),
``convert_fsmn_vad``, ``convert_ct_transformer``, ``convert_campplus`` (``:244-288``),
``convert_sense_voice``, ``convert_paraformer_v2`` and ``convert_monotonic_aligner``
(``:339-401, 564``): it takes the JAX
package's parameter tree (as numpy arrays) and gives the tensors that the port model's
``load_state_dict`` takes, under FunASR's state-dict names. Layouts:

* scanned layer stacks (``encoders``, ``decoders``, ``decoders2``, SenseVoice's
  ``tp_encoders``) -> ``name.{i}``;
  single-module lists (``encoders0``, ``decoders3``) and ``embed`` -> ``name.0``;
* Linear ``w`` (in, out) -> ``weight`` (out, in); LayerNorm ``scale`` -> ``weight``;
* depthwise conv ``w`` (k, C) -> ``weight`` (C, 1, k);
* full conv1d ``w`` (k, C_in, C_out) -> ``weight`` (C_out, C_in, k);
* Embedding ``w`` -> ``weight`` unchanged (CTTransformer's ``embed`` is one module,
  ``embed.weight``);
* a bare tensor beside layers (the PIF predictor's ``sigma`` and ``bias``) keeps its
  name; SenseVoice's query ``embed`` ``w`` -> ``embed.weight``; Paraformer-v2's
  model-level ``embed`` linear -> ``decoder.embed.0`` (the JAX decoder's own token table
  is dropped);
* the VAD's FSMN: ``fsmn`` is a list of blocks; ``linear`` / ``affine`` / ``in_linear*`` /
  ``out_linear*`` sit under FunASR's ``.linear``; the memory convs ``conv_left`` /
  ``conv_right`` ``w`` (k, C) -> ``fsmn_block.conv_*.weight`` (C, 1, k, 1);
* the CifPredictorV3 head: ``upsample_cnn`` ``w`` is torch's ConvTranspose1d
  (C_in, C_out, K) already and is not transposed; ``blstm_fw`` / ``blstm_bw`` ``w_ih`` /
  ``w_hh`` (in, 4H) -> ``blstm.weight_{ih,hh}_l0[_reverse]`` (4H, in);
* LSTM layers ``{w_ih, w_hh, b_ih, b_hh}`` (the hotword bias encoders: SeACo's list of
  two, Contextual's one) -> ``bias_encoder.weight_{ih,hh}_l{i}`` (transposed) and
  ``bias_{ih,hh}_l{i}``;
* ContextualParaformer's stacked decoder layers -> ``decoders.{i}`` for all but the last,
  which is ``last_decoder``; ``bias_output`` ``w`` (1, 2d, d) -> (d, 2d, 1); ``bias_embed``
  unchanged;
* CAM++: conv2d ``w`` HWIO -> ``weight`` OIHW; batch norm ``mean`` / ``var`` / ``scale``
  / ``bias`` -> ``running_mean`` / ``running_var`` / ``weight`` / ``bias``, plus a zero
  ``num_batches_tracked``; the FCM blocks ``head.layer{1,2}.{i}`` (0-based) with
  ``shortcut.0`` / ``shortcut.1``, the dense layers ``xvector.block{i}.tdnnd{j}``
  (1-based), every batch norm of the trunk under ``.batchnorm``;
* int8 linears of ``ops/quant.py::quantize_params_int8`` (``{w_q8 | w_q, scale[, b]}``)
  -> ``Int8Linear`` tensors: ``w_q8`` / ``w_q`` (in, out) -> (out, in), kept int8.
  The target model is quantized first (``funasr_tpu_torch.ops.quant``, same mode), so
  its state dict has the int8 names.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_STACKED = ("encoders", "decoders", "decoders2", "tp_encoders")
_SINGLE = ("encoders0", "decoders3", "embed")


def _leaf(p: Dict[str, np.ndarray], prefix: str, target: Dict[str, torch.Tensor]):
    """One JAX layer dict -> {torch name: array}, laid out as ``target`` expects."""
    if set(p) == {"scale", "bias"}:
        return {prefix + "weight": p["scale"], prefix + "bias": p["bias"]}
    q = next((k for k in ("w_q8", "w_q") if k in p), None)
    if q is not None:
        out = {prefix + q: np.asarray(p[q]).T, prefix + "scale": p["scale"]}
        if "b" in p:
            out[prefix + "bias"] = p["b"]
        return out
    w = np.asarray(p["w"])
    tw = target[prefix + "weight"]
    if w.ndim == 3:  # full conv1d (k, C_in, C_out)
        w = w.transpose(2, 1, 0)
    elif tw.dim() == 3:  # depthwise conv (k, C)
        w = w.T[:, None, :]
    elif not prefix.endswith("embed.0."):  # linear (in, out)
        w = w.T
    out = {prefix + "weight": w}
    if "b" in p:
        out[prefix + "bias"] = p["b"]
    return out


def _walk(tree, prefix: str, target, out):
    if all(not isinstance(v, dict) for v in tree.values()):
        out.update(_leaf(tree, prefix, target))
        return
    for name, sub in tree.items():
        if not isinstance(sub, dict):  # a bare tensor beside layers (PIF's sigma, bias)
            out[f"{prefix}{name}"] = sub
        elif name in _STACKED:
            n = len(next(iter(_flatten(sub))))
            for i in range(n):
                _walk(_index(sub, i), f"{prefix}{name}.{i}.", target, out)
        elif name in _SINGLE:
            _walk(sub, f"{prefix}{name}.0.", target, out)
        else:
            _walk(sub, f"{prefix}{name}.", target, out)


def _flatten(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flatten(v)
        else:
            yield v


def _index(tree, i: int):
    return {k: _index(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _fsmn_vad(tree, target, out):
    enc = tree["encoder"]

    def linear(prefix, p):
        out[prefix + "weight"] = np.asarray(p["w"]).T
        if "b" in p:
            out[prefix + "bias"] = p["b"]

    for name in ("in_linear1", "in_linear2", "out_linear1", "out_linear2"):
        linear(f"encoder.{name}.linear.", enc[name])
    for i, block in enumerate(enc["fsmn"]):
        prefix = f"encoder.fsmn.{i}."
        linear(prefix + "linear.linear.", block["linear"])
        linear(prefix + "affine.linear.", block["affine"])
        for conv in ("conv_left", "conv_right"):
            if conv in block:
                w = np.asarray(block[conv]["w"]).T  # (C, k)
                out[f"{prefix}fsmn_block.{conv}.weight"] = w[:, None, :, None]


def _ct_transformer(tree, target, out):
    out["embed.weight"] = tree["embed"]["w"]
    _walk(tree["encoder"], "encoder.", target, out)
    _walk(tree["decoder"], "decoder.", target, out)


def _generic(tree, target, out):  # Paraformer
    _walk(tree, "", target, out)


def _bicif(tree, target, out):
    """Paraformer, with the CifPredictorV3 head's transposed conv and BLSTM by hand."""
    pred = dict(tree["predictor"])
    up = pred.pop("upsample_cnn", None)
    lstm = {"": pred.pop("blstm_fw", None), "_reverse": pred.pop("blstm_bw", None)}
    _walk({**tree, "predictor": pred}, "", target, out)
    if up is not None:
        out["predictor.upsample_cnn.weight"] = up["w"]
        out["predictor.upsample_cnn.bias"] = up["b"]
    for suffix, p in lstm.items():
        if p is not None:
            _lstm_layer(p, "predictor.blstm", "l0" + suffix, out)


def _lstm_layer(p, prefix: str, suffix: str, out):
    for name in ("ih", "hh"):
        out[f"{prefix}.weight_{name}_{suffix}"] = np.asarray(p[f"w_{name}"]).T
        out[f"{prefix}.bias_{name}_{suffix}"] = p[f"b_{name}"]


def _seaco(tree, target, out):
    """BiCif, plus the 2-layer ``bias_encoder`` (the rest walks by name)."""
    rest = {k: v for k, v in tree.items() if k != "bias_encoder"}
    _bicif(rest, target, out)
    for i, p in enumerate(tree["bias_encoder"]):
        _lstm_layer(p, "bias_encoder", f"l{i}", out)


def _contextual(tree, target, out):
    """The stacked decoder layers split into ``decoders`` and ``last_decoder``, the
    1-layer ``bias_encoder`` and ``bias_embed`` by hand."""
    dec = dict(tree["decoder"])
    stacked = dec.pop("decoders")
    rest = {k: v for k, v in tree.items() if k not in ("bias_encoder", "bias_embed")}
    _bicif({**rest, "decoder": dec}, target, out)
    n = len(next(iter(_flatten(stacked))))
    for i in range(n):
        prefix = f"decoder.decoders.{i}." if i < n - 1 else "decoder.last_decoder."
        _walk(_index(stacked, i), prefix, target, out)
    _lstm_layer(tree["bias_encoder"], "bias_encoder", "l0", out)
    out["bias_embed.weight"] = tree["bias_embed"]["w"]


def _sense_voice(tree, target, out):
    """The stacks walk by name (``tp_encoders`` too); the query table is one
    ``nn.Embedding``, ``embed.weight``."""
    _walk({k: v for k, v in tree.items() if k != "embed"}, "", target, out)
    out["embed.weight"] = tree["embed"]["w"]


def _paraformer_v2(tree, target, out):
    """The model-level ``embed`` linear is FunASR's ``decoder.embed.0``; the JAX
    decoder's own token table (training's glancing sampler) has no counterpart."""
    dec = {k: v for k, v in tree["decoder"].items() if k != "embed"}
    rest = {k: v for k, v in tree.items() if k not in ("decoder", "embed")}
    _walk({**rest, "decoder": dec}, "", target, out)
    out["decoder.embed.0.weight"] = np.asarray(tree["embed"]["w"]).T
    out["decoder.embed.0.bias"] = tree["embed"]["b"]


def _campplus(tree, target, out):
    def bn(prefix, p):
        out[prefix + "running_mean"] = p["mean"]
        out[prefix + "running_var"] = p["var"]
        out[prefix + "num_batches_tracked"] = np.zeros((), np.int64)
        if "scale" in p:
            out[prefix + "weight"] = p["scale"]
            out[prefix + "bias"] = p["bias"]

    def conv(prefix, p):
        w = np.asarray(p["w"])
        out[prefix + "weight"] = (w.transpose(3, 2, 0, 1) if w.ndim == 4  # HWIO -> OIHW
                                  else w.transpose(2, 1, 0))  # (k, C_in, C_out)
        if "b" in p:
            out[prefix + "bias"] = p["b"]

    head = tree["head"]
    for name in ("conv1", "conv2"):
        conv(f"head.{name}.", head[name])
    for name in ("bn1", "bn2"):
        bn(f"head.{name}.", head[name])
    for li in (1, 2):
        for bi, block in enumerate(head[f"layer{li}"]):
            prefix = f"head.layer{li}.{bi}."
            conv(prefix + "conv1.", block["conv1"])
            conv(prefix + "conv2.", block["conv2"])
            bn(prefix + "bn1.", block["bn1"])
            bn(prefix + "bn2.", block["bn2"])
            if "shortcut" in block:
                conv(prefix + "shortcut.0.", block["shortcut"]["conv"])
                bn(prefix + "shortcut.1.", block["shortcut"]["bn"])
    xv = tree["xvector"]
    conv("xvector.tdnn.linear.", xv["tdnn"]["linear"])
    bn("xvector.tdnn.nonlinear.batchnorm.", xv["tdnn"]["bn"])
    for i in range(1, 4):
        for j, layer in enumerate(xv[f"block{i}"]):
            prefix = f"xvector.block{i}.tdnnd{j + 1}."
            bn(prefix + "nonlinear1.batchnorm.", layer["nonlinear1"])
            conv(prefix + "linear1.", layer["linear1"])
            bn(prefix + "nonlinear2.batchnorm.", layer["nonlinear2"])
            for name, p in layer["cam_layer"].items():
                conv(f"{prefix}cam_layer.{name}.", p)
        bn(f"xvector.transit{i}.nonlinear.batchnorm.", xv[f"transit{i}"]["nonlinear"])
        conv(f"xvector.transit{i}.linear.", xv[f"transit{i}"]["linear"])
    bn("xvector.out_nonlinear.batchnorm.", xv["out_nonlinear"])
    if "dense" in xv:
        conv("xvector.dense.linear.", xv["dense"]["linear"])
        bn("xvector.dense.nonlinear.batchnorm.", xv["dense"]["nonlinear"])


_BY_MODEL = {"FsmnVADStreaming": _fsmn_vad, "CTTransformer": _ct_transformer,
             "CTTransformerStreaming": _ct_transformer,
             "BiCifParaformer": _bicif, "CAMPPlus": _campplus, "SeacoParaformer": _seaco,
             "ContextualParaformer": _contextual, "SenseVoiceSmall": _sense_voice,
             "ParaformerV2": _paraformer_v2, "MonotonicAligner": _bicif}


def params_from_jax(np_params, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """JAX params (nested dict of arrays) of a Paraformer (a CTC head included),
    BiCifParaformer, ParaformerStreaming (Paraformer's layout), SeacoParaformer,
    ContextualParaformer, FsmnVADStreaming, CTTransformer, CTTransformerStreaming,
    CAMPPlus, SenseVoiceSmall, CTCModel, ParaformerV2, EParaformer or MonotonicAligner
    -> ``model``'s state dict.

    Int8 and int64 tensors keep their type, every other leaf becomes fp32. Raises if the names or
    shapes do not match ``model.state_dict()`` exactly.
    """
    target = model.state_dict()
    out: Dict[str, np.ndarray] = {}
    _BY_MODEL.get(type(model).__name__, _generic)(np_params, target, out)
    if set(out) != set(target):
        raise KeyError(f"parameter names differ: missing {sorted(set(target) - set(out))}, "
                       f"unexpected {sorted(set(out) - set(target))}")
    sd = {}
    for name, arr in out.items():
        dtype = {torch.int8: np.int8, torch.int64: np.int64}.get(target[name].dtype,
                                                                 np.float32)
        t = torch.from_numpy(np.array(arr, dtype=dtype))  # a writable copy
        if t.shape != target[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(target[name].shape)}")
        sd[name] = t
    return sd
