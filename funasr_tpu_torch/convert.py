"""JAX parameters -> the port's ``state_dict``.

The inverse of ``funasr_tpu/convert/torch_to_jax.py``'s ``convert_paraformer`` (the
BiCif predictor's head, the PIF predictor and the CTC head included, ``:154-192``),
``convert_fsmn_vad``, ``convert_ct_transformer``, ``convert_campplus`` (``:244-288``),
``convert_sense_voice``, ``convert_paraformer_v2`` and ``convert_monotonic_aligner``
(``:339-401, 564``), ``convert_transducer`` (``:1374``; the JAX converter reads every
encoder as a Conformer, so an RWKV encoder's tree, which it cannot read, maps here by its
own names), ``convert_fun_asr_nano`` (FunASRNano and the LLMASR family, ``:688``)
and ``convert_whisper`` (``:735``; Hugging Face names), ``convert_scama`` /
``convert_uniasr`` (``:1297``, ``:1275``; the SCAMA decoder's ``embed_concat_ffn`` too,
which the JAX converter does not read), ``convert_lcbnet`` (``:1397``) and
``convert_eres2netv2`` (``:297``), ``convert_fsmn_kws`` (``:1218``),
``convert_emotion2vec`` (``:513``) and ``convert_mfcca`` (``:840``), ``convert_eend_ola``
(``:479``), ``convert_data2vec`` (``:963``; the folded positional conv back to a
weight-norm pair, the EMA teacher under ``ema.``) and ``convert_mossformer`` (``:915``),
and maps the trees of
SAASR, LCBNetNAR and OpenAIWhisperLIDModel, which have no JAX converter, by name: it
takes the JAX
package's parameter tree (as numpy arrays) and gives the tensors that the port model's
``load_state_dict`` takes, under FunASR's state-dict names. Layouts:

* scanned layer stacks (``encoders``, ``decoders``, ``decoders2``, SenseVoice's
  ``tp_encoders``) -> ``name.{i}``;
  single-module lists (``encoders0``, ``decoders3``) and ``embed`` -> ``name.0``;
* Linear ``w`` (in, out) -> ``weight`` (out, in); LayerNorm ``scale`` -> ``weight``;
* depthwise conv ``w`` (k, C) -> ``weight`` (C, 1, k);
* full conv1d ``w`` (k, C_in, C_out) -> ``weight`` (C_out, C_in, k);
* Embedding ``w`` -> ``weight`` unchanged (CTTransformer's and TransformerLM's
  ``embed`` is one module, ``embed.weight``; SeqRNNLM's ``encoder.weight``); a linear
  ``embed`` (a bias beside ``w``, the Transformer encoder's ``linear`` input layer) is
  transposed as any linear;
* conv2d subsampling (``embed`` with ``conv1`` / ``conv2`` / ``out``) -> FunASR's
  ``embed.conv.0`` / ``embed.conv.2`` (HWIO -> OIHW) / ``embed.out.0``;
* inference BatchNorm ``mean`` / ``var`` / ``scale`` / ``bias`` -> ``running_mean`` /
  ``running_var`` / ``weight`` / ``bias`` and a zero ``num_batches_tracked``;
* the Branchformer layers' ``merge_conv``, ``norm_ff1`` / ``ffn1``, ``norm_ff2`` /
  ``ffn2`` and cgMLP ``channel_proj1`` / ``norm_gate`` / ``conv_gate`` -> FunASR's
  ``depthwise_conv_fusion``, ``norm_ff_macaron`` / ``feed_forward_macaron``, ``norm_ff``
  / ``feed_forward``, ``cgmlp.channel_proj1.0`` / ``cgmlp.csgu.norm`` /
  ``cgmlp.csgu.conv``; a convolution decoder's list of layers -> ``decoders.{i}``, its
  ``self_conv`` -> ``self_attn``;
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
* Qwen (``convert_hf_qwen``'s tree) -> Hugging Face names under ``llm.``: bare norm
  weights -> ``.weight``; stacked MoE experts (E, in, out) -> ``mlp.experts.J.*`` (out,
  in); whisper towers -> OpenAI names (``blocks.N.attn.query``, ``mlp.0``, ``ln_post``);
  Whisper -> Hugging Face names, the encoder's sinusoids computed, as the JAX package
  computes them;
* LoRA factors beside a linear's ``w`` (``funasr_tpu/models/lora/layers.py``: ``lora_a``
  (in, r), ``lora_b`` (r, out)) -> ``lora_A`` (r, in), ``lora_B`` (out, r), the tensors
  ``models/lora/layers.py::lora_init`` attaches;
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
_SINGLE = ("encoders0", "decoders3", "embed", "embed_concat_ffn")


def _leaf(p: Dict[str, np.ndarray], prefix: str, target: Dict[str, torch.Tensor]):
    """One JAX layer dict -> {torch name: array}, laid out as ``target`` expects."""
    if set(p) == {"scale", "bias"}:
        return {prefix + "weight": p["scale"], prefix + "bias": p["bias"]}
    if "mean" in p:  # inference BatchNorm (the Conformer's convolution module)
        out = {prefix + "running_mean": p["mean"], prefix + "running_var": p["var"],
               prefix + "num_batches_tracked": np.zeros((), np.int64)}
        if "scale" in p:
            out.update({prefix + "weight": p["scale"], prefix + "bias": p["bias"]})
        return out
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
    elif not (prefix.endswith("embed.0.") and "b" not in p):  # linear (in, out); an
        w = w.T                                                # embedding has no bias
    out = {prefix + "weight": w}
    if "b" in p:
        out[prefix + "bias"] = p["b"]
    if "lora_a" in p:  # models/lora: a (in, r), b (r, out) -> lora_A (r, in), lora_B (out, r)
        out[prefix + "lora_A"] = np.asarray(p["lora_a"]).T
        out[prefix + "lora_B"] = np.asarray(p["lora_b"]).T
    return out


def _walk(tree, prefix: str, target, out):
    if all(not isinstance(v, dict) for v in tree.values()):
        out.update(_leaf(tree, prefix, target))
        return
    for name, sub in tree.items():
        if isinstance(sub, list):  # layers the JAX package keeps as a list
            for i, layer in enumerate(sub):
                _walk(layer, f"{prefix}{name}.{i}.", target, out)
        elif not isinstance(sub, dict):  # a bare tensor beside layers (PIF's sigma, bias)
            out[f"{prefix}{name}"] = sub
        elif name == "embed" and "conv1" in sub:  # conv2d subsampling
            _subsampling(sub, f"{prefix}embed.", out)
        elif name in _STACKED:
            n = len(next(iter(_flatten(sub))))
            for i in range(n):
                _walk(_index(sub, i), f"{prefix}{name}.{i}.", target, out)
        elif name in _SINGLE:
            _walk(sub, f"{prefix}{name}.0.", target, out)
        else:
            _walk(sub, f"{prefix}{name}.", target, out)


def _subsampling(tree, prefix: str, out):
    """Conv2d subsampling: ``conv1`` / ``conv2`` HWIO -> ``conv.0`` / ``conv.2`` OIHW,
    ``out`` -> ``out.0``."""
    for jname, tname in (("conv1", "conv.0"), ("conv2", "conv.2")):
        out[f"{prefix}{tname}.weight"] = np.asarray(tree[jname]["w"]).transpose(3, 2, 0, 1)
        out[f"{prefix}{tname}.bias"] = tree[jname]["b"]
    out[f"{prefix}out.0.weight"] = np.asarray(tree["out"]["w"]).T
    out[f"{prefix}out.0.bias"] = tree["out"]["b"]


# the Branchformer layer's JAX names -> FunASR's
_BRANCHFORMER = {"merge_conv": "depthwise_conv_fusion", "norm_ff1": "norm_ff_macaron",
                 "ffn1": "feed_forward_macaron", "norm_ff2": "norm_ff", "ffn2": "feed_forward"}
_CGMLP = {"channel_proj1": "channel_proj1.0", "norm_gate": "csgu.norm",
          "conv_gate": "csgu.conv", "channel_proj2": "channel_proj2"}


def _branchformer(tree, target, out):
    """The AED walked by name, the encoder layers' JAX names renamed to FunASR's."""
    enc = dict(tree["encoder"])
    layers = enc.pop("encoders")
    _walk({**tree, "encoder": enc}, "", target, out)
    n = len(next(iter(_flatten(layers))))
    for i in range(n):
        lp = _index(layers, i)
        cg = lp.pop("cgmlp")
        lp = {_BRANCHFORMER.get(k, k): v for k, v in lp.items()}
        _walk(lp, f"encoder.encoders.{i}.", target, out)
        for jname, tname in _CGMLP.items():
            out.update(_leaf(cg[jname], f"encoder.encoders.{i}.cgmlp.{tname}.", target))


def _conv_decoder_aed(tree, target, out):
    """A Transformer AED whose decoder is a convolution decoder: the JAX layers'
    ``self_conv`` is FunASR's ``self_attn``."""
    dec = dict(tree["decoder"])
    dec["decoders"] = [{("self_attn" if k == "self_conv" else k): v for k, v in lp.items()}
                       for lp in dec["decoders"]]
    _walk({**tree, "decoder": dec}, "", target, out)


def _transformer_lm(tree, target, out):
    """TransformerLM: the token table is one ``nn.Embedding`` (``embed.weight``)."""
    _walk({k: v for k, v in tree.items() if k != "embed"}, "", target, out)
    out["embed.weight"] = tree["embed"]["w"]


def _seq_rnn_lm(tree, target, out):
    """SeqRNNLM: FunASR's ``encoder`` (embedding), ``rnn`` (the LSTM stack) and
    ``decoder`` (head)."""
    out["encoder.weight"] = tree["embed"]["w"]
    for i, p in enumerate(tree["lstm"]):
        _lstm_layer(p, "rnn", f"l{i}", out)
    out.update(_leaf(tree["decoder"], "decoder.", target))


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


def _encoder(enc, target, out):
    """The encoder's subtree under ``encoder.``: an ``RWKVEncoder``'s stacked ``blocks``
    to ``blocks.{i}`` (its ``embed`` is a plain linear), any other walked by name."""
    if "blocks" not in enc:
        _walk({"encoder": enc}, "", target, out)
        return
    out.update(_leaf(enc["embed"], "encoder.embed.", target))
    out.update(_leaf(enc["after_norm"], "encoder.after_norm.", target))
    for i in range(len(next(iter(_flatten(enc["blocks"]))))):
        _walk(_index(enc["blocks"], i), f"encoder.blocks.{i}.", target, out)


def _transducer(tree, target, out):
    """Transducer / BAT (``convert_transducer``, ``torch_to_jax.py:1374-1394``): the
    encoder (a Conformer, a chunk Conformer or an RWKV encoder), the prediction net's
    ``embed`` and ``pred_lstm`` list -> ``decoder.embed`` and ``decoder.rnn.{i}``
    (one-layer LSTMs), ``joint`` -> ``joint_network``."""
    _encoder(tree["encoder"], target, out)
    out["decoder.embed.weight"] = tree["embed"]["w"]
    for i, p in enumerate(tree["pred_lstm"]):
        _lstm_layer(p, f"decoder.rnn.{i}", "l0", out)
    for name, p in tree["joint"].items():
        out.update(_leaf(p, f"joint_network.{name}.", target))


def _conformer_rwkv(tree, target, out):
    """ConformerRWKV: the Transformer AED's tree with an RWKV encoder."""
    _encoder(tree["encoder"], target, out)
    _walk({k: v for k, v in tree.items() if k != "encoder"}, "", target, out)


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


def _bn_leaf(out, prefix, p):
    out[prefix + "running_mean"] = p["mean"]
    out[prefix + "running_var"] = p["var"]
    out[prefix + "num_batches_tracked"] = np.zeros((), np.int64)
    if "scale" in p:
        out[prefix + "weight"] = p["scale"]
        out[prefix + "bias"] = p["bias"]


def _conv_leaf(out, prefix, p):
    w = np.asarray(p["w"])
    out[prefix + "weight"] = (w.transpose(3, 2, 0, 1) if w.ndim == 4  # HWIO -> OIHW
                              else w.transpose(2, 1, 0))  # (k, C_in, C_out)
    if "b" in p:
        out[prefix + "bias"] = p["b"]


def _eres2netv2(tree, target, out):
    """ERes2NetV2 (``convert_eres2netv2``, ``torch_to_jax.py:297``): the block lists ->
    ``layer{l}.{i}``, their ``convs`` / ``bns`` lists by index, ``fuse`` -> ``fuse_models``
    and every AFF's two convs and batch norms -> ``local_att.0`` / ``.1`` / ``.3`` /
    ``.4``."""
    def aff(prefix, p):
        for i, name in ((0, "conv1"), (3, "conv2")):
            _conv_leaf(out, f"{prefix}local_att.{i}.", p[name])
        for i, name in ((1, "bn1"), (4, "bn2")):
            _bn_leaf(out, f"{prefix}local_att.{i}.", p[name])

    _conv_leaf(out, "conv1.", tree["conv1"])
    _bn_leaf(out, "bn1.", tree["bn1"])
    for li in range(1, 5):
        for bi, block in enumerate(tree[f"layer{li}"]):
            prefix = f"layer{li}.{bi}."
            for name in ("conv1", "conv3"):
                _conv_leaf(out, prefix + name + ".", block[name])
            for name in ("bn1", "bn3"):
                _bn_leaf(out, prefix + name + ".", block[name])
            for j, (c, b) in enumerate(zip(block["convs"], block["bns"])):
                _conv_leaf(out, f"{prefix}convs.{j}.", c)
                _bn_leaf(out, f"{prefix}bns.{j}.", b)
            for j, p in enumerate(block["fuse"]):
                aff(f"{prefix}fuse_models.{j}.", p)
            if "shortcut" in block:
                _conv_leaf(out, prefix + "shortcut.0.", block["shortcut"]["conv"])
                _bn_leaf(out, prefix + "shortcut.1.", block["shortcut"]["bn"])
    _conv_leaf(out, "layer3_ds.", tree["layer3_ds"])
    aff("fuse34.", tree["fuse34"])
    out.update(_leaf(tree["seg_1"], "seg_1.", target))


def _uniasr(tree, target, out):
    """UniASR (``convert_uniasr``, ``torch_to_jax.py:1275``): the rest by name, the stride
    conv's (k, C_in, C_out) weight -> FunASR's ``stride_conv.conv``."""
    _walk({k: v for k, v in tree.items() if k != "stride_conv"}, "", target, out)
    _conv_leaf(out, "stride_conv.conv.", tree["stride_conv"])


def _lcbnet(tree, target, out):
    """LCBNet (``convert_lcbnet``, ``torch_to_jax.py:1397``): the Conformer AED and the
    fusion and bias-predictor blocks by name; the text encoder's JAX ``encoder`` level has
    no FunASR name (``text_encoder.encoders.{i}``, ``text_encoder.after_norm``)."""
    _walk({k: v for k, v in tree.items() if k != "text_encoder"}, "", target, out)
    te = tree["text_encoder"]
    _walk({"embed": te["embed"], **te["encoder"]}, "text_encoder.", target, out)


def _campplus(tree, target, out):
    head = tree["head"]
    for name in ("conv1", "conv2"):
        _conv_leaf(out, f"head.{name}.", head[name])
    for name in ("bn1", "bn2"):
        _bn_leaf(out, f"head.{name}.", head[name])
    for li in (1, 2):
        for bi, block in enumerate(head[f"layer{li}"]):
            prefix = f"head.layer{li}.{bi}."
            _conv_leaf(out, prefix + "conv1.", block["conv1"])
            _conv_leaf(out, prefix + "conv2.", block["conv2"])
            _bn_leaf(out, prefix + "bn1.", block["bn1"])
            _bn_leaf(out, prefix + "bn2.", block["bn2"])
            if "shortcut" in block:
                _conv_leaf(out, prefix + "shortcut.0.", block["shortcut"]["conv"])
                _bn_leaf(out, prefix + "shortcut.1.", block["shortcut"]["bn"])
    xv = tree["xvector"]
    _conv_leaf(out, "xvector.tdnn.linear.", xv["tdnn"]["linear"])
    _bn_leaf(out, "xvector.tdnn.nonlinear.batchnorm.", xv["tdnn"]["bn"])
    for i in range(1, 4):
        for j, layer in enumerate(xv[f"block{i}"]):
            prefix = f"xvector.block{i}.tdnnd{j + 1}."
            _bn_leaf(out, prefix + "nonlinear1.batchnorm.", layer["nonlinear1"])
            _conv_leaf(out, prefix + "linear1.", layer["linear1"])
            _bn_leaf(out, prefix + "nonlinear2.batchnorm.", layer["nonlinear2"])
            for name, p in layer["cam_layer"].items():
                _conv_leaf(out, f"{prefix}cam_layer.{name}.", p)
        _bn_leaf(out, f"xvector.transit{i}.nonlinear.batchnorm.", xv[f"transit{i}"]["nonlinear"])
        _conv_leaf(out, f"xvector.transit{i}.linear.", xv[f"transit{i}"]["linear"])
    _bn_leaf(out, "xvector.out_nonlinear.batchnorm.", xv["out_nonlinear"])
    if "dense" in xv:
        _conv_leaf(out, "xvector.dense.linear.", xv["dense"]["linear"])
        _bn_leaf(out, "xvector.dense.nonlinear.batchnorm.", xv["dense"]["nonlinear"])


_MHA = {"linear_q": "q_proj", "linear_k": "k_proj", "linear_v": "v_proj",
        "linear_out": "out_proj"}
_TOWER_MHA = {"linear_q": "query", "linear_k": "key", "linear_v": "value", "linear_out": "out"}


def _mha(p, prefix, names, target, out):
    for jname, tname in names.items():
        out.update(_leaf(p[jname], f"{prefix}{tname}.", target))


def _qwen(tree, prefix, target, out):
    """A ``QwenLM`` tree (``convert_hf_qwen``'s layout) -> Hugging Face names under
    ``prefix``; MoE experts stacked (E, in, out) -> ``mlp.experts.J.*``."""
    out[f"{prefix}model.embed_tokens.weight"] = tree["embed_tokens"]
    out[f"{prefix}model.norm.weight"] = tree["norm"]
    for i, lp in enumerate(tree["layers"]):
        pre = f"{prefix}model.layers.{i}."
        for name in ("input_layernorm", "post_attention_layernorm"):
            out[f"{pre}{name}.weight"] = lp[name]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out.update(_leaf(lp[name], f"{pre}self_attn.{name}.", target))
        for name in ("q_norm", "k_norm"):
            if name in lp:
                out[f"{pre}self_attn.{name}.weight"] = lp[name]
        if "experts" in lp:
            out.update(_leaf(lp["gate"], f"{pre}mlp.gate.", target))
            for name, p in lp["experts"].items():
                for j, w in enumerate(np.asarray(p["w"])):
                    out[f"{pre}mlp.experts.{j}.{name}.weight"] = w.T
        else:
            for name in ("gate_proj", "up_proj", "down_proj"):
                out.update(_leaf(lp[name], f"{pre}mlp.{name}.", target))
    if "lm_head" in tree:
        out.update(_leaf(tree["lm_head"], f"{prefix}lm_head.", target))


def _adaptor(tree, prefix, target, out):
    """Linear / Transformer / QFormer adaptors: leaves by name, ``blocks`` and
    ``layers`` lists -> ``name.{i}``, QFormer's ``queries`` as it is."""
    for name, sub in tree.items():
        if isinstance(sub, list):
            for i, block in enumerate(sub):
                _walk(block, f"{prefix}{name}.{i}.", target, out)
        elif isinstance(sub, dict):
            _walk(sub, f"{prefix}{name}.", target, out)
        else:
            out[f"{prefix}{name}"] = sub


def _whisper_tower(tree, prefix, target, out):
    """``OpenAIWhisperEncoderWarp`` / ``QwenAudioEncoder`` -> OpenAI whisper names."""
    for name in ("conv1", "conv2", "ln_post", "proj"):
        if name in tree:
            out.update(_leaf(tree[name], f"{prefix}{name}.", target))
    for i, lp in enumerate(tree["layers"]):
        pre = f"{prefix}blocks.{i}."
        _mha(lp["self_attn"], pre + "attn.", _TOWER_MHA, target, out)
        out.update(_leaf(lp["self_attn_layer_norm"], pre + "attn_ln.", target))
        out.update(_leaf(lp["final_layer_norm"], pre + "mlp_ln.", target))
        out.update(_leaf(lp["fc1"], pre + "mlp.0.", target))
        out.update(_leaf(lp["fc2"], pre + "mlp.2.", target))
    if "audio_bos_eos_token" in tree:
        out[f"{prefix}audio_bos_eos_token.weight"] = tree["audio_bos_eos_token"]


def _llm_asr(tree, target, out):
    """FunASRNano and the LLMASR family: the SAN-M (or whisper-tower) encoder, the
    adaptors, the Qwen LM and the CTC head."""
    enc = tree["audio_encoder"]
    if "conv1" in enc:
        _whisper_tower(enc, "audio_encoder.", target, out)
    else:
        _walk(enc, "audio_encoder.", target, out)
    for name in ("audio_adaptor", "ctc_decoder"):
        if name in tree:
            _adaptor(tree[name], f"{name}.", target, out)
    _qwen(tree["llm"], "llm.", target, out)
    if "ctc" in tree:
        _walk(tree["ctc"], "ctc.", target, out)


def _whisper_side(t, pre, target, out):
    """One Whisper tower's convs, layers and final norm -> Hugging Face names."""
    for name in ("conv1", "conv2", "layer_norm"):
        if name in t:
            out.update(_leaf(t[name], f"{pre}{name}.", target))
    for i, lp in enumerate(t["layers"]):
        lpre = f"{pre}layers.{i}."
        for attn in ("self_attn", "encoder_attn"):
            if attn in lp:
                _mha(lp[attn], f"{lpre}{attn}.", _MHA, target, out)
        for name in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm",
                     "fc1", "fc2"):
            if name in lp:
                out.update(_leaf(lp[name], f"{lpre}{name}.", target))


def _encoder_positions(pre, target, out):
    """The encoder's sinusoid table, which the JAX package computes, from
    ``models/whisper/model.py::sinusoids``."""
    from funasr_tpu_torch.models.whisper.model import sinusoids

    out[pre + "embed_positions.weight"] = sinusoids(*target[pre + "embed_positions.weight"].shape)


def _whisper(tree, target, out):
    """WhisperModel -> Hugging Face names; the encoder's sinusoid table computed."""
    for side in ("encoder", "decoder"):
        _whisper_side(tree[side], f"model.{side}.", target, out)
    _encoder_positions("model.encoder.", target, out)
    out["model.decoder.embed_tokens.weight"] = tree["decoder"]["embed_tokens"]
    out["model.decoder.embed_positions.weight"] = tree["decoder"]["embed_positions"]


def _prefixed(fn, tree, prefix, target, out):
    """``fn`` over a submodule's tree, its names under ``prefix``."""
    sub_target = {k[len(prefix):]: v for k, v in target.items() if k.startswith(prefix)}
    sub = {}
    fn(tree, sub_target, sub)
    out.update({prefix + k: v for k, v in sub.items()})


def _whisper_lid(tree, target, out):
    """OpenAIWhisperLIDModel (no JAX converter): the Whisper encoder under ``encoder.``
    (Hugging Face names), the ERes2NetV2 ``lid_predictor``, the linears by name."""
    _whisper_side(tree["encoder"], "encoder.", target, out)
    _encoder_positions("encoder.", target, out)
    _prefixed(_eres2netv2, tree["lid_predictor"], "lid_predictor.", target, out)
    _walk({k: v for k, v in tree.items() if k in ("proj_layer", "output_layer")}, "", target,
          out)


def _fsmn_kws(tree, target, out):
    """FsmnKWS / SanmKWS (``convert_fsmn_kws``, ``torch_to_jax.py:1218``): the FSMN as the
    VAD's, a SAN-M encoder and the CTC head by name."""
    if "fsmn" in tree["encoder"]:
        _fsmn_vad({"encoder": tree["encoder"]}, target, out)
        if "ctc" in tree:
            _walk({"ctc": tree["ctc"]}, "", target, out)
    else:
        _walk(tree, "", target, out)


def _emotion2vec(tree, target, out):
    """Emotion2vec (``convert_emotion2vec``, ``torch_to_jax.py:513``): FunASR's
    ``modality_encoders.AUDIO`` layout, the conv extractor's layers ``conv_layers.{i}.0``
    / ``.2.1``, ``project_features.1`` / ``.2``, the positional convs
    ``relative_positional_encoder.{i + 1}.0``, the prenet ``context_encoder``."""
    aud = "modality_encoders.AUDIO."
    for i, lp in enumerate(tree["local_encoder"]):
        pre = f"{aud}local_encoder.conv_layers.{i}."
        out[pre + "0.weight"] = np.asarray(lp["conv"]["w"]).transpose(2, 1, 0)
        out.update(_leaf(lp["norm"], pre + "2.1.", target))
    pf = tree["project_features"]
    out.update(_leaf(pf["norm"], aud + "project_features.1.", target))
    out.update(_leaf(pf["linear"], aud + "project_features.2.", target))
    for i, lp in enumerate(tree["pos_conv"]):
        pre = f"{aud}relative_positional_encoder.{i + 1}.0."
        out[pre + "weight"] = np.asarray(lp["w"]).transpose(2, 1, 0)
        out[pre + "bias"] = lp["b"]
    out[aud + "extra_tokens"] = tree["extra_tokens"]
    out[aud + "alibi_scale"] = tree["alibi_scale"]
    out.update(_leaf(tree["prenet_norm"], aud + "context_encoder.norm.", target))
    for pre, blocks in ((aud + "context_encoder.", tree["prenet_blocks"]), ("", tree["blocks"])):
        for i, bp in enumerate(blocks):
            _walk(bp, f"{pre}blocks.{i}.", target, out)
    if "proj" in tree:
        out.update(_leaf(tree["proj"], "proj.", target))


def _mfcca_encoder(enc, prefix, target, out):
    """MFCCAEncoder (``convert_mfcca``, ``torch_to_jax.py:840``): each block's
    ``norm_mha_cca`` / ``cca`` -> ``norm_mha`` / ``encoder_cros_channel_atten``, the rest
    under ``encoder_csa``; the four fusion convs HWIO -> OIHW."""
    for i, lp in enumerate(enc["encoders"]):
        pre = f"{prefix}encoders.{i}."
        _walk({"norm_mha": lp["norm_mha_cca"], "encoder_cros_channel_atten": lp["cca"]},
              pre, target, out)
        csa = {k: v for k, v in lp.items() if k not in ("norm_mha_cca", "cca")}
        _walk(csa, pre + "encoder_csa.", target, out)
    _walk({k: v for k, v in enc.items() if k in ("after_norm", "embed")}, prefix, target, out)
    for name in ("conv1", "conv2", "conv3", "conv4"):
        _conv_leaf(out, f"{prefix}{name}.", enc[name])


def _mfcca(tree, target, out):
    _mfcca_encoder(tree["encoder"], "encoder.", target, out)
    _walk({k: v for k, v in tree.items() if k != "encoder"}, "", target, out)


def _eend(tree, target, out):
    """DiarEENDOLA (``convert_eend_ola``, ``torch_to_jax.py:479``): the encoder's flat
    ``enc.lnorm1_{i}`` / ``enc.self_att_{i}`` / ``enc.lnorm2_{i}`` / ``enc.ff_{i}`` names,
    the EDA LSTMs and counter under ``encoder_decoder_attractor``, the PostNet LSTM."""
    enc = tree["encoder"]
    for i, lp in enumerate(enc["layers"]):
        _walk({f"lnorm1_{i}": lp["lnorm1"], f"self_att_{i}": lp["att"],
               f"lnorm2_{i}": lp["lnorm2"], f"ff_{i}": lp["ff"]}, "enc.", target, out)
    _walk({k: enc[k] for k in ("linear_in", "lnorm_out")}, "enc.", target, out)
    eda = "encoder_decoder_attractor."
    _lstm_layer(tree["eda_encoder"], eda + "encoder", "l0", out)
    _lstm_layer(tree["eda_decoder"], eda + "decoder", "l0", out)
    _lstm_layer(tree["postnet"], "postnet", "l0", out)
    _walk({"counter": tree["counter"]}, eda, target, out)
    _walk({"output_layer": tree["output_layer"]}, "", target, out)


def _data2vec_transformer(enc, prefix, target, out):
    """The transformer (``pos_conv``, ``layers``, ``layer_norm``) under ``prefix``; the
    folded positional conv w (K, C_in / groups, C_out) -> ``pos_conv.0.weight_v`` = w in
    torch's (C_out, C_in / groups, K) and ``weight_g`` = its norm over all but the taps,
    so that g v / ||v|| gives w back."""
    v = np.asarray(enc["pos_conv"]["w"], np.float32).transpose(2, 1, 0)
    out[prefix + "pos_conv.0.weight_v"] = v
    out[prefix + "pos_conv.0.weight_g"] = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    out[prefix + "pos_conv.0.bias"] = enc["pos_conv"]["b"]
    _walk({k: enc[k] for k in ("layers", "layer_norm")}, prefix, target, out)


def _data2vec_encoder(enc, prefix, target, out):
    """Data2VecEncoder (``convert_data2vec``, ``torch_to_jax.py:963``): the conv layers
    ``feature_extractor.conv_layers.{i}.0`` with ``.2`` (the group norm) or ``.2.1`` (a
    layer norm), the transformer under ``encoder.``, the linears and norms by name."""
    for i, lp in enumerate(enc["feature_extractor"]):
        pre = f"{prefix}feature_extractor.conv_layers.{i}."
        out[pre + "0.weight"] = np.asarray(lp["conv"]["w"]).transpose(2, 1, 0)
        if "group_norm" in lp:
            out.update(_leaf(lp["group_norm"], pre + "2.", target))
        if "norm" in lp:
            out.update(_leaf(lp["norm"], pre + "2.1.", target))
    _data2vec_transformer(enc["encoder"], prefix + "encoder.", target, out)
    out[prefix + "mask_emb"] = enc["mask_emb"]
    _walk({k: enc[k] for k in ("layer_norm", "post_extract_proj", "final_proj") if k in enc},
          prefix, target, out)


def _data2vec(tree, target, out):
    """Data2VecPretrainModel: the student under ``encoder.``, the EMA teacher's transformer
    under ``ema.``; a bare encoder tree (``Data2VecEncoder``) at the root."""
    if "student" not in tree:
        _data2vec_encoder(tree, "", target, out)
        return
    _data2vec_encoder(tree["student"], "encoder.", target, out)
    _data2vec_transformer(tree["ema"], "ema.", target, out)


def _conv1x1(p, prefix, out):
    """A 1x1 conv kept as a (C_in, C_out) matrix -> ``weight`` (C_out, C_in, 1)."""
    out[prefix + "weight"] = np.asarray(p["w"]).T[:, :, None]
    if "b" in p:
        out[prefix + "bias"] = p["b"]


def _mossformer(tree, target, out):
    """MossFormer (``convert_mossformer``, ``torch_to_jax.py:915``): the encoder and
    decoder convs, the MaskNet's 1x1 convs, each block's FFConvM ``mdl.0.g`` / ``mdl.1`` /
    ``mdl.3.sequential.1.conv`` and its offset-scale; the scalar scales -> (1,)."""
    out["enc.conv1d.weight"] = np.asarray(tree["enc"]["w"]).transpose(2, 1, 0)
    out["dec.weight"] = np.asarray(tree["dec"]["w"]).transpose(2, 1, 0)
    mn = "mask_net."
    out.update(_leaf(tree["norm"], mn + "norm.", target))
    out[mn + "pos_enc.scale"] = np.reshape(tree["pos_scale"], (1,))
    for name in ("conv1d_encoder", "conv1d_out", "conv1_decoder"):
        _conv1x1(tree[name], f"{mn}{name}.", out)
    for name in ("output", "output_gate"):
        _conv1x1(tree[name], f"{mn}{name}.0.", out)
    out.update(_leaf(tree["mossformer_norm"], mn + "mdl.intra_mdl.norm.", target))
    out.update(_leaf(tree["intra_norm"], mn + "mdl.intra_norm.", target))
    out[mn + "prelu.weight"] = np.reshape(tree["prelu"], (1,))
    for i, bp in enumerate(tree["blocks"]):
        pre = f"{mn}mdl.intra_mdl.mossformerM.layers.{i}."
        for name in ("to_hidden", "to_qk", "to_out"):
            f = bp[name]
            out[f"{pre}{name}.mdl.0.g"] = np.reshape(f["norm"]["g"], (1,))
            out.update(_leaf(f["linear"], f"{pre}{name}.mdl.1.", target))
            out[f"{pre}{name}.mdl.3.sequential.1.conv.weight"] = np.asarray(
                f["conv"]["w"]).T[:, None, :]
        out[pre + "qk_offset_scale.gamma"] = bp["qk_offset_scale"]["gamma"]
        out[pre + "qk_offset_scale.beta"] = bp["qk_offset_scale"]["beta"]


_LLM_ASR_NAMES = ("FunASRNano", "GLMASR", "LLMASR", "LLMASR2", "LLMASR3", "LLMASR4", "LLMASRNAR",
                  "LLMASRNARPrompt", "LLMASRVersions", "Qwen3ASR", "QwenAudio", "MinMo")

_BY_MODEL = {"FsmnVADStreaming": _fsmn_vad, "CTTransformer": _ct_transformer,
             "CTTransformerStreaming": _ct_transformer,
             "BiCifParaformer": _bicif, "CAMPPlus": _campplus, "SeacoParaformer": _seaco,
             "ContextualParaformer": _contextual, "SenseVoiceSmall": _sense_voice,
             "ParaformerV2": _paraformer_v2, "MonotonicAligner": _bicif,
             "WhisperModel": _whisper, "Branchformer": _branchformer,
             "EBranchformer": _branchformer, "TransformerLM": _transformer_lm,
             "SeqRNNLM": _seq_rnn_lm, "Transducer": _transducer,
             "ConformerRWKV": _conformer_rwkv, "UniASR": _uniasr, "LCBNet": _lcbnet,
             "ERes2NetV2": _eres2netv2, "FsmnKWS": _fsmn_kws, "Emotion2vec": _emotion2vec,
             "MFCCA": _mfcca, "OpenAIWhisperLIDModel": _whisper_lid, "DiarEENDOLA": _eend,
             "Data2VecPretrainModel": _data2vec, "Data2VecEncoder": _data2vec,
             "MossFormer": _mossformer,
             **{name: _llm_asr for name in _LLM_ASR_NAMES}}


def params_from_jax(np_params, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """JAX params (nested dict of arrays) of a Paraformer (a CTC head included; its
    encoder a SAN-M or a Conformer), BiCifParaformer, ParaformerStreaming (Paraformer's
    layout), SeacoParaformer, ContextualParaformer, FsmnVADStreaming, CTTransformer,
    CTTransformerStreaming, CAMPPlus, SenseVoiceSmall, CTCModel, ParaformerV2,
    EParaformer, MonotonicAligner, FunASRNano, the LLMASR family (GLMASR included), a
    WhisperModel of any size, the Transformer AEDs (Transformer, SANM, Conformer,
    Branchformer, EBranchformer; a convolution decoder too), TransformerLM, SeqRNNLM,
    Transducer and BAT (a Conformer, chunk Conformer or RWKV encoder), ConformerRWKV,
    SCAMA, UniASR, LCBNet, ERes2NetV2, FsmnKWS / SanmKWS (and their streaming names),
    Emotion2vec, MFCCA, SAASR, LCBNetNAR (Paraformer's layout and their own linears and
    attentions by name), OpenAIWhisperLIDModel, DiarEENDOLA, Data2VecPretrainModel (or a
    bare Data2VecEncoder) or MossFormer -> ``model``'s state dict.

    Int8 and int64 tensors keep their type, every other leaf becomes fp32. Raises if the names or
    shapes do not match ``model.state_dict()`` exactly.
    """
    target = model.state_dict()
    out: Dict[str, np.ndarray] = {}
    # the nearest class with a converter: each Whisper size subclasses WhisperModel
    fn = next((_BY_MODEL[c.__name__] for c in type(model).__mro__ if c.__name__ in _BY_MODEL),
              _generic)
    if fn is _generic and isinstance(np_params.get("decoder", {}).get("decoders"), list):
        fn = _conv_decoder_aed
    fn(np_params, target, out)
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
