"""Inference from exported programs without the model code, and the weight writers of
the C++ runtime (a counterpart of ``funasr_tpu/export_runtime.py``).

``ExportedModel(dir).transcribe(wavs)`` loads what ``bin/export.py`` writes: the
``torch.export`` programs of the manifest, ``params.pt``, the frontend from
``config.yaml`` and ``am.mvn``, and ``tokens.txt``. The program is the model: this module
imports no module of ``funasr_tpu_torch.models``, and imports ``funasr_tpu_torch.ops``
only so that the kernels' custom ops are registered before the programs load.

The FTR writers (``save_params_npz``, ``_write_ftr``, ``export_ftr``, ``export_vad_ftr``,
``export_punc_ftr``, ``export_sensevoice_ftr``, ``export_native_dir``) take the port's
modules and write the bytes that the JAX package's writers write from the same weights:
the C++ engine's tensor names (the JAX parameter tree's, ``/``-joined, layers
``name.{i}``), layouts (linear ``w`` (in, out), depthwise conv ``w`` (k, C)), order and
metadata (``runtime/funasr_tpu_runtime/src/ftr.h``).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

import funasr_tpu_torch.ops.flash_attention  # noqa: F401  (registers the custom ops)
import funasr_tpu_torch.ops.fsmn  # noqa: F401
import funasr_tpu_torch.ops.w8a8  # noqa: F401


class ExportedModel:
    """``ExportedModel(dir, device="cuda").transcribe(wavs) -> [text, ...]``."""

    def __init__(self, export_dir: str, device: str = "cuda"):
        import yaml

        from funasr_tpu_torch.frontends.wav_frontend import WavFrontend

        with open(os.path.join(export_dir, "export_manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != "torch.export":
            raise ValueError(f"not a torch.export directory: {manifest.get('format')!r}")
        self.device = torch.device(device)
        if manifest["device"] != self.device.type:
            raise ValueError(f"the programs were exported on {manifest['device']}; they run "
                             f"there (constants bake the device in), not on {device}")
        if self.device.type == "cuda" and self.device.index is None:  # as tensors report it
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.params = {k: v.to(self.device) for k, v in torch.load(
            os.path.join(export_dir, "params.pt"), map_location="cpu",
            weights_only=True).items()}
        self.functions = []
        for entry in manifest["functions"]:
            program = torch.export.load(os.path.join(export_dir, entry["file"]))
            self.functions.append({**entry, "call": bind_weights(program, self.params)})
        self.functions.sort(key=lambda e: (e["batch"], e["frames"]))

        cfg_path = os.path.join(export_dir, "config.yaml")
        self.config = {}
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                self.config = yaml.safe_load(f) or {}
        self.tokens: Optional[List[str]] = None
        tok_path = os.path.join(export_dir, "tokens.txt")
        if os.path.exists(tok_path):
            with open(tok_path, encoding="utf-8") as f:
                self.tokens = f.read().splitlines()
        fconf = dict(self.config.get("frontend_conf") or {})
        cmvn = os.path.join(export_dir, "am.mvn")
        if os.path.exists(cmvn):
            fconf["cmvn_file"] = cmvn
        self.frontend = WavFrontend(**fconf)

    def _pick(self, b: int, t: int):
        for e in self.functions:
            if e["batch"] >= b and e["frames"] >= t:
                return e
        return self.functions[-1]

    def __call__(self, speech, lengths):
        """(B, T, D) features and (B,) lengths, padded to a bucket's shape -> that
        program's (yseq, token_lens, score)."""
        e = next((e for e in self.functions
                  if (e["batch"], e["frames"]) == tuple(speech.shape[:2])), None)
        if e is None:
            raise ValueError(f"no program for (B, T) = {tuple(speech.shape[:2])}: "
                             f"{[(f['batch'], f['frames']) for f in self.functions]}")
        if speech.shape[2:] != (e["input_dim"],) or speech.dtype != torch.float32 \
                or lengths.shape != (e["batch"],) or lengths.dtype != torch.int32 \
                or speech.device != self.device or lengths.device != self.device:
            raise ValueError(f"the program takes ({e['batch']}, {e['frames']}, "
                             f"{e['input_dim']}) float32 features and ({e['batch']},) int32 "
                             f"lengths on {self.device}: got {tuple(speech.shape)} "
                             f"{speech.dtype} on {speech.device}, {tuple(lengths.shape)} "
                             f"{lengths.dtype} on {lengths.device}")
        with torch.inference_mode():
            return e["call"](speech, lengths)

    def transcribe(self, wavs, fs: int = 16000) -> List[str]:
        """wavs: 1-D waveforms (float32 in [-1, 1) or int16 PCM) or file paths -> texts.
        A batch pads to the smallest bucket that holds it (extra rows repeat row 0, as
        the eager decode pads; frames past a bucket's are cut, as in the JAX package).
        Texts follow the eager decode's ``sentence_postprocess`` (the JAX package's
        loader joins the raw tokens, ``<unk>`` included)."""
        from funasr_tpu_torch.utils.load_utils import load_audio_text_image_video
        from funasr_tpu_torch.utils.postprocess_utils import sentence_postprocess

        audio = load_audio_text_image_video(list(wavs), fs=self.frontend.fs, audio_fs=fs)
        feats, lens = self.frontend.extract(audio, device=self.device)
        b, t = feats.shape[0], int(lens.max())
        e = self._pick(b, t)
        feats, lens = feats[:, :e["frames"]], torch.clamp(lens, max=e["frames"])
        speech = torch.zeros((e["batch"], e["frames"], feats.shape[-1]),
                             dtype=torch.float32, device=self.device)
        speech[:b, :feats.shape[1]] = feats
        speech[b:] = speech[:1]
        lengths = torch.cat([lens, lens[:1].expand(e["batch"] - b)]).to(torch.int32)
        yseq, token_lens, _ = self(speech, lengths)
        yseq, token_lens = yseq.cpu().numpy(), token_lens.cpu().numpy()
        out = []
        for i in range(b):
            ids = [int(x) for x in yseq[i, :token_lens[i]] if x > 2]
            if self.tokens:  # the eager decode's text rule (<unk> dropped, BPE joined)
                out.append(sentence_postprocess(
                    [self.tokens[j] for j in ids if j < len(self.tokens)])[0])
            else:
                out.append(" ".join(map(str, ids)))
        return out


def bind_weights(program, params):
    """A function ``(speech, lengths) -> (yseq, token_lens, score)`` that runs
    ``program``'s graph over ``params``, bound once here.

    ``program.module()`` would flatten every weight and check it against the program's
    input spec on every call, and run an ``_assert_tensor_metadata`` before each of the
    graph's dtype casts. Here the weights are checked once against
    the graph's placeholders (shape, dtype, device), ``__call__`` checks the features
    and lengths, and the asserts are dropped: with the inputs the trace saw, every
    cast's input has the dtype and device it was traced with."""
    import torch.utils._pytree as pytree
    from torch.export.graph_signature import InputKind

    specs = program.graph_signature.input_specs
    gm = program.graph_module
    holes = [object(), object()]  # speech and lengths, the last two user inputs
    flat, spec = pytree.tree_flatten(((params, *holes), {}))
    if spec != program.call_spec.in_spec:
        raise ValueError("params.pt does not hold the weights the program was traced with")
    user = iter(flat)
    lifted = {InputKind.PARAMETER: program.state_dict, InputKind.BUFFER: program.state_dict,
              InputKind.CONSTANT_TENSOR: program.constants}
    args = [lifted[s.kind][s.target] if s.kind in lifted else next(user) for s in specs]
    if [s.kind for s in specs[-2:]] != [InputKind.USER_INPUT] * 2 \
            or any(a is not h for a, h in zip(args[-2:], holes)):
        raise ValueError("the program's last inputs must be its features and lengths")
    args = args[:-2]
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for node, x in zip(placeholders, args):
        val = node.meta.get("val")
        if val is not None and (tuple(val.shape) != tuple(x.shape) or val.dtype != x.dtype
                                or val.device.type != x.device.type):
            raise ValueError(f"weight {node.name}: {tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"the program was traced with {tuple(val.shape)} {val.dtype} "
                             f"on {val.device}")
    for node in list(gm.graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            gm.graph.erase_node(node)
    gm.recompile()

    def call(speech, lengths):
        return tuple(gm(*args, speech, lengths))
    return call


# ---------------------------------------------------------------------------
# The JAX parameter tree of a port module (numpy), as the JAX package's converter
# (``funasr_tpu/convert/torch_to_jax.py``) builds it from the same state dict: linear
# ``w`` (in, out), LayerNorm ``scale``, depthwise conv ``w`` (k, C), full conv1d ``w``
# (k, C_in, C_out); layer stacks stacked on a new leading axis, each layer's dicts in
# name order (its ``stack_params`` is a ``jax.tree_util.tree_map``, which sorts keys).
# ---------------------------------------------------------------------------


class _SD:
    """A state-dict view with prefix navigation (the converter's ``SD``)."""

    def __init__(self, sd, prefix: str = ""):
        self.sd, self.prefix = sd, prefix

    def sub(self, name: str) -> "_SD":
        return _SD(self.sd, self.prefix + name + ".")

    def get(self, name: str) -> np.ndarray:
        return self.sd[self.prefix + name].detach().float().cpu().numpy()

    def has(self, name: str) -> bool:
        return (self.prefix + name) in self.sd

    def linear(self, name: str):
        p = {"w": self.get(name + ".weight").T}
        if self.has(name + ".bias"):
            p["b"] = self.get(name + ".bias")
        return p

    def norm(self, name: str):
        return {"scale": self.get(name + ".weight"), "bias": self.get(name + ".bias")}

    def dwconv(self, name: str):
        p = {"w": self.get(name + ".weight")[:, 0, :].T}  # (C, 1, K) -> (K, C)
        if self.has(name + ".bias"):
            p["b"] = self.get(name + ".bias")
        return p

    def conv1d(self, name: str):
        p = {"w": self.get(name + ".weight").transpose(2, 1, 0)}
        if self.has(name + ".bias"):
            p["b"] = self.get(name + ".bias")
        return p


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _stack(layers):
    """``stack_params``: identically shaped layer trees -> one tree of stacked arrays."""
    first = _sorted(layers[0])
    if isinstance(first, dict):
        return {k: _stack([layer[k] for layer in layers]) for k in first}
    return np.stack(layers, axis=0)


def _unstack(stacked, n: int):
    """``unstack_params``: the inverse of ``_stack``."""
    def take(node, i):
        return {k: take(v, i) for k, v in node.items()} if isinstance(node, dict) else node[i]
    return [take(stacked, i) for i in range(n)]


def _enc_layer(s: _SD):
    return {"norm1": s.norm("norm1"), "norm2": s.norm("norm2"),
            "self_attn": {"linear_q_k_v": s.linear("self_attn.linear_q_k_v"),
                          "linear_out": s.linear("self_attn.linear_out"),
                          "fsmn_block": s.dwconv("self_attn.fsmn_block")},
            "feed_forward": {"w_1": s.linear("feed_forward.w_1"),
                             "w_2": s.linear("feed_forward.w_2")}}


def _sanm_encoder(sd: _SD, num_blocks: int, tp_blocks: int = None):
    params = {"encoders0": _enc_layer(sd.sub("encoders0.0")),
              "after_norm": sd.norm("after_norm")}
    if tp_blocks is not None:
        params["tp_norm"] = sd.norm("tp_norm")
    if num_blocks > 1:
        params["encoders"] = _stack([_enc_layer(sd.sub(f"encoders.{i}"))
                                     for i in range(num_blocks - 1)])
    if tp_blocks:
        params["tp_encoders"] = _stack([_enc_layer(sd.sub(f"tp_encoders.{i}"))
                                        for i in range(tp_blocks)])
    return params


def _dec_layer(s: _SD, has_self: bool, has_src: bool):
    p = {"norm1": s.norm("norm1"),
         "feed_forward": {"w_1": s.linear("feed_forward.w_1"),
                          "norm": s.norm("feed_forward.norm"),
                          "w_2": s.linear("feed_forward.w_2")}}
    if has_self:
        p["norm2"] = s.norm("norm2")
        p["self_attn"] = {"fsmn_block": s.dwconv("self_attn.fsmn_block")}
    if has_src:
        p["norm3"] = s.norm("norm3")
        p["src_attn"] = {"linear_q": s.linear("src_attn.linear_q"),
                         "linear_k_v": s.linear("src_attn.linear_k_v"),
                         "linear_out": s.linear("src_attn.linear_out")}
    return p


def _paraformer_decoder(sd: _SD, cfg):
    params = {"decoders": _stack([_dec_layer(sd.sub(f"decoders.{i}"), True, True)
                                  for i in range(cfg.att_layer_num)]),
              "decoders3": _dec_layer(sd.sub("decoders3.0"), False, False),
              "after_norm": sd.norm("after_norm")}
    if cfg.num_blocks - cfg.att_layer_num > 0:
        params["decoders2"] = _stack([_dec_layer(sd.sub(f"decoders2.{i}"), True, False)
                                      for i in range(cfg.num_blocks - cfg.att_layer_num)])
    if cfg.use_output_layer:
        params["output_layer"] = sd.linear("output_layer")
    if sd.has("embed.0.weight"):
        params["embed"] = {"w": sd.get("embed.0.weight")}
    return params


def _cif_predictor(sd: _SD):
    params = {"cif_conv1d": sd.conv1d("cif_conv1d"), "cif_output": sd.linear("cif_output")}
    if sd.has("upsample_cnn.weight"):  # CifPredictorV3's timestamp head
        params["upsample_cnn"] = {"w": sd.get("upsample_cnn.weight"),
                                  "b": sd.get("upsample_cnn.bias")}
        params["cif_output2"] = sd.linear("cif_output2")
    if sd.has("blstm.weight_ih_l0"):
        for side, suffix in (("blstm_fw", ""), ("blstm_bw", "_reverse")):
            params[side] = {"w_ih": sd.get(f"blstm.weight_ih_l0{suffix}").T,
                            "w_hh": sd.get(f"blstm.weight_hh_l0{suffix}").T,
                            "b_ih": sd.get(f"blstm.bias_ih_l0{suffix}"),
                            "b_hh": sd.get(f"blstm.bias_hh_l0{suffix}")}
    return params


def _vad_tree(model, sd: _SD):
    enc = sd.sub("encoder")
    params = {name: enc.linear(f"{name}.linear")
              for name in ("in_linear1", "in_linear2", "out_linear1", "out_linear2")}
    params["fsmn"] = []
    for i in range(model.encoder.cfg.fsmn_layers):
        s = enc.sub(f"fsmn.{i}")
        block = {"linear": s.linear("linear.linear"),
                 "conv_left": {"w": s.get("fsmn_block.conv_left.weight")[:, 0, :, 0].T},
                 "affine": s.linear("affine.linear")}
        if s.has("fsmn_block.conv_right.weight"):
            block["conv_right"] = {"w": s.get("fsmn_block.conv_right.weight")[:, 0, :, 0].T}
        params["fsmn"].append(block)
    return {"encoder": params}


def _is_int8(model) -> bool:
    return any(k.endswith((".w_q8", ".w_q")) for k in model.state_dict())


def params_tree(model):
    """The JAX parameter tree (numpy) of a port Paraformer (the family sharing its layout:
    BiCif's timestamp head and a CTC head included), FsmnVADStreaming, CTTransformer[
    Streaming] or SenseVoiceSmall, from its fp32 or bf16 weights."""
    if _is_int8(model):
        raise ValueError("the writers take float weights, not an int8-quantized model")
    name = type(model).__name__
    sd = _SD(model.state_dict())
    if name == "FsmnVADStreaming":
        return _vad_tree(model, sd)
    if name in ("CTTransformer", "CTTransformerStreaming"):
        return {"embed": {"w": sd.get("embed.weight")},
                "encoder": _sanm_encoder(sd.sub("encoder"), model.encoder.cfg.num_blocks),
                "decoder": sd.linear("decoder")}
    if name == "SenseVoiceSmall":
        return {"encoder": _sanm_encoder(sd.sub("encoder"), model.encoder.cfg.num_blocks,
                                         model.encoder.tp_blocks),
                "ctc": {"ctc_lo": sd.linear("ctc.ctc_lo")},
                "embed": {"w": sd.get("embed.weight")}}
    params = {"encoder": _sanm_encoder(sd.sub("encoder"), model.encoder.cfg.num_blocks),
              "decoder": _paraformer_decoder(sd.sub("decoder"), model.decoder.cfg),
              "predictor": _cif_predictor(sd.sub("predictor"))}
    if sd.has("ctc.ctc_lo.weight"):
        params["ctc"] = {"ctc_lo": sd.linear("ctc.ctc_lo")}
    return params


def _flatten_params(params, prefix=""):
    flat = {}
    if isinstance(params, dict):
        for k, v in params.items():
            flat.update(_flatten_params(v, f"{prefix}{k}/"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(_flatten_params(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = np.asarray(params)
    return flat


def save_params_npz(model, path: str):
    """Write the module's weights as the flat npz of its JAX parameter tree (what
    ``funasr_tpu/bin/export.py`` writes beside its StableHLO programs)."""
    np.savez(path, **_flatten_params(params_tree(model)))


# ---------------------------------------------------------------------------
# FTR export: weights for the pure-C++ native engine
# (runtime/funasr_tpu_runtime/src/{ftr,paraformer-engine}.cc)
# ---------------------------------------------------------------------------

_QUANT_MIN_SIZE = 4096  # only matmul-sized tensors are worth int8


def _ftr_meta(model) -> dict:
    """Flat key->value meta for the C++ engine (Paraformer-family models)."""
    enc, dec, pred = model.encoder.cfg, model.decoder.cfg, model.predictor
    meta = {
        "model": type(model).__name__,
        "input_size": enc.input_size,
        "encoder.output_size": enc.output_size,
        "encoder.attention_heads": enc.attention_heads,
        "encoder.linear_units": enc.linear_units,
        "encoder.num_blocks": enc.num_blocks,
        "encoder.kernel_size": enc.kernel_size,
        "encoder.sanm_shift": enc.sanm_shift,
        "decoder.attention_heads": dec.attention_heads,
        "decoder.linear_units": dec.linear_units,
        "decoder.num_blocks": dec.num_blocks,
        "decoder.att_layer_num": dec.att_layer_num,
        "decoder.kernel_size": dec.kernel_size,
        "decoder.sanm_shift": dec.sanm_shift,
        "vocab_size": dec.vocab_size,
        "blank_id": model.blank_id,
        "sos": model.sos,
        "eos": model.eos,
        "predictor.l_order": pred.l_order,
        "predictor.r_order": pred.r_order,
        "predictor.tail_threshold": pred.tail_threshold,
        "predictor.smooth_factor": pred.smooth_factor,
        "predictor.noise_threshold": pred.noise_threshold,
    }
    if hasattr(pred, "upsample_times"):  # CifPredictorV3 (BiCif)
        meta["predictor.upsample_times"] = pred.upsample_times
        meta["predictor.upsample_type"] = pred.upsample_type
        meta["predictor.use_cif1_cnn"] = int(pred.use_cif1_cnn)
        meta["predictor.smooth_factor2"] = pred.smooth_factor2
        meta["predictor.noise_threshold2"] = pred.noise_threshold2
    return meta


def _unstack_layers(tree: dict, stacks) -> dict:
    """Scan-stacked layers -> per-layer entries ``name.{i}``, appended in ``stacks``'
    order after the other entries."""
    out = dict(tree)
    for name, n in stacks:
        if name in out:
            for i, layer in enumerate(_unstack(out.pop(name), n)):
                out[f"{name}.{i}"] = layer
    return out


def _unstack_for_ftr(params, model):
    """Expand scan-stacked layer arrays to per-layer entries ("encoders.{i}")."""
    enc, dec = model.encoder.cfg, model.decoder.cfg
    out = dict(params)
    out["encoder"] = _unstack_layers(out["encoder"], [("encoders", enc.num_blocks - 1)])
    out["decoder"] = _unstack_layers(out["decoder"], [
        ("decoders", dec.att_layer_num), ("decoders2", dec.num_blocks - dec.att_layer_num)])
    return out


# sub-4-bit group sizes (ggml K-quant block role): picked so the per-group
# scale/min overhead keeps the effective rates strictly ordered —
# int3 = 64*3/8+4 bytes = 3.5 bpw, int2 = 128*2/8+8 bytes = 2.5 bpw
# (ggml Q3_K 3.44 / Q2_K 2.56 bpw ballpark)
_GROUP3 = 64
_GROUP2 = 128


def _group_quant_sym(arr: np.ndarray, levels: int, group: int = _GROUP3):
    """Flat row-major groups, symmetric: scale = absmax/levels,
    q in [-levels, levels]. Returns (flat padded values, q int8, scales)."""
    v = np.asarray(arr, np.float32).reshape(-1)
    pad = -v.size % group
    if pad:
        v = np.concatenate([v, np.zeros((pad,), np.float32)])
    g = v.reshape(-1, group)
    scales = np.maximum(np.abs(g).max(axis=1), 1e-12) / float(levels)
    q = np.clip(np.round(g / scales[:, None]), -levels, levels).astype(np.int8)
    return v, q.reshape(-1), scales.astype(np.float32)


def _pack3(q: np.ndarray) -> np.ndarray:
    """int3 packing: (q+3) in [0, 6] -> 8 values per 3 bytes (24 bits)."""
    u = (q.astype(np.int16) + 3).astype(np.uint32)
    pad = -u.size % 8
    if pad:
        u = np.concatenate([u, np.zeros((pad,), np.uint32)])
    u = u.reshape(-1, 8)
    word = np.zeros((u.shape[0],), np.uint32)
    for j in range(8):
        word |= u[:, j] << np.uint32(3 * j)
    out = np.zeros((u.shape[0], 3), np.uint8)
    out[:, 0] = word & 0xFF
    out[:, 1] = (word >> np.uint32(8)) & 0xFF
    out[:, 2] = (word >> np.uint32(16)) & 0xFF
    return out.reshape(-1)


def _group_quant_asym2(arr: np.ndarray, group: int = _GROUP2):
    """Flat groups, asymmetric 2-bit: v ~= q*scale + min, q in [0, 3].
    Returns (q uint8 flat padded to a group multiple, scales, mins)."""
    v = np.asarray(arr, np.float32).reshape(-1)
    pad = -v.size % group
    if pad:
        v = np.concatenate([v, np.zeros((pad,), np.float32)])
    g = v.reshape(-1, group)
    mins = g.min(axis=1)
    scales = np.maximum((g.max(axis=1) - mins) / 3.0, 1e-12)
    q = np.clip(np.round((g - mins[:, None]) / scales[:, None]), 0, 3)
    return (q.astype(np.uint8).reshape(-1), scales.astype(np.float32),
            mins.astype(np.float32))


def _write_ftr(path: str, meta: dict, flat: dict, quant: str = None):
    """Serialize a flat name->array dict in the FTR container format
    (runtime/funasr_tpu_runtime/src/ftr.h layout)."""
    import struct

    meta_str = "".join(f"{k} {v}\n" for k, v in meta.items()).encode()
    with open(path, "wb") as f:
        f.write(b"FTR1")
        f.write(struct.pack("<I", len(meta_str)))
        f.write(meta_str)
        f.write(struct.pack("<I", len(flat)))
        for name, arr in flat.items():
            arr = np.asarray(arr, np.float32)
            name_b = name.encode()
            f.write(struct.pack("<I", len(name_b)))
            f.write(name_b)
            # embedding tables are row-gathered (not matmul'd) by the C++
            # engines and must stay fp32; depthwise-conv kernels
            # (fsmn_block/w K x C, VAD conv_left/right) are consumed raw via
            # WTensor.f32 by DepthwiseConv1d, never through the
            # int8-aware MatMul, so they must not be quantized either
            is_embed = name.startswith("embed/") or "/embed/" in name
            is_raw_f32 = name.endswith(("fsmn_block/w", "conv_left/w",
                                        "conv_right/w"))
            do_quant = (quant in ("int8", "int4", "int3", "int2")
                        and arr.ndim == 2
                        and name.endswith("/w")
                        and not is_embed and not is_raw_f32
                        and arr.size >= _QUANT_MIN_SIZE)
            dtype_flag = (0 if not do_quant else
                          {"int8": 1, "int4": 2, "int3": 3, "int2": 4}[quant])
            f.write(struct.pack("<BB", dtype_flag, arr.ndim))
            f.write(np.asarray(arr.shape, "<i8").tobytes())
            if dtype_flag == 1:
                scales = np.maximum(np.abs(arr).max(axis=0), 1e-12) / 127.0
                q = np.clip(np.round(arr / scales[None, :]), -127, 127).astype(np.int8)
                f.write(struct.pack("<q", scales.size))
                f.write(scales.astype("<f4").tobytes())
                f.write(q.tobytes())
            elif dtype_flag == 2:
                # int4 (ggml-Q4 role): values in [-7, 7], per-output-channel
                # scale absmax/7; nibble-packed pairs in flat row-major order
                # (low nibble = even index). The C++ loader expands to int8 in
                # memory and feeds the same AMX int8 microkernel (ftr.cc).
                scales = np.maximum(np.abs(arr).max(axis=0), 1e-12) / 7.0
                q = np.clip(np.round(arr / scales[None, :]), -7, 7).astype(
                    np.int8).reshape(-1)
                if q.size % 2:
                    q = np.concatenate([q, np.zeros((1,), np.int8)])
                lo = (q[0::2] & 0x0F).astype(np.uint8)
                hi = (q[1::2] & 0x0F).astype(np.uint8)
                packed = lo | (hi << np.uint8(4))
                f.write(struct.pack("<q", scales.size))
                f.write(scales.astype("<f4").tobytes())
                f.write(packed.astype(np.uint8).tobytes())
            elif dtype_flag == 3:
                # int3 (ggml-Q3 role): GROUP-wise symmetric — per-channel
                # scales are too coarse below 4 bits. Groups of 64 along flat
                # row-major order, scale = absmax/3, q in [-3, 3]; (q+3)
                # packed 8 values -> 3 bytes (3.5 bpw incl. scales). The C++
                # loader reconstructs f32 then requantizes per-column int8 so
                # the AMX GEMM path is shared (2-3 bit is an install-size
                # play; ggml likewise dequantizes K-quants for compute).
                flat_v, groups, scales = _group_quant_sym(arr, levels=3)
                f.write(struct.pack("<q", scales.size))
                f.write(scales.astype("<f4").tobytes())
                f.write(_pack3(groups).tobytes())
            elif dtype_flag == 4:
                # int2 (ggml-Q2 role): group-wise ASYMMETRIC (scale + min per
                # 128-group; 4 levels can't afford to spend one on symmetry).
                # v ~= q * scale + min, q in [0, 3], 4 per byte (2.5 bpw).
                q, scales, mins = _group_quant_asym2(arr)
                f.write(struct.pack("<q", scales.size))
                f.write(scales.astype("<f4").tobytes())
                f.write(mins.astype("<f4").tobytes())
                b0 = q[0::4] | (q[1::4] << np.uint8(2)) \
                    | (q[2::4] << np.uint8(4)) | (q[3::4] << np.uint8(6))
                f.write(b0.astype(np.uint8).tobytes())
            else:
                f.write(arr.astype("<f4").tobytes())
    return path




def export_ftr(model, path: str, quant: str = None, extra_meta: dict = None):
    """Write a ``weights.ftr`` of a port Paraformer (the family sharing its layout) for the
    C++ engine.

    quant="int8": weight-only per-output-channel symmetric int8 for 2D matmul kernels
    (the ggml-Q8 role); norms, biases, convs stay fp32. "int4": nibble-packed [-7, 7]
    weights; "int3" / "int2": group-wise (``_write_ftr``)."""
    flat = _flatten_params(_unstack_for_ftr(params_tree(model), model))
    meta = _ftr_meta(model)
    meta.update(extra_meta or {})
    return _write_ftr(path, meta, flat, quant=quant)


def export_vad_ftr(model, path: str, extra_meta: dict = None):
    """Write a ``vad.ftr`` of a port FsmnVADStreaming for the C++ FSMN-VAD engine
    (runtime/funasr_tpu_runtime/src/vad-engine.cc): the FSMN scoring network plus the
    VADXOptions the windowed endpoint detector needs."""
    c = model.encoder.cfg
    o = model.vad_opts
    meta = {
        "model": "FsmnVADStreaming",
        "input_dim": c.input_dim, "input_affine_dim": c.input_affine_dim,
        "fsmn_layers": c.fsmn_layers, "linear_dim": c.linear_dim,
        "proj_dim": c.proj_dim, "lorder": c.lorder, "rorder": c.rorder,
        "output_affine_dim": c.output_affine_dim, "output_dim": c.output_dim,
        "n_mels": 80, "lfr_m": 5, "lfr_n": 1,
        "window_size_ms": o.window_size_ms,
        "sil_to_speech_time_thres": o.sil_to_speech_time_thres,
        "speech_to_sil_time_thres": o.speech_to_sil_time_thres,
        "max_end_silence_time": o.max_end_silence_time,
        "max_single_segment_time": o.max_single_segment_time,
        "speech_noise_thres": o.speech_noise_thres,
        "speech_2_noise_ratio": o.speech_2_noise_ratio,
        "sil_pdf_id": o.sil_pdf_ids[0] if o.sil_pdf_ids else 0,
    }
    meta.update(extra_meta or {})
    flat = {}
    enc = params_tree(model)["encoder"]
    for name in ("in_linear1", "in_linear2", "out_linear1", "out_linear2"):
        for part, v in enc[name].items():
            flat[f"encoder/{name}/{part}"] = v
    for i, bp in enumerate(enc["fsmn"]):
        for mod, tree in bp.items():
            for part, v in tree.items():
                flat[f"encoder/fsmn.{i}/{mod}/{part}"] = v
    return _write_ftr(path, meta, flat)


def export_punc_ftr(model, path: str, token_list=None, quant: str = None,
                    extra_meta: dict = None):
    """Write a ``punc.ftr`` of a port CTTransformer[Streaming] for the C++ punctuation
    engine (runtime/funasr_tpu_runtime/src/punc-engine.cc): embedding + SAN-M encoder +
    punc classifier, plus the punc symbol table in the meta block. With ``token_list``,
    also writes ``punc_tokens.txt`` next to the ftr (the text->id vocabulary the C++
    tokenizer consumes)."""
    cfg = model.encoder.cfg
    params = params_tree(model)
    meta = {
        "model": type(model).__name__,
        "embed_unit": params["embed"]["w"].shape[1], "att_unit": model.decoder.in_features,
        "n_punc": len(model.punc_list),
        "sentence_end_id": model.sentence_end_id,
        # CTTransformerStreaming uses the VAD-masked encoder (causal blocks + vad-corner
        # last block) -> the C++ engine's EncodeVad path
        "vad_encoder": int(type(model.encoder).__name__ == "SANMVadEncoder"),
        "encoder.attention_heads": cfg.attention_heads,
        "encoder.linear_units": cfg.linear_units,
        "encoder.num_blocks": cfg.num_blocks,
        "encoder.kernel_size": cfg.kernel_size,
        "encoder.sanm_shift": cfg.sanm_shift,
    }
    for i, p in enumerate(model.punc_list):
        meta[f"punc_{i}"] = p
    meta.update(extra_meta or {})
    enc = _unstack_layers(params["encoder"], [("encoders", cfg.num_blocks - 1)])
    flat = _flatten_params({"embed": params["embed"], "encoder": enc,
                            "decoder": params["decoder"]})
    _write_ftr(path, meta, flat, quant=quant)
    if token_list is not None:
        with open(os.path.join(os.path.dirname(path) or ".", "punc_tokens.txt"), "w") as f:
            f.write("\n".join(token_list) + "\n")
    return path


def export_sensevoice_ftr(model, path: str, quant: str = None, extra_meta: dict = None):
    """Write a ``weights.ftr`` of a port SenseVoiceSmall for the C++ SenseVoice engine
    (runtime/funasr_tpu_runtime/src/sensevoice-engine.cc): query-embedding table + SAN-M
    encoder with tp tail + CTC head."""
    cfg = model.encoder.cfg
    params = params_tree(model)
    meta = {
        "model": "SenseVoiceSmall",
        "input_size": cfg.input_size,
        "encoder.output_size": cfg.output_size,
        "encoder.attention_heads": cfg.attention_heads,
        "encoder.linear_units": cfg.linear_units,
        "encoder.num_blocks": cfg.num_blocks,
        "encoder.kernel_size": cfg.kernel_size,
        "encoder.sanm_shift": cfg.sanm_shift,
        "encoder.tp_blocks": model.encoder.tp_blocks,
        "vocab_size": params["ctc"]["ctc_lo"]["w"].shape[1],
        "blank_id": model.blank_id,
    }
    meta.update(extra_meta or {})
    enc = _unstack_layers(params["encoder"], [("encoders", cfg.num_blocks - 1),
                                              ("tp_encoders", model.encoder.tp_blocks)])
    flat = _flatten_params({"embed": params["embed"], "encoder": enc, "ctc": params["ctc"]})
    return _write_ftr(path, meta, flat, quant=quant)


def export_native_dir(model, model_dir: str, output_dir: str, quant: str = None):
    """Package a port model for the C++ runtime: weights.ftr + tokens.txt + am.mvn.

    ``model_dir`` supplies tokens and cmvn (a hub snapshot or local config dir)."""
    import shutil

    import yaml

    os.makedirs(output_dir, exist_ok=True)
    frontend_meta = {}
    cfg_path = os.path.join(model_dir, "config.yaml")
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as f:
            cfg = yaml.safe_load(f) or {}
        fc = cfg.get("frontend_conf", {})
        frontend_meta = {"lfr_m": fc.get("lfr_m", 7), "lfr_n": fc.get("lfr_n", 6),
                         "n_mels": fc.get("n_mels", 80)}
    exporter = (export_sensevoice_ftr
                if type(model).__name__ == "SenseVoiceSmall" else export_ftr)
    exporter(model, os.path.join(output_dir, "weights.ftr"), quant=quant,
             extra_meta=frontend_meta)
    for name in ("tokens.txt", "am.mvn"):
        src = os.path.join(model_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_dir, name))
    return output_dir
