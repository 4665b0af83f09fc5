"""Shared builders for the parity tests of the PyTorch port against the JAX package.

The port's model is built from a seeded ``torch.Generator``; its ``state_dict`` goes
through the JAX package's own converter (``convert_paraformer``), so both packages run
identical weights. Inputs are made with numpy and handed to both. The pipeline's model
directories (Paraformer, FSMN-VAD, CT-Transformer) are written the same way.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from funasr_tpu.convert.torch_to_jax import convert_paraformer
from funasr_tpu.models.paraformer.model import Paraformer as JaxParaformer
from funasr_tpu_torch.models.paraformer.model import Paraformer as TorchParaformer

TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("一") + i) for i in range(37)] + ["<unk>"]

# the small config of the slice's end-to-end tests: 2 encoder + 2 decoder blocks, d = 64
SMALL_CONF = dict(
    input_size=560, vocab_size=len(TOKENS),
    encoder_conf=dict(output_size=64, attention_heads=4, linear_units=96, num_blocks=2,
                      kernel_size=11, sanm_shfit=0),
    decoder_conf=dict(attention_heads=4, linear_units=96, num_blocks=2, att_layer_num=2,
                      kernel_size=11, sanm_shfit=0),
    predictor_conf=dict(idim=64, l_order=1, r_order=1, tail_threshold=0.45),
    sos=1, eos=2, predictor_bias=1)


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def build_pair(conf=SMALL_CONF, seed=0):
    """(port model, JAX model, JAX params) holding the same weights, fp32."""
    pt = TorchParaformer(**conf, generator=torch.Generator().manual_seed(seed)).eval()
    jm = JaxParaformer(**conf)
    return pt, jm, to_jax(convert_paraformer(pt.state_dict(), jm))


def t(x):
    """numpy (or a JAX array) -> torch CPU tensor, copied."""
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# the VAD -> ASR -> punctuation pipeline: seeded port modules written as FunASR-layout
# model directories (config.yaml + model.pt [+ tokens.txt, am.mvn]) that both packages'
# AutoModel load
# ---------------------------------------------------------------------------

# fsmn-vad's published widths (benchmarks/bench_realtime_ws.py:80-83)
VAD_CONF = dict(input_dim=400, input_affine_dim=140, fsmn_layers=4, linear_dim=250,
                proj_dim=128, lorder=20, rorder=0, lstride=1, rstride=1,
                output_affine_dim=140, output_dim=248)
VAD_FRONTEND = dict(fs=16000, window="hamming", n_mels=80, frame_length=25, frame_shift=10,
                    lfr_m=5, lfr_n=1, dither=0.0)
PUNC_LIST = ["<unk>", "_", "，", "。", "？", "、"]
# ct-punc-c's published widths (benchmarks/bench_realtime_ws.py:63-74)
PUNC_ENC = dict(input_size=256, output_size=256, attention_heads=8, linear_units=1024,
                num_blocks=4, input_layer="pe", kernel_size=11, sanm_shfit=0)
PUNC_MODEL_CONF = dict(punc_list=PUNC_LIST, embed_unit=256, att_unit=256, sentence_end_id=3)
# 3 specials + 60 CJK characters + <unk>: the ASR's and the punctuation model's vocab
PIPE_TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("一") + i) for i in range(60)] + ["<unk>"]
PIPE_ASR_CONF = dict(
    input_size=560, vocab_size=len(PIPE_TOKENS),
    encoder_conf=dict(output_size=64, attention_heads=4, linear_units=96, num_blocks=2,
                      input_layer="pe", kernel_size=11, sanm_shfit=0),
    decoder_conf=dict(attention_heads=4, linear_units=96, num_blocks=2, att_layer_num=2,
                      kernel_size=11, sanm_shfit=0),
    predictor_conf=dict(idim=64, l_order=1, r_order=1, threshold=1.0, tail_threshold=0.45),
    sos=1, eos=2, predictor_bias=1, ctc_weight=0.0)


def craft_energy_vad(vad, seed=0, tap=1e-3):
    """Turn a port FsmnVADStreaming into a deterministic energy detector (the idea of
    ``tests/pipeline_parity_util.py::_craft_energy_vad`` on the port's names): every
    layer averages its input, the output affine maps the mean feature energy m to
    logits sil = 3 - 2m, speech = 2m (every other pdf at -10). The memory taps are small
    seeded values in +-tap instead of zeros, so the FSMN memory enters the scores."""
    enc, c = vad.encoder, vad.encoder.cfg
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for lin, fan_in in ((enc.in_linear1.linear, c.input_dim),
                            (enc.in_linear2.linear, c.input_affine_dim),
                            (enc.out_linear1.linear, c.linear_dim)):
            lin.weight.fill_(1.0 / fan_in)
            lin.bias.zero_()
        for blk in enc.fsmn:
            blk.linear.linear.weight.fill_(1.0 / c.linear_dim)
            w = blk.fsmn_block.conv_left.weight
            w.copy_((torch.rand(w.shape, generator=g) * 2 - 1) * tap)
            blk.affine.linear.weight.fill_(1.0 / c.proj_dim)
            blk.affine.linear.bias.zero_()
        out = enc.out_linear2.linear
        out.weight.zero_()
        out.weight[0].fill_(-2.0 / c.output_affine_dim)
        out.weight[1].fill_(2.0 / c.output_affine_dim)
        out.bias.fill_(-10.0)
        out.bias[0] = 3.0
        out.bias[1] = 0.0
    return vad


def write_identity_cmvn(path, dim):
    means, istd = " ".join(["0.0"] * dim), " ".join(["1.0"] * dim)
    with open(path, "w") as f:
        f.write(f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n"
                f"<AddShift> {dim} {dim}\n<LearnRateCoef> 0 [ {means} ]\n"
                f"<Rescale> {dim} {dim}\n<LearnRateCoef> 0 [ {istd} ]\n</Nnet>\n")


def _write_config(d, cfg):
    import yaml
    with open(os.path.join(d, "config.yaml"), "w", encoding="utf-8") as f:
        yaml.safe_dump(cfg, f, allow_unicode=True)
    return str(d)


def _write_tokens(d, tokens):
    with open(os.path.join(d, "tokens.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")


def write_asr_dir(d, seed=0):
    conf = dict(PIPE_ASR_CONF)
    model = TorchParaformer(**conf, generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, PIPE_TOKENS)
    write_identity_cmvn(os.path.join(d, "am.mvn"), conf["input_size"])
    return _write_config(d, dict(
        model="Paraformer",
        model_conf=dict(sos=1, eos=2, predictor_bias=1, ctc_weight=0.0),
        encoder="SANMEncoder", encoder_conf=conf["encoder_conf"],
        decoder="ParaformerSANMDecoder", decoder_conf=conf["decoder_conf"],
        predictor="CifPredictorV2", predictor_conf=conf["predictor_conf"],
        frontend="WavFrontend",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=7, lfr_n=6, cmvn_file="am.mvn", dither=0.0),
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))


def write_vad_dir(d, seed=1):
    from funasr_tpu_torch.models.fsmn_vad_streaming.model import FsmnVADStreaming
    vad = craft_energy_vad(FsmnVADStreaming(
        encoder_conf=VAD_CONF, generator=torch.Generator().manual_seed(seed)), seed)
    torch.save(vad.state_dict(), os.path.join(d, "model.pt"))
    write_identity_cmvn(os.path.join(d, "am.mvn"), 400)
    return _write_config(d, dict(
        model="FsmnVADStreaming",
        model_conf=dict(max_end_silence_time=800, speech_noise_thres=0.6, sil_pdf_ids=[0]),
        encoder="FSMN", encoder_conf=VAD_CONF,
        frontend="WavFrontendOnline", frontend_conf=dict(VAD_FRONTEND, cmvn_file="am.mvn")))


def write_punc_dir(d, seed=2, tokens=PIPE_TOKENS):
    from funasr_tpu_torch.models.ct_transformer.model import CTTransformer
    punc = CTTransformer(encoder_conf=PUNC_ENC, vocab_size=len(tokens), **PUNC_MODEL_CONF,
                         generator=torch.Generator().manual_seed(seed))
    torch.save(punc.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, tokens)
    return _write_config(d, dict(
        model="CTTransformer", model_conf=PUNC_MODEL_CONF,
        encoder="SANMEncoder", encoder_conf=PUNC_ENC,
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))
