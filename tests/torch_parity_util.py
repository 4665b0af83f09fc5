"""Shared builders for the parity tests of the PyTorch port against the JAX package.

The port's model is built from a seeded ``torch.Generator``; its ``state_dict`` goes
through the JAX package's own converter (``convert_paraformer``), so both packages run
identical weights. Inputs are made with numpy and handed to both. The pipeline's model
directories (Paraformer, FSMN-VAD, CT-Transformer) are written the same way.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's port on one CPU thread. Its ops are small and sequential (BLSTM
    steps, B = 1 windows and convs): one thread is as fast alone, and with several test
    workers on the machine each worker's spinning thread pool made them 10-30x slower.
    Import it into a test module to use it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
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


# ---------------------------------------------------------------------------
# the speaker-attributed pipeline: a small BiCifParaformer (CifPredictorV3 head) and a
# small CAM++, written the same way
# ---------------------------------------------------------------------------

# the published timestamp head of speech_paraformer-large-vad-punc (upsample 3, BLSTM,
# the encoder output upsampled), at the pipeline's d = 64
BICIF_PREDICTOR = dict(PIPE_ASR_CONF["predictor_conf"], smooth_factor2=0.25,
                       noise_threshold2=0.01, upsample_times=3, use_cif1_cnn=False,
                       upsample_type="cnn_blstm")
# CAM++ at the width of tests/pipeline_parity_util.py:300-302
SPK_CONF = dict(feat_dim=80, embedding_size=16, growth_rate=4, bn_size=2, init_channels=8)


def seed_batchnorm(model, seed):
    """Draw every batch norm's running statistics (and affine parameters) from a numpy
    seed, so that they are not the identity."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                n = m.num_features
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
                if m.affine:
                    m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, n).astype(np.float32)))
                    m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
    return model


def write_bicif_dir(d, seed=0):
    from funasr_tpu_torch.models.bicif_paraformer.model import BiCifParaformer
    conf = dict(PIPE_ASR_CONF, predictor_conf=BICIF_PREDICTOR)
    model = BiCifParaformer(**conf, generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, PIPE_TOKENS)
    write_identity_cmvn(os.path.join(d, "am.mvn"), conf["input_size"])
    return _write_config(d, dict(
        model="BiCifParaformer",
        model_conf=dict(sos=1, eos=2, predictor_bias=1, ctc_weight=0.0),
        encoder="SANMEncoder", encoder_conf=conf["encoder_conf"],
        decoder="ParaformerSANMDecoder", decoder_conf=conf["decoder_conf"],
        predictor="CifPredictorV3", predictor_conf=BICIF_PREDICTOR,
        frontend="WavFrontend",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=7, lfr_n=6, cmvn_file="am.mvn", dither=0.0),
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))


# ---------------------------------------------------------------------------
# the hotword models: a small SeACo-Paraformer (BiCif base, 2-layer bias LSTM, a SeACo
# decoder at FunASR's kernel_size 21) and a small Contextual Paraformer, written the same
# way
# ---------------------------------------------------------------------------

NO_BIAS = 7  # the hotword head's "no bias" token at the test vocab (8377 at 8404)
SEACO_DECODER_CONF = dict(attention_heads=4, linear_units=64, num_blocks=2, att_layer_num=3,
                          kernel_size=21, sanm_shfit=0, use_output_layer=False)


def seaco_conf(base=PIPE_ASR_CONF, kernel_size=21):
    d = base["encoder_conf"]["output_size"]
    return dict(base, predictor_conf=dict(BICIF_PREDICTOR, idim=d), inner_dim=d, NO_BIAS=NO_BIAS,
                seaco_decoder="ParaformerSANMDecoder",
                seaco_decoder_conf=dict(SEACO_DECODER_CONF, kernel_size=kernel_size))


def contextual_conf(base=PIPE_ASR_CONF):
    return dict(base, inner_dim=base["encoder_conf"]["output_size"])


def _write_asr_family(d, name, model, conf, extra):
    torch.save(model.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, PIPE_TOKENS)
    write_identity_cmvn(os.path.join(d, "am.mvn"), conf["input_size"])
    return _write_config(d, dict(
        model=name,
        model_conf=dict(sos=1, eos=2, predictor_bias=1, ctc_weight=0.0, **extra),
        encoder="SANMEncoder", encoder_conf=conf["encoder_conf"],
        decoder=conf.get("decoder", "ParaformerSANMDecoder"), decoder_conf=conf["decoder_conf"],
        predictor=conf.get("predictor", "CifPredictorV2"), predictor_conf=conf["predictor_conf"],
        frontend="WavFrontend",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=7, lfr_n=6, cmvn_file="am.mvn", dither=0.0),
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))


def write_seaco_dir(d, seed=0, model=None):
    """A SeACo directory as FunASR lays it out (``model_conf`` carries inner_dim, NO_BIAS
    and the SeACo decoder)."""
    from funasr_tpu_torch.models.seaco_paraformer.model import SeacoParaformer
    conf = seaco_conf()
    if model is None:
        model = SeacoParaformer(**conf, generator=torch.Generator().manual_seed(seed))
    extra = {k: conf[k] for k in ("inner_dim", "NO_BIAS", "seaco_decoder", "seaco_decoder_conf")}
    return _write_asr_family(d, "SeacoParaformer", model,
                             dict(conf, predictor="CifPredictorV3"), extra)


def write_contextual_dir(d, seed=0):
    from funasr_tpu_torch.models.contextual_paraformer.model import ContextualParaformer
    conf = contextual_conf()
    model = ContextualParaformer(**conf, generator=torch.Generator().manual_seed(seed))
    return _write_asr_family(d, "ContextualParaformer", model,
                             dict(conf, decoder="ContextualParaformerDecoder"),
                             dict(inner_dim=conf["inner_dim"]))


def write_spk_dir(d, seed=3):
    """A cam++ directory as FunASR lays it out: its config names a WavFrontend, which
    CAM++ does not use (it computes its own fbank)."""
    from funasr_tpu_torch.models.campplus.model import CAMPPlus
    model = seed_batchnorm(CAMPPlus(**SPK_CONF, generator=torch.Generator().manual_seed(seed)),
                           seed)
    torch.save(model.state_dict(), os.path.join(d, "model.pt"))
    return _write_config(d, dict(
        model="CAMPPlus",
        model_conf=dict(SPK_CONF, config_str="batchnorm-relu", memory_efficient=False,
                        output_level="segment"),
        frontend="WavFrontend",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=1, lfr_n=1, dither=0.0)))


def two_voice_wav(seconds=40.0, seed=11, fs=16000):
    """Two synthetic voices taking turns of 3-7 s with 1.2-2 s of near silence between
    them. Voice A: 100-200 Hz harmonic tones with a 3 Hz AM, in 2 Hz syllables (75 %
    voiced); voice B: 2-4 kHz band-limited noise bursts at 8 Hz (35 % on). The short
    silences inside each voice make a segment's first chunk, which starts in silence,
    look like the rest of its voice to a CAM++ with random weights. Returns (float32
    waveform, [(start s, end s, voice), ...])."""
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal(int(seconds * fs)) * 1e-6).astype(np.float32)
    turns, t0, voice = [], 0.5, 0
    while t0 + 3.0 < seconds:
        t1 = min(t0 + rng.uniform(3.0, 7.0), seconds - 0.3)
        i, j = int(t0 * fs), int(t1 * fs)
        wav[i:j] += voice_burst(rng, voice, j - i, fs)
        turns.append((t0, t1, voice))
        t0, voice = t1 + rng.uniform(1.2, 2.0), 1 - voice
    return wav, turns


def voice_burst(rng, voice, n, fs=16000):
    tt = np.arange(n) / fs
    rate, duty = (2.0, 0.75) if voice == 0 else (8.0, 0.35)
    gate = ((tt * rate + rng.uniform()) % 1.0) < duty
    if voice == 0:
        f0 = rng.uniform(100.0, 200.0)
        tone = sum(np.sin(2 * np.pi * f0 * h * tt) / h for h in range(1, 12))
        return (0.12 * tone * (1 + 0.5 * np.sin(2 * np.pi * 3 * tt)) * gate).astype(np.float32)
    spec = np.fft.rfft(rng.standard_normal(n))
    freqs = np.fft.rfftfreq(n, 1.0 / fs)
    spec[(freqs < 2000.0) | (freqs > 4000.0)] = 0.0
    noise = np.fft.irfft(spec, n)
    return (0.3 * noise / (np.abs(noise).max() + 1e-9) * gate).astype(np.float32)


# ---------------------------------------------------------------------------
# streaming: a small ParaformerStreaming (the parts of paraformer-zh-streaming: the chunk
# encoder with input_layer pe_online, decoder sanm_shfit 5, WavFrontendOnline) and a
# small realtime punctuation model, written the same way
# ---------------------------------------------------------------------------

STREAM_CONF = dict(
    input_size=560, vocab_size=len(PIPE_TOKENS),
    encoder_conf=dict(output_size=32, attention_heads=4, linear_units=48, num_blocks=2,
                      input_layer="pe_online", kernel_size=11, sanm_shfit=0),
    decoder_conf=dict(attention_heads=4, linear_units=48, num_blocks=3, att_layer_num=2,
                      kernel_size=11, sanm_shfit=5),
    predictor_conf=dict(idim=32, l_order=1, r_order=1, threshold=1.0, tail_threshold=0.45),
    sos=1, eos=2, predictor_bias=1, ctc_weight=0.0)
STREAM_FRONTEND = dict(fs=16000, window="hamming", n_mels=80, frame_length=25, frame_shift=10,
                       lfr_m=7, lfr_n=6, dither=0.0)
# the demo's pieces (examples/industrial_data_pretraining/ct_transformer_streaming/demo.py)
PUNC_DEMO = ("跨境河流是养育沿岸|人民的生命之源长期以来为帮助下游地区防灾减灾中方技术人员|"
             "在上游地区极为恶劣的自然条件下克服巨大困难甚至冒着生命危险|"
             "向印方提供汛期水文资料处理紧急事件中方重视印方在跨境河流>问题上的关切|"
             "愿意进一步完善双方联合工作机制|凡是|中方能做的我们|"
             "都会去做而且会做得更好我请印度朋友们放心中国在上游的|任何开发利用都会经过科学|"
             "规划和论证兼顾上下游的利益")
# the demo's characters as the punctuation vocabulary, so its words are not <unk>
PUNC_DEMO_TOKENS = (["<blank>", "<s>", "</s>"] + sorted(set(PUNC_DEMO) - {"|"}) + ["<unk>"])
# ct-punc's widths cut to 3 blocks of 64 (the realtime model's SANMVadEncoder)
PUNC_RT_ENC = dict(PUNC_ENC, input_size=64, output_size=64, attention_heads=4,
                   linear_units=96, num_blocks=3)
PUNC_RT_MODEL_CONF = dict(PUNC_MODEL_CONF, embed_unit=64, att_unit=64)


def write_streaming_dir(d, seed=0):
    from funasr_tpu_torch.models.paraformer_streaming.model import ParaformerStreaming
    conf = dict(STREAM_CONF)
    model = ParaformerStreaming(**conf, generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, PIPE_TOKENS)
    write_identity_cmvn(os.path.join(d, "am.mvn"), conf["input_size"])
    return _write_config(d, dict(
        model="ParaformerStreaming",
        model_conf=dict(sos=1, eos=2, predictor_bias=1, ctc_weight=0.0),
        encoder="SANMEncoderChunkOpt", encoder_conf=conf["encoder_conf"],
        decoder="ParaformerSANMDecoder", decoder_conf=conf["decoder_conf"],
        predictor="CifPredictorV2", predictor_conf=conf["predictor_conf"],
        frontend="WavFrontendOnline", frontend_conf=dict(STREAM_FRONTEND, cmvn_file="am.mvn"),
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))


def write_punc_realtime_dir(d, seed=2):
    from funasr_tpu_torch.models.ct_transformer_streaming.model import CTTransformerStreaming
    punc = CTTransformerStreaming(encoder_conf=PUNC_RT_ENC, vocab_size=len(PUNC_DEMO_TOKENS),
                                  **PUNC_RT_MODEL_CONF,
                                  generator=torch.Generator().manual_seed(seed))
    torch.save(punc.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, PUNC_DEMO_TOKENS)
    return _write_config(d, dict(
        model="CTTransformerStreaming", model_conf=PUNC_RT_MODEL_CONF,
        encoder="SANMVadEncoder", encoder_conf=PUNC_RT_ENC,
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))


@contextlib.contextmanager
def shape_only_init(names=("Paraformer", "BiCifParaformer", "FsmnVADStreaming",
                           "CTTransformer", "CAMPPlus", "SeacoParaformer",
                           "ContextualParaformer")):
    """The JAX ``AutoModel`` draws random parameters for each model and then replaces
    them with the converted ``model.pt``; inside this context it draws their shapes only
    (``jax.eval_shape``), which changes no parameter it runs and saves the eager
    initialisation (~50 s for CAM++)."""
    from funasr_tpu.register import tables as jtables

    originals = {name: jtables.model_classes[name].init_params for name in names}

    def init(original):
        def shapes(self, rng):
            tree = jax.eval_shape(lambda r: original(self, r), rng)
            return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), tree)
        return shapes

    for name, original in originals.items():
        jtables.model_classes[name].init_params = init(original)
    try:
        yield
    finally:
        for name, original in originals.items():
            jtables.model_classes[name].init_params = original


# ---------------------------------------------------------------------------
# SenseVoice-Small: a small SenseVoiceSmall (3 + 2 tp blocks, d = 64) over the published
# vocabulary size, with the rich tags at their published ids, written the same way
# ---------------------------------------------------------------------------

SV_VOCAB = 25055
# the published tag ids (SenseVoiceSmall.LID_INT_DICT / TEXTNORM_INT_DICT); the emotion
# and event tags of the copied tag tables placed beside EMO_UNK (25009)
SV_TAGS = {24884: "<|zh|>", 24885: "<|en|>", 24888: "<|yue|>", 24892: "<|ja|>",
           24896: "<|ko|>", 24992: "<|nospeech|>", 25016: "<|withitn|>", 25017: "<|woitn|>",
           24993: "<|Speech|>", 24994: "<|BGM|>", 24995: "<|Applause|>",
           24996: "<|Laughter|>", 24997: "<|Cry|>", 24998: "<|Sneeze|>", 24999: "<|Breath|>",
           25000: "<|Cough|>", 25001: "<|HAPPY|>", 25002: "<|SAD|>", 25003: "<|ANGRY|>",
           25004: "<|NEUTRAL|>", 25005: "<|FEARFUL|>", 25006: "<|DISGUSTED|>",
           25007: "<|SURPRISED|>", 25008: "<|Event_UNK|>"}
SV_CONF = dict(
    input_size=560, vocab_size=SV_VOCAB, blank_id=0,
    encoder="SenseVoiceEncoderSmall",
    encoder_conf=dict(output_size=64, attention_heads=4, linear_units=96, num_blocks=3,
                      tp_blocks=2, kernel_size=11, sanm_shfit=0))


def sense_voice_tokens(n=SV_VOCAB):
    """n distinct tokens: <blank>, <s>, </s>, <unk>, the tags at their ids, characters
    from U+4E00 on elsewhere."""
    tokens = [chr(0x4E00 + i) for i in range(n)]
    tokens[:4] = ["<blank>", "<s>", "</s>", "<unk>"]
    for i, tag in SV_TAGS.items():
        if i < n:
            tokens[i] = tag
    return tokens


def write_sense_voice_dir(d, seed=0, model=None, conf=SV_CONF):
    from funasr_tpu_torch.models.sense_voice.model import SenseVoiceSmall
    if model is None:
        model = SenseVoiceSmall(**conf, generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, sense_voice_tokens(conf["vocab_size"]))
    write_identity_cmvn(os.path.join(d, "am.mvn"), conf["input_size"])
    return _write_config(d, dict(
        model="SenseVoiceSmall", model_conf=dict(blank_id=0, sos=1, eos=2),
        encoder=conf["encoder"], encoder_conf=conf["encoder_conf"],
        frontend="WavFrontend",
        frontend_conf=dict(fs=16000, window="hamming", n_mels=80, frame_length=25,
                           frame_shift=10, lfr_m=7, lfr_n=6, cmvn_file="am.mvn", dither=0.0),
        tokenizer="CharTokenizer",
        tokenizer_conf=dict(token_list="tokens.txt", unk_symbol="<unk>")))
