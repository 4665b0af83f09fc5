"""UniASR of the PyTorch port against the JAX package (CPU), small configs (two 2-block
SAN-M chunk encoders of d 16, kernel 5, two chunk configs; 3-block SCAMA decoders, pass
1's with ``concat_embeds``; vocab 24 over WavFrontend lfr 7 / 6), the same weights in
both packages (the port's seeded init through ``convert_state_dict``; ``params_from_jax``
takes it back). The JAX decoders run jitted over one padded length (``PaddedJitDecoder``).
Limits:

* ``inference`` ids and texts equal to JAX's in all three ``decoding_model``s: fast and
  normal at ``decoding_ind`` 0 and 1, offline (the last config whatever the index), over
  two utterances of unequal length; once, in the normal decode of the shorter one,
  against JAX's own unpadded ``_decode_pass`` (no ``PaddedJitDecoder``);
* ``forward`` (JAX's trainer call: no masks, config 0) loss and stats within 1e-5
  relative and every gradient within 1e-4 relative L2 of
  ``jax.jit(jax.value_and_grad(forward_jit))``, with both passes' predictor biases 1,
  and with biases 0 (the decoders' inputs are then the bare targets, -1 padding
  included); the training CIF's last fire moved off its rounding tie in both packages,
  as ``test_torch_train_streaming.py`` moves it;
* ``AutoModel(model=<UniASR dir>).generate(decoding_model=...)`` equal to the JAX
  model's ``inference`` on the same weights.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import funasr_tpu.models.paraformer.cif_predictor as jax_cif
import funasr_tpu.models.uniasr.model as juniasr
import funasr_tpu_torch.models.paraformer.cif_predictor as port_cif
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.register import tables as jtables
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch import AutoModel, tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from test_torch_scama import check_loss_stats_grads
from torch_parity_util import _write_config, _write_tokens, to_jax
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("一") + i) for i in range(20)] + ["<unk>"]
V = len(TOKENS)
CIF_TIE_SCALE = 1 + 1e-5
CHUNK = dict(chunk_size=[8, 12], stride=[5, 8], pad_left=[0, 0],
             encoder_att_look_back_factor=[1, 1], decoder_att_look_back_factor=[1, 1])
ENC = dict(output_size=16, attention_heads=2, linear_units=32, num_blocks=2, kernel_size=5,
           **CHUNK)
DEC = dict(attention_heads=2, linear_units=32, num_blocks=3, att_layer_num=2, kernel_size=5)
CONF = dict(encoder="SANMEncoderChunkOpt", encoder_conf=ENC,
            encoder2="SANMEncoderChunkOpt", encoder2_conf=ENC,
            decoder="FsmnDecoderSCAMAOpt", decoder_conf=dict(DEC, concat_embeds=True),
            decoder2="FsmnDecoderSCAMAOpt", decoder2_conf=dict(DEC, sanm_shfit=0),
            predictor_conf=dict(idim=16), predictor2_conf=dict(idim=16),
            stride_conv_conf=dict(kernel_size=2, stride=2, pad=[0, 1]),
            input_size=560, vocab_size=V, sos=1, eos=2, lsm_weight=0.1,
            predictor_bias=1, predictor2_bias=1)
FRONTEND = dict(fs=16000, lfr_m=7, lfr_n=6, n_mels=80, dither=0.0)


def build(conf=CONF, seed=0):
    """(port model, JAX model, JAX tree as numpy) on the port's seeded weights, through
    ``convert_state_dict``; pass 1's ``embed_concat_ffn``, which the JAX converter does not
    read, by hand."""
    pt = tables.model_classes["UniASR"](**conf, generator=torch.Generator().manual_seed(seed))
    jm = jtables.model_classes["UniASR"](**conf)
    tree = jax.tree_util.tree_map(np.asarray, convert_state_dict(pt.state_dict(), jm, "UniASR"))
    if pt.decoder.embed_concat_ffn is not None:
        ffn = pt.decoder.embed_concat_ffn[0]
        arr = lambda x: x.detach().numpy()  # noqa: E731
        tree["decoder"]["embed_concat_ffn"] = {
            "norm1": {"scale": arr(ffn.norm1.weight), "bias": arr(ffn.norm1.bias)},
            "feed_forward": {
                "w_1": {"w": arr(ffn.feed_forward.w_1.weight).T,
                        "b": arr(ffn.feed_forward.w_1.bias)},
                "norm": {"scale": arr(ffn.feed_forward.norm.weight),
                         "bias": arr(ffn.feed_forward.norm.bias)},
                "w_2": {"w": arr(ffn.feed_forward.w_2.weight).T}}}
    return pt.eval(), jm, tree


class PaddedJitDecoder:
    """A JAX decoder jitted over one target length. JAX's ``_decode_pass`` grows its ids a
    step at a time, and each eager call compiles the decoder's layer scans anew (~0.5 s
    a step here); this pads the ids with eos, and the SCAMA windows with empty rows, to
    the windows' ``max_tokens`` rows, all past the valid count (the length JAX passes),
    and gives back the valid rows' logits: one compile a pass. The valid rows are
    those of the unpadded call (the pad rows are masked out of the FSMN and have their own
    cross-attention rows), as JAX's own SCAMA decode relies on; ``test_torch_scama.py``
    holds the port's fixed-shape step to the prefix-only forward."""

    def __init__(self, decoder, eos=2):
        self.decoder, self.eos = decoder, eos
        self.fn = jax.jit(decoder.__call__)

    def __call__(self, params, hs, hlens, ys, ylens, chunk_mask=None,
                 pre_acoustic_embeds=None):
        if pre_acoustic_embeds is not None or chunk_mask is None:  # not a decode step
            return self.decoder(params, hs, hlens, ys, ylens, chunk_mask=chunk_mask,
                                pre_acoustic_embeds=pre_acoustic_embeds)
        u, width = ys.shape[1], chunk_mask.shape[1]
        ys = jnp.pad(ys, ((0, 0), (0, width - u)), constant_values=self.eos)
        logits, lens = self.fn(params, hs, hlens, ys, ylens, chunk_mask=chunk_mask)
        return logits[:, :u], lens


def jit_encoder(encoder):
    """``forward_train_chunk`` jitted with the masks' arrays as inputs (eager, each of its
    ops compiles for every new shape)."""
    original = encoder.forward_train_chunk
    jitted = jax.jit(lambda p, x, lens, m, pad_left: original(p, x, lens,
                                                              dict(m, pad_left=pad_left)),
                     static_argnums=4)
    encoder.forward_train_chunk = lambda p, x, lens, masks, rng=None: jitted(
        p, x, lens, {k: v for k, v in masks.items() if k != "pad_left"}, masks["pad_left"])


def jit_passes(jm, pad_decoders=True):
    """The JAX model's encoders, CIF alphas and stride conv jitted, and (``pad_decoders``)
    its decode steps (``PaddedJitDecoder``)."""
    if pad_decoders:
        jm.decoder, jm.decoder2 = PaddedJitDecoder(jm.decoder), PaddedJitDecoder(jm.decoder2)
    for enc in (jm.encoder, jm.encoder2):
        jit_encoder(enc)
    for pred in (jm.predictor, jm.predictor2):
        pred.alphas = jax.jit(pred.alphas)
    jm._stride_conv = jax.jit(jm._stride_conv)
    return jm


@pytest.fixture(scope="module", autouse=True)
def jitted_windows():
    """The JAX alignment and window functions as UniASR calls them, jitted over their
    integer and string arguments."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(juniasr, "gen_frame_alignments", jax.jit(
            juniasr.gen_frame_alignments, static_argnames=("max_token_num", "training")))
        mp.setattr(juniasr, "build_scama_mask_for_cross_attention_decoder", jax.jit(
            juniasr.build_scama_mask_for_cross_attention_decoder, static_argnames=(
                "max_target_length", "chunk_size", "encoder_chunk_size",
                "attention_chunk_size", "attention_chunk_type",
                "decoder_att_look_back_factor", "is_training")))
        yield


@pytest.fixture(scope="module")
def pair():
    pt, jm, tree = build()
    return pt, jit_passes(jm), tree


def wavs(seed=5, lengths=(11000, 8000)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in lengths]


@pytest.mark.parametrize("mode,ind", [("fast", 0), ("normal", 0), ("fast", 1), ("normal", 1),
                                      ("offline", 0)])
def test_inference_ids_and_texts_match_jax(pair, mode, ind):
    pt, jm, tree = pair
    kw = dict(key=["a", "b"], decoding_model=mode, decoding_ind=ind)
    got, _ = pt.inference(wavs(), tokenizer=CharTokenizer(token_list=TOKENS),
                          frontend=WavFrontend(**FRONTEND), **kw)
    want, _ = jm.inference(to_jax(tree), wavs(), tokenizer=JaxCharTokenizer(token_list=TOKENS),
                           frontend=JaxWavFrontend(**FRONTEND), **kw)
    assert got == want and all(r["text"] for r in got), got
    ids, _ = pt.inference(wavs(), frontend=WavFrontend(**FRONTEND), **kw)
    assert [r["token_int"] for r in ids] and all(r["token_int"] for r in ids)


def test_inference_matches_jaxs_own_unpadded_decode(pair):
    """JAX's own ``_decode_pass``, its ids grown a step at a time through the eager
    decoders (no ``PaddedJitDecoder``), in the 2-pass normal decode of the shorter
    utterance, where decoder2's FSMN (``sanm_shfit`` 0) reads rows to the right: the port's
    fixed-shape decode gives its ids and text."""
    pt, _, tree = pair
    jm = jit_passes(jtables.model_classes["UniASR"](**CONF), pad_decoders=False)
    steps, decoder2 = [], jm.decoder2
    jm.decoder2 = lambda *a, **k: steps.append(a[3].shape[1]) or decoder2(*a, **k)
    kw = dict(key=["b"], decoding_model="normal")
    short = wavs()[1:]
    got, _ = pt.inference(short, tokenizer=CharTokenizer(token_list=TOKENS),
                          frontend=WavFrontend(**FRONTEND), **kw)
    want, _ = jm.inference(to_jax(tree), short, tokenizer=JaxCharTokenizer(token_list=TOKENS),
                           frontend=JaxWavFrontend(**FRONTEND), **kw)
    assert got == want and got[0]["text"], (got, want)
    assert steps == list(range(1, len(steps) + 1)) and len(steps) >= 2, steps


def test_params_round_trip_through_the_jax_converter(pair):
    """The port's state dict -> ``convert_state_dict`` (+ ``embed_concat_ffn``) ->
    ``params_from_jax`` gives it back, every tensor equal."""
    pt, _, tree = pair
    back = params_from_jax(tree, pt)
    want = pt.state_dict()
    assert set(back) == set(want)
    for name, w in want.items():
        assert torch.equal(back[name], w), name


def batch(seed=0, feat=560):
    rng = np.random.default_rng(seed)
    speech = rng.standard_normal((2, 33, feat)).astype(np.float32)
    slen = np.asarray([33, 21], np.int32)
    tlen = np.asarray([5, 3], np.int32)
    text = np.full((2, 5), -1, np.int32)
    for i in range(2):
        text[i, :tlen[i]] = rng.integers(3, V, tlen[i])
    return speech, slen, text, tlen


@pytest.fixture
def cif_tie_moved(monkeypatch):
    """Both packages' training CIF with the rescaled alphas scaled by 1 + 1e-5: the last
    fire sits on a rounding tie at the exact target count, which each framework decides
    in its own order (``test_torch_train_streaming.py``); pass 1's decoder reads the
    fired embeddings (``concat_embeds``)."""
    jax_fn, port_fn = jax_cif.cif, port_cif.cif
    monkeypatch.setattr(jax_cif, "cif", lambda h, a, k, thr=1.0: jax_fn(h, a * CIF_TIE_SCALE,
                                                                          k, thr))
    monkeypatch.setattr(port_cif, "cif", lambda h, a, k, thr=1.0: port_fn(h, a * CIF_TIE_SCALE,
                                                                            k, thr))


@pytest.mark.parametrize("bias", [1, 0])
def test_loss_stats_and_grads_match_jax(pair, bias, cif_tie_moved):
    pt, jm, tree = pair if bias else build(dict(CONF, predictor_bias=0, predictor2_bias=0), 2)
    check_loss_stats_grads(pt, jm, tree, *batch())


def write_uniasr_dir(d, pt, conf):
    torch.save(pt.state_dict(), os.path.join(d, "model.pt"))
    _write_tokens(d, TOKENS)
    conf = {k: v for k, v in conf.items() if k not in ("input_size", "vocab_size")}
    model_conf = {k: conf.pop(k) for k in ("sos", "eos", "lsm_weight", "predictor_bias",
                                           "predictor2_bias")}
    return _write_config(d, dict(
        model="UniASR", model_conf=model_conf, **conf,
        frontend="WavFrontend", frontend_conf=FRONTEND,
        tokenizer="CharTokenizer", tokenizer_conf=dict(token_list="tokens.txt",
                                                       unk_symbol="<unk>")))


def test_automodel_generate_matches_jax(pair, tmp_path):
    """``AutoModel(model=<UniASR dir>)`` (config.yaml + model.pt + tokens.txt) gives the JAX
    model's results on the same weights."""
    pt, jm, tree = pair
    d = write_uniasr_dir(str(tmp_path), pt, CONF)
    port = AutoModel(model=d, device="cpu", log_level="WARNING")
    for cfg in (dict(decoding_model="fast"), dict(decoding_model="normal", decoding_ind=1)):
        got = port.generate(input=wavs(), key=["a", "b"], **cfg)
        want, _ = jm.inference(to_jax(tree), wavs(), key=["a", "b"],
                               tokenizer=JaxCharTokenizer(token_list=TOKENS),
                               frontend=JaxWavFrontend(**FRONTEND), **cfg)
        assert got == want and all(r["text"] for r in got), (cfg, got)
