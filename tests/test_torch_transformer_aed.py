"""The Transformer-family AED of the PyTorch port against the JAX package (CPU), small
configs (2 encoder + 2 decoder blocks, d 32), the same weights in both packages (the
port's seeded state dict through ``convert_state_dict``; the JAX package's init through
``params_from_jax`` for the language models and GLM-ASR). Tolerances:

* relative-position attention, the relative shift, the espnet PE tables and the conv2d
  subsampling within 1e-6 of max |y| (sums in another order); the subsampled lengths
  and the shift equal;
* the Transformer and SAN-M encoders within 2e-4 of max |y| on a padded batch of unequal
  lengths; the decoder's ``score_step`` log-probs and the four convolution decoders'
  logits within 2e-4;
* ``forward``'s loss and stats within 1e-5 relative of ``forward_jit``;
* beam search token ids equal, plain and fused with ``TransformerLM``, ``SeqRNNLM`` and
  the hotword scorer (``max_len`` <= 16, few ``Lmax`` buckets), ``inference`` texts equal;
* the copied ``HotwordScorer`` equal to the JAX one on every transition;
* ``GLMASR`` generated texts equal on the byte tokenizer of ``tests/test_torch_llm_asr.py``.

The SANM AED's JAX converter (``convert_sanm_aed``) maps a SCAMA decoder, so its tree
here is ``convert_sanm_encoder`` + ``_aed_decoder_params`` over the TransformerDecoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.convert.torch_to_jax import (SD, _aed_decoder_params, convert_ctc,
                                             convert_sanm_encoder, convert_state_dict)
from funasr_tpu.core.layers import make_pad_mask as jmake_pad_mask
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.models.language_model import transformer_lm as jlm
from funasr_tpu.models.transformer import attention as jatt
from funasr_tpu.models.transformer import conv_decoders  # noqa: F401 (registers)
from funasr_tpu.models.transformer import hotword_scorer as jhw
from funasr_tpu.models.transformer import model  # noqa: F401 (registers)
from funasr_tpu.models.transformer import search as jsearch
from funasr_tpu.models.transformer import subsampling as jsub
from funasr_tpu.register import tables as jtables
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch import tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.core.layers import make_pad_mask
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.language_model.transformer_lm import SeqRNNLM, TransformerLM
from funasr_tpu_torch.models.transformer import attention as patt
from funasr_tpu_torch.models.transformer import hotword_scorer as phw
from funasr_tpu_torch.models.transformer import search as psearch
from funasr_tpu_torch.models.transformer.subsampling import Conv2dSubsampling
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from torch_parity_util import one_torch_thread, t, to_jax  # noqa: F401 (autouse)

TOKENS = ["<blank>", "<s>", "</s>"] + [chr(ord("a") + i) for i in range(20)] + ["<unk>"]
ENC = dict(output_size=32, attention_heads=4, linear_units=64, num_blocks=2)
DEC = dict(attention_heads=4, linear_units=64, num_blocks=2)
CONF = dict(input_size=80, vocab_size=len(TOKENS), ctc_weight=0.3, encoder_conf=ENC,
            decoder_conf=DEC, sos=1, eos=2, lsm_weight=0.1)
SANM_ENC = dict(output_size=32, attention_heads=4, linear_units=64, num_blocks=2,
                kernel_size=11, sanm_shfit=0, input_layer="pe", dropout_rate=0.0)
FRONTEND = dict(fs=16000, lfr_m=1, lfr_n=1, n_mels=80, dither=0.0)
SMALL_TOL = 1e-6
MODEL_TOL = 2e-4
LOSS_RTOL = 1e-5
MAX_LEN = 12


def close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)
    assert err <= tol, err


def lin(m):
    p = {"w": t(m.weight.detach()).numpy().T}
    if m.bias is not None:
        p["b"] = m.bias.detach().numpy()
    return p


def build(name, conf=CONF, seed=0):
    """(port model, JAX model, JAX params) with the port's seeded weights."""
    pt = tables.model_classes[name](**conf, generator=torch.Generator().manual_seed(seed)).eval()
    jm = jtables.model_classes[name](**conf)
    if name == "SANM":
        sd = SD(pt.state_dict())
        params = {"encoder": convert_sanm_encoder(sd.sub("encoder"), conf["encoder_conf"]
                                                  ["num_blocks"]),
                  "decoder": _aed_decoder_params(sd.sub("decoder"), DEC["num_blocks"])}
        if pt.ctc is not None:
            params["ctc"] = convert_ctc(sd.sub("ctc"))
    else:
        params = convert_state_dict(pt.state_dict(), jm, name)
    return pt, jm, to_jax(params)


def padded_batch(seed=0, t_len=120, lens=(120, 83, 57)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((len(lens), t_len, 80)).astype(np.float32)
    return x, np.asarray(lens, np.int32)


def test_relpos_attention_shift_and_pe_tables(rng):
    cfg = patt.MHAConfig(4, 32)
    attn = patt.RelPositionMultiHeadedAttention(cfg)
    torch.nn.init.normal_(attn.pos_bias_u, std=0.3)
    torch.nn.init.normal_(attn.pos_bias_v, std=0.3)
    jp = {n: lin(getattr(attn, n)) for n in ("linear_q", "linear_k", "linear_v",
                                             "linear_out", "linear_pos")}
    jp.update(pos_bias_u=attn.pos_bias_u.detach().numpy(),
              pos_bias_v=attn.pos_bias_v.detach().numpy())
    x = rng.standard_normal((3, 19, 32)).astype(np.float32)
    lens = np.asarray([19, 12, 5], np.int32)
    mask = np.arange(19)[None] < lens[:, None]
    pos = patt.rel_pos_emb(19, 32)
    close(pos.numpy(), jatt.rel_pos_emb(19, 32), SMALL_TOL)
    close(patt.espnet_pe(23, 32, offset=3).numpy(), jatt.espnet_pe(23, 32, offset=3), SMALL_TOL)
    close(patt.add_espnet_pe(t(x)).numpy(), jatt.add_espnet_pe(jnp.asarray(x)), SMALL_TOL)
    with torch.no_grad():
        got = patt.relpos_mha_apply(attn, t(x), pos, t(mask)[:, None, :])
    want = jatt.relpos_mha_apply(jp, jatt.MHAConfig(4, 32), jnp.asarray(x), jnp.asarray(pos),
                                 jnp.asarray(mask)[:, None, :])
    close(got.numpy(), want, SMALL_TOL)
    s = rng.standard_normal((2, 3, 7, 13)).astype(np.float32)
    np.testing.assert_array_equal(patt.rel_shift(t(s)).numpy(), jatt._rel_shift(jnp.asarray(s)))


@pytest.mark.parametrize("add_pe", [True, False])
def test_conv2d_subsampling_and_lengths(add_pe):
    sub = Conv2dSubsampling(80, 32)
    torch.manual_seed(0)
    jp = {"conv1": {"w": sub.conv[0].weight.detach().numpy().transpose(2, 3, 1, 0),
                    "b": sub.conv[0].bias.detach().numpy()},
          "conv2": {"w": sub.conv[2].weight.detach().numpy().transpose(2, 3, 1, 0),
                    "b": sub.conv[2].bias.detach().numpy()},
          "out": lin(sub.out[0])}
    x, lens = padded_batch(1, 61, (61, 40, 9, 1))
    with torch.no_grad():
        got, glens = sub(t(x), t(lens), add_pe=add_pe)
    want, wlens = jsub.conv2d_subsampling_apply(to_jax(jp), jnp.asarray(x), jnp.asarray(lens),
                                                add_pe=add_pe)
    close(got.numpy(), want, SMALL_TOL)
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))


@pytest.mark.parametrize("name,encoder_conf", [("Transformer", ENC),
                                               ("SANM", SANM_ENC)])
def test_encoder_padded_batch_matches_jax(name, encoder_conf):
    conf = dict(CONF, encoder_conf=encoder_conf)
    if name == "SANM":
        conf["input_size"] = 80
    pt, jm, jp = build(name, conf)
    x, lens = padded_batch()
    with torch.no_grad():
        got, glens = pt.encode(t(x), t(lens))
    want, wlens = jax.jit(lambda p, a, b: jm.encode(p, a, b))(jp, jnp.asarray(x),
                                                             jnp.asarray(lens))
    np.testing.assert_array_equal(glens.numpy(), np.asarray(wlens))
    for i, n in enumerate(np.asarray(wlens)):
        close(got[i, :n].numpy(), np.asarray(want)[i, :n], MODEL_TOL)


def test_score_step_log_probs_match_jax(rng):
    pt, jm, jp = build("Transformer")
    mem = rng.standard_normal((3, 17, 32)).astype(np.float32)
    mlen = np.asarray([17, 11, 4], np.int32)
    ys = rng.integers(3, len(TOKENS), (3, 8)).astype(np.int32)
    ylen = np.asarray([8, 5, 1], np.int32)
    with torch.no_grad():
        got = pt.decoder.score_step(t(ys), t(ylen), t(mem), make_pad_mask(t(mlen), 17))
    want = jm.decoder.score_step(jp["decoder"], jnp.asarray(ys), jnp.asarray(ylen),
                                 jnp.asarray(mem), jmake_pad_mask(jnp.asarray(mlen), 17))
    close(got.numpy(), want, MODEL_TOL)


@pytest.mark.parametrize("decoder", ["LightweightConvolutionTransformerDecoder",
                                     "LightweightConvolution2DTransformerDecoder",
                                     "DynamicConvolutionTransformerDecoder",
                                     "DynamicConvolution2DTransformerDecoder"])
def test_conv_decoders_match_jax(rng, decoder):
    dconf = dict(DEC, conv_wshare=4, conv_kernel_length=[5, 7])
    jdec = jtables.decoder_classes[decoder](len(TOKENS), 32, **dconf)
    jparams = jax.tree_util.tree_map(np.asarray, jdec.init(jax.random.PRNGKey(3)))
    conf = dict(CONF, decoder=decoder, decoder_conf=dconf, ctc_weight=0.0)
    pt = tables.model_classes["Transformer"](**conf).eval()
    jenc = jtables.model_classes["Transformer"](**dict(conf, decoder="TransformerDecoder",
                                                       decoder_conf=DEC)).encoder
    tree = {"encoder": jax.tree_util.tree_map(np.asarray, jenc.init(jax.random.PRNGKey(4))),
            "decoder": jparams}
    pt.load_state_dict(params_from_jax(tree, pt))
    mem = rng.standard_normal((2, 15, 32)).astype(np.float32)
    mlen = np.asarray([15, 9], np.int32)
    ys = rng.integers(3, len(TOKENS), (2, 9)).astype(np.int32)
    ylen = np.asarray([9, 4], np.int32)
    with torch.no_grad():
        got, _ = pt.decoder(t(mem), t(mlen), t(ys), t(ylen))
        step = pt.decoder.score_step(t(ys), t(ylen), t(mem), make_pad_mask(t(mlen), 15))
    want, _ = jdec(to_jax(jparams), jnp.asarray(mem), jnp.asarray(mlen), jnp.asarray(ys),
                   jnp.asarray(ylen))
    for i, n in enumerate(ylen):
        close(got[i, :n].numpy(), np.asarray(want)[i, :n], MODEL_TOL)
    jstep = jdec.score_step(to_jax(jparams), jnp.asarray(ys), jnp.asarray(ylen),
                            jnp.asarray(mem), jmake_pad_mask(jnp.asarray(mlen), 15))
    close(step.numpy(), jstep, MODEL_TOL)


CHUNK_ENC = dict(ENC, cnn_module_kernel=15, chunk_size=8, left_chunks=1, input_layer="conv2d")
FORWARD_CASES = {
    "Transformer": ("Transformer", CONF),
    "SANM": ("SANM", dict(CONF, encoder_conf=SANM_ENC)),
    # the chunk-causal Conformer under an AED, and the transducer over it (its loss alone)
    "Conformer_chunk": ("Conformer", dict(CONF, encoder="ChunkConformerEncoder",
                                          encoder_conf=CHUNK_ENC)),
    "Transducer": ("Transducer", dict(input_size=80, vocab_size=len(TOKENS),
                                      encoder="ChunkConformerEncoder", encoder_conf=CHUNK_ENC,
                                      decoder_conf=dict(embed_size=16, hidden_size=24),
                                      joint_network_conf=dict(joint_space_size=40))),
}


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_forward_loss_and_stats_match_forward_jit(name):
    model, conf = FORWARD_CASES[name]
    pt, jm, jp = build(model, conf, seed=2)
    x, lens = padded_batch(2)
    rng = np.random.default_rng(5)
    tlens = np.asarray([7, 4, 2], np.int32)
    text = rng.integers(3, len(TOKENS), (3, 7)).astype(np.int32)
    text = np.where(np.arange(7)[None] < tlens[:, None], text, -1)
    loss, stats, weight = pt(t(x), t(lens), t(text).long(), t(tlens))
    jloss, jstats, jweight = jax.jit(lambda p, a, b, c, d: jm.forward_jit(p, a, b, c, d, None))(
        jp, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(text), jnp.asarray(tlens))
    assert weight == int(jweight) and set(stats) == set(jstats)
    for k, want in jstats.items():
        got = float(stats[k].detach())
        assert abs(got - float(want)) <= LOSS_RTOL * max(abs(float(want)), 1.0), (k, got, want)


def lm_pair(kind, seed):
    """(port LM, JAX LM, JAX params): the JAX init loaded into the port."""
    if kind == "TransformerLM":
        conf = dict(vocab_size=len(TOKENS), embed_unit=16, att_unit=32, head=4, unit=48, layer=2)
        jm, pt = jlm.TransformerLM(**conf), TransformerLM(**conf)
    else:
        conf = dict(vocab_size=len(TOKENS), embed_unit=16, hidden_size=24, num_layers=2)
        jm, pt = jlm.SeqRNNLM(**conf), SeqRNNLM(**conf)
    jp = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    pt.load_state_dict(params_from_jax(jp, pt))
    return pt.eval(), jm, to_jax(jp)


@pytest.mark.parametrize("kind", ["TransformerLM", "SeqRNNLM"])
def test_language_model_scores_and_loss_match_jax(rng, kind):
    pt, jm, jp = lm_pair(kind, 6)
    ys = rng.integers(1, len(TOKENS), (3, 9)).astype(np.int32)
    ylen = np.asarray([9, 6, 2], np.int32)
    with torch.no_grad():
        got = pt.score_step(t(ys), t(ylen))
        loss, stats, n = pt(t(ys).long(), t(ylen))
    close(got.numpy(), jm.score_step(jp, jnp.asarray(ys), jnp.asarray(ylen)), MODEL_TOL)
    jloss, _, jn = jm.forward_jit(jp, jnp.asarray(ys), jnp.asarray(ylen))
    assert int(n) == int(jn)
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * max(abs(float(jloss)), 1.0)


class Jitted:
    """A JAX scorer whose ``score_step`` is jitted (the search calls it once a step; eager,
    each call retraces the layer scan)."""

    def __init__(self, scorer):
        self.score_step = jax.jit(scorer.score_step)


class CharsTokenizer:
    """Characters to ids over TOKENS (the hotword words' tokenizer)."""

    def tokens2ids(self, chars):
        return [TOKENS.index(c) for c in chars]


@pytest.mark.parametrize("fusion", ["plain", "TransformerLM", "SeqRNNLM", "hotword"])
def test_beam_search_ids_match_jax(fusion):
    pt, jm, jp = build("Transformer", seed=1)
    x, lens = padded_batch(3, 80, (80, 61))
    with torch.no_grad():
        enc, elens = pt.encode(t(x), t(lens))
    jenc, jelens = jax.jit(lambda p, a, b: jm.encode(p, a, b))(jp, jnp.asarray(x),
                                                              jnp.asarray(lens))
    kw, jkw = {}, {}
    if fusion in ("TransformerLM", "SeqRNNLM"):
        lm, jlm_, jlp = lm_pair(fusion, 7)
        kw = dict(lm=lm, lm_weight=0.5)
        jkw = dict(lm=Jitted(jlm_), lm_params=jlp, lm_weight=0.5)
    elif fusion == "hotword":
        words = ["abc", "fed", "cab"]
        kw = dict(hotword_scorer=phw.build_hotword_scorer(words, CharsTokenizer(), 2.0))
        jkw = dict(hotword_scorer=jhw.build_hotword_scorer(words, CharsTokenizer(), 2.0))
    for i in range(2):
        mem, n = enc[i: i + 1], int(elens[i])
        got = psearch.beam_search(pt.decoder, mem, make_pad_mask(elens[i: i + 1], mem.shape[1]),
                                  1, 2, beam_size=4, max_len=MAX_LEN, **kw)
        want = jsearch.beam_search(Jitted(jm.decoder), jp["decoder"], jenc[i: i + 1],
                                   jmake_pad_mask(jelens[i: i + 1], jenc.shape[1]), 1, 2,
                                   beam_size=4, max_len=MAX_LEN, **jkw)
        assert [h.yseq for h in got] == [h.yseq for h in want]
        assert n == int(jelens[i])
        for g, w in zip(got, want):
            assert abs(g.score - w.score) <= MODEL_TOL * max(abs(w.score), 1.0)


def test_inference_texts_match_jax():
    pt, jm, jp = build("Transformer", seed=4)
    jm.decoder.score_step = jax.jit(jm.decoder.score_step)
    rng = np.random.default_rng(8)
    wavs = [(rng.standard_normal(n) * 0.1).astype(np.float32) for n in (5600, 4000)]
    kw = dict(key=["a", "b"], beam_size=3, maxlenratio=0.3)
    got, _ = pt.inference(wavs, tokenizer=CharTokenizer(token_list=TOKENS),
                          frontend=WavFrontend(**FRONTEND), **kw)
    want, _ = jm.inference(jp, wavs, tokenizer=JaxCharTokenizer(token_list=TOKENS),
                           frontend=JaxWavFrontend(**FRONTEND), **kw)
    assert got == want and all(r["text"] for r in got)


def test_hotword_scorer_copy_matches_jax():
    seqs = [[3, 4, 5], [4, 5], [5, 3, 3, 4], [7]]
    a, b = phw.HotwordScorer(seqs, 1.5), jhw.HotwordScorer(seqs, 1.5)
    assert (a.children, a.depth, a.terminal, a.fail) == (b.children, b.depth, b.terminal,
                                                         b.fail)
    for node in range(len(a.children)):
        np.testing.assert_array_equal(a.score_step(node, 10), b.score_step(node, 10))
        for tok in range(10):
            assert a.advance(node, tok) == b.advance(node, tok)
    assert phw.build_hotword_scorer("", CharsTokenizer()) is None


def test_beam_search_para_matches_jax(rng):
    am = rng.standard_normal((6, 11)).astype(np.float32)
    got, want = psearch.beam_search_para(am, 3, 0.1), jsearch.beam_search_para(am, 3, 0.1)
    assert [(h.yseq, h.score) for h in got] == [(h.yseq, h.score) for h in want]


class ByteTokenizer:
    """``tests/test_torch_llm_asr.py``'s: bytes -> ids shifted by 1; id 0 is the audio
    slot."""

    def encode(self, text):
        return [1 + ((b - 32) % 95) for b in text.encode()][:512]

    def decode(self, ids):
        return "".join(chr(32 + ((i - 1) % 95)) for i in ids if i > 0)


GLM_LLM = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=96, head_dim=8,
               rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=False,
               qkv_bias=False, qk_norm=True)
GLM_CONF = dict(input_size=80, audio_encoder_conf=dict(output_size=24, attention_heads=2,
                                                       linear_units=48, num_blocks=2),
                audio_adaptor="Linear",
                audio_adaptor_conf=dict(downsample_rate=2, encoder_dim=24, llm_dim=32,
                                        ffn_dim=48),
                llm_conf=GLM_LLM)


def test_glmasr_generate_matches_jax():
    jm = jtables.model_classes["GLMASR"](**GLM_CONF)
    tree = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(5)))
    tree["llm"]["embed_tokens"] = tree["llm"]["embed_tokens"] * 5.0  # ids vary step to step
    pt = tables.model_classes["GLMASR"](**GLM_CONF).eval()
    pt.load_state_dict(params_from_jax(tree, pt))
    wavs = [np.random.default_rng(i).standard_normal(n).astype(np.float32) * 0.1
            for i, n in enumerate((6400, 4000))]
    kw = dict(tokenizer=ByteTokenizer(), key=["a", "b"], max_new_tokens=8)
    got, _ = pt.inference(wavs, frontend=WavFrontend(**FRONTEND), **kw)
    want, _ = jm.inference(to_jax(tree), wavs, frontend=JaxWavFrontend(**FRONTEND), **kw)
    assert got == want and all(r["text"] for r in got)
    tok = ByteTokenizer()
    assert pt.build_chatml_ids(tok, "p", "x") == jm.build_chatml_ids(tok, "p", "x")
