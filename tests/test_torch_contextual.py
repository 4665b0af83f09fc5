"""ContextualParaformer (CLAS hotword biasing) of the PyTorch port against the JAX
package (CPU).

The port keeps FunASR's state-dict layout (``decoders.0 .. {att - 2}`` + ``last_decoder``,
``bias_decoder``, ``bias_output`` as a 1-wide conv, ``bias_embed``, a 1-layer
``bias_encoder``), which the JAX package's converter reads. Weights go port -> JAX through
``convert_state_dict`` and back through ``params_from_jax``.

* the decoder with and without a hotword memory, logits within 2e-4 (3 and 2 attention
  layers, ``clas_scale`` 1 and 0.5);
* the hotword representation (``bias_embed``, or the decoder's embed under
  ``use_decoder_embedding``, through the LSTM) within 1e-5;
* ``ContextualParaformer.inference`` with 0 and 3 hotwords: token ids equal;
* ``AutoModel.generate(batch_size=1)`` over 3 inputs keeps the bias through the dispatch
  / fetch pair, where the JAX ``AutoModel`` loses it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_state_dict
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.models.contextual_paraformer.model import ContextualParaformer as JaxContextual
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.core.layers import encode_hotwords
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.contextual_paraformer.model import ContextualParaformer
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import (PIPE_ASR_CONF, PIPE_TOKENS, contextual_conf, shape_only_init, t,
                               to_jax, write_contextual_dir)
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

FRONTEND = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, dither=0.0)
HOTWORDS = "一二 三四五 六"


def _conf(att_layer_num=3, **extra):
    dec = dict(PIPE_ASR_CONF["decoder_conf"], num_blocks=3, att_layer_num=att_layer_num)
    return dict(contextual_conf(), decoder_conf=dec, **extra)


def _pair(conf, seed=0):
    pt = ContextualParaformer(**conf, generator=torch.Generator().manual_seed(seed)).eval()
    jm = JaxContextual(**conf)
    return pt, jm, to_jax(convert_state_dict(pt.state_dict(), jm))


def test_state_dict_keeps_funasr_layout():
    pt = ContextualParaformer(**_conf())
    names = set(pt.state_dict())
    assert {"decoder.decoders.0.src_attn.linear_q.weight", "decoder.decoders.1.norm1.weight",
            "decoder.last_decoder.self_attn.fsmn_block.weight",
            "decoder.bias_decoder.norm3.weight", "decoder.bias_decoder.src_attn.linear_k_v.weight",
            "bias_embed.weight", "bias_encoder.weight_ih_l0", "bias_encoder.bias_hh_l0"} <= names
    assert "decoder.decoders.2.norm1.weight" not in names
    assert tuple(pt.state_dict()["decoder.bias_output.weight"].shape) == (64, 128, 1)
    assert not any("_l1" in n for n in names)


@pytest.mark.parametrize("att_layer_num,clas_scale", [(3, 1.0), (2, 0.5)])
def test_decoder_matches_jax(att_layer_num, clas_scale):
    pt, jm, params = _pair(_conf(att_layer_num), seed=1)
    back = ContextualParaformer(**_conf(att_layer_num)).eval()
    back.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), back))
    for name, tensor in pt.state_dict().items():
        torch.testing.assert_close(back.state_dict()[name], tensor, rtol=0, atol=0)
    rng = np.random.default_rng(2)
    enc = rng.standard_normal((2, 40, 64)).astype(np.float32)
    emb = rng.standard_normal((2, 12, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 5, 64)).astype(np.float32)
    elens, ylens = np.asarray([40, 23], np.int32), np.asarray([12, 7], np.int32)
    jargs = (params["decoder"], jnp.asarray(enc), jnp.asarray(elens), jnp.asarray(emb),
             jnp.asarray(ylens))
    for info in (None, ctx):
        with torch.inference_mode():
            got, _ = pt.decoder(t(enc), t(elens), t(emb), t(ylens),
                                contextual_info=None if info is None else t(info),
                                clas_scale=clas_scale)
        want, _ = jm.decoder(*jargs, contextual_info=None if info is None else jnp.asarray(info),
                             clas_scale=clas_scale)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


@pytest.mark.parametrize("use_decoder_embedding", [False, True])
def test_hotword_representation_matches_jax(use_decoder_embedding):
    pt, jm, params = _pair(_conf(use_decoder_embedding=use_decoder_embedding), seed=3)
    hw = [[5, 9, 11], [3], [20, 21], [1]]
    table = (pt.decoder.embed[0] if use_decoder_embedding else pt.bias_embed).weight
    with torch.inference_mode():
        rep = encode_hotwords(pt.bias_encoder, table, hw)
    pad = np.zeros((4, 3), np.int32)
    for i, h in enumerate(hw):
        pad[i, :len(h)] = h
    want = jm._hotword_repr(params, jnp.asarray(pad), jnp.asarray([3, 1, 2, 1], jnp.int32))
    np.testing.assert_allclose(rep.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hotword", [None, HOTWORDS])
def test_inference_matches_jax(hotword):
    pt, jm, params = _pair(_conf(), seed=4)
    waves = [multi_segment_wav(s, seed=i + 3) for i, s in enumerate((1.1, 4.2, 9.0))]
    tok, jtok = CharTokenizer(token_list=PIPE_TOKENS), JaxCharTokenizer(token_list=PIPE_TOKENS)
    got, _ = pt.inference(waves, tokenizer=tok, frontend=WavFrontend(**FRONTEND),
                          hotword=hotword, clas_scale=0.8)
    want, _ = jm.inference(params, waves, tokenizer=jtok, frontend=JaxWavFrontend(**FRONTEND),
                           hotword=hotword, clas_scale=0.8)
    assert got == want and all(r["text"] for r in got)
    ids, _ = pt.inference(waves, frontend=WavFrontend(**FRONTEND), hotword=hotword)
    jids, _ = jm.inference(params, waves, frontend=JaxWavFrontend(**FRONTEND), hotword=hotword)
    assert ids == jids  # no tokenizer: token ids, and no bias


def test_automodel_keeps_the_hotword_bias_in_the_double_buffered_loop(tmp_path):
    d = write_contextual_dir(tmp_path)
    port = AutoModel(model=d, device="cpu", log_level="WARNING")
    assert type(port.model.decoder).__name__ == "ContextualParaformerDecoder"
    waves = [multi_segment_wav(s, seed=i) for i, s in enumerate((2.0, 3.0, 4.0))]
    got = port.generate(input=waves, batch_size=1, key=["a", "b", "c"], hotword=HOTWORDS)
    jm = JaxContextual(**contextual_conf())
    params = to_jax(convert_state_dict(torch.load(os.path.join(d, "model.pt")), jm))
    jtok = JaxCharTokenizer(token_list=PIPE_TOKENS)
    want = [jm.inference(params, [w], key=[k], tokenizer=jtok, hotword=HOTWORDS,
                         frontend=JaxWavFrontend(**FRONTEND))[0][0]
            for w, k in zip(waves, "abc")]
    assert got == want
    plain = port.generate(input=waves, batch_size=1, key=["a", "b", "c"])
    assert [r["text"] for r in plain] != [r["text"] for r in got]
    with shape_only_init():  # the JAX AutoModel takes Paraformer's pair: no bias
        ref = jauto.AutoModel(model=d, device="cpu", log_level="WARNING")
    lost = ref.generate(input=waves, batch_size=1, key=["a", "b", "c"], hotword=HOTWORDS)
    assert [r["text"].replace(" ", "") for r in lost] == [r["text"].replace(" ", "")
                                                           for r in plain]
