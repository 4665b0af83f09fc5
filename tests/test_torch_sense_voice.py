"""SenseVoiceSmall of the PyTorch port against the JAX package (CPU), at 3 + 2 tp blocks of
d = 64 over the published 25055-token vocabulary, the same weights in both packages
(``convert_sense_voice`` one way, ``params_from_jax`` the other):

* the encoder output on every frame (it is not masked) within 2e-4;
* the CTC log-probs within 2e-4 and the ids equal for language auto / zh / en, use_itn
  both ways and ban_emo_unk both ways, at ragged lengths;
* ``inference`` texts equal through a ``CharTokenizer`` with the rich tags at their ids;
* ``AutoModel`` over a written model dir equal to the JAX ``AutoModel``, alone and behind
  the VAD with ``merge_vad`` (``use_itn=True`` is the prompt, not the ITN of ``itn=True``);
* bf16 by the token-flip method of ``tests/test_w8a8_production.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.auto import auto_model as jauto
from funasr_tpu.convert.torch_to_jax import convert_sense_voice
from funasr_tpu.core.module import cast_floats as jax_cast_floats
from funasr_tpu.frontends.wav_frontend import WavFrontend as JaxWavFrontend
from funasr_tpu.models.sense_voice.model import SenseVoiceSmall as JaxSenseVoice
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch import AutoModel
from funasr_tpu_torch.auto.auto_model import dispatch_pair
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.core.module import cast_floats
from funasr_tpu_torch.frontends.wav_frontend import WavFrontend
from funasr_tpu_torch.models.sense_voice.model import SenseVoiceSmall
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from funasr_tpu_torch.utils.postprocess_utils import rich_transcription_postprocess
from pipeline_parity_util import multi_segment_wav
from torch_parity_util import (SV_CONF, sense_voice_tokens, t, to_jax, write_sense_voice_dir,
                               write_vad_dir)
from torch_parity_util import one_torch_thread  # noqa: F401 (autouse)

FRONTEND = dict(fs=16000, n_mels=80, lfr_m=7, lfr_n=6, dither=0.0)
TOL = 2e-4
LENGTHS = [37, 20, 29]


@pytest.fixture(scope="module")
def pair():
    pt = SenseVoiceSmall(**SV_CONF, generator=torch.Generator().manual_seed(0)).eval()
    jm = JaxSenseVoice(**SV_CONF)
    return pt, jm, to_jax(convert_sense_voice(pt.state_dict(), jm))


@pytest.fixture(scope="module")
def feats():
    x = np.random.default_rng(3).standard_normal((3, max(LENGTHS), 560)).astype(np.float32)
    return x, np.asarray(LENGTHS, np.int32)


def test_encoder_output_unmasked_matches_jax(pair, feats):
    pt, jm, params = pair
    x, lens = feats
    want, want_lens = jm.encoder(params["encoder"], jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        got, got_lens = pt.encoder(t(x), t(lens))
    # every frame, the padded ones included: the JAX encoder returns them unmasked
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert np.abs(got.numpy()[1, 25:]).max() > 0.1  # the padding is not zeroed
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


@pytest.mark.parametrize("ban_emo_unk", [False, True])
@pytest.mark.parametrize("use_itn", [False, True])
@pytest.mark.parametrize("language", ["auto", "zh", "en"])
def test_log_probs_and_ids_match_jax(pair, feats, language, use_itn, ban_emo_unk):
    pt, jm, params = pair
    x, lens = feats
    lid, tn = pt.query_ids(dict(language=language, use_itn=use_itn))
    assert (lid, tn) == (jm.LID_DICT[language], jm.TEXTNORM_DICT["withitn" if use_itn
                                                                 else "woitn"])
    ids = np.full((3,), lid, np.int32), np.full((3,), tn, np.int32)
    want_ids, want_lens, want_logp = jm.infer_jit(params, jnp.asarray(x), jnp.asarray(lens),
                                                  *map(jnp.asarray, ids),
                                                  ban_emo_unk=ban_emo_unk)
    with torch.no_grad():
        got_ids, got_lens, got_logp = pt.infer(t(x), t(lens), *map(t, ids), ban_emo_unk)
    want_logp = np.asarray(want_logp)
    finite = np.isfinite(want_logp)
    np.testing.assert_array_equal(np.isfinite(got_logp.numpy()), finite)
    np.testing.assert_allclose(got_logp.numpy()[finite], want_logp[finite], atol=TOL, rtol=0)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got_lens.numpy(), lens + 4)
    assert (got_ids.numpy() != SenseVoiceSmall.EMO_UNK).all() or not ban_emo_unk


def test_ban_emo_unk_removes_the_tag(pair, feats):
    """With the EMO_UNK column lifted above every other, the ids are all EMO_UNK unless it
    is banned, as in JAX."""
    pt, jm, params = pair
    pt2 = SenseVoiceSmall(**SV_CONF).eval()
    pt2.load_state_dict(pt.state_dict())
    with torch.no_grad():
        pt2.ctc.ctc_lo.bias[SenseVoiceSmall.EMO_UNK] = 100.0
    p2 = to_jax(convert_sense_voice(pt2.state_dict(), jm))
    x, lens = feats
    ids = t(np.zeros(3, np.int32)), t(np.full(3, 15, np.int32))
    for ban in (False, True):
        with torch.no_grad():
            got = pt2.infer(t(x), t(lens), *ids, ban)[0].numpy()
        want = np.asarray(jm.infer_jit(p2, jnp.asarray(x), jnp.asarray(lens),
                                       *(jnp.asarray(i.numpy()) for i in ids),
                                       ban_emo_unk=ban)[0])
        np.testing.assert_array_equal(got, want)
        assert ((got == SenseVoiceSmall.EMO_UNK).all()) == (not ban)


def test_params_from_jax_loads_jax_init():
    jm = JaxSenseVoice(**SV_CONF)
    params = jm.init_params(jax.random.PRNGKey(4))
    pt = SenseVoiceSmall(**SV_CONF).eval()
    pt.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), pt))
    x = np.random.default_rng(5).standard_normal((2, 23, 560)).astype(np.float32)
    lens = np.asarray([23, 11], np.int32)
    ids = np.zeros(2, np.int32), np.full(2, 14, np.int32)
    want = jm.infer_jit(params, jnp.asarray(x), jnp.asarray(lens), *map(jnp.asarray, ids))
    with torch.no_grad():
        got = pt.infer(t(x), t(lens), *map(t, ids))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def _waves():
    rng = np.random.default_rng(9)
    return [multi_segment_wav(3.0, seed=1), (rng.standard_normal(16000 * 2) * 0.1)
            .astype(np.float32), multi_segment_wav(4.2, seed=2)]


@pytest.mark.parametrize("call", [dict(language="auto"), dict(language="zh", use_itn=True),
                                  dict(language="en", text_norm="woitn", ban_emo_unk=True)])
def test_inference_texts_match_jax(pair, call):
    pt, jm, params = pair
    tokens = sense_voice_tokens()
    waves = _waves()
    got, meta = pt.inference(waves, tokenizer=CharTokenizer(token_list=tokens),
                             frontend=WavFrontend(**FRONTEND), **call)
    want, want_meta = jm.inference(params, waves, tokenizer=JaxCharTokenizer(token_list=tokens),
                                   frontend=JaxWavFrontend(**FRONTEND), **call)
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert all(r["text"] for r in got)
    assert meta["batch_data_time"] == pytest.approx(want_meta["batch_data_time"])
    assert dispatch_pair(pt) is None


def test_rich_tags_reach_the_text_and_are_stripped(pair):
    """Under a head that favours the tags, the rich text carries them and
    ``rich_transcription_postprocess`` removes every one."""
    pt, _, _ = pair
    biased = SenseVoiceSmall(**SV_CONF).eval()
    biased.load_state_dict(pt.state_dict())
    tags = [i for i in range(24990, 25018) if sense_voice_tokens()[i].startswith("<|")]
    with torch.no_grad():
        biased.ctc.ctc_lo.bias[tags] += 3.0
    got, _ = biased.inference(_waves(), tokenizer=CharTokenizer(token_list=sense_voice_tokens()),
                              frontend=WavFrontend(**FRONTEND))
    texts = [r["text"] for r in got]
    assert all("<|" in s for s in texts)
    assert all("<|" not in rich_transcription_postprocess(s) for s in texts)


@pytest.fixture(scope="module")
def sv_dir(tmp_path_factory):
    return write_sense_voice_dir(tmp_path_factory.mktemp("sense_voice"))


def test_automodel_matches_jax(sv_dir):
    waves = _waves()
    kw = dict(model=sv_dir, device="cpu", log_level="WARNING")
    port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    call = dict(batch_size=2, language="auto", use_itn=True, key=["a", "b", "c"])
    got, want = port.generate(input=waves, **call), ref.generate(input=waves, **call)
    assert [r["text"] for r in got] == [r["text"] for r in want]
    assert [r["key"] for r in got] == ["a", "b", "c"]


def test_automodel_behind_the_vad_matches_jax(sv_dir, tmp_path):
    """The demo's call (``sense_voice/demo.py:19-28``) at test size: VAD segments merged
    to 15 s, ``batch_size_s=60``, the prompt's ``use_itn=True``."""
    vad = write_vad_dir(tmp_path)
    kw = dict(model=sv_dir, vad_model=vad, vad_kwargs={"max_single_segment_time": 30000},
              device="cpu", log_level="WARNING")
    port, ref = AutoModel(**kw), jauto.AutoModel(**kw)
    wav = np.concatenate([multi_segment_wav(12.0, seed=s) for s in (3, 4)])
    call = dict(language="auto", use_itn=True, batch_size_s=60, merge_vad=True,
                merge_length_s=15)
    got, want = port.generate(input=[wav], **call), ref.generate(input=[wav], **call)
    assert len(got) == 1 and got[0]["text"]
    assert got[0]["text"] == want[0]["text"]
    assert rich_transcription_postprocess(got[0]["text"]) == \
        rich_transcription_postprocess(want[0]["text"])


def test_bf16_token_flips_within_the_rounding_floor(pair, feats):
    """bf16 weights and features in the port against the JAX package at fp32: the flips
    stay within 3x the floor that bf16 rounding alone gives in JAX (bf16 weights, its
    features cast to bf16 as the port casts them), and the port's bf16 ids flip no more
    against JAX's bf16 ids than that floor."""
    pt, jm, params = pair
    x, lens = feats
    ids = np.zeros(3, np.int32), np.full(3, 15, np.int32)
    f32 = np.asarray(jm.infer_jit(params, jnp.asarray(x), jnp.asarray(lens),
                                  *map(jnp.asarray, ids))[0])
    jb = np.asarray(jm.infer_jit(jax_cast_floats(params, jnp.bfloat16),
                                 jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(lens),
                                 *map(jnp.asarray, ids))[0])
    pb_model = cast_floats(SenseVoiceSmall(**SV_CONF).eval(), torch.bfloat16)
    pb_model.load_state_dict(pt.state_dict())
    with torch.no_grad():
        pb = pb_model.infer(t(x).to(torch.bfloat16), t(lens), *map(t, ids))[0].numpy()
    valid = np.arange(f32.shape[1])[None] < (lens + 4)[:, None]
    floor = int(((jb != f32) & valid).sum())
    total = int(valid.sum())
    assert 0 < floor < total
    assert int(((pb != f32) & valid).sum()) <= 3 * floor
    assert int(((pb != jb) & valid).sum()) <= floor
