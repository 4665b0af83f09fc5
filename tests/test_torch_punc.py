"""CT-Transformer punctuation of the PyTorch port against the JAX package (CPU).

At ct-punc-c's published widths (SANM encoder d 256, 8 heads, FFN 1024, 4 blocks,
kernel 11, embedding 256) with a 64-token vocabulary: each window's logits within 2e-4
abs (the fp32 budget the JAX package holds against the reference), and ``punc_array``
and the punctuated text equal over a text of several 20-word windows. Weights cross
with the JAX package's ``convert_ct_transformer`` and the port's ``params_from_jax``.
Also the copied word-splitting helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.convert.torch_to_jax import convert_ct_transformer
from funasr_tpu.models.ct_transformer import utils as jutils
from funasr_tpu.models.ct_transformer.model import CTTransformer as JaxCT
from funasr_tpu.tokenizer.char_tokenizer import CharTokenizer as JaxCharTokenizer
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.models.ct_transformer import utils as tutils
from funasr_tpu_torch.models.ct_transformer.model import CTTransformer
from funasr_tpu_torch.tokenizer.char_tokenizer import CharTokenizer
from torch_parity_util import PIPE_TOKENS, PUNC_ENC, PUNC_MODEL_CONF

LOGIT_ATOL = 2e-4
CONF = dict(encoder_conf=PUNC_ENC, vocab_size=len(PIPE_TOKENS), **PUNC_MODEL_CONF)


@pytest.fixture(scope="module")
def pair():
    port = CTTransformer(**CONF, generator=torch.Generator().manual_seed(2)).eval()
    ref = JaxCT(**CONF)
    params = jax.tree_util.tree_map(jnp.asarray, convert_ct_transformer(port.state_dict(), ref))
    return port, ref, params


@pytest.mark.parametrize("n", [1, 7, 20, 33])
def test_window_logits_match_jax(pair, rng, n):
    """One window, padded to its bucket (8, 8, 24, 40) with length n."""
    port, ref, params = pair
    ids = rng.integers(3, len(PIPE_TOKENS), size=n).astype(np.int32)
    got = port.window_logits(ids)
    want = ref._window_logits(params, ids)
    assert got.shape == want.shape == (n, len(PUNC_MODEL_CONF["punc_list"]))
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def _text(rng, n_words):
    chars = PIPE_TOKENS[3:-1]
    words = [chars[i] for i in rng.integers(0, len(chars), size=n_words)]
    for i in rng.choice(n_words, size=n_words // 9, replace=False):  # a few latin words
        words[i] = ["hello", "ok", "abc"][i % 3]
    return " ".join(words)


@pytest.mark.parametrize("n_words", [5, 57, 130])
def test_inference_text_and_punc_array_match_jax(pair, rng, n_words):
    port, ref, params = pair
    text = _text(rng, n_words)
    got, _ = port.inference([text], key=["k"], tokenizer=CharTokenizer(token_list=PIPE_TOKENS))
    want, _ = ref.inference(params, [text], key=["k"],
                            tokenizer=JaxCharTokenizer(token_list=PIPE_TOKENS))
    assert got[0]["key"] == want[0]["key"] == "k"
    assert got[0]["text"] == want[0]["text"] and got[0]["text"]
    np.testing.assert_array_equal(got[0]["punc_array"], want[0]["punc_array"])
    empty, _ = port.inference(["  "], key=["e"], tokenizer=CharTokenizer(token_list=PIPE_TOKENS))
    assert empty[0]["text"] == "" and empty[0]["punc_array"] is None


def test_params_from_jax_loads_jax_ct_params(rng):
    ref = JaxCT(**CONF)
    params = ref.init_params(jax.random.PRNGKey(5))
    port = CTTransformer(**CONF)
    port.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), port))
    ids = rng.integers(3, len(PIPE_TOKENS), size=13).astype(np.int32)
    np.testing.assert_allclose(port.window_logits(ids), ref._window_logits(params, ids),
                               atol=LOGIT_ATOL, rtol=0)


def test_word_split_copies_match():
    for text in ("一丁 七hello world万  丈", "abc", "", "一 二 三 ok's 四"):
        assert tutils.split_words(text) == jutils.split_words(text)
    for text in ("hello world", "ok's fine", "一丁", "a-b"):
        assert [tutils.is_english_word(w) for w in text.split()] == \
               [jutils.is_english_word(w) for w in text.split()]
    words = list(range(47))
    for limit in (2, 20, 47, 50):
        assert tutils.split_to_mini_sentence(words, limit) == \
               jutils.split_to_mini_sentence(words, limit)
