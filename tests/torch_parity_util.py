"""Shared builders for the parity tests of the PyTorch port against the JAX package.

The port's model is built from a seeded ``torch.Generator``; its ``state_dict`` goes
through the JAX package's own converter (``convert_paraformer``), so both packages run
identical weights. Inputs are made with numpy and handed to both.
"""

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
