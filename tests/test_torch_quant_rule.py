"""Which linears ``quant=`` swaps: the port's ``ops/quant.py::quantize_params_int8`` against
the JAX package's ``funasr_tpu/ops/quant.py::quantize_params_int8`` (CPU), for every model
class ``AutoModel(quant=...)`` builds in both packages, at widths of 256 where the rule's
``min_dim`` reads them.

The JAX rule quantizes a 2-D ``{"w"}`` leaf whatever its name, but a scan-stacked 3-D leaf
only under a name in ``_LINEAR3_KEYS``; the port swaps an ``nn.Linear`` inside a layer the
JAX package stacks only under those names (``quant.py::scan_stacked``). The JAX side is
the model's own init, quantized as a tree; where each quantized JAX leaf lands among the
port's modules is read through ``params_from_jax`` on a tagged copy of the tree (every
leaf filled with its index, and a stacked leaf's layers with their own), so the test
holds the two sets of module names equal, key for key (``w_q8``, or ``w_q`` for the
logits heads under W8A8).
"""

import jax
import numpy as np
import pytest

from funasr_tpu.ops import quant as jquant
from funasr_tpu.register import tables as jtables
from funasr_tpu_torch import tables
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.ops import quant
from torch_parity_util import (BICIF_PREDICTOR, NANO_LLM, PUNC_ENC, PUNC_MODEL_CONF,
                               SEACO_DECODER_CONF, SV_CONF, one_torch_thread)  # noqa: F401

import funasr_tpu.models.conformer.model  # noqa: F401,E402 (registers Conformer in JAX)
import funasr_tpu.models.lcbnet.model  # noqa: F401,E402 (registers LCBNet in JAX)
import funasr_tpu.models.uniasr.model  # noqa: F401,E402 (registers UniASR in JAX)
import funasr_tpu.models.rwkv_bat.model  # noqa: F401,E402 (registers BAT in JAX)
import funasr_tpu.models.transducer.model  # noqa: F401,E402

D = 256
SANM_ENC = dict(output_size=D, attention_heads=4, linear_units=D, num_blocks=2,
                kernel_size=11, sanm_shfit=0)
SANM_DEC = dict(attention_heads=4, linear_units=D, num_blocks=2, att_layer_num=2,
                kernel_size=11, sanm_shfit=0)
PREDICTOR = dict(idim=D, l_order=1, r_order=1, tail_threshold=0.45)
PARAFORMER = dict(input_size=560, vocab_size=300, encoder_conf=SANM_ENC, decoder_conf=SANM_DEC,
                  predictor_conf=PREDICTOR, sos=1, eos=2, predictor_bias=1)
AED_DEC = dict(attention_heads=4, linear_units=D, num_blocks=2)
AED = dict(input_size=80, vocab_size=300, decoder_conf=AED_DEC, ctc_weight=0.3)
LLM = dict(NANO_LLM, hidden_size=D, intermediate_size=D, head_dim=64, vocab_size=300)
ADAPTOR = dict(downsample_rate=2, encoder_dim=D, llm_dim=D, ffn_dim=D)

CASES = {
    "Paraformer": ("Paraformer", PARAFORMER),
    "Paraformer_ctc": ("Paraformer", dict(PARAFORMER, ctc_weight=0.3)),
    "BiCifParaformer": ("BiCifParaformer",
                        dict(PARAFORMER, predictor_conf=dict(BICIF_PREDICTOR, idim=D))),
    "SeacoParaformer": ("SeacoParaformer", dict(
        PARAFORMER, predictor_conf=dict(BICIF_PREDICTOR, idim=D), inner_dim=D,
        seaco_decoder="ParaformerSANMDecoder",
        seaco_decoder_conf=dict(SEACO_DECODER_CONF, linear_units=D))),
    "ContextualParaformer": ("ContextualParaformer", dict(PARAFORMER, inner_dim=D)),
    "ParaformerStreaming": ("ParaformerStreaming", dict(
        PARAFORMER, encoder_conf=dict(SANM_ENC, input_layer="pe_online"),
        decoder_conf=dict(SANM_DEC, num_blocks=3, sanm_shfit=5))),
    "EParaformer": ("EParaformer", PARAFORMER),
    "SenseVoiceSmall": ("SenseVoiceSmall", dict(
        SV_CONF, vocab_size=300, encoder_conf=dict(SV_CONF["encoder_conf"], output_size=D,
                                                   linear_units=D, num_blocks=2))),
    "CTTransformer": ("CTTransformer", dict(
        PUNC_MODEL_CONF, vocab_size=300, encoder="SANMEncoder",
        encoder_conf=dict(PUNC_ENC, num_blocks=2, linear_units=D))),
    "FunASRNano": ("FunASRNano", dict(
        input_size=560, audio_encoder="SANMEncoder", audio_encoder_conf=SANM_ENC,
        audio_adaptor="Linear", audio_adaptor_conf=ADAPTOR, llm_conf=LLM)),
    "GLMASR": ("GLMASR", dict(
        input_size=80, audio_encoder_conf=dict(output_size=D, attention_heads=4,
                                               linear_units=D, num_blocks=2),
        audio_adaptor="Linear", audio_adaptor_conf=ADAPTOR, llm_conf=LLM)),
    "Transformer": ("Transformer", dict(AED, encoder_conf=dict(
        output_size=D, attention_heads=4, linear_units=D, num_blocks=2))),
    "Transformer_lightconv": ("Transformer", dict(
        AED, encoder_conf=dict(output_size=D, attention_heads=4, linear_units=D, num_blocks=1),
        decoder="LightweightConvolutionTransformerDecoder",
        decoder_conf=dict(AED_DEC, conv_kernel_length=[5, 7]))),
    "SANM": ("SANM", dict(AED, input_size=560, encoder_conf=SANM_ENC)),
    "Conformer": ("Conformer", dict(AED, encoder_conf=dict(
        output_size=D, attention_heads=4, linear_units=D, num_blocks=2, cnn_module_kernel=15))),
    "Branchformer": ("Branchformer", dict(AED, encoder_conf=dict(
        output_size=D, attention_heads=4, cgmlp_linear_units=2 * D, num_blocks=2))),
    "EBranchformer": ("EBranchformer", dict(AED, encoder_conf=dict(
        output_size=D, attention_heads=4, cgmlp_linear_units=2 * D, num_blocks=2,
        ffn_units=D))),
    "TransformerLM": ("TransformerLM", dict(vocab_size=300, embed_unit=D, att_unit=D, head=4,
                                            unit=D, layer=2)),
    "SeqRNNLM": ("SeqRNNLM", dict(vocab_size=300, embed_unit=D, hidden_size=D, num_layers=2)),
    "Transducer": ("Transducer", dict(
        input_size=80, vocab_size=300, encoder="ChunkConformerEncoder",
        encoder_conf=dict(output_size=D, attention_heads=4, linear_units=D, num_blocks=2,
                          cnn_module_kernel=15, input_layer="conv2d"),
        decoder_conf=dict(embed_size=D, hidden_size=D), joint_network_conf=dict(
            joint_space_size=D))),
    "UniASR": ("UniASR", dict(
        input_size=560, vocab_size=300,
        encoder_conf=dict(SANM_ENC, num_blocks=1, chunk_size=[12, 15], stride=[8, 10]),
        encoder2_conf=dict(SANM_ENC, num_blocks=1),
        decoder_conf=dict(SANM_DEC, num_blocks=3, concat_embeds=True),
        decoder2_conf=dict(SANM_DEC, num_blocks=2), predictor_conf=PREDICTOR,
        sos=1, eos=2, predictor_bias=1, predictor2_bias=1)),
    "LCBNet": ("LCBNet", dict(AED, encoder_conf=dict(
        output_size=D, attention_heads=4, linear_units=D, num_blocks=1, cnn_module_kernel=15),
        text_encoder_conf=dict(linear_units=D, num_blocks=2),
        fusion_encoder_conf=dict(linear_units=D), bias_predictor_conf=dict(linear_units=D))),
    "BAT": ("BAT", dict(input_size=80, vocab_size=300, encoder_conf=dict(
        output_size=D, num_blocks=2, ffn_mult=2), decoder_conf=dict(embed_size=D, hidden_size=D),
        joint_network_conf=dict(joint_space_size=D))),
}


def _init(jm):
    init = getattr(jm, "init_params", None) or jm.init
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))


def jax_quantized_names(pt, tree, mode="w8a8"):
    """{port module name: key} of the linears the JAX package quantizes in ``tree``."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    index = {jax.tree_util.keystr(path): i for i, (path, _) in enumerate(leaves)}
    tagged = []
    for i, (_, a) in enumerate(leaves):
        a = np.asarray(a)
        if a.dtype.kind != "f" or a.ndim == 0:
            tagged.append(a)
            continue
        tag = np.full(a.shape, i * 4096.0) + np.arange(a.shape[0]).reshape(
            (-1,) + (1,) * (a.ndim - 1))
        tagged.append(tag.astype(np.float32))
    sd = params_from_jax(jax.tree_util.tree_unflatten(treedef, tagged), pt)
    where = {int(v.reshape(-1)[0]): name[: -len(".weight")] for name, v in sd.items()
             if name.endswith(".weight") and v.is_floating_point() and v.numel()}
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jquant.quantize_params_int8(tree, mode=mode))[0]:
        key = getattr(path[-1], "key", None)
        if key not in ("w_q8", "w_q"):
            continue
        i = index[jax.tree_util.keystr(path[:-1]) + "['w']"]
        layers = range(np.shape(leaf)[0]) if np.ndim(leaf) == 3 else (0,)
        for layer in layers:
            want[where[i * 4096 + layer]] = key
    return want


@pytest.mark.parametrize("case", list(CASES))
def test_port_swaps_the_linears_jax_quantizes(case):
    name, conf = CASES[case]
    pt = tables.model_classes[name](**conf).eval()
    jm = jtables.model_classes[name](**conf)
    want = jax_quantized_names(pt, _init(jm))
    quant.quantize_params_int8(pt, mode="w8a8")
    got = {n: m.key for n, m in pt.named_modules() if isinstance(m, quant.Int8Linear)}
    assert got == want, (sorted(set(got) ^ set(want)))
    assert want  # the case reaches the rule
