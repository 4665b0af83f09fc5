"""SCAMA and UniASR on the card, without JAX: the flash kernels' chunk mode, which every
encoder self-attention of theirs runs, is fp32 only, so a model cast to another dtype on
CUDA raises ``NotImplementedError`` naming the roadmap's bf16 chunk-mode item (``cuda``)
and does not run the plain version in its place. On the CPU, where the plain version
runs, a bf16 cast is allowed. ``chip_smoke.py`` phase 22 drives both models on the card.
"""

import pytest
import torch

from funasr_tpu_torch import tables

ENC = dict(output_size=16, attention_heads=2, linear_units=32, num_blocks=2, kernel_size=5,
           chunk_size=(8,), stride=(5,), pad_left=(0,), encoder_att_look_back_factor=(1,),
           decoder_att_look_back_factor=(1,))
DEC = dict(attention_heads=2, linear_units=32, num_blocks=2, att_layer_num=2, kernel_size=5)
CONFS = {"SCAMA": dict(input_size=16, vocab_size=12, encoder_conf=ENC, decoder_conf=DEC),
         "UniASR": dict(input_size=16, vocab_size=12, encoder_conf=ENC, encoder2_conf=ENC,
                        decoder_conf=DEC, decoder2_conf=DEC, predictor_conf=dict(idim=16),
                        predictor2_conf=dict(idim=16))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", list(CONFS))
def test_bf16_on_the_cpu_is_allowed(name):
    model = tables.model_classes[name](**CONFS[name]).to(torch.bfloat16)
    assert next(model.parameters()).dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFS))
def test_bf16_on_cuda_raises_the_named_error(cuda_device, name):
    model = tables.model_classes[name](**CONFS[name]).to(cuda_device)
    with pytest.raises(NotImplementedError, match="bf16 chunk mode"):
        model.to(torch.bfloat16)
