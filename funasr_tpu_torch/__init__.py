"""funasr_tpu_torch: the PyTorch + CUDA port of funasr_tpu (slices 1-2: offline
Paraformer, ``AutoModel`` with bf16 and int8 / W8A8 quantization).

Imports torch and numpy, never jax and never ``funasr_tpu``. The public entry point:

    from funasr_tpu_torch import AutoModel
    model = AutoModel(model="<model dir>", device="cuda", bf16=True, quant="w8a8")
    results = model.generate(input=[wave, "a.wav"], batch_size=32)

Importing the package registers its classes in its own ``tables``:

    from funasr_tpu_torch import tables
    model = tables.model_classes["Paraformer"](**conf, device="cuda", generator=g)
    frontend = tables.frontend_classes["WavFrontend"](fs=16000, lfr_m=7, lfr_n=6)
    tokenizer = tables.tokenizer_classes["CharTokenizer"](token_list=tokens)
    results, meta = model.inference(waves, tokenizer=tokenizer, frontend=frontend)

On a CUDA device the encoder's attention, every FSMN memory block and every W8A8 linear
run hand-written kernels (``csrc/``, built with nvcc at first use); on the CPU they run
their plain PyTorch versions.
"""

import torch

from funasr_tpu_torch.register import tables

# The JAX package runs its fp32 products at full precision (the fbank DFT explicitly at
# HIGHEST). PyTorch defaults CUDA fp32 convolutions to TF32; state both switches.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from funasr_tpu_torch.frontends import wav_frontend  # noqa: E402,F401
from funasr_tpu_torch.models.paraformer import cif_predictor, decoder, model  # noqa: E402,F401
from funasr_tpu_torch.models.sanm import encoder  # noqa: E402,F401
from funasr_tpu_torch.tokenizer import char_tokenizer  # noqa: E402,F401
from funasr_tpu_torch.auto.auto_model import AutoModel  # noqa: E402

__all__ = ["AutoModel", "tables"]
