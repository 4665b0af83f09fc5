"""Int8 / W8A8 quantization of the PyTorch port against ``funasr_tpu/ops/quant.py``.

Inputs are made with numpy and handed to both packages. Tolerances:

* weight quantization (``w_q8`` / ``w_q``, ``scale``) bit-equal, fp32 and bf16 weights;
* per-row activation quantization and the W8A8 product bit-equal to the JAX functions
  as the path runs them (jitted: XLA turns ``/ 127.0`` into ``* fl(1/127)`` and the
  bias add into an fma);
* ``qlinear``'s float layouts within 1e-6 of max|y| (sums in another order);
* the encoder of a W8A8 model loaded from a JAX W8A8 tree within 1e-3 relative L2: the
  fp32 sums upstream of each W8A8 linear differ from XLA's in the last bits, and where
  an activation sits within that of a rounding boundary of x / sx its int8 value moves
  by one, which moves the output row by ~1e-4 of its norm (measured: 6e-4 after two
  blocks, 1e-7 after one).

The ``cuda``-marked test holds the kernel to its plain version on the card.
"""

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.ops import quant as jquant
from funasr_tpu_torch.convert import params_from_jax
from funasr_tpu_torch.core.module import cast_floats
from funasr_tpu_torch.ops import cuda_lib, quant
from funasr_tpu_torch.ops.w8a8 import w8a8_linear, w8a8_linear_ref
from torch_parity_util import build_pair, t

D256_CONF = dict(
    input_size=560, vocab_size=304,
    encoder_conf=dict(output_size=256, attention_heads=4, linear_units=256, num_blocks=2,
                      kernel_size=11, sanm_shfit=0),
    decoder_conf=dict(attention_heads=4, linear_units=256, num_blocks=2, att_layer_num=2,
                      kernel_size=11, sanm_shfit=0),
    predictor_conf=dict(idim=256, l_order=1, r_order=1, tail_threshold=0.45),
    sos=1, eos=2, predictor_bias=1)

# what the JAX package quantizes on this config (one per layer instance)
W8A8_SET = {
    **{f"encoder.{stack}.{i}.{name}": "w_q8"
       for stack, n in (("encoders0", 1), ("encoders", 1)) for i in range(n)
       for name in ("self_attn.linear_q_k_v", "self_attn.linear_out",
                    "feed_forward.w_1", "feed_forward.w_2")},
    **{f"decoder.decoders.{i}.{name}": "w_q8" for i in range(2)
       for name in ("feed_forward.w_1", "feed_forward.w_2", "src_attn.linear_q",
                    "src_attn.linear_k_v", "src_attn.linear_out")},
    "decoder.decoders3.0.feed_forward.w_1": "w_q8",
    "decoder.decoders3.0.feed_forward.w_2": "w_q8",
    "decoder.output_layer": "w_q",
}

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _weights(rng, k_in, n_out):
    w = rng.standard_normal((k_in, n_out)).astype(np.float32) * rng.uniform(0.01, 2.0, n_out)
    w[:, 3] = 0.0  # an all-zero output channel: scale clamps to 1e-12
    return w.astype(np.float32), rng.standard_normal(n_out).astype(np.float32)


def _linear(w_jax, b, dtype):
    lin = torch.nn.Linear(*w_jax.shape)
    with torch.no_grad():
        lin.weight.copy_(t(w_jax.T))
        lin.bias.copy_(t(b))
    return lin.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("key", ["w_q8", "w_q"])
def test_quantize_linear_int8_bit_equal(rng, dtype, key):
    w, b = _weights(rng, 560, 384)
    lin = _linear(w, b, dtype)
    got = quant.quantize_linear_int8(lin, key=key)
    want = jquant.quantize_linear_int8({"w": jnp.asarray(w, _JDT[dtype]), "b": jnp.asarray(b)},
                                       key=key)
    assert got.weight_q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.weight_q.numpy(), np.asarray(want[key]).T)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want["scale"]))
    torch.testing.assert_close(got.bias, lin.bias, rtol=0, atol=0)
    back = quant.dequantize_linear_int8(got)
    np.testing.assert_allclose(back.weight.detach().numpy(),
                               _f32(jquant.dequantize_linear_int8(want)["w"]).T, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_int8_bit_equal(rng, dtype):
    x = (rng.standard_normal((300, 560)) * rng.uniform(0.01, 30.0, (300, 1))).astype(np.float32)
    x[7] = 0.0  # a padded row: sx = 1e-6 / 127, x_q = 0
    xt = t(x).to(dtype)
    xj = jnp.asarray(x, _JDT[dtype])
    q, sx = quant._quantize_rows_int8(xt)
    jq, jsx = jax.jit(jquant._quantize_rows_int8)(xj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    assert (q[7] == 0).all() and torch.isfinite(sx).all()


@pytest.mark.parametrize("layout", ["w", "w_q", "w_q8"])
def test_qlinear_matches_jax(rng, layout):
    w, b = _weights(rng, 512, 320)
    x = (rng.standard_normal((4, 37, 512)) * 2).astype(np.float32)
    lin = _linear(w, b, torch.float32)
    mod = lin if layout == "w" else quant.quantize_linear_int8(lin, key=layout)
    p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    if layout != "w":
        p = jquant.quantize_linear_int8(p, key=layout)
    with torch.inference_mode():
        got = quant.qlinear(mod, t(x)).numpy()
    want = np.asarray(jax.jit(jquant.qlinear)(p, jnp.asarray(x)))
    if layout == "w_q8":
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [True, False])
def test_w8a8_linear_ref_matches_jax_at_ragged_shapes(rng, dtype, bias):
    m, k, n = 7, 560, 24
    w, b = _weights(rng, k, n)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    x[2] = 0.0
    p = jquant.quantize_linear_int8({"w": jnp.asarray(w), "b": jnp.asarray(b)}, key="w_q8")
    if not bias:
        del p["b"]
    xt = t(x).to(dtype)
    w_q8, scale = t(np.asarray(p["w_q8"]).T), t(np.asarray(p["scale"]))
    bt = t(b) if bias else None
    before = w8a8_linear.launches
    got = w8a8_linear(xt, w_q8, scale, bt)  # a CPU tensor takes the plain version
    assert w8a8_linear.launches == before and cuda_lib.load_library.cache_info().currsize == 0
    torch.testing.assert_close(got, w8a8_linear_ref(xt, w_q8, scale, bt), rtol=0, atol=0)
    want = jax.jit(jquant.qlinear)(p, jnp.asarray(x, _JDT[dtype]))
    assert got.dtype == dtype and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))
    if bias:
        np.testing.assert_array_equal(got[2].float().numpy(), t(b).to(dtype).float().numpy())


def _quantized_names(model):
    return {name: m.key for name, m in model.named_modules()
            if isinstance(m, quant.Int8Linear)}


def test_quantize_params_int8_swaps_the_jax_set():
    pt, jm, params = build_pair(D256_CONF, seed=0)
    quant.quantize_params_int8(pt, mode="w8a8")
    assert _quantized_names(pt) == W8A8_SET
    # the JAX tree quantized alike maps name for name onto the port's state dict
    jq = jax.tree_util.tree_map(np.asarray, jquant.quantize_params_int8(params, mode="w8a8"))
    sd = params_from_jax(jq, pt)
    assert set(sd) == set(pt.state_dict())
    for name, key in W8A8_SET.items():
        mod = pt.get_submodule(name)
        torch.testing.assert_close(sd[f"{name}.{key}"], mod.weight_q, rtol=0, atol=0)
        torch.testing.assert_close(sd[f"{name}.scale"], mod.scale, rtol=0, atol=0)
    # weight-only swaps the same layers, all as w_q
    pt2 = quant.quantize_params_int8(build_pair(D256_CONF, seed=0)[0])
    assert _quantized_names(pt2) == {k: "w_q" for k in W8A8_SET}
    assert quant.quantized_bytes(pt2) < quant.quantized_bytes(build_pair(D256_CONF)[0])


def test_int8_linear_scale_stays_fp32_under_cast():
    pt = quant.quantize_params_int8(build_pair(D256_CONF, seed=0)[0], mode="w8a8")
    mod = pt.decoder.decoders[0].src_attn.linear_k_v
    scale = mod.scale.clone()
    cast_floats(pt, torch.bfloat16)
    assert mod.scale.dtype == torch.float32 and torch.equal(mod.scale, scale)
    assert mod.bias.dtype == torch.bfloat16 and mod.w_q8.dtype == torch.int8


def test_params_from_jax_w8a8_tree_runs_like_jax(rng):
    pt, jm, params = build_pair(D256_CONF, seed=3)
    jq = jquant.quantize_params_int8(params, mode="w8a8")
    quant.quantize_params_int8(pt, mode="w8a8")
    pt.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jq), pt))
    x = rng.standard_normal((3, 100, 560)).astype(np.float32)
    lens = np.asarray([100, 80, 37], np.int32)
    with torch.inference_mode():
        enc, _ = pt.encode(t(x), t(lens))
    jenc, _ = jax.jit(lambda p, a, b: jm.encode(p, a, b))(jq, jnp.asarray(x), jnp.asarray(lens))
    jenc = np.asarray(jenc)
    rel = np.linalg.norm(enc.numpy() - jenc) / np.linalg.norm(jenc)
    assert rel <= 1e-3, rel
    got, want = pt.infer_bucketed(x, lens), jm.infer_bucketed(jq, x, lens)
    np.testing.assert_array_equal(got[1], want[1])
    for i, n in enumerate(want[1]):
        np.testing.assert_array_equal(got[0][i, :n], want[0][i, :n])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mkn", chip_smoke.W8A8_SHAPES + [(7, 560, 24), (33, 40, 24),
                                                         (65, 100, 37), (300, 512, 1024),
                                                         (33, 40, 24, 0), (9, 9000, 40, 0),
                                                         (12416, 512, 25055)])
def test_w8a8_kernel_matches_plain_bit_exact(cuda_device, dtype, mkn):
    """Every (M, K, N) of the W8A8 path, plus ragged M / N and K = 40, 100 (weights
    padded to K % 16 == 0 by the wrapper) and N = 37 (output row pitch padded); x with
    row stride 2K, starting `off` elements into its row. K % 16 != 0 starts off a
    16-byte boundary (the quantizer's scalar loads) unless `off` = 0 is given: then the
    vector loads meet the ragged K tail, and at K = 9000 the row is longer than the
    8,192 values the quantizer keeps in registers, so it is read again. (12416, 512,
    25055) is SenseVoice's CTC head at B = 32 x 15 s (odd N: the pitch pads to 25056)."""
    m, k, n, *given = mkn
    g = torch.Generator().manual_seed(0)
    off = given[0] if given else 1 if k % 16 else 0
    x = (torch.randn(m, 2 * k, generator=g) * 2).to(cuda_device, dtype)[:, off:off + k]
    x[1] = 0
    w_q8 = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(cuda_device)
    scale = (torch.rand(n, generator=g) * 0.01).to(cuda_device)
    bias = torch.randn(n, generator=g).to(cuda_device, dtype)
    before = w8a8_linear.launches
    out = w8a8_linear(x, w_q8, scale, bias)
    torch.cuda.synchronize()
    assert w8a8_linear.launches == before + 1
    torch.testing.assert_close(out, w8a8_linear_ref(x, w_q8, scale, bias), rtol=0, atol=0)
