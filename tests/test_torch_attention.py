"""SAN-M attention and kernel parity of the PyTorch port against the JAX package.

On the CPU the kernel wrappers take their plain PyTorch versions; those are held to the
JAX functions here:

* flash: against the Pallas kernel in interpret mode, as ``tests/test_flash_attention.py``
  runs it (atol/rtol 2e-3, valid query rows);
* FSMN memory: against ``attention.py::_fsmn`` / ``fsmn_decoder_apply`` (built on
  ``depthwise_conv1d_apply``, to which the Pallas ``dw_pallas`` is bit-exact), 1e-5 fp32;
* ``sanm_attention_apply`` / ``cross_attention_apply``: 2e-4 fp32 (the ROADMAP budget);
  with the streaming punctuation encoder's causal and "VAD corner" masks (the flash
  route's per-row key limits against JAX's masked einsum route); the streaming chunk
  functions (queries over [cached K/V | chunk], Tq < Tk; the cross-attention cache; the
  decoder's FSMN step over concat(cache, x) with a gathered cache) against JAX's.

The tests marked ``cuda`` hold each CUDA kernel to its plain version on the card and
skip elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from funasr_tpu.convert.torch_to_jax import SD
from funasr_tpu.models.sanm import attention as jattn
from funasr_tpu.ops.flash_attention import flash_attention as pallas_flash
from funasr_tpu_torch.core.module import init_weights
from funasr_tpu_torch.models.sanm import attention as tattn
from funasr_tpu_torch.ops import cuda_lib
from funasr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_ref
from funasr_tpu_torch.ops.fsmn import fsmn_memory, fsmn_memory_ref
from torch_parity_util import t, to_jax

FLASH_TOL = 2e-3
FSMN_TOL = 1e-5
ATTN_TOL = 2e-4


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _mask(lens, n):
    return np.arange(n)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("t_len,block", [(256, 128), (512, 256)])
def test_flash_plain_matches_pallas_interpret(rng, t_len, block):
    b, h, d = 2, 2, 128
    q, k, v = (rng.standard_normal((b, h, t_len, d)).astype(np.float32) for _ in range(3))
    lens = np.asarray([t_len, t_len - 37], np.int32)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(lens), block_q=block, block_k=block,
                                   interpret=True))
    got = flash_attention_ref(t(q), t(k), t(v), t(lens)).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :, :n], want[i, :, :n], rtol=FLASH_TOL,
                                   atol=FLASH_TOL)


def test_kernel_wrappers_take_plain_version_on_cpu(rng):
    """No nvcc here: the wrappers import, never build, and run the plain versions."""
    q, k, v = (t(rng.standard_normal((2, 3, 77, 16)).astype(np.float32)) for _ in range(3))
    lens = torch.tensor([77, 0])
    before = flash_attention.launches
    out = flash_attention(q, k, v, lens)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_ref(q, k, v, lens), rtol=0, atol=0)
    # a zero-length row averages V over all T keys (the Pallas kernel's behaviour)
    torch.testing.assert_close(out[1], v[1].mean(dim=1, keepdim=True).expand(3, 77, 16))

    x = t(rng.standard_normal((2, 30, 8)).astype(np.float32))
    w = t(rng.standard_normal((8, 1, 11)).astype(np.float32))
    mask = t(_mask([30, 20], 30))
    before = fsmn_memory.launches
    out = fsmn_memory(x, w, mask, 5, 5)
    assert fsmn_memory.launches == before
    torch.testing.assert_close(out, fsmn_memory_ref(x, w, mask, 5, 5), rtol=0, atol=0)
    assert cuda_lib.load_library.cache_info().currsize == 0


@pytest.mark.parametrize("shift", [0, 5])
@pytest.mark.parametrize("masked", [True, False])
def test_fsmn_plain_matches_jax(rng, shift, masked):
    b, n, c, k = 3, 40, 24, 11
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w_kc = rng.uniform(-0.3, 0.3, (k, c)).astype(np.float32)  # JAX layout (k, C)
    mask = _mask([40, 33, 7], n) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else t(mask)
    enc_cfg = jattn.SANMAttentionConfig(4, c, c, kernel_size=k, sanm_shift=shift)
    dec_cfg = jattn.FSMNDecoderConfig(c, kernel_size=k, sanm_shift=shift)
    params = {"fsmn_block": {"w": jnp.asarray(w_kc)}}
    left, right = enc_cfg.fsmn_pads
    got = fsmn_memory_ref(t(x), t(w_kc.T[:, None, :]), tm, left, right).numpy()
    np.testing.assert_allclose(got, np.asarray(jattn._fsmn(params, enc_cfg, jnp.asarray(x), jm)),
                               atol=FSMN_TOL, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jattn.fsmn_decoder_apply(params, dec_cfg, jnp.asarray(x), jm)),
        atol=FSMN_TOL, rtol=0)


def test_fsmn_plain_bf16_rounds_like_jax(rng):
    """bf16: the conv sum is rounded before the residual add, and again after."""
    b, n, c, k = 2, 33, 16, 11
    x = rng.standard_normal((b, n, c)).astype(np.float32)
    w_kc = rng.uniform(-0.3, 0.3, (k, c)).astype(np.float32)
    mask = _mask([33, 20], n)
    cfg = jattn.FSMNDecoderConfig(c, kernel_size=k)
    want = jattn.fsmn_decoder_apply({"fsmn_block": {"w": jnp.asarray(w_kc)}}, cfg,
                                    jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask))
    got = fsmn_memory_ref(t(x).bfloat16(), t(w_kc.T[:, None, :]), t(mask), 5, 5)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def _sanm_pair(in_feat, n_feat, n_head, seed=0):
    cfg = tattn.SANMAttentionConfig(n_head, in_feat, n_feat)
    mod = init_weights(tattn.MultiHeadedAttentionSANM(cfg), _gen(seed))
    sd = SD(mod.state_dict())
    params = to_jax({"linear_q_k_v": sd.linear("linear_q_k_v"),
                     "linear_out": sd.linear("linear_out"),
                     "fsmn_block": sd.dwconv("fsmn_block")})
    return mod, jattn.SANMAttentionConfig(n_head, in_feat, n_feat), params


@pytest.mark.parametrize("in_feat", [48, 64])
def test_sanm_attention_matches_jax(rng, in_feat):
    """The port's flash route against the JAX einsum route (the one it takes off-TPU)."""
    b, n, d, h = 3, 45, 64, 4
    mod, jcfg, params = _sanm_pair(in_feat, d, h)
    x = rng.standard_normal((b, n, in_feat)).astype(np.float32)
    lens = np.asarray([45, 30, 12], np.int32)
    mask = _mask(lens, n)
    want = jattn.sanm_attention_apply(params, jcfg, jnp.asarray(x), jnp.asarray(mask),
                                      lengths=jnp.asarray(lens))
    got = tattn.sanm_attention_apply(mod, t(x), t(mask), t(lens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("vad_pos", [None, (0, 1), (6, 40), (20, 13)])
def test_sanm_attention_row_limits_match_jax(rng, vad_pos):
    """Causal (``vad_pos`` None) and corner key limits against the JAX einsum route with
    the (B, T, T) mask beside the pad mask (``SANMVadEncoder``'s layers), ragged lengths."""
    b, n, d, h = 2, 37, 64, 4
    mod, jcfg, params = _sanm_pair(d, d, h)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    lens = np.asarray([37, 22], np.int32)
    mask = _mask(lens, n)
    rows, cols = np.arange(n)[None, :, None], np.arange(n)[None, None, :]
    if vad_pos is None:
        attn_mask = np.broadcast_to(rows >= cols, (b, n, n))
        mode, vp = "causal", None
    else:
        vpa = np.asarray(vad_pos, np.int32)[:, None, None]
        attn_mask = ~((rows <= vpa - 2) & (cols >= vpa))
        mode, vp = "corner", t(np.asarray(vad_pos, np.int32))
    want = jattn.sanm_attention_apply(params, jcfg, jnp.asarray(x), jnp.asarray(mask),
                                      attn_mask=jnp.asarray(attn_mask))
    got = tattn.sanm_attention_apply(mod, t(x), t(mask), t(lens), mode, vp)
    for i, m in enumerate(lens):  # JAX zeroes no padded query row: compare the valid ones
        np.testing.assert_allclose(got.detach().numpy()[i, :m], np.asarray(want)[i, :m],
                                   atol=ATTN_TOL, rtol=0)


@pytest.mark.parametrize("look_back", [0, 1, 4, -1])
def test_sanm_attention_chunk_matches_jax(rng, look_back):
    """Four chunks of 15 rows ([0, 10, 5]): queries over [cached K/V | chunk] (Tk up to
    55 at look-back 4), the cache kept to the stride boundary and trimmed."""
    mod, jcfg, params = _sanm_pair(64, 64, 4)
    jcache = {"k": jnp.zeros((1, 4, 0, 16)), "v": jnp.zeros((1, 4, 0, 16))}
    pcache = None
    for _ in range(4):
        x = rng.standard_normal((1, 15, 64)).astype(np.float32)
        want, jcache = jattn.sanm_attention_apply_chunk(params, jcfg, jnp.asarray(x), jcache,
                                                        (0, 10, 5), look_back)
        tk = 15 + (0 if pcache is None or look_back == 0 else pcache["k"].shape[2])
        got, pcache = tattn.sanm_attention_apply_chunk(
            mod, t(x), pcache, torch.tensor([tk], dtype=torch.int32), (0, 10, 5), look_back)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATTN_TOL,
                                   rtol=0)
        if look_back:
            np.testing.assert_allclose(pcache["v"].detach().numpy(), np.asarray(jcache["v"]),
                                       atol=ATTN_TOL, rtol=0)
    assert pcache is None if look_back == 0 else pcache["k"].shape[2] == {
        1: 10, 4: 40, -1: 40}[look_back]


def test_cross_attention_chunk_and_fsmn_step_match_jax(rng):
    """The streaming decoder's cross-attention with a look-back of 1 chunk, and its FSMN
    step over concat(cache, x) with n valid rows of a padded bucket."""
    d, h = 64, 16
    cfg = tattn.CrossAttentionConfig(h, d, d)
    mod = init_weights(tattn.MultiHeadedAttentionCrossAtt(cfg), _gen(1))
    sd = SD(mod.state_dict())
    params = to_jax({name: sd.linear(name) for name in ("linear_q", "linear_k_v", "linear_out")})
    fcfg = tattn.FSMNDecoderConfig(d, 11, 5)
    fmod = init_weights(tattn.MultiHeadedAttentionSANMDecoder(fcfg), _gen(2))
    fparams = to_jax({"fsmn_block": SD(fmod.state_dict()).dwconv("fsmn_block")})
    jkv, pkv = None, None
    jfc, pfc = jnp.zeros((1, 10, d)), torch.zeros(1, 10, d)
    for n, tmax in ((4, 15), (0, 15), (16, 16)):
        x = rng.standard_normal((1, tmax, d)).astype(np.float32)
        mem = rng.standard_normal((1, 15, d)).astype(np.float32)
        want, jkv = jattn.cross_attention_apply_chunk(params, jattn.CrossAttentionConfig(h, d, d),
                                                      jnp.asarray(x), jnp.asarray(mem), jkv,
                                                      (0, 10, 5), 1)
        got, pkv = tattn.cross_attention_apply_chunk(mod, t(x), t(mem), pkv, (0, 10, 5), 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATTN_TOL,
                                   rtol=0)
        want, jfc = jattn.fsmn_decoder_apply_masked(fparams, jattn.FSMNDecoderConfig(d, 11, 5),
                                                    jnp.asarray(x), jfc, n)
        got, pfc = tattn.fsmn_decoder_apply_masked(fmod, t(x), pfc, n + torch.arange(10))
        np.testing.assert_allclose(got.detach().numpy()[:, :n], np.asarray(want)[:, :n],
                                   atol=FSMN_TOL, rtol=0)
        np.testing.assert_array_equal(pfc.numpy(), np.asarray(jfc))
    assert pkv["k"].shape[2] == 10


def test_cross_attention_and_decoder_fsmn_match_jax(rng):
    b, nq, nk, d, h = 2, 17, 40, 64, 16
    cfg = tattn.CrossAttentionConfig(h, d, d)
    mod = init_weights(tattn.MultiHeadedAttentionCrossAtt(cfg), _gen(1))
    sd = SD(mod.state_dict())
    params = to_jax({name: sd.linear(name) for name in ("linear_q", "linear_k_v", "linear_out")})
    x = rng.standard_normal((b, nq, d)).astype(np.float32)
    mem = rng.standard_normal((b, nk, d)).astype(np.float32)
    mmask = _mask([40, 25], nk)
    want = jattn.cross_attention_apply(params, jattn.CrossAttentionConfig(h, d, d),
                                       jnp.asarray(x), jnp.asarray(mem), jnp.asarray(mmask))
    got = tattn.cross_attention_apply(mod, t(x), t(mem), t(mmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATTN_TOL, rtol=0)

    fcfg = tattn.FSMNDecoderConfig(d)
    fmod = init_weights(tattn.MultiHeadedAttentionSANMDecoder(fcfg), _gen(2))
    fparams = to_jax({"fsmn_block": SD(fmod.state_dict()).dwconv("fsmn_block")})
    tmask = _mask([17, 9], nq)
    want = jattn.fsmn_decoder_apply(fparams, jattn.FSMNDecoderConfig(d), jnp.asarray(x),
                                    jnp.asarray(tmask))
    got = fmod(t(x), t(tmask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=FSMN_TOL, rtol=0)


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(4, 4, 384, 128), (2, 3, 77, 40), (32, 4, 384, 128),
                                   (1, 4, 1408, 128), (3, 4, 200, 64),
                                   (1, 8, 40, 32), (2, 8, 224, 32),  # ct-punc: 8 x 32
                                   (32, 4, 388, 128)])  # SenseVoice: 384 + 4 prompt rows
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, tol, shape):
    """Strided q|k|v head views, ragged lengths, a zero-length row (uniform average of V
    over all T keys, every row compared), T not a multiple of the tile (77), D = 32 (the
    punctuation encoder's heads; the next head's columns sit just above D in memory)."""
    b, h, n, d = shape
    g = _gen(3)
    qkv = torch.randn(b, n, 3, h, d, generator=g).to(cuda_device, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # strided head views
    lens = [n - 37 * (i % 2) for i in range(b)]
    if b > 1:
        lens[-1] = 0
    lens = torch.tensor(lens, device=cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_ref(q, k, v, lens)
    for i in range(b):
        n_i = int(lens[i]) or n
        torch.testing.assert_close(got[i, :, :n_i].float(), want[i, :, :n_i].float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,mode", [
    ((1, 4, 15, 55, 128), "none"),   # a streaming chunk over a full look-back of 4
    ((1, 4, 15, 15, 128), "none"),   # the first chunk
    ((1, 4, 15, 1005, 128), "none"),  # look-back -1, 100 chunks in
    ((2, 3, 70, 200, 64), "none"),   # Tq over one 64-row block, Tk over one key tile
    ((2, 8, 64, 64, 32), "causal"),  # the punctuation encoder's layers
    ((2, 8, 64, 64, 32), "corner"),  # and its last
    ((3, 4, 200, 200, 64), "causal"),
    ((4, 4, 130, 130, 64), "corner"),
])
def test_flash_kernel_key_cache_and_row_limits_on_card(cuda_device, dtype, tol, shape, mode):
    """Tq < Tk with its own K / V strides, and per-row key limits: every valid query row
    against the plain version; ragged lengths, vad positions 0, 1, mid, >= T."""
    b, h, tq, tk, d = shape
    g = _gen(6)
    q = torch.randn(b, tq, 3, h, d, generator=g).to(cuda_device, dtype)[:, :, 0].transpose(1, 2)
    kv = torch.randn(b, tk, 2, h, d, generator=g).to(cuda_device, dtype)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    lens = torch.tensor([tk - 17 * (i % 2) for i in range(b)], device=cuda_device)
    vad_pos = None
    if mode == "corner":
        vad_pos = torch.tensor([0, 1, tq // 2, tq + 3][:b] if b > 2 else [tq // 2, 1],
                               dtype=torch.int32, device=cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, lens, mode, vad_pos)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1 and got.shape == q.shape
    want = flash_attention_ref(q, k, v, lens, mode, vad_pos)
    for i in range(b):
        rows = min(tq, int(lens[i]))
        torch.testing.assert_close(got[i, :, :rows].float(), want[i, :, :rows].float(),
                                   atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t_len", [25, 26, 208])
def test_fsmn_kernel_streaming_step_on_card(cuda_device, dtype, tol, t_len):
    """The streaming decoder's step, k = 11 with pads (10, 0) over concat(cache, x), no
    mask: its own instantiation against the plain version and, bit for bit, the generic
    one."""
    g = _gen(7)
    x = torch.randn(1, t_len, 512, generator=g).to(cuda_device, dtype)
    w = (torch.rand(512, 1, 11, generator=g) - 0.5).to(cuda_device, dtype)
    got = fsmn_memory(x, w, None, 10, 0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), fsmn_memory_ref(x, w, None, 10, 0).float(),
                               atol=tol, rtol=tol)
    assert torch.equal(got, fsmn_memory(x, w, None, 10, 0, generic=True))


# (B, T, C, k, left, mask): "prefix" lengths (T, T - 17, 100, 1, ...), "random" a
# non-prefix bool mask, None no mask
FSMN_CARD_CASES = {
    "path": (4, 208, 512, 11, 5, "prefix"),        # the decoder's shape, the k = 11 kernel
    "asymmetric pads": (4, 208, 512, 11, 7, "prefix"),
    "no mask": (3, 384, 512, 11, 5, None),
    "non-prefix mask": (3, 150, 256, 11, 5, "random"),
    "T = 1": (2, 1, 512, 11, 5, None),
    "T not a multiple of the time tile": (4, 50, 64, 11, 5, "prefix"),
    "k = 1": (2, 97, 128, 1, 0, "prefix"),
    "k = 21": (2, 130, 512, 21, 10, "random"),
    # the VAD's causal memory over cache + one 60 s chunk, and the punctuation encoder's
    "VAD causal k = 20": (1, 6019, 128, 20, 19, None),
    "punc": (1, 64, 256, 11, 5, "prefix"),
    "SenseVoice": (32, 388, 512, 11, 5, "prefix"),  # a 15 s batch + the 4 prompt rows
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(FSMN_CARD_CASES))
def test_fsmn_kernel_matches_plain_on_card(cuda_device, dtype, tol, case):
    """x as the v slice of a q|k|v projection; prefix, non-prefix and no masks, any
    pads, ragged T, the generic-k kernel (k = 1, 21, or pads other than 5 / 5)."""
    b, n, c, k, left, mask_kind = FSMN_CARD_CASES[case]
    g = _gen(4)
    x = torch.randn(b, n, 3 * c, generator=g).to(cuda_device, dtype)[..., 2 * c:]
    w = (torch.rand(c, 1, k, generator=g) - 0.5).to(cuda_device, dtype)
    mask = None
    if mask_kind == "prefix":
        lens = torch.tensor([[n, n - 17, 100, 1][i % 4] for i in range(b)],
                            device=cuda_device).clamp(0, n)
        mask = torch.arange(n, device=cuda_device)[None] < lens[:, None]
    elif mask_kind == "random":
        mask = (torch.rand(b, n, generator=g) < 0.7).to(cuda_device)
    before = fsmn_memory.launches
    got = fsmn_memory(x, w, mask, left, k - 1 - left)
    torch.cuda.synchronize()
    assert fsmn_memory.launches == before + 1
    torch.testing.assert_close(got.float(),
                               fsmn_memory_ref(x, w, mask, left, k - 1 - left).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fsmn_kernel_refuses_unaligned_input_on_card(cuda_device, dtype):
    """The kernel moves 16-byte vectors: C not a multiple of the vector width, or a slice
    whose base is not 16-byte aligned, raises instead of launching."""
    g = _gen(5)
    w10 = torch.rand(10, 1, 11, generator=g).to(cuda_device, dtype)
    x10 = torch.randn(2, 40, 10, generator=g).to(cuda_device, dtype)  # C = 10
    w = torch.rand(64, 1, 11, generator=g).to(cuda_device, dtype)
    x = torch.randn(2, 40, 65, generator=g).to(cuda_device, dtype)[..., 1:]  # base + 1 elem
    before = fsmn_memory.launches
    for xs, ws in ((x10, w10), (x, w)):
        with pytest.raises(ValueError, match="16-byte"):
            fsmn_memory(xs, ws, None, 5, 5)
    assert fsmn_memory.launches == before
