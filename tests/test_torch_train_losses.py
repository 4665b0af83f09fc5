"""The port's training losses and feature transforms against the JAX package's, on the
same numpy inputs (fp32, CPU; tolerances 1e-5 relative unless a case says otherwise).

* ``label_smoothing_loss`` (both normalizations, smoothing 0 and 0.1), ``th_accuracy``,
  ``mae_token_loss``, ``cr_ctc_loss``;
* ``CTC.loss``: a copy of optax's recursion, so equal to ``optax.ctc_loss`` on a
  feasible batch and on an infeasible row (more labels than frames), where optax gives
  a large finite value and ``F.ctc_loss`` gives ``inf`` (both sides shown);
* ``SpecAug`` / ``SpecAugLFR`` with given mask positions against the JAX masking, and
  the draws' ranges; ``GlobalMVN`` (npy and npz stats) / ``UtteranceMVN``;
* ``maybe_dropout``: the rate, the 1 / (1 - rate) scaling, the identity in ``eval()``,
  at rate 0 and without a generator, and the SAN-M encoder's dropout only in ``train()``
  mode with a generator.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from funasr_tpu.losses.cr_ctc import cr_ctc_loss as jax_cr_ctc
from funasr_tpu.losses.label_smoothing_loss import label_smoothing_loss as jax_lsl
from funasr_tpu.losses.label_smoothing_loss import th_accuracy as jax_acc
from funasr_tpu.models.ctc.ctc import CTC as JaxCTC
from funasr_tpu.models.normalize.normalize import GlobalMVN as JaxGlobalMVN
from funasr_tpu.models.normalize.normalize import UtteranceMVN as JaxUtteranceMVN
from funasr_tpu.models.paraformer.cif_predictor import mae_token_loss as jax_mae
from funasr_tpu.models.specaug import specaug as jax_specaug
from funasr_tpu_torch.core.module import maybe_dropout
from funasr_tpu_torch.losses.cr_ctc import cr_ctc_loss
from funasr_tpu_torch.losses.label_smoothing_loss import label_smoothing_loss, th_accuracy
from funasr_tpu_torch.models.ctc.ctc import CTC
from funasr_tpu_torch.models.normalize.normalize import GlobalMVN, UtteranceMVN
from funasr_tpu_torch.models.paraformer.cif_predictor import mae_token_loss
from funasr_tpu_torch.models.specaug.specaug import SpecAug, SpecAugLFR, _apply_axis_mask

RTOL = 1e-5


def close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def logits_targets(seed=0, b=3, t=7, v=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    targets = rng.integers(0, v, (b, t)).astype(np.int64)
    targets[1, 4:] = -1
    targets[2, 1:] = -1
    return logits, targets


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_loss_matches_jax(smoothing, normalize_length):
    logits, targets = logits_targets()
    got = label_smoothing_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                               smoothing=smoothing, normalize_length=normalize_length)
    want = jax_lsl(jnp.asarray(logits), jnp.asarray(targets), smoothing=smoothing,
                   normalize_length=normalize_length)
    close(got, want)


def test_th_accuracy_matches_jax():
    logits, targets = logits_targets(1)
    targets[0, :3] = logits[0, :3].argmax(-1)
    got = th_accuracy(torch.from_numpy(logits), torch.from_numpy(targets))
    close(got, jax_acc(jnp.asarray(logits), jnp.asarray(targets)))
    assert float(got) > 0


@pytest.mark.parametrize("normalize_length", [False, True])
def test_mae_token_loss_matches_jax(normalize_length):
    tok = np.array([5, 9, 2], np.int32)
    pred = np.array([4.5, 9.25, 0.0], np.float32)
    close(mae_token_loss(torch.from_numpy(tok), torch.from_numpy(pred), normalize_length),
          jax_mae(jnp.asarray(tok), jnp.asarray(pred), normalize_length))


def ctc_batch(seed=0, b=3, t=12, v=9, n=5):
    rng = np.random.default_rng(seed)
    hs = rng.standard_normal((b, t, 16)).astype(np.float32)
    hlens = np.array([12, 9, 4], np.int32)
    ys = rng.integers(1, v, (b, n)).astype(np.int32)
    ys[0, 2] = ys[0, 1]  # a repeated label
    ylens = np.array([5, 3, 2], np.int32)
    ys[1, 3:] = -1
    ys[2, 2:] = -1
    return hs, hlens, ys, ylens


def ctc_pair(v=9):
    port = CTC(odim=v, encoder_output_size=16)
    jm = JaxCTC(odim=v, encoder_output_size=16)
    params = {"ctc_lo": {"w": jnp.asarray(port.ctc_lo.weight.detach().numpy().T),
                         "b": jnp.asarray(port.ctc_lo.bias.detach().numpy())}}
    return port, jm, params


def test_ctc_loss_matches_optax_on_a_feasible_batch():
    port, jm, params = ctc_pair()
    hs, hlens, ys, ylens = ctc_batch()
    got = port.loss(torch.from_numpy(hs), torch.from_numpy(hlens).long(),
                    torch.from_numpy(ys).long(), torch.from_numpy(ylens).long())
    want = jm.loss(params, jnp.asarray(hs), jnp.asarray(hlens), jnp.asarray(ys),
                   jnp.asarray(ylens))
    close(got, want)
    # feasible rows: torch's own CTC gives the same per-sequence NLL
    logp = torch.log_softmax(port.logits(torch.from_numpy(hs)).float(), -1)
    ys_t = torch.from_numpy(np.where(ys < 0, 0, ys)).long()
    ref = torch.nn.functional.ctc_loss(logp.transpose(0, 1), ys_t, torch.from_numpy(hlens).long(),
                                       torch.from_numpy(ylens).long(), reduction="none")
    close(ref.mean(), want, rtol=1e-4)


def test_ctc_loss_on_an_infeasible_row_is_optax_value_not_inf():
    """Row 2 has 4 frames and 4 labels with a repeat (5 frames needed): optax's
    log_epsilon gives a large finite NLL with finite gradients, the port the same;
    ``F.ctc_loss`` gives inf."""
    port, jm, params = ctc_pair()
    hs, hlens, ys, ylens = ctc_batch(1)
    ys[2, :4] = [3, 3, 4, 5]
    ylens[2] = 4
    got = port.loss(torch.from_numpy(hs).requires_grad_(), torch.from_numpy(hlens).long(),
                    torch.from_numpy(ys).long(), torch.from_numpy(ylens).long())
    want = jm.loss(params, jnp.asarray(hs), jnp.asarray(hlens), jnp.asarray(ys),
                   jnp.asarray(ylens))
    assert np.isfinite(float(want)) and float(want) > 1e4
    close(got, want)
    got.backward()
    assert all(torch.isfinite(p.grad).all() for p in port.parameters())
    logp = torch.log_softmax(port.logits(torch.from_numpy(hs)).float(), -1)
    ref = torch.nn.functional.ctc_loss(logp.transpose(0, 1), torch.from_numpy(ys).clamp_min(0).long(),
                                       torch.from_numpy(hlens).long(),
                                       torch.from_numpy(ylens).long(), reduction="none")
    assert torch.isinf(ref[2]) and torch.isfinite(ref[:2]).all()


def test_cr_ctc_loss_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 10, 7)).astype(np.float32)
    b = a + 0.3 * rng.standard_normal((2, 10, 7)).astype(np.float32)
    lens = np.array([10, 6], np.int32)
    labels = np.array([[1, 2, 3], [4, 4, 0]], np.int32)
    llens = np.array([3, 2], np.int32)
    got = cr_ctc_loss(*(torch.from_numpy(x) for x in (a, b, lens, labels, llens)))
    want = jax_cr_ctc(*(jnp.asarray(x) for x in (a, b, lens, labels, llens)))
    close(got, want)


@pytest.mark.parametrize("axis", [1, 2])
def test_apply_axis_mask_matches_jax(axis):
    rng = np.random.default_rng(3)
    spec = rng.standard_normal((2, 30, 24)).astype(np.float32)
    pos = np.array([[3, 17], [0, 20]], np.int64)
    lengths = np.array([[4, 0], [2, 9]], np.int64)
    got = _apply_axis_mask(torch.from_numpy(spec), torch.from_numpy(pos),
                           torch.from_numpy(lengths), axis)
    want = jax_specaug._apply_axis_mask(jnp.asarray(spec), jnp.asarray(pos),
                                        jnp.asarray(lengths), axis)
    close(got, want, rtol=0, atol=0)


def jax_specaug_with(aug, spec, freq, time):
    """The JAX ``SpecAug.__call__`` body with given (pos, lengths) in place of its draws."""
    b, _, d = spec.shape
    pos, lengths = (jnp.asarray(x) for x in freq)
    if aug.lfr_rate > 1:
        offs = jnp.arange(aug.lfr_rate) * (d // aug.lfr_rate)
        pos = (pos[:, None, :] + offs[None, :, None]).reshape(b, -1)
        lengths = jnp.tile(lengths, (1, aug.lfr_rate))
    spec = jax_specaug._apply_axis_mask(spec, pos, lengths, axis=2)
    return jax_specaug._apply_axis_mask(spec, *(jnp.asarray(x) for x in time), axis=1)


@pytest.mark.parametrize("cls,lfr_rate", [("SpecAug", 0), ("SpecAugLFR", 6)])
def test_specaug_masks_match_jax(cls, lfr_rate):
    conf = dict(apply_time_warp=True, freq_mask_width_range=[0, 30], num_freq_mask=1,
                time_mask_width_range=[0, 12], num_time_mask=1, lfr_rate=lfr_rate)
    port = {"SpecAug": SpecAug, "SpecAugLFR": SpecAugLFR}[cls](**conf)
    jm = getattr(jax_specaug, cls)(**conf)
    assert port.lfr_rate == jm.lfr_rate
    rng = np.random.default_rng(4)
    spec = rng.standard_normal((2, 50, 560)).astype(np.float32)
    freq = (np.array([[5], [40]]), np.array([[20], [7]]))
    time = (np.array([[10], [0]]), np.array([[11], [3]]))
    got = port.apply(torch.from_numpy(spec), {
        "freq": tuple(torch.from_numpy(x) for x in freq),
        "time": tuple(torch.from_numpy(x) for x in time)})
    want = jax_specaug_with(jm, jnp.asarray(spec), freq, time)
    close(got, want, rtol=0, atol=0)
    zero_cols = (got[0] == 0).all(dim=0).sum().item()
    assert zero_cols == 20 * jm.lfr_rate


def test_specaug_draws_in_range_and_time_warp_ignored():
    aug = SpecAugLFR(apply_time_warp=True, freq_mask_width_range=[0, 30], num_freq_mask=2,
                     time_mask_width_range=[0, 12], num_time_mask=2, lfr_rate=6)
    masks = aug.draw(64, 100, 560, torch.Generator().manual_seed(0))
    fpos, flen = masks["freq"]
    tpos, tlen = masks["time"]
    assert fpos.shape == (64, 2) and 0 <= fpos.min() and fpos.max() < 80 - 30
    assert 0 <= flen.min() and flen.max() < 30 and tlen.max() < 12 and tpos.max() < 100 - 12
    spec = torch.randn(64, 100, 560)
    out, lens = aug(spec, torch.full((64,), 100), torch.Generator().manual_seed(0))
    assert out.shape == spec.shape and ((out == 0) | (out == spec)).all()


@pytest.mark.parametrize("fmt", ["npy", "npz"])
def test_global_mvn_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    if fmt == "npy":
        stats = np.zeros((2, 9))
        stats[0, :-1] = rng.standard_normal(8) * 50
        stats[1, :-1] = rng.random(8) * 500 + 400
        stats[0, -1] = 100
        path = tmp_path / "stats.npy"
        np.save(path, stats)
    else:
        path = tmp_path / "stats.npz"
        np.savez(path, mean=rng.standard_normal(8), var=rng.random(8) + 0.5)
    got, _ = GlobalMVN(str(path))(torch.from_numpy(x), torch.tensor([6, 4]))
    want, _ = JaxGlobalMVN(str(path))(jnp.asarray(x), jnp.asarray([6, 4]))
    close(got, want)


@pytest.mark.parametrize("norm_vars", [False, True])
def test_utterance_mvn_matches_jax(norm_vars):
    x = np.random.default_rng(6).standard_normal((2, 6, 8)).astype(np.float32)
    lens = np.array([6, 4], np.int32)
    got, _ = UtteranceMVN(norm_vars=norm_vars)(torch.from_numpy(x), torch.from_numpy(lens))
    want, _ = JaxUtteranceMVN(norm_vars=norm_vars)(jnp.asarray(x), jnp.asarray(lens))
    close(got, want)


def test_dropout_rate_scaling_and_identity():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = maybe_dropout(x, 0.1, True, g)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.9))
    assert maybe_dropout(x, 0.1, False, g) is x
    assert maybe_dropout(x, 0.0, True, g) is x
    assert maybe_dropout(x, 0.1, True, None) is x  # no generator, no key: the identity
    y2 = maybe_dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)


def test_encoder_dropout_only_in_train_mode():
    from funasr_tpu_torch.models.sanm.encoder import SANMEncoder
    enc = SANMEncoder(input_size=16, output_size=16, attention_heads=2, linear_units=32,
                      num_blocks=2, dropout_rate=0.5)
    x = torch.randn(2, 9, 16)
    lens = torch.tensor([9, 5])
    enc.eval()
    a, _ = enc(x, lens)
    b, _ = enc(x, lens, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    enc.train()
    assert torch.equal(enc(x, lens)[0], a)  # train() mode without a generator: none
    c, _ = enc(x, lens, generator=torch.Generator().manual_seed(1))
    d, _ = enc(x, lens, generator=torch.Generator().manual_seed(1))
    assert torch.equal(c, d) and not torch.allclose(a, c)
