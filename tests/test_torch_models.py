"""The port's ASR models (``tpufeat_torch.models``: encoders, the CTC and
RNN-T steps, the decoders, the error rate) against ``tpufeat.models`` on
the CPU, with the reference's parameters carried across by
``models.convert.state_dict_from_flax``, and against the float64 goldens
of ``tpufeat_torch.reference.cpu``; the reference's own checks of
``tests/test_models.py`` mirrored; and the data-parallel steps
(``dryrun_train_step`` as an 8-rank gloo group on the CPU) against the
reference's CTC and RNN-T steps on the whole batch.

Tolerances:
- encoder, joint and head outputs at d=32: atol 1e-5 (the two
  frameworks' sums in another order; measured under 2e-6); ``asr_forward``
  from audio on the plain route 1e-4 of the logits' scale (the front-ends'
  float32 rounding, 1e-5 scaled, through the encoder), the fused route
  against the plain one the same;
- losses rtol 1e-5 (the reference's against its golden); gradients 1e-4
  of each tensor's largest entry; the RNN-T gradient against finite
  differences atol 2e-3 (the reference's);
- AdamW against ``optax.adamw``: atol 1e-6 after three steps;
- the dp steps: the all-reduced loss rtol 1e-5 (the sums over the ranks
  reassociated), the parameters after one step atol 1e-6 (one AdamW step
  at lr 1e-4 moves a parameter by about 1e-4, its direction set by the
  gradient, which agrees to 1e-4 of each tensor's scale);
- decoders, alignments and error rates: equal.
"""

import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpufeat import features as jfeatures
from tpufeat.config import WHISPER80 as JWHISPER80
from tpufeat.models import encoder as jenc
from tpufeat.models import train as jtrain

from tpufeat_torch import features
from tpufeat_torch.config import WHISPER80
from tpufeat_torch.models import convert
from tpufeat_torch.models import encoder as enc
from tpufeat_torch.models import train
from tpufeat_torch.reference import cpu

from conftest import make_signal
from tpufeat_torch.multichip import spawn

CPU = "cpu"
ATOL = 1e-5
PLAIN = dataclasses.replace(WHISPER80, use_pallas=False)
JPLAIN = dataclasses.replace(JWHISPER80, use_pallas=False)
FUSED = dataclasses.replace(WHISPER80, use_pallas=True, gemm_dft=True,
                            fused_framing=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried(params, model):
    model.load_state_dict(convert.state_dict_from_flax(_np(params), model))
    return model


def _t(a):
    return torch.from_numpy(np.array(a))


def _mel(B=2, T=37, D=80, seed=0, cut=25):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.ones((B, T), bool)
    mask[-1, cut:] = False
    return mel, mask


def _encoders(arch, in_dim=80, **kw):
    if arch == "whisper":
        return (jenc.WhisperEncoder(**kw),
                enc.WhisperEncoder(in_dim=in_dim, device=CPU, **kw))
    return (jenc.ConformerEncoder(**kw),
            enc.ConformerEncoder(in_dim=in_dim, device=CPU, **kw))


def _grad_gap(jgrads, model) -> float:
    """Largest gap of the port's .grad to the reference's gradients, each
    tensor scaled by its largest entry."""
    want = convert.state_dict_from_flax(_np(jgrads), model)
    gap = 0.0
    for name, p in model.named_parameters():
        w = want[name]
        gap = max(gap, float((p.grad - w).abs().max())
                  / max(float(w.abs().max()), 1e-12))
    return gap


class TestEncoders:
    @pytest.mark.parametrize("arch", ["whisper", "conformer"])
    def test_shapes(self, arch):
        mel = torch.randn(2, 100, 80)
        _, model = _encoders(arch, dim=64, layers=2, heads=2)
        out, m2 = model(mel, torch.ones(2, 100, dtype=torch.bool))
        assert out.shape == (2, 50, 64) and m2.shape == (2, 50)

    @pytest.mark.parametrize("arch,T", [("whisper", 37), ("whisper", 40),
                                        ("conformer", 37),
                                        ("conformer", 40)])
    def test_matches_reference(self, arch, T):
        """Ragged masks, odd and even T (the stride-2 conv's and the
        pad-reshape subsampling's edges)."""
        mel, mask = _mel(T=T)
        jm, model = _encoders(arch, dim=32, layers=1, heads=2)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), mel, mask)
        want, wmask = jax.jit(jm.apply)(params, mel, mask)
        got, gmask = _carried(params, model)(_t(mel), _t(mask))
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=ATOL)

    @pytest.mark.parametrize("arch", ["whisper", "conformer"])
    def test_mask_invariance(self, arch):
        """Padding frames never change the outputs."""
        mel, mask = _mel(B=1, T=64, cut=40, seed=1)
        _, model = _encoders(arch, dim=32, layers=1, heads=2)
        with torch.no_grad():
            a, _ = model(_t(mel), _t(mask))
            mel[:, 40:] = 123.0
            b, _ = model(_t(mel), _t(mask))
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)

    def test_sinusoids(self):
        s = enc.sinusoids(10, 8)
        np.testing.assert_array_equal(s, jenc.sinusoids(10, 8))
        np.testing.assert_allclose(s[0], [0, 0, 0, 0, 1, 1, 1, 1], atol=1e-7)

    def test_flax_defaults(self):
        """LayerNorm epsilon, the tanh GELU, lecun-normal kernels (variance
        1/fan_in, truncated at two deviations) and zero biases."""
        assert enc.layer_norm(8).eps == 1e-6
        x = np.linspace(-4, 4, 101, dtype=np.float32)
        np.testing.assert_allclose(enc.gelu(_t(x)).numpy(),
                                   np.asarray(jax.nn.gelu(x)), atol=1e-6)
        torch.manual_seed(0)
        lin = enc.dense(400, 300)
        w = lin.weight.detach().numpy()
        assert abs(w.std() * np.sqrt(400) - 1) < 0.02
        assert np.abs(w).max() <= 2 / np.sqrt(400) / 0.8796256610342398
        assert not lin.bias.detach().any()
        dw = enc.conv(8, 16, 5, groups=8).weight
        assert abs(dw.std().item() * np.sqrt(5) - 1) < 0.2

    @pytest.mark.parametrize("width,stride,padding,dilation,groups", [
        (3, 1, 1, 1, 1), (3, 2, 1, 1, 1), (15, 1, "SAME", 1, 8),
        (5, 1, "SAME", 1, 1), (3, 1, "SAME", 2, 1), (3, 1, "SAME", 3, 1),
        (1, 1, "SAME", 1, 1), (4, 1, "SAME", 1, 1)])
    def test_conv_matches_flax(self, width, stride, padding, dilation,
                               groups):
        """Every padding the models use (int, SAME; strided, dilated,
        depthwise; an even width's lopsided SAME) maps onto torch's."""
        import flax.linen as fnn
        x = np.random.default_rng(width).standard_normal(
            (2, 21, 8)).astype(np.float32)
        jc = fnn.Conv(8, (width,), strides=(stride,), padding=padding,
                      kernel_dilation=(dilation,), feature_group_count=groups)
        params = jc.init(jax.random.PRNGKey(0), x)
        tc = enc.conv(8, 8, width, stride=stride,
                      padding="same" if padding == "SAME" else padding,
                      dilation=dilation, groups=groups)
        tc.load_state_dict(convert.state_dict_from_flax(_np(params), tc))
        got = tc(_t(x).transpose(1, 2)).transpose(1, 2)
        np.testing.assert_allclose(got.detach().numpy(),
                                   np.asarray(jc.apply(params, x)),
                                   rtol=0, atol=ATOL)

    def test_convert_refuses_what_it_cannot_place(self):
        mel, mask = _mel()
        jm, model = _encoders("whisper", dim=16, layers=1, heads=2)
        params = _np(jm.init(jax.random.PRNGKey(0), mel, mask))["params"]
        extra = dict(params, Conv_0=dict(params["Conv_0"], scale=np.ones(16)))
        with pytest.raises(ValueError, match="no counterpart"):
            convert.state_dict_from_flax(extra, model)
        short = {k: v for k, v in params.items() if k != "LayerNorm_0"}
        with pytest.raises(ValueError, match="lack"):
            convert.state_dict_from_flax(short, model)
        bad = dict(params, Conv_0=dict(params["Conv_0"],
                                       bias=np.ones(17, np.float32)))
        with pytest.raises(ValueError, match="shape"):
            convert.state_dict_from_flax(bad, model)


def _audio(B=2, n=8000, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n)) * 0.1).astype(np.float32)


class TestCtc:
    @staticmethod
    def _case(seed=0, B=3, T=12, V=6):
        r = np.random.default_rng(seed)
        logits = r.standard_normal((B, T, V)).astype(np.float32) * 2
        mask = np.ones((B, T), bool)
        mask[1, 9:] = False
        labels = np.array([[1, 1, 2, 3], [4, 2, 2, 0], [5, 0, 0, 0]],
                          np.int32)[:B]
        llen = np.array([4, 3, 1])[:B]
        return logits, mask, labels, llen

    def test_loss_matches_optax_and_golden(self):
        logits, mask, labels, llen = self._case()
        got = train.ctc_loss(_t(logits), _t(mask), labels, llen).numpy()
        label_pad = (np.arange(labels.shape[1])[None] >= llen[:, None])
        want = np.asarray(optax.ctc_loss(logits, 1.0 - mask, labels,
                                         label_pad.astype(np.float32)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        lp = np.asarray(jax.nn.log_softmax(logits.astype(np.float64)))
        for b in range(len(got)):
            gold = -cpu.ctc_sequence_logp(lp[b, : mask[b].sum()],
                                          labels[b, : llen[b]])
            np.testing.assert_allclose(got[b], gold, rtol=1e-5)

    def test_infeasible_sequence_gives_zero(self):
        """More labels (with a repeat) than frames: no alignment; 0 and no
        gradient, the others' losses unchanged."""
        logits, mask, labels, llen = self._case()
        mask = mask.copy()
        mask[2, 1:] = False                        # one frame
        labels = labels.copy()
        labels[2, :2] = [5, 5]
        llen = np.array([4, 3, 2])
        x = _t(logits).requires_grad_()
        loss = train.ctc_loss(x, _t(mask), labels, llen)
        assert loss[2].item() == 0.0 and torch.isfinite(loss).all()
        loss.sum().backward()
        assert not x.grad[2].any() and x.grad[0].any()


class TestTrainStep:
    def test_adamw_matches_optax(self):
        r = np.random.default_rng(3)
        p0 = r.standard_normal((5, 4)).astype(np.float32)
        grads = [r.standard_normal((5, 4)).astype(np.float32)
                 for _ in range(3)]
        tx = optax.adamw(3e-3)
        jp = jnp.asarray(p0)
        st = tx.init(jp)
        for g in grads:
            upd, st = tx.update(jnp.asarray(g), st, jp)
            jp = optax.apply_updates(jp, upd)
        lin = torch.nn.Linear(4, 5, bias=False)
        with torch.no_grad():
            lin.weight.copy_(_t(p0))
        opt = train.adamw(lin, 3e-3)
        for g in grads:
            lin.weight.grad = _t(g).clone()
            opt.step()
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(jp), rtol=0, atol=1e-6)

    def test_loss_and_gradients_match_reference(self):
        """One CTC step's loss and every parameter's gradient, from audio
        through the front-end, against the reference's value_and_grad."""
        jm = jtrain.make_models(dim=16, layers=1, heads=2, vocab=8)
        audio = _audio(n=4000)
        lengths = np.array([4000, 3100])
        labels = np.array([[1, 2, 3, 4, 5], [6, 7, 1, 0, 0]], np.int32)
        llen = np.array([5, 3])
        res = jfeatures.extract_impl(jnp.asarray(audio), jnp.asarray(lengths),
                                     JPLAIN)
        params = jm.init(jax.random.PRNGKey(0), res.features, res.mask)

        def loss_fn(p):
            logits, mask = jtrain.asr_forward(p, jm, jnp.asarray(audio),
                                              jnp.asarray(lengths), JPLAIN)
            label_pad = (jnp.arange(5)[None] >= llen[:, None])
            return jnp.mean(optax.ctc_loss(logits, 1.0 - mask, labels,
                                           label_pad.astype(jnp.float32)))

        want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
        model = _carried(params, train.make_models(
            dim=16, layers=1, heads=2, vocab=8, device=CPU))
        state = train.TrainState(model, train.adamw(model, 0.0))
        state, loss = train.ctc_train_step(state, audio, lengths, labels,
                                           llen, cfg=PLAIN)
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
        assert _grad_gap(jgrads, model) < 1e-4 and state.step == 1

    def test_loss_decreases(self):
        model = train.make_models(dim=32, layers=1, heads=2, vocab=12,
                                  device=CPU)
        state = train.TrainState(model, train.adamw(model, 3e-3))
        rng = np.random.default_rng(2)
        audio = _audio()
        labels = rng.integers(1, 12, (2, 5))
        losses = [train.ctc_train_step(state, audio, None, labels,
                                       [5, 5], cfg=PLAIN)[1].item()
                  for _ in range(5)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
        assert state.step == 5

    def test_checkpoint_roundtrip(self, tmp_path):
        """Saved and restored: the same parameters, optimizer moments and
        step, so the next step is the same."""
        audio, labels = _audio(n=4000), np.array([[1, 2], [3, 3]])

        def fresh(seed):
            torch.manual_seed(seed)
            m = train.make_models(dim=16, layers=1, heads=2, vocab=8,
                                  device=CPU)
            return train.TrainState(m, train.adamw(m, 1e-3))

        state = fresh(0)
        train.ctc_train_step(state, audio, None, labels, [2, 2], cfg=PLAIN)
        path = str(tmp_path / "ckpt.pt")
        train.save_train_state(path, state)
        back = train.load_train_state(path, fresh(1))
        assert back.step == 1
        for a, b in zip(state.model.state_dict().values(),
                        back.model.state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        _, la = train.ctc_train_step(state, audio, None, labels, [2, 2],
                                     cfg=PLAIN)
        _, lb = train.ctc_train_step(back, audio, None, labels, [2, 2],
                                     cfg=PLAIN)
        assert la.item() == lb.item()
        for a, b in zip(state.model.parameters(), back.model.parameters()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    @pytest.mark.parametrize("arch", ["whisper", "conformer"])
    def test_asr_forward_from_audio(self, arch):
        """Raw audio -> logits against the reference's ``asr_forward`` on
        the plain route; the fused route (the signal kernel's twin here)
        against the plain one."""
        jm = jtrain.make_models(dim=32, layers=1, heads=2, vocab=12,
                                arch=arch)
        sig = make_signal(8000, seed=3)
        audio = np.stack([sig, np.roll(sig, 1234)])
        lengths = np.array([8000, 6000])
        res = jfeatures.extract_impl(jnp.asarray(audio), jnp.asarray(lengths),
                                     JPLAIN)
        params = jm.init(jax.random.PRNGKey(0), res.features, res.mask)
        want, wmask = jax.jit(functools.partial(
            jtrain.asr_forward, model=jm, cfg=JPLAIN))(
            params, audio=jnp.asarray(audio), lengths=jnp.asarray(lengths))
        model = _carried(params, train.make_models(
            dim=32, layers=1, heads=2, vocab=12, arch=arch, device=CPU))
        with torch.no_grad():
            got, gmask = train.asr_forward(model, audio, lengths, PLAIN)
            fused, _ = train.asr_forward(model, audio, lengths, FUSED)
        want = np.asarray(want)
        scale = max(1.0, np.abs(want).max())
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
        assert np.abs(got.numpy() - want).max() / scale < 1e-4
        assert (fused - got).abs().max().item() / scale < 1e-4
        assert got.shape[0] == 2 and got.shape[2] == 12


class TestDecode:
    def test_greedy_ctc_collapse(self):
        path = [1, 1, 0, 2, 2, 3]
        logits = np.full((1, len(path), 4), -10.0, np.float32)
        for t, k in enumerate(path):
            logits[0, t, k] = 10.0
        out = train.greedy_ctc_decode(_t(logits),
                                      torch.ones(1, len(path), dtype=bool))
        assert out == [[1, 2, 3]]

    def test_greedy_respects_mask(self):
        logits = np.full((1, 4, 4), -10.0, np.float32)
        logits[0, :, 1] = 10.0
        out = train.greedy_ctc_decode(logits, np.array([[1, 1, 0, 0]], bool))
        assert out == [[1]]

    def test_greedy_matches_reference(self):
        r = np.random.default_rng(5)
        logits = r.standard_normal((4, 30, 5)).astype(np.float32)
        mask = np.arange(30)[None] < np.array([30, 17, 1, 0])[:, None]
        assert train.greedy_ctc_decode(_t(logits), _t(mask)) == \
            jtrain.greedy_ctc_decode(jnp.asarray(logits), jnp.asarray(mask))


class TestErrorRate:
    def test_edit_distance_cases(self):
        ed = train.edit_distance
        assert ed([], []) == 0
        assert ed([1, 2, 3], [1, 2, 3]) == 0
        assert ed([1, 2, 3], []) == 3
        assert ed([], [7]) == 1
        assert ed([1, 2, 3], [1, 9, 3]) == 1
        assert ed([1, 2, 3], [1, 3]) == 1
        assert ed([1, 3], [1, 2, 3]) == 1
        assert ed("kitten", "sitting") == 3

    def test_edit_distance_matches_brute_force(self):
        rng = np.random.default_rng(4)
        for _ in range(25):
            a = rng.integers(0, 4, rng.integers(0, 7)).tolist()
            b = rng.integers(0, 4, rng.integers(0, 7)).tolist()

            @functools.lru_cache(maxsize=None)
            def f(i, j):
                if i == 0:
                    return j
                if j == 0:
                    return i
                return min(f(i - 1, j) + 1, f(i, j - 1) + 1,
                           f(i - 1, j - 1) + (a[i - 1] != b[j - 1]))
            assert train.edit_distance(a, b) == f(len(a), len(b))

    def test_token_error_rate(self):
        out = train.token_error_rate([[1, 2, 3], [4]], [[1, 3], [4]])
        assert out == {"ter": 0.25, "errors": 1, "sub": 0, "ins": 0,
                       "del": 1, "ref_tokens": 4, "utterances": 2}
        assert train.token_error_rate([[]], [[1]])["ter"] == float("inf")
        assert train.token_error_rate([], [])["ter"] == 0.0
        with pytest.raises(ValueError):
            train.token_error_rate([[1]], [])

    def test_edit_alignment_breakdown(self):
        assert train.edit_alignment("kitten", "sitting") == (2, 1, 0)
        assert train.edit_alignment([1, 2], [1, 2]) == (0, 0, 0)
        assert train.edit_alignment([1, 2], []) == (0, 0, 2)
        assert train.edit_alignment([], [9, 9]) == (0, 2, 0)
        rng = np.random.default_rng(6)
        for _ in range(25):
            a = rng.integers(0, 3, rng.integers(0, 8)).tolist()
            b = rng.integers(0, 3, rng.integers(0, 8)).tolist()
            assert sum(train.edit_alignment(a, b)) == \
                train.edit_distance(a, b)

    def test_matches_reference(self):
        rng = np.random.default_rng(7)
        refs = [rng.integers(0, 4, rng.integers(0, 9)).tolist()
                for _ in range(20)]
        hyps = [rng.integers(0, 4, rng.integers(0, 9)).tolist()
                for _ in range(20)]
        for r, h in zip(refs, hyps):
            assert train.edit_alignment(r, h) == jtrain.edit_alignment(r, h)
        assert train.token_error_rate(refs, hyps) == \
            jtrain.token_error_rate(refs, hyps)

    def test_end_to_end_with_decode(self):
        logits = np.full((1, 6, 5), -10.0, np.float32)
        for t, tok in enumerate([1, 1, 0, 2, 3, 3]):
            logits[0, t, tok] = 10.0
        hyp = train.greedy_ctc_decode(logits, np.ones((1, 6), bool))
        assert train.token_error_rate([[1, 2, 3]], hyp)["ter"] == 0.0


class TestTransducerLoss:
    @staticmethod
    def _case(seed, B=3, T=4, U=2, V=5):
        r = np.random.default_rng(seed)
        logits = r.standard_normal((B, T, U + 1, V)).astype(np.float32)
        labels = r.integers(1, V, (B, U)).astype(np.int32)
        return (logits, labels, np.array([T, T - 1, T])[:B],
                np.array([U, U, U - 1])[:B])

    def test_matches_golden_and_reference(self):
        logits, labels, tlen, llen = self._case(0)
        got = train.transducer_loss(_t(logits), tlen, labels, llen).numpy()
        lp = np.asarray(jax.nn.log_softmax(logits.astype(np.float64)))
        for b in range(3):
            want = cpu.transducer_loss(lp[b], labels[b], int(tlen[b]),
                                       int(llen[b]))
            np.testing.assert_allclose(got[b], want, rtol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(jtrain.transducer_loss(logits, tlen, labels,
                                                   llen)), rtol=1e-5)
        with pytest.raises(ValueError, match="labels"):
            train.transducer_loss(_t(logits), tlen, labels[:, :1], llen)

    def test_longer_grid_matches_reference(self):
        """T=9, U=5 with ragged lengths: more diagonals than either side."""
        logits, labels, _, _ = self._case(5, B=3, T=9, U=5, V=7)
        tlen, llen = np.array([9, 4, 7]), np.array([5, 2, 0])
        got = train.transducer_loss(_t(logits), tlen, labels, llen).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jtrain.transducer_loss(logits, tlen, labels,
                                                   llen)), rtol=1e-5)

    def test_padding_invariance(self):
        logits, labels, tlen, llen = self._case(1)
        base = train.transducer_loss(_t(logits), tlen, labels, llen)
        r = np.random.default_rng(2)
        padded = np.concatenate(
            [logits, r.standard_normal((3, 2, 3, 5)).astype(np.float32)],
            axis=1)
        np.testing.assert_allclose(
            train.transducer_loss(_t(padded), tlen, labels, llen).numpy(),
            base.numpy(), rtol=1e-5)

    def test_gradients_match_finite_differences(self):
        logits, labels, tlen, llen = self._case(3, B=2)
        tlen, llen, labels = tlen[:2], llen[:2], labels[:2]

        def f(lg):
            return train.transducer_loss(lg, tlen, labels, llen).sum()

        x = _t(logits).requires_grad_()
        f(x).backward()
        eps = 1e-3
        r = np.random.default_rng(4)
        for _ in range(6):
            ix = tuple(int(r.integers(0, s)) for s in logits.shape)
            lp, lm = logits.copy(), logits.copy()
            lp[ix] += eps
            lm[ix] -= eps
            fd = (f(_t(lp)).item() - f(_t(lm)).item()) / (2 * eps)
            np.testing.assert_allclose(x.grad[ix].item(), fd, atol=2e-3)

    def test_greedy_decode_roundtrip(self):
        V, T, ref = 6, 4, [2, 5, 1]

        def joint(frame, history):
            v = np.full(V, -10.0)
            if len(history) < len(ref) and len(history) <= int(frame[0]):
                v[ref[len(history)]] = 5.0
            v[0] = 0.0
            return v

        enc_out = np.arange(T, dtype=np.float32)[:, None]
        assert train.greedy_transducer_decode(joint, enc_out,
                                              np.ones(T, bool)) == ref


class TestTransducerTraining:
    def test_forward_loss_and_gradients_match_reference(self):
        cfg_kw = dict(dim=32, layers=1, heads=2, vocab=12, arch="whisper")
        audio = _audio(n=4000, seed=0)
        lengths = np.array([4000, 3000])
        labels = np.array([[3, 1, 7], [2, 2, 0]], np.int32)
        llen = np.array([3, 2])
        jm = jtrain.make_transducer(**cfg_kw)
        res = jfeatures.extract_impl(jnp.asarray(audio), jnp.asarray(lengths),
                                     JPLAIN)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), res.features,
                                  res.mask, labels)
        wlog, wmask = jax.jit(jm.apply)(params, res.features, res.mask,
                                        labels)

        def loss_fn(p):
            lg, m = jm.apply(p, res.features, res.mask, labels)
            return jnp.mean(jtrain.transducer_loss(
                lg, m.astype(jnp.int32).sum(-1), labels, llen))

        want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
        model = _carried(params, train.make_transducer(**cfg_kw, device=CPU))
        with torch.no_grad():
            r = features.extract(audio, lengths, PLAIN, device=CPU)
            glog, gmask = model(r.features, r.mask, labels)
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
        np.testing.assert_allclose(glog.numpy(), np.asarray(wlog), rtol=0,
                                   atol=1e-4)
        state = train.TrainState(model, train.adamw(model, 0.0))
        _, loss = train.transducer_train_step(state, audio, lengths, labels,
                                              llen, cfg=PLAIN)
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
        assert _grad_gap(jgrads, model) < 1e-4

    def test_loss_decreases(self):
        r = np.random.default_rng(0)
        model = train.make_transducer(dim=32, layers=1, heads=2, vocab=12,
                                      arch="whisper", device=CPU)
        state = train.TrainState(model, train.adamw(model, 3e-3))
        audio = _audio(n=4000, seed=0)
        labels = r.integers(1, 12, (2, 3))
        losses = [train.transducer_train_step(
            state, audio, None, labels, [3, 3], cfg=PLAIN)[1].item()
            for _ in range(8)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


class TestBeamTransducerDecode:
    @staticmethod
    def _joint_table(T, U_max, V, seed):
        r = np.random.default_rng(seed)
        table = r.standard_normal((T, U_max + 1, V)) * 2.0
        table[:, U_max, 0] += 12.0

        def joint(frame, history):
            return table[int(frame[0]), min(len(history), U_max)]

        return joint

    @staticmethod
    def _exhaustive_best(joint, enc_out, T, V, max_u, blank=0):
        def seq_logp(lab):
            U = len(lab)

            @functools.lru_cache(maxsize=None)
            def p(t, u):
                logits = np.asarray(joint(enc_out[t], list(lab[:u])),
                                    np.float64)
                lp = logits - np.logaddexp.reduce(logits)
                if t == T - 1 and u == U:
                    return lp[blank]
                outs = []
                if t < T - 1:
                    outs.append(lp[blank] + p(t + 1, u))
                if u < U:
                    outs.append(lp[lab[u]] + p(t, u + 1))
                return np.logaddexp.reduce(np.asarray(outs))
            return p(0, 0)

        best, best_lp = (), -np.inf
        for U in range(max_u + 1):
            for lab in itertools.product(range(1, V), repeat=U):
                lp = seq_logp(lab)
                if lp > best_lp:
                    best, best_lp = lab, lp
        return list(best)

    def test_matches_exhaustive_on_tiny(self):
        T, V, max_u = 3, 3, 2
        enc_out = np.arange(T, dtype=np.float32)[:, None]
        for seed in (0, 1, 2, 3):
            joint = self._joint_table(T, max_u, V, seed)
            got = train.beam_transducer_decode(joint, enc_out,
                                               np.ones(T, bool), beam=8,
                                               max_symbols=max_u)
            assert got == self._exhaustive_best(joint, enc_out, T, V, max_u)

    def test_beats_or_matches_greedy(self):
        T, V, max_u = 4, 4, 3
        enc_out = np.arange(T, dtype=np.float32)[:, None]
        wins = 0
        for seed in (10, 11, 12, 16, 17, 18):   # 16: greedy-divergent
            joint = self._joint_table(T, max_u, V, seed)
            b = train.beam_transducer_decode(joint, enc_out,
                                             np.ones(T, bool), beam=16,
                                             max_symbols=max_u)
            g = train.greedy_transducer_decode(joint, enc_out,
                                               np.ones(T, bool),
                                               max_symbols=max_u)
            want = self._exhaustive_best(joint, enc_out, T, V, max_u)
            assert b == want, (seed, b, want)
            wins += int(g != want)
        assert wins >= 1

    def test_matches_reference(self):
        """Beam and greedy on random joints over a tensor encoder output,
        masked tail included, equal the reference's."""
        T, V, max_u = 6, 5, 4
        enc_out = torch.arange(T, dtype=torch.float32)[:, None]
        mask = np.arange(T) < 5
        for seed in range(4):
            joint = self._joint_table(T, max_u, V, 40 + seed)
            for beam in (2, 4):
                assert train.beam_transducer_decode(
                    joint, enc_out, mask, beam=beam, max_symbols=max_u) == \
                    jtrain.beam_transducer_decode(
                        joint, enc_out.numpy(), mask, beam=beam,
                        max_symbols=max_u)
            assert train.greedy_transducer_decode(
                joint, enc_out, _t(mask), max_symbols=max_u) == \
                jtrain.greedy_transducer_decode(joint, enc_out.numpy(),
                                                mask, max_symbols=max_u)


class TestPrefixBeamCtc:
    def test_exact_vs_exhaustive(self):
        T, V = 4, 3
        for seed in range(6):
            r = np.random.default_rng(seed)
            lp = np.asarray(jax.nn.log_softmax(
                jnp.asarray(r.standard_normal((T, V)) * 2.0), axis=-1))
            best, best_lp = [], -np.inf
            for L in range(T + 1):
                for seq in itertools.product(range(1, V), repeat=L):
                    v = cpu.ctc_sequence_logp(lp, seq)
                    if v > best_lp:
                        best, best_lp = list(seq), v
            got = train.prefix_beam_ctc_decode(_t(lp), np.ones(T, bool),
                                               beam=64)
            assert got == best, (seed, got, best)

    def test_collapses_repeats_and_mask(self):
        lp = np.log(np.full((4, 2), 1e-6))
        lp[0, 1] = lp[1, 1] = lp[3, 1] = np.log(0.999)
        lp[2, 0] = np.log(0.999)
        assert train.prefix_beam_ctc_decode(lp, np.ones(4, bool),
                                            beam=8) == [1, 1]
        assert train.prefix_beam_ctc_decode(
            lp, np.array([True, True, False, False]), beam=8) == [1]

    def test_matches_reference(self):
        r = np.random.default_rng(9)
        for seed in range(3):
            lp = np.asarray(jax.nn.log_softmax(
                jnp.asarray(r.standard_normal((12, 5)) * 1.5), axis=-1))
            mask = np.arange(12) < 10 + seed
            for beam in (1, 4, 8):
                assert train.prefix_beam_ctc_decode(_t(lp), mask,
                                                    beam=beam) == \
                    jtrain.prefix_beam_ctc_decode(lp, mask, beam=beam)


class TestDataParallel:
    """``dryrun_train_step`` over 8 ranks (two rows each) from the
    reference's initial parameters against the reference's CTC and RNN-T
    steps on the whole batch of 16 (``tpufeat/models/train.py``'s dry
    run)."""

    @pytest.fixture(scope="class")
    def steps(self):
        B, n = 16, 16000
        rng = np.random.default_rng(0)
        audio = (rng.standard_normal((B, n)) * 0.1).astype(np.float32)
        labels = rng.integers(1, 16, size=(B, 8)).astype(np.int32)
        lengths, llen = np.full(B, n, np.int32), np.full(B, 8, np.int32)
        res = jfeatures.extract_impl(jnp.asarray(audio[:1]),
                                     jnp.asarray(lengths[:1]), JPLAIN)
        kw = dict(dim=32, layers=1, heads=2, vocab=16)
        tx = optax.adamw(1e-4)
        want, sds = {}, []
        for name, jm, init_args, step, port in (
                ("ctc", jtrain.make_models(**kw), (), jtrain.ctc_train_step,
                 train.make_models(**kw, device=CPU)),
                ("rnnt", jtrain.make_transducer(**kw, arch="whisper"),
                 (labels[:1],), jtrain.transducer_train_step,
                 train.make_transducer(**kw, arch="whisper", device=CPU))):
            params = jax.jit(jm.init)(
                jax.random.PRNGKey(len(sds)), res.features, res.mask,
                *init_args)
            st = jtrain.TrainState(params, tx.init(params),
                                   jnp.zeros((), jnp.int32))
            st, loss = jax.jit(functools.partial(
                step, model=jm, tx=tx, cfg=JPLAIN))(
                st, audio, lengths, labels, llen)
            want[name] = (float(loss), {
                k: v.numpy() for k, v in convert.state_dict_from_flax(
                    _np(st.params), port).items()})
            sds.append({k: v.numpy() for k, v in
                        convert.state_dict_from_flax(_np(params),
                                                     port).items()})
        got = spawn(train.dryrun_train_step, 8, None, "whisper", CPU, None,
                    tuple(sds), device=CPU)[0]
        return want, got

    @pytest.mark.parametrize("name", ["ctc", "rnnt"])
    def test_loss_matches_reference(self, steps, name):
        want, got = steps
        np.testing.assert_allclose(got[name], want[name][0], rtol=1e-5)

    @pytest.mark.parametrize("name", ["ctc", "rnnt"])
    def test_parameters_match_reference(self, steps, name):
        want, got = steps
        params = got[f"{name}_params"]
        assert sorted(params) == sorted(want[name][1])
        for k, w in want[name][1].items():
            np.testing.assert_allclose(params[k], w, rtol=0, atol=1e-6,
                                       err_msg=k)
