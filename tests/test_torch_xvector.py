"""The port's x-vector network (``tpufeat_torch.models.xvector``) against
``tpufeat.models.xvector`` on the CPU, with the reference's parameters
carried across by ``models.convert.state_dict_from_flax``; the
reference's own checks of ``tests/test_xvector.py`` mirrored: training
separates speakers, masked pooling ignores padding, embeddings compose
with the port's PLDA backend, and the data-parallel step (8 ranks of a
gloo group on the CPU) matches the reference's step on the whole batch.

Tolerances: embeddings and logits at channels 32 atol 1e-5 (measured
under 4e-7); one step's loss rtol 1e-5 and gradients 1e-4 of each
tensor's largest entry; padding invariance atol 2e-4 (the reference's);
the dp step's loss rtol 1e-5 and parameters atol 1e-5 (the reference's
own dp test, ``tests/test_xvector.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpufeat.models import xvector as jxv

from tpufeat_torch import plda as pl
from tpufeat_torch.models import convert, train
from tpufeat_torch.models import xvector as xv
from tpufeat_torch.multichip import spawn

import _torch_dist_cases

CPU = "cpu"


def _batch(n_spk=4, n_utt=6, T=50, D=13, seed=0):
    r = np.random.default_rng(seed)
    offs = r.standard_normal((n_spk, D)) * 2.0
    feats, labels = [], []
    for s in range(n_spk):
        for _ in range(n_utt):
            feats.append(offs[s] + r.standard_normal((T, D)))
        labels += [s] * n_utt
    return (np.stack(feats).astype(np.float32),
            np.asarray(labels, np.int32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def trained():
    feats, labels = _batch()
    torch.manual_seed(0)
    model = xv.xvector_model(4, in_dim=13, embed_dim=16, channels=32,
                             device=CPU)
    state = xv.XvectorState(model, train.adamw(model, 3e-3))
    mask = np.ones(feats.shape[:2], np.float32)
    losses = [xv.xvector_train_step(state, feats, mask, labels)[1].item()
              for _ in range(60)]
    return model, feats, labels, losses


class TestTraining:
    def test_loss_decreases(self, trained):
        losses = trained[3]
        assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])

    def test_embeddings_separate_speakers(self, trained):
        model, feats, labels, _ = trained
        emb = xv.extract_xvectors(model, feats).numpy()
        from scipy.spatial.distance import cdist
        d = cdist(emb, emb)
        np.fill_diagonal(d, 1e9)
        assert (labels[d.argmin(1)] == labels).mean() > 0.9


class TestMasking:
    def test_padding_invariance(self, trained):
        model, feats, _, _ = trained
        one = feats[:2]
        short = xv.extract_xvectors(model, one, num_frames=[50, 30])
        padded = np.concatenate(
            [one, 99.0 * np.ones((2, 37, one.shape[2]), np.float32)], axis=1)
        pad = xv.extract_xvectors(model, padded, num_frames=[50, 30])
        np.testing.assert_allclose(pad.numpy(), short.numpy(), atol=2e-4)

    def test_single_utterance_2d(self, trained):
        model, feats, _, _ = trained
        assert xv.extract_xvectors(model, feats[0]).shape == (1, 16)


class TestPldaComposition:
    def test_xvector_plda_verification(self, trained):
        """x-vectors -> length-norm -> PLDA, on the port's backend."""
        model, feats, labels, _ = trained
        emb = pl.length_normalize(
            xv.extract_xvectors(model, feats).double().numpy())
        plda = pl.train_plda(emb, labels, iters=5)
        means, counts, spks = pl.ivector_mean(emb[::2], labels[::2])
        sc = np.asarray(plda.score(means, emb[1::2], n_enroll=counts,
                                   device=CPU))
        truth = labels[1::2]
        same = sc[np.asarray(spks)[:, None] == truth[None, :]]
        diff = sc[np.asarray(spks)[:, None] != truth[None, :]]
        assert (same[:, None] > diff[None, :]).mean() > 0.95


class TestReference:
    @pytest.fixture(scope="class")
    def carried(self):
        feats, labels = _batch(seed=3)
        mask = np.ones(feats.shape[:2], np.float32)
        mask[::3, 35:] = 0.0
        jm = jxv.xvector_model(4, embed_dim=16, channels=32)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), feats, mask)
        model = xv.xvector_model(4, in_dim=13, embed_dim=16, channels=32,
                                 device=CPU)
        model.load_state_dict(convert.state_dict_from_flax(_np(params),
                                                           model))
        return jm, params, model, feats, mask, labels

    def test_embeddings_and_logits(self, carried):
        jm, params, model, feats, mask, _ = carried
        we, wl = jax.jit(jm.apply)(params, feats, mask)
        with torch.no_grad():
            ge, gl = model(torch.from_numpy(feats), torch.from_numpy(mask))
        np.testing.assert_allclose(ge.numpy(), np.asarray(we), atol=1e-5)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-5)
        nf = mask.sum(axis=1).astype(int)
        np.testing.assert_allclose(
            xv.extract_xvectors(model, feats, num_frames=nf).numpy(),
            np.asarray(jxv.extract_xvectors(params, jm, feats,
                                            num_frames=nf)), atol=1e-5)

    def test_train_step_loss_and_gradients(self, carried):
        jm, params, model, feats, mask, labels = carried

        def loss_fn(p):
            _, logits = jm.apply(p, feats, mask)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.asarray(labels)).mean()

        want, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
        state = xv.XvectorState(model, train.adamw(model, 0.0))
        state, loss = xv.xvector_train_step(state, feats, mask, labels)
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
        wg = convert.state_dict_from_flax(_np(jgrads), model)
        for name, p in model.named_parameters():
            gap = (p.grad - wg[name]).abs().max() / wg[name].abs().max()
            assert gap < 1e-4, name
        assert state.step == 1


class TestDataParallel:
    """The x-vector step with the batch's 24 rows split over 8 ranks
    against the reference's step on the whole batch (optax.adam at 1e-3,
    ``tests/test_xvector.py``'s dp case), from the same parameters; every
    loss is a mean over rows, so equal shards give the whole batch's
    gradient."""

    @pytest.fixture(scope="class")
    def step(self):
        feats, labels = _batch(seed=4)
        mask = np.ones(feats.shape[:2], np.float32)
        mask[::3, 35:] = 0.0
        jm = jxv.xvector_model(4, embed_dim=16, channels=32)
        params = jax.jit(jm.init)(jax.random.PRNGKey(0), feats, mask)
        tx = optax.adam(1e-3)
        s0 = jxv.XvectorState(params, tx.init(params),
                              jnp.zeros((), jnp.int32))
        want_state, want_loss = jax.jit(
            lambda s, f, m, l: jxv.xvector_train_step(
                s, f, m, l, model=jm, tx=tx))(s0, feats, mask, labels)
        model = xv.xvector_model(4, in_dim=13, embed_dim=16, channels=32,
                                 device=CPU)
        sd = {k: v.numpy() for k, v in convert.state_dict_from_flax(
            _np(params), model).items()}
        want = {k: v.numpy() for k, v in convert.state_dict_from_flax(
            _np(want_state.params), model).items()}
        got = spawn(_torch_dist_cases.xvector_dp_step, 8, sd, feats, mask,
                    labels, 32, device=CPU)[0]
        return float(want_loss), want, got

    def test_loss_matches_reference(self, step):
        want_loss, _, got = step
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)

    def test_parameters_match_reference(self, step):
        _, want, got = step
        assert sorted(got["params"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(got["params"][k], w, rtol=0,
                                       atol=1e-5, err_msg=k)
