"""The speaker stack on the card: i-vectors, the online pipeline's 142-dim
rows, fMLLR statistics, PLDA scoring and diarization, each held against
the CPU run of the same call, and the products pinned whatever the
caller's TF32 setting.

Marked ``cuda``: run with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_speaker.py`` on a machine with a card
(``--noconftest`` because ``tests/conftest.py`` imports jax; this file
imports no jax). Without a card every test skips inside the ``cuda``
fixture.

The models are trained by the port on the CPU from seeded data (G=16,
K=8; the pipeline's extractor K=100 over G=16 for Kaldi's 142-dim row).

Tolerances (the CPU tests' own, ``tests/test_torch_ivector.py`` and
``tests/test_torch_diarize.py``):
- log-likelihoods atol 2e-4 / rtol 1e-5; utterance i-vectors atol 2e-4 /
  rtol 1e-3; ``ivector_features`` and the stream 1e-4; segment i-vectors
  atol 2e-4 / rtol 1e-4; fMLLR statistics 1e-4 of their largest entry;
  PLDA scores atol 5e-3 / rtol 1e-4;
- the stream against ``ivector_features`` on the card: 1e-4; the frames
  before a boundary when later frames change: bit for bit;
- diarization labels: equal to the CPU's;
- the pipeline on the card against the CPU: spectral columns 1e-4 scaled
  (the plain path), pitch columns 1e-4 where the decisions agree,
  i-vector columns 1e-4; its spectral and pitch columns against the same
  pipeline without ``ivector=``: bit for bit;
- under ``allow_tf32``: bit for bit with the default.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufeat_torch import diarization, fmllr, ivector, plda, streaming
from tpufeat_torch.config import KALDI39

pytestmark = pytest.mark.cuda

CPU = "cpu"
SLIDING = dataclasses.replace(KALDI39, cmvn="sliding", cmvn_window=30,
                              cmvn_min_window=10)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(n, seed, dim=13, clusters=4):
    r = np.random.default_rng(seed)
    centers = np.random.default_rng(0).standard_normal((clusters, dim)) * 3
    return (centers[r.integers(0, clusters, n)]
            + r.standard_normal((n, dim))).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    ubm = ivector.train_diag_ubm(_frames(2000, 1), 16, iters=2,
                                 final_iters=3, seed=0, device=CPU)
    utts = [_frames(200, 10 + i) for i in range(12)]
    ext = ivector.train_ivector_extractor(ubm, utts, ivector_dim=8, iters=2,
                                          seed=1, device=CPU)
    ivs = np.stack([ivector.utterance_ivector(ext, u, device=CPU).numpy()
                    for u in utts]).astype(np.float64)
    model = plda.train_plda(ivs, [i // 3 for i in range(12)], iters=4)
    return ubm, ext, model


def _close(got, want, atol, rtol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else want
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _scaled(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    return ((got - want).abs().max() / max(1.0, want.abs().max().item())
            ).item()


def test_ubm_on_the_card(cuda, models):
    ubm = models[0]
    x = _frames(300, 2)
    _close(ubm.log_likes(x, device=cuda), ubm.log_likes(x, device=CPU),
           2e-4, 1e-5)
    trained = ivector.train_diag_ubm(_frames(2000, 1), 16, iters=2,
                                     final_iters=3, seed=0, device=cuda)
    a = ivector.avg_log_like(trained, x, device=CPU)
    b = ivector.avg_log_like(ubm, x, device=CPU)
    assert abs(a - b) <= 1e-4 * abs(b)


def test_utterance_ivector_and_training(cuda, models):
    ubm, ext, _ = models
    utts = np.stack([_frames(200, 30 + i) for i in range(4)])
    mask = (np.arange(200)[None] < np.array([200, 150, 90, 30])[:, None])
    _close(ivector.utterance_ivector(ext, utts, mask.astype(np.float32),
                                     device=cuda),
           ivector.utterance_ivector(ext, utts, mask.astype(np.float32),
                                     device=CPU), 2e-4, 1e-3)
    _, mine = ivector.train_ivector_extractor(
        ubm, list(utts), ivector_dim=8, iters=2, seed=1,
        return_objective=True, device=cuda)
    _, ref = ivector.train_ivector_extractor(
        ubm, list(utts), ivector_dim=8, iters=2, seed=1,
        return_objective=True, device=CPU)
    np.testing.assert_allclose(mine, ref, rtol=1e-3)


def test_ivector_features_and_stream(cuda, models):
    ext = models[1]
    x = np.stack([_frames(137, 40), _frames(137, 41)])
    offline = ivector.ivector_features(ext, x, lengths=[137, 101],
                                       device=cuda)
    _close(offline, ivector.ivector_features(ext, x, lengths=[137, 101],
                                             device=CPU), 1e-4, 0)
    full = ivector.ivector_features(ext, x, device=cuda)
    for plan in ([10] * 13 + [7], [7, 13, 1, 19, 97], [137]):
        st = ivector.StreamingIvector(ext, 2, device=cuda)
        outs, pos = [], 0
        for c in plan:
            outs.append(st.process(x[:, pos:pos + c]))
            pos += c
        assert _scaled(torch.cat(outs, dim=1), full) <= 1e-4
        st.check()
    later = x.copy()
    later[:, 65:] += 3.0
    again = ivector.ivector_features(ext, later, device=cuda)
    assert torch.equal(again[:, :70], full[:, :70])


def test_fmllr_stats_on_the_card(cuda, models):
    ubm = models[0]
    batch = np.stack([_frames(120, 50 + i) for i in range(3)])
    lengths = np.array([120, 80, 45])
    for got, want in zip(
            fmllr.fmllr_stats(ubm, batch, lengths, per_row=True,
                              device=cuda),
            fmllr.fmllr_stats(ubm, batch, lengths, per_row=True,
                              device=CPU)):
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * np.abs(want).max())


def test_plda_and_diarization_on_the_card(cuda, models):
    _, ext, model = models
    r = np.random.default_rng(60)
    e, t = r.standard_normal((5, 8)), r.standard_normal((7, 8))
    _close(model.score(e, t, n_enroll=[1, 2, 3, 1, 5], device=cuda),
           model.score(e, t, n_enroll=[1, 2, 3, 1, 5], device=CPU),
           5e-3, 1e-4)
    feats = np.concatenate([_frames(450, 70, clusters=1),
                            _frames(450, 71, clusters=2)])
    got, spans = diarization.segment_ivectors(ext, feats, device=cuda)
    want, _ = diarization.segment_ivectors(ext, feats, device=CPU)
    _close(got, want, 2e-4, 1e-4)
    labels, _ = diarization.diarize(ext, model, feats, num_speakers=2,
                                    device=cuda)
    cpu_labels, _ = diarization.diarize(ext, model, feats, num_speakers=2,
                                        device=CPU)
    np.testing.assert_array_equal(labels, cpu_labels)
    sd = diarization.StreamingDiarizer(ext, model, max_speakers=2,
                                       device=cuda)
    ref = diarization.StreamingDiarizer(ext, model, max_speakers=2,
                                        device=CPU)
    for pos in range(0, 900, 200):
        a, _ = sd.process(feats[pos:pos + 200])
        b, _ = ref.process(feats[pos:pos + 200])
        np.testing.assert_array_equal(a, b)


def test_pipeline_142_dim_rows(cuda, models):
    """KALDI39 with sliding CMVN, pitch and a K=100 extractor: Kaldi
    nnet3-online's [39 | 3 | 100] row, on the card against the CPU."""
    ubm = models[0]
    ext = ivector.train_ivector_extractor(
        ubm, [_frames(300, 80 + i) for i in range(8)], ivector_dim=100,
        iters=1, seed=2, device=CPU)
    n = 16000
    t = np.arange(n) / 16000
    x = np.stack([0.4 * np.sin(2 * np.pi * f0 * t) for f0 in (140, 210)])
    x = (x + 0.01 * np.random.default_rng(3).standard_normal(x.shape)
         ).astype(np.float32)

    def run(device, **kw):
        pipe = streaming.StreamingPipeline(SLIDING, 2, pitch=True,
                                           device=device, **kw)
        outs = [pipe.process(x[:, k:k + 1600]) for k in range(0, n, 1600)]
        return torch.cat(outs + [pipe.flush()], dim=1)

    got = run(cuda, ivector=ext)
    assert got.shape[-1] == 142 and bool(torch.isfinite(got).all())
    assert torch.equal(got[..., :42], run(cuda))
    want = run(CPU, ivector=ext)
    assert _scaled(got[..., :39], want[..., :39]) <= 1e-4
    same = (got[..., 39] - want[..., 39].to(cuda)).abs() < 1e-4
    assert same.float().mean() > 0.99
    assert (got[..., 39:42][same] - want[..., 39:42].to(cuda)[same]
            ).abs().max() <= 1e-4
    assert _scaled(got[..., 42:], want[..., 42:]) <= 1e-4


def test_products_ignore_tf32(cuda, models, monkeypatch):
    ubm, ext, model = models
    x = np.stack([_frames(90, 90), _frames(90, 91)])
    base = (ubm.log_likes(x, device=cuda),
            ivector.ivector_features(ext, x, device=cuda),
            model.score(x[0, :4, :8], x[1, :5, :8], device=cuda))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    again = (ubm.log_likes(x, device=cuda),
             ivector.ivector_features(ext, x, device=cuda),
             model.score(x[0, :4, :8], x[1, :5, :8], device=cuda))
    for a, b in zip(base, again):
        assert torch.equal(a, b)
