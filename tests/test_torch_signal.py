"""The signal kernel's plain twin against the Pallas kernel it replaces.

``tpufeat.pallas.fused.signal_features`` runs in Pallas interpret mode on
the CPU with matmul_precision="highest", in both TPU layouts: n_frames 127
takes the v4 hop-split body, 128 and 129 the v5 phase-packed body, and
``layout="v4"`` pins v4 at 129 (hop 100 is not phase-eligible: always v4).

Tolerance: <= 1e-4 abs on broadband noise — the same fp32 math with a
different summation order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufeat.config import FeatureConfig as JConfig
from tpufeat.config import MFCC13_HTK as J_MFCC13, WHISPER80 as J_WHISPER80
from tpufeat.pallas import fused

from tpufeat_torch.config import from_reference
from tpufeat_torch.kernels import signal

CFGS = {
    "mfcc13": J_MFCC13,
    "whisper80": J_WHISPER80,
    "kaldi_fold": JConfig(kaldi_mode=True, dc_offset=True, window="povey"),
    "magnitude_lifter": JConfig(spectrum="magnitude", lifter=22),
    "hop100": JConfig(hop_length=100, frame_length=300),
    "fl1024": JConfig(frame_length=1024, hop_length=256, n_fft=1024,
                      n_mels=40),
}


def _buf(jcfg, n_frames, batch=2, short=5, seed=0):
    """Noise buffer ``short`` samples shorter than the last frame's end, so
    the zero reads past M are exercised."""
    M = (n_frames - 1) * jcfg.hop_length + jcfg.frame_length - short
    return (np.random.default_rng(seed).standard_normal((batch, M))
            * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_frames,layout", [(127, "auto"), (128, "auto"),
                                             (129, "auto"), (129, "v4")])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_twin_matches_pallas_kernel(name, n_frames, layout):
    jcfg = dataclasses.replace(CFGS[name], matmul_precision="highest")
    buf = _buf(jcfg, n_frames)
    want = np.asarray(fused.signal_features(jnp.asarray(buf), n_frames,
                                            jcfg, layout=layout))
    got = signal.signal_features_reference(
        torch.from_numpy(buf), n_frames,
        from_reference(dataclasses.asdict(jcfg)))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4


@pytest.mark.parametrize("name", sorted(CFGS))
def test_cpu_tensor_runs_the_twin(name):
    """The wrapper takes the twin for a CPU tensor, and counts no launch."""
    cfg = from_reference(dataclasses.asdict(CFGS[name]))
    buf = torch.from_numpy(_buf(CFGS[name], 40, batch=3, seed=1))
    before = signal.launches
    out = signal.signal_features(buf, 40, cfg)
    assert signal.launches == before
    torch.testing.assert_close(
        out, signal.signal_features_reference(buf, 40, cfg), rtol=0, atol=0)


def test_log_kinds_and_output_dims():
    base = from_reference(dataclasses.asdict(J_MFCC13))
    buf = torch.from_numpy(_buf(J_MFCC13, 9, seed=2))
    mel_only = dataclasses.replace(base, n_mfcc=0)
    lin = signal.signal_features(buf, 9, dataclasses.replace(mel_only,
                                                             log="none"))
    for log, fn in (("natural", torch.log), ("log10", torch.log10)):
        got = signal.signal_features(buf, 9, dataclasses.replace(
            mel_only, log=log))
        torch.testing.assert_close(got, fn(torch.clamp(lin, min=1e-10)))
    assert signal.signal_features(buf, 9, base).shape == (2, 9, 13)
    assert lin.shape == (2, 9, 26)


@pytest.mark.parametrize("bad,exc", [
    (lambda b: b.double(), TypeError),
    (lambda b: b.t().contiguous().t(), ValueError),
    (lambda b: b[0], ValueError),
    (lambda b: b.to("meta"), ValueError),
])
def test_wrapper_rejects_bad_input(bad, exc):
    cfg = from_reference(dataclasses.asdict(J_MFCC13))
    buf = torch.from_numpy(_buf(J_MFCC13, 4))
    with pytest.raises(exc):
        signal.signal_features(bad(buf), 4, cfg)


def test_wrapper_rejects_zero_frames_and_spectrogram_configs():
    buf = torch.from_numpy(_buf(J_MFCC13, 4))
    with pytest.raises(ValueError, match="n_frames"):
        signal.signal_features(buf, 0, from_reference(
            dataclasses.asdict(J_MFCC13)))
    spec = from_reference(dataclasses.asdict(JConfig(n_mels=0, n_mfcc=0)))
    with pytest.raises(ValueError, match="n_mels"):
        signal.signal_features(buf, 4, spec)
