"""The port's framing against ``tpufeat.framing`` (float32, CPU).

Tolerance: exact for the elementwise copies (pre-emphasis, reflect
padding, framing views). condition_frames' DC offset is a mean whose sum
order differs between XLA and torch: <= 1e-6 abs there.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufeat import framing as jfr
from tpufeat.config import MFCC13_HTK as J_MFCC13, WHISPER80 as J_WHISPER80

from tpufeat_torch import framing as tfr
from tpufeat_torch.config import from_reference


def _port(jcfg):
    return from_reference(dataclasses.asdict(jcfg))


def _noise(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.1).astype(np.float32)


@pytest.mark.parametrize("prev", [0.0, 0.25, "per_row"])
def test_preemphasize_exact(prev):
    x = _noise((3, 1001))
    p = np.array([0.1, -0.2, 0.3], np.float32) if prev == "per_row" else prev
    want = np.asarray(jfr.preemphasize(jnp.asarray(x), 0.97, jnp.asarray(p)))
    got = tfr.preemphasize(torch.from_numpy(x), 0.97, torch.as_tensor(p))
    np.testing.assert_array_equal(got.numpy(), want)


def test_preemphasize_zero_alpha_is_identity():
    x = torch.from_numpy(_noise((2, 50)))
    assert tfr.preemphasize(x, 0.0) is x


@pytest.mark.parametrize("jcfg", [J_MFCC13, J_WHISPER80,
                                  dataclasses.replace(J_WHISPER80,
                                                      drop_last_frame=False)])
def test_num_frames_dynamic(jcfg):
    lengths = np.array([0, 1, 159, 160, 399, 400, 401, 560, 48000])
    want = np.asarray(jfr.num_frames_dynamic(jnp.asarray(lengths), jcfg))
    got = tfr.num_frames_dynamic(torch.from_numpy(lengths), _port(jcfg))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fl,hop,n_frames,M", [
    (400, 160, 7, 1360),      # buffer exactly long enough
    (400, 160, 9, 1300),      # reads past M are zeros
    (400, 512, 3, 1424),      # hop > frame_length
    (300, 100, 5, 800),       # frame_length a multiple of hop
])
def test_frames_from_buffer_exact(fl, hop, n_frames, M):
    buf = _noise((2, M), seed=1)
    want = np.asarray(jfr.frames_from_buffer(jnp.asarray(buf), n_frames,
                                             fl, hop))
    got = tfr.frames_from_buffer(torch.from_numpy(buf), n_frames, fl, hop)
    assert got.shape == (2, n_frames, fl)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reflect_index_exact():
    pos = np.arange(-450, 450)[None, :]
    lengths = np.array([1, 2, 57, 150, 2500])[:, None]
    want = np.asarray(jfr._reflect_index(jnp.asarray(pos),
                                         jnp.asarray(lengths)))
    got = tfr._reflect_index(torch.from_numpy(pos), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("jcfg", [
    J_WHISPER80,
    dataclasses.replace(J_WHISPER80, drop_last_frame=False),
    J_MFCC13,
], ids=["whisper80", "centered_keep_last", "mfcc13"])
def test_framing_buffer_exact(jcfg):
    """Centred reflect padding per row, including utterances shorter than
    the n_fft/2 = 200 pad (multi-fold reflect) and a one-sample row."""
    lengths = np.array([2500, 150, 57, 1])
    x = _noise((4, 2500), seed=2)
    for i, L in enumerate(lengths):
        x[i, L:] = 9.0                 # padding must never reach a frame
    jbuf, jmask = jfr.framing_buffer(jnp.asarray(x), jnp.asarray(lengths),
                                     jcfg)
    buf, mask = tfr.framing_buffer(torch.from_numpy(x),
                                   torch.from_numpy(lengths), _port(jcfg))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def test_framing_buffer_rejects_short_centred_batch():
    cfg = _port(J_WHISPER80)
    with pytest.raises(ValueError, match="n_fft/2"):
        tfr.framing_buffer(torch.zeros(2, 200), torch.tensor([200, 100]), cfg)


@pytest.mark.parametrize("kaldi", [False, True])
def test_frame_signal_and_conditioning(kaldi):
    jcfg = dataclasses.replace(J_MFCC13, kaldi_mode=kaldi, dc_offset=kaldi)
    x = _noise((2, 4000), seed=3)
    lengths = np.array([4000, 2345])
    jf, jm = jfr.frame_signal(jnp.asarray(x), jnp.asarray(lengths), jcfg)
    f, m = tfr.frame_signal(torch.from_numpy(x), torch.from_numpy(lengths),
                            _port(jcfg))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    want = np.asarray(jfr.condition_frames(jf, jcfg))
    got = tfr.condition_frames(f, _port(jcfg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_frame_signal_without_frames():
    cfg = _port(J_MFCC13)
    f, m = tfr.frame_signal(torch.zeros(2, 399), torch.tensor([399, 10]), cfg)
    assert f.shape == (2, 0, 400) and m.shape == (2, 0)
