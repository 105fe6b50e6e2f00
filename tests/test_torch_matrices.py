"""The port's host constants against the JAX package's.

Tolerance: exact. The port's matrices, configs and kernel constants come
from the same numpy code, so every value must match bit for bit.
"""

import dataclasses

import numpy as np
import pytest

from tpufeat import matrices as jmat
from tpufeat.config import PRESETS as JPRESETS
from tpufeat.pallas import fused

from tpufeat_torch import matrices as tmat
from tpufeat_torch.config import PRESETS, from_reference
from tpufeat_torch.kernels import signal

NAMES = sorted(JPRESETS)
# the signal kernel's configs: mel-path presets plus the corners it covers
KERNEL_CFGS = {
    **{n: JPRESETS[n] for n in NAMES if JPRESETS[n].n_mels > 0},
    "kaldi_dc": dataclasses.replace(JPRESETS["mfcc13"], kaldi_mode=True,
                                    dc_offset=True, window="povey"),
    "kaldi_pre_only": dataclasses.replace(JPRESETS["mfcc13"],
                                          kaldi_mode=True),
    "magnitude_lifter": dataclasses.replace(JPRESETS["mfcc13"],
                                            spectrum="magnitude", lifter=22),
    "log10": dataclasses.replace(JPRESETS["mfcc13"], log="log10"),
    "vtln": dataclasses.replace(JPRESETS["fbank80"], vtln_warp=1.1),
}


@pytest.mark.parametrize("name", NAMES)
def test_from_reference_equals_preset(name):
    jcfg = JPRESETS[name]
    cfg = from_reference(dataclasses.asdict(jcfg))
    assert cfg == PRESETS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_bins, cfg.feature_dim, cfg.fmax_hz, cfg.num_frames(4321)) \
        == (jcfg.n_bins, jcfg.feature_dim, jcfg.fmax_hz, jcfg.num_frames(4321))


def test_from_reference_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown"):
        from_reference({"n_mels": 40, "not_a_field": 1})


@pytest.mark.parametrize("name", NAMES)
def test_matrices_bit_exact(name):
    c = JPRESETS[name]
    fbargs = (c.sample_rate, c.n_fft, c.n_mels, c.fmin, c.fmax_hz,
              c.mel_scale, c.mel_norm, c.mel_bin_style, c.vtln_warp,
              c.vtln_low, c.vtln_high)
    pairs = [
        ("window", (c.window, c.frame_length)),
        ("dft_matrices", (c.frame_length, c.n_fft, c.window)),
        ("dft_matrix_combined", (c.frame_length, c.n_fft, c.window)),
        ("kaldi_conditioning_matrix", (c.frame_length, 0.97, True)),
        ("lifter_vector", (13, 22)),
    ]
    if c.n_mels > 0:
        pairs += [
            ("mel_filterbank", fbargs),
            ("mel_filterbank_folded", fbargs),
            ("dct_matrix", (c.n_mels, 13)),
            ("mel_center_freqs", (c.n_mels, c.fmin, c.fmax_hz,
                                  c.mel_scale)),
            ("equal_loudness_vector", (c.n_mels, c.fmin, c.fmax_hz,
                                       c.mel_scale)),
            ("plp_idft_matrix", (c.n_mels, 12)),
        ]
    for fn, args in pairs:
        np.testing.assert_array_equal(np.asarray(getattr(tmat, fn)(*args)),
                                      np.asarray(getattr(jmat, fn)(*args)),
                                      err_msg=fn)


def test_scalar_helpers_bit_exact():
    f = np.linspace(0.0, 8000.0, 97)
    for scale in ("htk", "slaney", "erb"):
        np.testing.assert_array_equal(tmat.hz_to_mel(f, scale),
                                      jmat.hz_to_mel(f, scale))
        np.testing.assert_array_equal(tmat.mel_to_hz(f / 10, scale),
                                      jmat.mel_to_hz(f / 10, scale))
    np.testing.assert_array_equal(
        tmat.vtln_warp_freq(f, 0.0, 8000.0, 100.0, 7500.0, 0.9),
        jmat.vtln_warp_freq(f, 0.0, 8000.0, 100.0, 7500.0, 0.9))
    for a, b in zip(tmat.nccf_gemm_matrices(400, 20, 320),
                    jmat.nccf_gemm_matrices(400, 20, 320)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(KERNEL_CFGS))
def test_kernel_constants_bit_exact(name):
    """The unpadded region of the Pallas kernel's constants, bit for bit."""
    jcfg = KERNEL_CFGS[name]
    cfg = from_reference(dataclasses.asdict(jcfg))
    cs = signal.cs_constant(cfg)
    nc = 2 * cfg.n_bins - 2
    assert cs.dtype == np.float32 and cs.shape == (cfg.frame_length, nc)
    np.testing.assert_array_equal(cs, fused._cs_constant(jcfg, True)[:, :nc])

    fb = signal.fb_constant(cfg)
    rows = nc if cfg.spectrum == "power" else cfg.n_bins
    assert fb.dtype == np.float32 and fb.shape == (rows, cfg.n_mels)
    jfb, jdct = fused._folded_fb_constants(jcfg)
    np.testing.assert_array_equal(fb, jfb[:rows, :cfg.n_mels])
    np.testing.assert_array_equal(jfb[rows:], 0.0)

    dct = signal.dct_constant(cfg)
    if jdct is None:
        assert dct is None
    else:
        assert dct.shape == (cfg.n_mels, cfg.n_mfcc)
        np.testing.assert_array_equal(dct, jdct[:cfg.n_mels, :cfg.n_mfcc])
        np.testing.assert_array_equal(
            dct, fused._tail_constants(jcfg)[1][:cfg.n_mels, :cfg.n_mfcc])


def test_cached_constants_are_read_only():
    cfg = PRESETS["mfcc13"]
    for a in (signal.cs_constant(cfg), signal.fb_constant(cfg),
              signal.dct_constant(cfg)):
        with pytest.raises(ValueError):
            a[0, 0] = 1.0
