"""The Hopper signal kernels on the card, against their plain twin.

Marked ``cuda``: run with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_signal.py`` on a machine with an H100 and nvcc
(``--noconftest`` because ``tests/conftest.py`` imports jax, which a
torch-only host lacks; this file imports no jax). Without a card every
test skips inside the ``cuda`` fixture (decided at run time, never at
collection, so every worker collects the same tests).

Tolerance: kernel vs twin within ``_tolerance.compare_to_twin``: 1e-4
relative to max(1, |twin|.max()) plus the bound of the f32 sum order
through the later stages (large only over near-silent bins), plus at
"default" the bound of one bf16 flip per rounding, with at most
FLIP_FRAMES frames past 1e-4 in any window of the tile's frames. Every
precision runs the tensor-core kernel: six bf16 passes per product at
"highest", three at "bf16x3", one at "default".
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufeat_torch import config as C
from tpufeat_torch import features, framing
from tpufeat_torch.kernels import _build, signal
from tpufeat_torch.kernels import _tolerance as tolerance
from tpufeat_torch.reference import cpu

pytestmark = pytest.mark.cuda

CFGS = {
    "mfcc13": C.MFCC13_HTK,
    "whisper80": C.WHISPER80,
    "whisper128": C.WHISPER128,
    "kaldi_dc": dataclasses.replace(C.MFCC13_HTK, kaldi_mode=True,
                                    dc_offset=True, window="povey"),
    "magnitude": dataclasses.replace(C.MFCC13_HTK, spectrum="magnitude"),
    "lifter": dataclasses.replace(C.MFCC13_HTK, lifter=22),
    "log10": dataclasses.replace(C.MFCC13_HTK, log="log10"),
    # a hop that divides nothing (not a multiple of 8: no ldmatrix), an odd
    # one, and 1024 DFT columns (eight chunks)
    "hop100": C.FeatureConfig(hop_length=100, frame_length=300),
    "hop101": C.FeatureConfig(hop_length=101, frame_length=300),
    # a frame_length not a multiple of 16: the last 16-deep step is partial
    "fl403": C.FeatureConfig(frame_length=403, n_fft=512),
    "fl1024": C.FeatureConfig(frame_length=1024, hop_length=256,
                              n_fft=1024, n_mels=40),
    # past one slab of 128 mel bands: MFCCs, and a log-mel
    "mel160": C.FeatureConfig(n_mels=160, n_mfcc=13),
    "mel200_logmel": C.FeatureConfig(n_mels=200, n_mfcc=0),
}
TM = signal.MMA_TILE_FRAMES
HALF = TM // 2
PRECISIONS = ["highest", "bf16x3", "default"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _buf(cfg, n_frames, batch, device, seed=0):
    M = (n_frames - 1) * cfg.hop_length + cfg.frame_length - 3
    x = np.random.default_rng(seed).standard_normal((batch, M)) * 0.1
    return torch.tensor(x, dtype=torch.float32, device=device)


def _frames(buf, n_frames, cfg):
    return framing.frames_from_buffer(buf, n_frames, cfg.frame_length,
                                      cfg.hop_length)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n_frames", [1, HALF - 1, HALF, HALF + 1, TM - 1,
                                      TM + 1, 2 * TM + 1])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_kernel_matches_twin(cuda, name, n_frames, batch, precision):
    cfg = dataclasses.replace(CFGS[name], matmul_precision=precision)
    buf = _buf(cfg, n_frames, batch, cuda)
    before = signal.mma_launches
    got = signal.signal_features(buf, n_frames, cfg)
    torch.cuda.synchronize()
    assert signal.mma_launches == before + 1
    want = signal.signal_features_reference(buf, n_frames, cfg)
    torch.cuda.synchronize()
    tolerance.compare_to_twin(got, want, _frames(buf, n_frames, cfg), cfg,
                           what=name)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_frame_bits_do_not_depend_on_position(cuda, precision):
    """The fixed tile and K order: a frame computed at another offset in
    another call has the same bits, at every row position of a tile."""
    cfg = dataclasses.replace(C.MFCC13_HTK, matmul_precision=precision)
    buf = _buf(cfg, 200, 2, cuda, seed=1)
    whole = signal.signal_features(buf, 200, cfg)
    for shift in range(TM):
        part = signal.signal_features(
            buf[:, shift * cfg.hop_length:].contiguous(), 200 - shift, cfg)
        assert torch.equal(whole[:, shift:], part), shift


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("n_frames", [1, 3, 10])
def test_tiles_cross_rows_of_few_frames(cuda, n_frames, precision):
    """Many rows of a few frames each (a streaming step's shape), M not a
    multiple of 4: each tile stages a span in every row it touches."""
    cfg = dataclasses.replace(C.MFCC13_HTK, matmul_precision=precision)
    buf = _buf(cfg, n_frames, 300, cuda, seed=4)
    assert buf.shape[1] % 4
    got = signal.signal_features(buf, n_frames, cfg)
    want = signal.signal_features_reference(buf, n_frames, cfg)
    torch.cuda.synchronize()
    tolerance.compare_to_twin(got, want, _frames(buf, n_frames, cfg), cfg,
                              what=f"{n_frames} a row")


@pytest.mark.parametrize("name", ["mfcc13", "whisper80"])
def test_extract_on_card_matches_golden(cuda, name):
    cfg = dataclasses.replace(CFGS[name], use_pallas=True, gemm_dft=True,
                              fused_framing=True, matmul_precision="bf16x3")
    lengths = np.array([48000, 30001, 7777])
    x = (np.random.default_rng(2).standard_normal((3, 48000)) * 0.1
         ).astype(np.float32)
    before = signal.mma_launches
    res = features.extract(x, lengths, cfg, device="cuda")
    assert signal.mma_launches == before + 1
    assert res.features.device.type == "cuda"
    on_card = features.extract(torch.from_numpy(x).to(cuda), lengths, cfg,
                               device="cuda")
    assert torch.equal(on_card.features, res.features)
    for i, L in enumerate(lengths):
        gold = cpu.extract(x[i, :L].astype(np.float64), CFGS[name])
        nf = int(res.num_frames[i])
        assert nf == gold.shape[0]
        got = res.features[i, :nf].double().cpu().numpy()
        assert np.abs(got - gold).max() / max(1.0, np.abs(gold).max()) \
            <= 1e-3


def test_unbuildable_source_raises(cuda, tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text("this is not CUDA C++;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    buf = _buf(C.MFCC13_HTK, 4, 1, cuda)
    before = signal.mma_launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        signal.signal_features(buf, 4, C.MFCC13_HTK)
    assert signal.mma_launches == before
