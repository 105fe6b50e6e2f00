"""The Hopper staged kernels (K3, K4) and the streaming front-end on the card.

Marked ``cuda``: run with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_staged.py`` on a machine with an H100 and nvcc
(``--noconftest`` because ``tests/conftest.py`` imports jax; this file
imports no jax). Without a card every test skips inside the ``cuda``
fixture.

Tolerances, relative to max(1, |reference|.max()):
- kernel vs twin: K3 and K4 within ``_tolerance.compare_to_twin`` (1e-4
  plus the bounds of the sum order and, at "default", of one bf16 flip per
  rounding, with at most FLIP_FRAMES rows past 1e-4 in a window of 64);
- staged ``extract`` vs the float64 golden: <= 1e-3;
- hop-aligned chunk plans of the static step, on the signal kernel and on
  K3: bitwise, and equal to ``extract_scan``. The K4 route is held to 1e-5
  across plans: its rFFT is cuFFT's, whose plan may change with the batch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpufeat_torch import config as C
from tpufeat_torch import features, streaming
from tpufeat_torch.kernels import _build, signal, staged
from tpufeat_torch.kernels import _tolerance as tolerance
from tpufeat_torch.reference import cpu

pytestmark = pytest.mark.cuda

CFGS = {
    "mfcc13": C.MFCC13_HTK,
    "fbank80": C.FBANK80,
    "whisper80": C.WHISPER80,
    "magnitude": dataclasses.replace(C.MFCC13_HTK, spectrum="magnitude"),
    "lifter22": dataclasses.replace(C.MFCC13_HTK, lifter=22),
    "kaldi_dc": dataclasses.replace(C.MFCC13_HTK, kaldi_mode=True,
                                    dc_offset=True, window="povey"),
}
STATIC = {
    "fused": dict(use_pallas=True, gemm_dft=True, fused_framing=True),
    "staged_k3": dict(use_pallas=True, gemm_dft=True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel_err(got, want):
    return ((got.double() - want.double()).abs().max()
            / max(1.0, want.abs().max().item())).item()


def _frames(cfg, rows, device, seed=0):
    x = np.random.default_rng(seed).standard_normal((rows, cfg.frame_length))
    return torch.tensor(x * 0.1, dtype=torch.float32, device=device)


def _spectrum(cfg, rows, device, seed=0):
    """Power (or magnitude) spectra of windowed noise: broadband rows."""
    w = torch.hann_window(cfg.frame_length, periodic=False, device=device)
    x = torch.fft.rfft(_frames(cfg, rows, device, seed) * w, n=cfg.n_fft)
    p = x.real * x.real + x.imag * x.imag
    return p.sqrt() if cfg.spectrum == "magnitude" else p


def _kernel_input(kernel, cfg, rows, device, seed=0):
    return (_frames if kernel == "dft_mel_log_dct" else _spectrum)(
        cfg, rows, device, seed)


def _count(kernel):
    """The launch count of ``kernel``'s wrapper."""
    return {"dft_mel_log_dct": "dft_mel_log_dct_mma_launches",
            "mel_log_dct": "mel_log_dct_launches"}[kernel]


def _compare(kernel, got, want, x, cfg, what):
    return tolerance.compare_to_twin(got, want, x, cfg, fold_kaldi=False,
                                     what=what,
                                     spectrum=kernel == "mel_log_dct")


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("rows", [1, 31, 32, 33, 63, 65, 513])
@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("kernel", ["dft_mel_log_dct", "mel_log_dct"])
def test_kernel_matches_twin(cuda, kernel, name, rows, precision):
    cfg = dataclasses.replace(CFGS[name], matmul_precision=precision)
    x = _kernel_input(kernel, cfg, rows, cuda)
    count = _count(kernel)
    before = getattr(staged, count)
    got = getattr(staged, kernel)(x, cfg)
    torch.cuda.synchronize()
    assert getattr(staged, count) == before + 1
    want = getattr(staged, f"{kernel}_reference")(x, cfg)
    assert got.shape == want.shape and got.device.type == "cuda"
    _compare(kernel, got, want, x, cfg, name)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("kernel", ["dft_mel_log_dct", "mel_log_dct"])
def test_row_bits_do_not_depend_on_the_call(cuda, kernel, precision):
    """A row has the same bits at another place in a call of another R."""
    cfg = dataclasses.replace(C.MFCC13_HTK, matmul_precision=precision)
    x = _kernel_input(kernel, cfg, 300, cuda, seed=1)
    whole = getattr(staged, kernel)(x, cfg)
    for start in (37, 38, 101):
        part = getattr(staged, kernel)(x[start:250].contiguous(), cfg)
        torch.cuda.synchronize()
        assert torch.equal(whole[start:250], part)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("value", ["nan", "inf"])
@pytest.mark.parametrize("frame_length", [400, 403])
def test_rows_beside_nonfinite_rows_stay_exact(cuda, frame_length, value,
                                               precision):
    """K3 reads no sample past its own row, whatever frame_length % 8 (or
    % 32) is: a row beside rows of NaN or Inf keeps the values it has
    alone."""
    cfg = dataclasses.replace(C.MFCC13_HTK, frame_length=frame_length,
                              matmul_precision=precision)
    x = _frames(cfg, 96, cuda, seed=5)
    x[::2] = float(value)
    got = staged.dft_mel_log_dct(x, cfg)
    alone = staged.dft_mel_log_dct(x[1::2].contiguous(), cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got[1::2]).all()
    assert torch.equal(got[1::2], alone)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("value", ["nan", "inf"])
def test_tail_rows_beside_nonfinite_rows_stay_exact(cuda, value, precision):
    """K4 reads no bin past its own row (the 16-deep steps end past
    n_bins = 257): a row beside rows of NaN or Inf keeps the values it has
    alone, at every place in its tile."""
    cfg = dataclasses.replace(C.MFCC13_HTK, matmul_precision=precision)
    x = _spectrum(cfg, 200, cuda, seed=6)
    x[::2] = float(value)
    got = staged.mel_log_dct(x, cfg)
    alone = staged.mel_log_dct(x[1::2].contiguous(), cfg)
    torch.cuda.synchronize()
    assert torch.isfinite(got[1::2]).all()
    assert torch.equal(got[1::2], alone)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("n_fft", [1024, 2048, 4096])
def test_tail_tiles_of_wide_spectra(cuda, n_fft, precision):
    """Where two 64-row slots do not fit in shared memory, K4 takes tiles of
    32 or 16 rows (one slot at 2049 bins) and still matches its twin; the
    offset of a row in its tile changes nothing."""
    cfg = C.FeatureConfig(frame_length=n_fft, hop_length=n_fft // 4,
                          n_fft=n_fft, n_mels=40, matmul_precision=precision)
    smem, blocks, rows, slots, _ = staged.tail_resources(cfg)
    assert blocks >= 1 and slots >= 1
    assert rows == {1024: 32, 2048: 16, 4096: 16}[n_fft]
    x = _spectrum(cfg, 3 * rows + 5, cuda, seed=7)
    got = staged.mel_log_dct(x, cfg)
    want = staged.mel_log_dct_reference(x, cfg)
    _compare("mel_log_dct", got, want, x, cfg, f"n_fft={n_fft}")
    part = staged.mel_log_dct(x[7:].contiguous(), cfg)
    torch.cuda.synchronize()
    assert torch.equal(got[7:], part)


def test_tail_rows_off_16_bytes_are_copied(cuda):
    """The bulk copies need rows that start on 16 bytes: a view that starts
    elsewhere gives what its aligned copy gives."""
    cfg = dataclasses.replace(C.MFCC13_HTK, matmul_precision="bf16x3")
    base = _spectrum(cfg, 70, cuda, seed=8).reshape(-1)
    x = base[1: 1 + 69 * cfg.n_bins].reshape(69, cfg.n_bins)
    assert x.data_ptr() % 16
    got = staged.mel_log_dct(x, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, staged.mel_log_dct(x.clone(), cfg))


@pytest.mark.parametrize("route", [dict(gemm_dft=True), {}],
                         ids=["K3", "K4"])
@pytest.mark.parametrize("name", ["mfcc13", "whisper80"])
def test_staged_extract_on_card_matches_golden(cuda, name, route):
    cfg = dataclasses.replace(CFGS[name], use_pallas=True,
                              matmul_precision="bf16x3", **route)
    count = "dft_mel_log_dct_mma_launches" if route \
        else "mel_log_dct_launches"
    lengths = np.array([48000, 30001, 7777])
    x = (np.random.default_rng(2).standard_normal((3, 48000)) * 0.1
         ).astype(np.float32)
    before = getattr(staged, count)
    res = features.extract(x, lengths, cfg, device="cuda")
    assert getattr(staged, count) == before + 1
    assert res.features.device.type == "cuda"
    for i, L in enumerate(lengths):
        gold = cpu.extract(x[i, :L].astype(np.float64), CFGS[name])
        nf = int(res.num_frames[i])
        assert nf == gold.shape[0]
        assert _rel_err(res.features[i, :nf].cpu(), torch.from_numpy(gold)) \
            <= 1e-3


def _stream(cfg, x, sizes):
    fe = streaming.StreamingFrontend(cfg, batch_size=x.shape[0],
                                     device="cuda")
    outs, pos = [], 0
    for c in sizes:
        outs.append(fe.process(x[:, pos: pos + c])[0])
        pos += c
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("name", sorted(STATIC))
def test_hop_aligned_plans_are_bitwise_on_card(cuda, name, precision):
    """Every hop-aligned plan of the static step is bitwise the same, and
    equal to extract_scan: a stream's frames share tiles with other streams'
    on the tensor-core kernel, whose rows do not depend on their tile."""
    cfg = dataclasses.replace(C.MFCC13_HTK, matmul_precision=precision,
                              **STATIC[name])
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(4, 16000, generator=g, device="cuda") * 0.1
    a = _stream(cfg, x, [1600] * 10)
    for plan in ([4800, 1600, 1600, 8000], [160] * 40 + [9600],
                 [320] * 50):
        assert torch.equal(_stream(cfg, x, plan), a)
    assert torch.equal(streaming.extract_scan(x, cfg, 1600), a)
    assert torch.equal(streaming.extract_scan(x, cfg, 4800), a)
    one = features.extract(x, cfg=cfg).features
    assert _rel_err(a, one) <= 1e-5


def test_k4_route_plans_agree_on_card(cuda):
    cfg = dataclasses.replace(C.MFCC13_HTK, use_pallas=True)
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn(4, 16000, generator=g, device="cuda") * 0.1
    before = staged.mel_log_dct_launches
    a = _stream(cfg, x, [1600] * 10)
    assert staged.mel_log_dct_launches == before + 10
    assert _rel_err(_stream(cfg, x, [4800, 1600, 1600, 8000]), a) <= 1e-5
    assert _rel_err(streaming.extract_scan(x, cfg, 1600), a) <= 1e-5


@pytest.mark.parametrize("kernel", ["dft_mel_log_dct", "mel_log_dct"])
def test_unbuildable_source_raises(cuda, kernel, tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cu").write_text("this is not CUDA C++;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    x = _kernel_input(kernel, C.MFCC13_HTK, 4, cuda)
    count = _count(kernel)
    before = getattr(staged, count)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        getattr(staged, kernel)(x, C.MFCC13_HTK)
    assert getattr(staged, count) == before
