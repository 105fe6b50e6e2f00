"""The signal kernel's plain twin against the Pallas kernel it replaces.

``tpufeat.pallas.fused.signal_features`` runs in Pallas interpret mode on
the CPU with matmul_precision="highest", in both TPU layouts: n_frames 127
takes the v4 hop-split body, 128 and 129 the v5 phase-packed body, and
``layout="v4"`` pins v4 at 129 (hop 100 is not phase-eligible: always v4).

Tolerance: <= 1e-4 abs on broadband noise. The interpreter computes
"highest" in f32; the twin computes it as the TPU does, six bf16 passes,
whose products keep all 24 bits of each operand, so the two differ by
their sums' order and the last bits the split drops (about 1e-6 scaled).
"""

import dataclasses

import hypothesis
import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufeat.config import FeatureConfig as JConfig
from tpufeat.config import MFCC13_HTK as J_MFCC13, WHISPER80 as J_WHISPER80
from tpufeat.pallas import fused

from tpufeat_torch.config import from_reference
from tpufeat_torch.kernels import _tolerance as tolerance, signal

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
    before = signal.mma_launches
    out = signal.signal_features(buf, 40, cfg)
    assert signal.mma_launches == before
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


# ---------------------------------------------------------------------------
# bf16x3 and default: the twin of the tensor-core kernel
# ---------------------------------------------------------------------------
# bf16x3 is the same function in both packages (three bf16 products at every
# product, exact in f32, summed in f32), so the twin is held to the Pallas
# kernel at 1e-4 relative to max(1, |want|), and to the float64 golden at
# 5e-4 scaled, as tests/test_kernel_v4.py holds the JAX kernel. Not 1e-4
# abs: hi + lo keeps 16-17 bits of each operand, so where the two sum z in
# another order the dropped residual of z*z's split moves by up to 2^-17 of
# the term, and lifter 22's factor of 12 takes that to 1.2e-4 abs (9e-6
# scaled) on the magnitude config. The CPU interpreter computes
# Precision.DEFAULT in f32, so it is no oracle for "default": the one-pass
# twin is held to the golden at 0.1 (tests/test_kernel_v4.py's bound) and to
# a numpy one-pass computation (tests/_one_pass.py) within the flips the two
# sum orders allow (tolerance.twin_tolerance).

import math  # noqa: E402

import _one_pass  # noqa: E402
from conftest import make_signal  # noqa: E402
from tpufeat import features as jfeatures  # noqa: E402
from tpufeat.reference import cpu as jcpu  # noqa: E402
from tpufeat_torch import features  # noqa: E402

FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True)


def _port(jcfg, **flags):
    return dataclasses.replace(from_reference(dataclasses.asdict(jcfg)),
                               **flags)


@pytest.mark.parametrize("n_frames,layout", [(127, "auto"), (128, "auto"),
                                             (129, "auto"), (129, "v4")])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_bf16x3_twin_matches_pallas_kernel(name, n_frames, layout):
    jcfg = dataclasses.replace(CFGS[name], matmul_precision="bf16x3")
    buf = _buf(jcfg, n_frames, seed=3)
    want = np.asarray(fused.signal_features(jnp.asarray(buf), n_frames,
                                            jcfg, layout=layout))
    got = signal.signal_features_reference(torch.from_numpy(buf), n_frames,
                                           _port(jcfg))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4 * max(
        1.0, np.abs(want).max())


@pytest.mark.parametrize("name", ["mfcc13", "whisper80", "kaldi_fold",
                                  "magnitude_lifter"])
def test_bf16x3_extract_matches_golden(name):
    jcfg = CFGS[name]
    sig = make_signal(16000, seed=10)
    res = features.extract(sig, cfg=_port(jcfg, matmul_precision="bf16x3",
                                          **FUSED), device="cpu")
    gold = jcpu.extract(sig.astype(np.float64), jcfg)
    err = np.abs(res.features.numpy() - gold).max() / max(
        1.0, np.abs(gold).max())
    assert err < 5e-4


@pytest.mark.parametrize("name", sorted(CFGS))
def test_default_twin_matches_golden_and_one_pass_oracle(name):
    jcfg = CFGS[name]
    cfg = _port(jcfg, matmul_precision="default")
    sig = make_signal(8000, seed=18)
    res = features.extract(sig, cfg=dataclasses.replace(cfg, **FUSED),
                           device="cpu")
    gold = jcpu.extract(sig.astype(np.float64), jcfg)
    if name in ("mfcc13", "whisper80"):       # the main path's presets
        assert np.abs(res.features.numpy() - gold).max() < 0.1
    buf = _buf(jcfg, 70, seed=4)
    frames = _one_pass.frames_of(buf, 70, cfg)
    want = torch.from_numpy(_one_pass.features(frames, cfg))
    got = signal.signal_features_reference(torch.from_numpy(buf), 70, cfg)
    tolerance.compare_to_twin(got, want, torch.from_numpy(frames), cfg,
                           what=name)


def emulate_passes(a: torch.Tensor, w: tuple, n_passes: int) -> torch.Tensor:
    """a @ W as the tensor-core kernels run it: a split into its pieces
    (signal.split_pieces) against W's packed pieces ``w``, the products
    as f32 in signal.PASS_ORDER."""
    pa = [t.float() for t in signal.split_pieces(a, len(w))]
    out = 0
    for i, j in signal.PASS_ORDER[:n_passes]:
        out = out + pa[i] @ w[j].float()
    return out


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("name", sorted(CFGS) + ["whisper128", "mel160"])
def test_mma_constants_emulate_the_twin(name, precision):
    """The tensor-core kernel's data flow on its packed constants
    (signal.mma_constants: pair-ordered, padded, split into the pieces of
    the precision's passes), emulated with f32 products: the twin's
    features within its tolerance. Checks the host side of the kernel
    where no card is."""
    base = {"whisper128": J_WHISPER80, "mel160": J_MFCC13}.get(name)
    base = base or CFGS[name]
    cfg = _port(base, matmul_precision=precision)
    if name in ("whisper128", "mel160"):
        cfg = dataclasses.replace(cfg, n_mels=int(name[-3:]))
    n_passes = signal.passes(cfg)
    cs, fb, dct = signal.mma_constants(cfg)
    assert len(cs) == len(fb) == signal.PIECES[n_passes]
    fl, nc, nm = cfg.frame_length, 2 * cfg.n_bins - 2, cfg.n_mels
    assert cs[0].shape == (-(-fl // signal.MMA_DEPTH) * signal.MMA_DEPTH,
                           -(-nc // signal.MMA_COLS) * signal.MMA_COLS)
    assert fb[0].shape == (cs[0].shape[1], -(-nm // 8) * 8)
    buf = torch.from_numpy(_buf(base, 70, seed=5))
    fr = torch.from_numpy(_one_pass.frames_of(buf.numpy(), 70, cfg))
    x = torch.zeros(*fr.shape[:-1], cs[0].shape[0])
    x[..., :fl] = fr

    z = emulate_passes(x, cs, n_passes)[..., :nc].unflatten(-1, (nc // 2, 2))
    re, im = z[..., 0], z[..., 1]
    if cfg.spectrum == "power":
        spec = torch.stack([re * re, im * im], -1)
    else:
        first = torch.zeros_like(re, dtype=torch.bool)
        first[..., 0] = True
        spec = torch.stack([
            torch.where(first, torch.sqrt(re * re),
                        torch.sqrt(re * re + im * im)),
            torch.where(first, torch.sqrt(im * im), torch.zeros_like(im))],
            -1)
    mel = emulate_passes(spec.flatten(-2), tuple(t[:nc] for t in fb),
                         n_passes)[..., :nm]
    got = signal.log_tail(mel, None, cfg)
    if dct is not None:
        got = emulate_passes(got, dct, n_passes)
    want = signal.signal_features_reference(buf, 70, cfg)
    tolerance.compare_to_twin(got, want, fr, cfg, what=name)


def test_split_and_pair_order():
    """split_bf16 rounds to nearest even as the numpy bit rounding does, and
    hi + lo keeps 16 bits; pair_order is a permutation with each bin's Re
    and Im side by side."""
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(4096)
                         .astype(np.float32) * 10.0 ** np.arange(-4, 4)
                         .repeat(512).astype(np.float32))
    hi, lo = signal.split_bf16(x)
    np.testing.assert_array_equal(hi.double().numpy(),
                                  _one_pass.bf16(x.numpy()))
    rest = (x.double() - hi.double() - lo.double()).abs()
    assert (rest <= 2.0 ** -16 * x.double().abs()).all()
    order = signal.pair_order(257)
    assert sorted(order) == list(range(512))
    assert list(order[:4]) == [0, 256, 1, 257]
    assert all(order[2 * k + 1] == order[2 * k] + 256
               for k in range(1, 256))


# f32 of exponent -110 to 127: lo's last bit (2^-23 of x's exponent) is then
# a bf16 value, past 2^-133 only bf16's subnormals would drop it
_SPLIT3_RANGE = dict(min_value=2.0 ** -110, max_value=2.0 ** 127,
                     allow_subnormal=False, width=32)


@hypothesis.settings(max_examples=200, deadline=None)
@hypothesis.given(st.lists(st.floats(**_SPLIT3_RANGE), min_size=1,
                           max_size=64),
                  st.lists(st.booleans(), min_size=64, max_size=64))
def test_split3_bf16_is_exact(values, negative):
    """split3_bf16: each piece is a bf16 value, and hi + mid + lo is x
    exactly (in float64) for f32 x in the normal range; each piece is at
    most half an ulp of the one before."""
    x = torch.tensor([-v if s else v for v, s in zip(values, negative)],
                     dtype=torch.float32)
    hi, mid, lo = signal.split3_bf16(x)
    for piece in (hi, mid, lo):
        assert piece.dtype == torch.bfloat16
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert torch.equal(torch.from_numpy(_one_pass.bf16(x.numpy())),
                       hi.double())
    for big, small in ((hi, mid), (mid, lo)):
        assert bool((small.double().abs()
                     <= big.double().abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
def test_mel_limit_of_the_tensor_core_kernel(precision):
    """No precision limits n_mels: past one slab of MMA_MEL_SLAB bands (the
    tensor-core kernel runs them slab by slab) the twin computes what the
    JAX package computes ("highest", bf16x3), or the numpy one-pass oracle
    (default), for MFCCs and for the log-mel."""
    for n_mels, n_mfcc in ((signal.MMA_MEL_SLAB + 32, 13),
                           (signal.MMA_MEL_SLAB + 8, 0)):
        jcfg = dataclasses.replace(J_MFCC13, matmul_precision=precision,
                                   n_mels=n_mels, n_mfcc=n_mfcc)
        cfg = _port(jcfg)
        buf = _buf(jcfg, 40, seed=11)
        got = signal.signal_features(torch.from_numpy(buf), 40, cfg)
        assert got.shape == (2, 40, n_mfcc or n_mels)
        if precision == "default":
            frames = _one_pass.frames_of(buf, 40, cfg)
            tolerance.compare_to_twin(
                got, torch.from_numpy(_one_pass.features(frames, cfg)),
                torch.from_numpy(frames), cfg, what=f"{n_mels} mels")
        else:
            want = np.asarray(fused.signal_features(jnp.asarray(buf), 40,
                                                    jcfg))
            assert np.abs(got.numpy() - want).max() <= 1e-4 * max(
                1.0, np.abs(want).max())


def _default_case(n_frames=200):
    cfg = _port(J_MFCC13, matmul_precision="default")
    buf = torch.from_numpy(_buf(J_MFCC13, n_frames, seed=12))
    frames = _one_pass.frames_of(buf.numpy(), n_frames, cfg)
    return cfg, buf, frames


@pytest.mark.parametrize("fault", ["none", "pass_swap", "one_window"])
def test_default_check_counts_frames(fault):
    """At default the flip bound is loose, so the check counts frames: a
    sound one-pass computation in another sum order (the numpy oracle)
    passes, while the bf16x3 result held as the default one (a pass swap),
    or one window of FLIP_WINDOW frames moved by half the tolerance,
    stays inside the bound and fails on the count."""
    cfg, buf, frames = _default_case()
    want = signal.signal_features_reference(buf, 200, cfg)
    fr = torch.from_numpy(frames)
    if fault == "none":
        got = torch.from_numpy(_one_pass.features(frames, cfg))
    elif fault == "pass_swap":
        got = signal.signal_features_reference(
            buf, 200, dataclasses.replace(cfg, matmul_precision="bf16x3"))
    else:
        tol = tolerance.twin_tolerance(want, fr, cfg)
        got = want.double().clone()
        tm = tolerance.FLIP_WINDOW
        got[1, 64: 64 + tm] += 0.5 * tol[1, 64: 64 + tm]
    if fault == "none":
        agreement = tolerance.compare_to_twin(got, want, fr, cfg)
        assert agreement.worst_window <= tolerance.FLIP_FRAMES
        return
    assert bool(((got.double() - want.double()).abs()
                 <= tolerance.twin_tolerance(want, fr, cfg)).all())
    with pytest.raises(AssertionError, match="consecutive frames"):
        tolerance.compare_to_twin(got, want, fr, cfg)


def test_frames_past_windows():
    """Frames are counted in windows of FLIP_WINDOW rows, the last one
    partial; a frame counts once however many of its outputs are past."""
    tm = tolerance.FLIP_WINDOW
    err = torch.zeros(2 * tm + 5, 3)
    err[[0, 1, tm + 3], :] = 1.0
    err[2 * tm + 1, 0] = err[2 * tm + 4, 2] = 1.0
    share, window = tolerance.frames_past(err, 0.5)
    assert share == pytest.approx(5 / (2 * tm + 5))
    assert window == 2
    assert tolerance.frames_past(err.reshape(1, -1, 3), 2.0) == (0.0, 0)


def test_one_pass_bound_terms():
    """One bf16 flip of z*z moves a natural log by <= 2^-7 and a log10 by
    2^-7 / ln 10; with a DCT, a flip of the log-mel adds one bf16 ulp of it
    through |dct_hi|. The sum-order bound of a log-mel is relative: the
    same for a frame 1024 times louder."""
    lm = torch.tensor([[0.75, -3.0, 9.0]])
    nat = _port(J_MFCC13, n_mels=3, n_mfcc=0)
    torch.testing.assert_close(tolerance.one_pass_bound(lm, nat),
                               torch.full((1, 3), 2.0 ** -7,
                                          dtype=torch.float64))
    l10 = dataclasses.replace(nat, log="log10")
    assert tolerance.one_pass_bound(lm, l10).max().item() == pytest.approx(
        2.0 ** -7 / math.log(10.0))
    mfcc = dataclasses.replace(nat, n_mfcc=2)
    ulp = torch.tensor([2.0 ** -8, 2.0 ** -6, 2.0 ** -4],
                       dtype=torch.float64)
    dct = signal.split_bf16(torch.tensor(signal.dct_constant(mfcc)))[0]
    torch.testing.assert_close(tolerance.one_pass_bound(lm, mfcc)[0],
                               (2.0 ** -7 + ulp) @ dct.double().abs())
    cfg = _port(J_MFCC13, matmul_precision="bf16x3", n_mfcc=0)
    loud = torch.from_numpy(_buf(J_MFCC13, 5, batch=1)[0, :2 * 400]
                            ).reshape(2, 400)
    quiet = tolerance.sum_order_bound(tolerance.twin_stages(loud, cfg, True), cfg)
    louder = tolerance.sum_order_bound(
        tolerance.twin_stages(loud * 1024.0, cfg, True), cfg)
    torch.testing.assert_close(louder, quiet, rtol=1e-6, atol=0.0)


def test_bf16x3_extract_matches_tpufeat_bf16x3():
    """One call through both packages' fused path at bf16x3, on the CPU."""
    jcfg = dataclasses.replace(J_MFCC13, matmul_precision="bf16x3", **FUSED)
    sig = make_signal(12000, seed=19)
    want = np.asarray(jfeatures.extract(sig, cfg=jcfg).features)
    got = features.extract(sig, cfg=_port(jcfg), device="cpu").features
    assert np.abs(got.numpy() - want).max() <= 1e-4 * max(
        1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# the wgmma kernel's host side: packed constants and the tile plan
# ---------------------------------------------------------------------------

PACKED = {
    "mfcc13": J_MFCC13,
    "whisper80": J_WHISPER80,
    "magnitude_lifter": CFGS["magnitude_lifter"],
    # frame_length 403: not a multiple of 16, so CS's last slice is partial
    "fl403": JConfig(frame_length=403, n_fft=512),
    # 200 bands: two slabs of MMA_MEL_SLAB
    "mel200": JConfig(n_mels=200, n_mfcc=0),
}


def _unswizzle(blocks: torch.Tensor) -> torch.Tensor:
    """[..., n * 64] packed blocks -> [..., n, 64] by the swizzle's byte
    rule: element (n, k) sits at n * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8."""
    rows = blocks.shape[-1] // 64
    n = torch.arange(rows)[:, None]
    k = torch.arange(64)[None, :]
    at = (n * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8).reshape(-1)
    return blocks[..., at].reshape(*blocks.shape[:-1], rows, 64)


@pytest.mark.parametrize("precision", ["highest", "bf16x3", "default"])
@pytest.mark.parametrize("name", sorted(PACKED))
def test_mma_blocks_unswizzle_to_mma_constants(name, precision):
    """Every packed block of CS and FB (signal.mma_blocks), unswizzled by
    the byte rule, is its slice of the plain pieces of
    signal.mma_constants: a CS block (chunk c, slice j, half h, piece q)
    holds CS[q][64j + k, 128c + 64h + n] at (n, k), the halves of a piece
    side by side; an FB block (slab s,
    block d, piece q) holds fb[q][64d + k, 128s + n], zeros past n_mels."""
    cfg = _port(PACKED[name], matmul_precision=precision)
    cs, fb, dct = signal.mma_constants(cfg)
    cs_blocks, fb_blocks, dct_blocks = signal.mma_blocks(cfg)
    n_pieces = signal.PIECES[signal.passes(cfg)]
    depth, cols = cs[0].shape
    assert depth % signal.MMA_DEPTH == 0 and cols % signal.MMA_COLS == 0
    assert cs_blocks.dtype == fb_blocks.dtype == torch.bfloat16
    assert cs_blocks.shape == (cols // signal.MMA_COLS,
                               depth // signal.MMA_DEPTH, n_pieces, 2,
                               64 * 64)
    got = _unswizzle(cs_blocks)               # [c, j, q, h, n, k]
    want = torch.stack(cs).reshape(n_pieces, depth // 64, 64,
                                   cols // 128, 2, 64)   # [q, j, k, c, h, n]
    assert torch.equal(got, want.permute(3, 1, 0, 4, 5, 2))
    slabs = -(-cfg.n_mels // signal.MMA_MEL_SLAB)
    assert fb_blocks.shape == (slabs, cols // 64, n_pieces, 128 * 64)
    got = _unswizzle(fb_blocks)               # [s, d, q, n, k]
    for q in range(n_pieces):
        plain = torch.zeros(cols, slabs * 128, dtype=torch.bfloat16)
        plain[:, : fb[q].shape[1]] = fb[q]
        for s in range(slabs):
            for d in range(cols // 64):
                assert torch.equal(
                    got[s, d, q],
                    plain[64 * d: 64 * d + 64, 128 * s: 128 * s + 128].T)
    assert (dct_blocks is None) == (dct is None)
    assert all(torch.equal(a, b) for a, b in zip(dct_blocks or (), dct or ()))


# (batch, short of the last frame's end, n_frames, hop, frame_length,
# passes): the dual's hop 160; hop 100, not a multiple of 8; rows of a few
# frames, so tiles cross rows of buf (a streaming step's 10 a row, and 1);
# frames past M; K3's rows (hop = frame_length, 403 not a multiple of 16)
# as spans at one pass and frame by frame at three and six (but for a last
# tile of 44 rows, whose span fits)
PLANS = {
    "hop160": (3, 5, 200, 160, 400, 3),
    "hop100": (2, 0, 150, 100, 300, 6),
    "stream_rows": (40, 0, 10, 160, 400, 3),
    "one_frame_rows": (300, 0, 1, 160, 400, 1),
    "past_m": (2, 2000, 140, 160, 400, 1),
    "k3_spans": (1, 0, 300, 403, 403, 1),
    "k3_frames": (1, 0, 300, 403, 403, 3),
    "k3_frames_f32": (1, 0, 256, 400, 400, 6),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_tile_plan_stages_every_frame(name):
    """The kernel's tile plan (signal.tile_plan, staged_rows): for every
    tile, which samples it stages and where each frame starts in the
    planes give back every frame of the twin's framing (zeros past M), the
    columns at or past frame_length zero; spans start at multiples of 8
    samples, one after the other, and fit beside the last frame's 16-deep
    step, or the tile goes frame by frame."""
    batch, short, n_frames, hop, fl, n_passes = PLANS[name]
    M = (n_frames - 1) * hop + fl - short
    buf = (np.random.default_rng(20).standard_normal((batch, M))
           .astype(np.float32))
    frames = signal.framing.frames_from_buffer(
        torch.from_numpy(buf), n_frames, fl, hop).reshape(-1, fl).numpy()
    tm = signal.MMA_TILE_FRAMES
    tiles = -(-batch * n_frames // tm)
    modes = set()
    for tile in range(tiles):
        plan = signal.tile_plan(batch, M, n_frames, hop, fl, tile, n_passes)
        assert plan.valid == min(tm, batch * n_frames - tile * tm)
        rows = signal.staged_rows(buf, n_frames, hop, fl, tile, n_passes)
        assert rows.shape == (tm, -(-fl // 16) * 16)
        np.testing.assert_array_equal(
            rows[: plan.valid, :fl], frames[tile * tm: tile * tm + plan.valid])
        assert not rows[:, fl:].any()
        modes.add("frames" if plan.window else "spans")
        if plan.window:
            assert plan.window % signal.MMA_DEPTH == 0
            assert tm * (plan.window + 8) <= signal.SPAN_SAMPLES[n_passes]
            continue
        offsets = [o for _, _, o, _ in plan.spans]
        ends = [o + n for _, _, o, n in plan.spans]
        assert offsets == [0] + ends[:-1]
        assert all(o % 8 == 0 for o in offsets)
        assert ends[-1] + 16 <= signal.SPAN_SAMPLES[n_passes]
        if hop % 8 == 0:
            assert (plan.bases % 8 == 0).all()
    want = {"k3_frames": {"frames", "spans"}, "k3_frames_f32": {"frames"}}
    assert modes == want.get(name, {"spans"})
