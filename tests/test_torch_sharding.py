"""The port's multi-device extraction (``tpufeat_torch.sharding``) as an
8-rank gloo group on the CPU against ``tpufeat.sharding`` on conftest's 8
fake JAX devices, and against the port's own unsharded ``extract``, on the
same numpy inputs from a seed; the cases follow ``tests/test_sharding.py``
(time sharding for MFCC-13, Whisper, Kaldi-39, delta order 3, PLP, GFCC,
the padded tail and GEMM DFT; the 2-D mesh; dp with sliding CMVN, GFCC
and PNCC; pitch dp), plus the fused route (K1's twin on the CPU) sharded.
The ranks run once per module (``multichip.spawn`` over a file store, so
no TCP port can collide between test workers); the tests compare what
rank 0 returned. The one-rank case and the refusals run in this process,
where no process group exists.

Tolerances: against the reference 1e-4 scaled by max(1, |want|.max()), as
``tests/test_torch_extract.py`` holds the port against ``tpufeat.extract``
(the two frameworks' f32 products in another order); against the port's
unsharded ``extract``: equal bit for bit without CMVN (every halo is an
exact copy, each frame's arithmetic is the same and a max is
order-free), within 2e-5 scaled with CMVN (its sums reassociated over the
ranks, ``__graft_entry__.py``'s bound) and for PLP and PNCC: their power
laws (``x ** c``) take another rounding for the elements of a CPU tensor
past its last full vector, so where a frame falls in a call moves its last
bits (measured 1.6e-6 for PLP, 4.8e-7 for PNCC).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from tpufeat import pitch as jpitch
from tpufeat import sharding as jsharding
from tpufeat import config as jconfig

from tpufeat_torch import config, extract, io, pipeline, pitch, sharding
from tpufeat_torch.multichip import spawn

from conftest import make_signal
import _torch_dist_cases

RANKS = 8
TOL_REF = 1e-4
TOL_CMVN = 2e-5
FUSED = dict(use_pallas=True, gemm_dft=True, fused_framing=True)


def _both(name, **kw):
    """(port config, reference config) of a preset with ``kw`` replaced."""
    return (dataclasses.replace(getattr(config, name), **kw),
            dataclasses.replace(getattr(jconfig, name), **kw))


def _padded_tail():
    raw = make_signal(51203, seed=93)
    cfg, _ = _both("KALDI39", cmvn="meanvar")
    padded = np.zeros(sharding.shardable_length(len(raw), cfg, RANKS),
                      np.float32)
    padded[: len(raw)] = raw
    return padded, len(raw)


def _ragged_batch(cfg, n_time):
    n = sharding.shardable_length(4 * 16000, cfg, n_time)
    sigs, lens = [], []
    for b in range(4):
        raw = make_signal(n - 531 * b, seed=170 + b)
        lens.append(len(raw))
        sigs.append(np.pad(raw, (0, n - len(raw))))
    return np.stack(sigs), np.array(lens)


def _cases() -> dict:
    """name -> (kind, port config, reference config, args, kwargs)."""
    out = {}
    for name, preset, kw, seconds, seed in (
            ("time_mfcc13", "MFCC13_HTK", {}, 2, 90),
            ("time_whisper80", "WHISPER80", {}, 2, 91),
            ("time_kaldi39", "KALDI39", {}, 2, 92),
            ("time_delta_order3", "KALDI39", dict(delta_order=3), 2, 93),
            ("time_plp13", "PLP13", {}, 2, 94),
            ("time_gfcc13", "GFCC13", {}, 2, 95),
            ("time_gemm_dft", "MFCC13_HTK", dict(gemm_dft=True), 2, 95),
            ("time_fused_mfcc13", "MFCC13_HTK", FUSED, 1, 200),
            ("time_fused_whisper80", "WHISPER80", FUSED, 1, 201),
            ("time_fused_kaldi39", "KALDI39", FUSED, 1, 202),
            ("time_fused_kaldi_mode", "MFCC13_HTK",
             dict(kaldi_mode=True, window="povey", **FUSED), 1, 203)):
        cfg, jcfg = _both(preset, **kw)
        n = sharding.shardable_length(seconds * 16000, cfg, RANKS)
        out[name] = ("time", cfg, jcfg, (make_signal(n, seed=seed),), {})
    padded, length = _padded_tail()
    out["time_padded_tail"] = ("time", *_both("KALDI39", cmvn="meanvar"),
                               (padded,), dict(length=length))
    x, lens = _ragged_batch(config.KALDI39, RANKS // 2)
    out["mesh_kaldi39"] = ("batch_time", *_both("KALDI39"), (x, lens), {})
    n = sharding.shardable_length(16000, config.WHISPER80, RANKS // 2)
    xw = np.stack([make_signal(n, seed=180 + b) for b in range(2)])
    out["mesh_whisper80"] = ("batch_time", *_both("WHISPER80"),
                             (xw, np.full((2,), n)), {})
    out["mesh_fused_mfcc13"] = ("batch_time", *_both("MFCC13_HTK", **FUSED),
                                (xw, np.full((2,), n)), {})
    B = 2 * RANKS
    sigs = np.stack([make_signal(16000, seed=100 + i) for i in range(B)])
    lengths = np.full((B,), 16000, np.int32)
    lengths[1] = 9000
    out["dp_mfcc13"] = ("dp", *_both("MFCC13_HTK"), (sigs, lengths), {})
    sl = np.full((RANKS,), 16000, np.int32)
    sl[2] = 11000
    out["dp_sliding_cmvn"] = ("dp", *_both(
        "KALDI39", cmvn="sliding", cmvn_window=80, cmvn_min_window=20),
        (sigs[:RANKS], sl), {})
    for preset in ("GFCC13", "PNCC13"):
        out[f"dp_{preset.lower()}"] = ("dp", *_both(preset), (
            sigs[:RANKS], np.full(RANKS, 16000, np.int32)), {})
    t = np.arange(9600) / 16000.0
    xp = np.stack([(0.3 * np.sin(2 * np.pi * (100.0 + 15.0 * b) * t))
                   .astype(np.float32) for b in range(RANKS)])
    out["pitch_dp"] = ("pitch_dp", pitch.PitchConfig(), jpitch.PitchConfig(),
                       (xp, np.full((RANKS,), 9600, np.int32)), {})
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eleven PCM16 WAVs over three length buckets."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(5)
    for i, n in enumerate([16000, 9000, 20000, 12000, 30000, 4000, 17000,
                           15000, 8000, 22000, 11000]):
        io.write_wav(str(root / f"u{i:02d}.wav"),
                     (0.1 * rng.standard_normal(n)).astype(np.float32),
                     16000)
    return str(root)


@pytest.fixture(scope="module")
def ranks(corpus):
    """Every case through the 8 ranks at once: rank 0's results by name.
    The corpus pass runs with batches of 3 rows (padded to 8, one a
    rank) and of 5."""
    port_cases = {name: (kind, args, dict(kw, cfg=cfg))
                  for name, (kind, cfg, _, args, kw) in CASES.items()}
    for batch in (3, 5):
        port_cases[f"corpus_{batch}"] = ("corpus", (corpus, config.KALDI39,
                                                    batch), {})
    return spawn(_torch_dist_cases.sharding_cases, RANKS, port_cases,
                 device="cpu")[0]


@pytest.mark.parametrize("batch", [3, 5])
def test_corpus_dp_matches_one_rank(ranks, corpus, batch):
    """``extract_corpus(dp=True)`` over 8 ranks: rank 0 yields every
    utterance, the others none, each row equal bit for bit to the
    one-process pass's (each row's arithmetic alone; CMVN per row)."""
    rows, counts = ranks[f"corpus_{batch}"]
    assert counts == [11] + [0] * (RANKS - 1)
    want = dict(pipeline.extract_corpus(corpus, config.KALDI39, batch,
                                        device="cpu"))
    assert list(rows) == list(want)
    for key in want:
        np.testing.assert_array_equal(rows[key], want[key])


def _reference(name):
    kind, _, jcfg, args, kw = CASES[name]
    if kind == "time":
        return np.asarray(jsharding.extract_time_sharded(*args, jcfg, **kw))
    if kind == "pitch_dp":
        return tuple(map(np.asarray, jsharding.pitch_features_data_parallel(
            *args, jcfg)))
    if kind == "batch_time":
        mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(2, -1),
                    ("dp", "time"))
        res = jsharding.extract_batch_time_sharded(*args, jcfg, mesh)
    else:
        res = jsharding.extract_data_parallel(*args, jcfg)
    return np.asarray(res.features), np.asarray(res.mask)


def _unsharded(name):
    """The port's one-process counterpart on the CPU."""
    kind, cfg, _, args, kw = CASES[name]
    if kind == "time":
        sig, length = args[0], kw.get("length", len(args[0]))
        return extract(sig[:length], cfg=cfg, device="cpu").features.numpy()
    if kind == "pitch_dp":
        return tuple(t.numpy() for t in pitch.pitch_features(
            *args, cfg, device="cpu"))
    if kind == "batch_time":
        x, lens = args
        rows = [extract(x[b, : lens[b]], cfg=cfg, device="cpu").features
                for b in range(len(x))]
        return [r.numpy() for r in rows]
    res = extract(*args, cfg, device="cpu")
    return res.features.numpy(), res.mask.numpy()


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(ranks, name):
    got, want = ranks[name], _reference(name)
    kind = CASES[name][0]
    if kind == "time":
        assert _scaled(got, want) <= TOL_REF
        return
    np.testing.assert_array_equal(got[1], want[1])      # mask / valid
    if kind == "batch_time":
        for b in range(len(got[0])):
            assert _scaled(got[0][b][got[1][b]],
                           want[0][b][want[1][b]]) <= TOL_REF, b
    else:
        assert _scaled(got[0], want[0]) <= TOL_REF


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_unsharded(ranks, name):
    """Bit for bit without CMVN, 2e-5 scaled with it (and for PLP and
    PNCC on the CPU)."""
    got, want = ranks[name], _unsharded(name)
    kind, cfg = CASES[name][:2]
    loose = getattr(cfg, "cmvn", "none") != "none" or \
        getattr(cfg, "pncc", False) or getattr(cfg, "plp_order", 0) > 0

    def same(a, b):
        if loose:
            assert _scaled(a, b) <= TOL_CMVN
        else:
            np.testing.assert_array_equal(a, b)

    if kind == "time":
        same(got, want)
    elif kind == "batch_time":
        for b, row in enumerate(want):
            same(got[0][b][got[1][b]], row)
    else:
        np.testing.assert_array_equal(got[1], want[1])
        same(got[0], want[0])


def test_one_rank_without_a_group():
    """No process group: one rank, the reference's one-device mesh."""
    sig = make_signal(16000, seed=94)
    got = sharding.extract_time_sharded(sig, config.MFCC13_HTK,
                                        device="cpu").numpy()
    mesh = jsharding.default_mesh("time", jax.devices()[:1])
    want = np.asarray(jsharding.extract_time_sharded(
        sig, jconfig.MFCC13_HTK, mesh=mesh))
    assert _scaled(got, want) <= TOL_REF
    np.testing.assert_array_equal(got, extract(
        sig, cfg=config.MFCC13_HTK, device="cpu").features.numpy())
    res = sharding.extract_data_parallel(sig[None], [16000],
                                         config.MFCC13_HTK, device="cpu")
    np.testing.assert_array_equal(res.features[0].numpy(), got)
    with pytest.raises(ValueError, match="no process group"):
        sharding.default_mesh()


@pytest.mark.parametrize("cfg,match", [
    (config.PNCC13, "PNCC"),
    (dataclasses.replace(config.KALDI39, cmvn="sliding"), "sliding"),
    (dataclasses.replace(config.WHISPER80, drop_last_frame=False),
     "centered"),
    (dataclasses.replace(config.MFCC13_HTK, dither=1.0), "generator")],
    ids=["pncc", "sliding_cmvn", "centered_last_frame", "dither"])
def test_time_sharding_refusals(cfg, match):
    sig = make_signal(sharding.shardable_length(2 * 16000, cfg, RANKS),
                      seed=98)
    with pytest.raises(ValueError, match=match):
        sharding.extract_time_sharded(sig, cfg, device="cpu")


def test_rejects_unshardable():
    with pytest.raises(ValueError, match="not shardable"):
        sharding.extract_time_sharded(np.zeros(1000 * RANKS + 7),
                                      config.MFCC13_HTK, device="cpu")
    with pytest.raises(ValueError, match="centered configs reflect"):
        sharding.extract_time_sharded(np.zeros(32000, np.float32),
                                      config.WHISPER80, length=31000,
                                      device="cpu")


def test_shardable_length_matches_reference():
    for n, cfg, jcfg in ((51203, config.KALDI39, jconfig.KALDI39),
                         (100, config.WHISPER80, jconfig.WHISPER80),
                         (16000 * 8, config.MFCC13_HTK, jconfig.MFCC13_HTK)):
        for shards in (1, 2, 3, 8):
            assert sharding.shardable_length(n, cfg, shards) == \
                jsharding.shardable_length(n, jcfg, shards)


def test_multichip_dry_run():
    """``python -m tpufeat_torch.multichip 4 --device cpu``: the dry run's
    every part (the 2-D mesh at 4 ranks, the dp steps against one rank's,
    dp i-vectors and PLDA) within its bound."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "tpufeat_torch.multichip",
                          "4", "--device", "cpu"], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    for line in ("dryrun 2-D row 1:", "dryrun xvector params:",
                 "dryrun PLDA scores:", "dryrun_multichip(4): OK"):
        assert line in out.stdout, out.stdout


@pytest.mark.parametrize("how,match", [
    ("raise", "rank 1 of 2 failed:(.|\n)*failed on purpose"),
    ("exit", "ranks \\[1\\] exited without a result")])
def test_spawn_reports_a_failed_rank(how, match):
    """A rank that raises, or dies without a result, stops ``spawn`` at
    once with the reason, the other rank ended (well inside the
    timeout)."""
    with pytest.raises(RuntimeError, match=match):
        spawn(_torch_dist_cases.fail_on_rank, 2, 1, how, device="cpu",
              timeout=100)
