"""The port's streaming front-end against itself, against one-shot
extraction and against ``tpufeat.streaming`` (Pallas in interpret mode).

Mirrors ``tests/test_streaming.py`` (TestEquivalence and
TestStreamingMechanics) and the front-end half of
``tests/test_stream_pool.py``.

Tolerances, relative to max(1, |reference|.max()):
- streaming vs one-shot, and across chunk plans whose step shapes differ:
  <= 1e-5 (``assert_stream_equal``). On the CPU the plain twins go through
  BLAS, whose blocking may depend on the row count, so plans with other
  step shapes may round differently in the last bits; carry or off-by-one
  faults give O(1) errors. The bitwise contract across hop-aligned plans is
  asserted on the card (``tests/test_torch_cuda_staged.py``).
- the same step shapes through different drivers (StreamingFrontend, the
  scan, ``extract_scan``): bitwise;
- the port vs ``tpufeat`` on the same chunks: <= 1e-5 (fp32 in both, sums
  in another order; the JAX side runs matmul_precision="highest").
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufeat import features as jfeat
from tpufeat import streaming as jstream
from tpufeat.config import PRESETS as JPRESETS

from tpufeat_torch import features, streaming
from tpufeat_torch.config import FeatureConfig, MFCC13_HTK, WHISPER80
from tpufeat_torch.config import from_reference

from conftest import make_signal

FLAGS = {
    "plain": {},
    "staged_k3": dict(use_pallas=True, gemm_dft=True),
    "staged_k4": dict(use_pallas=True),
    "fused": dict(use_pallas=True, gemm_dft=True, fused_framing=True),
}


def stream_extract(sig, cfg, chunk_sizes, batch=False):
    """Feed ``sig`` through StreamingFrontend.process with the given chunk
    sizes and concatenate the valid frames."""
    x = sig if batch else sig[None]
    fe = streaming.StreamingFrontend(cfg, batch_size=x.shape[0], device="cpu")
    outs, pos = [], 0
    for c in chunk_sizes:
        chunk = x[:, pos: pos + c]
        pos += c
        if chunk.shape[1] == 0:
            break
        feats, mask = fe.process(chunk)
        assert bool(mask.all())
        outs.append(feats)
    assert pos >= x.shape[1], "chunk plan must cover the signal"
    out = torch.cat(outs, dim=1).numpy()
    return out if batch else out[0]


def plan(total, size):
    out = [size] * (total // size)
    if total % size:
        out.append(total % size)
    return out


def one_shot(sig, cfg):
    return features.extract(sig, cfg=cfg, device="cpu").features.numpy()


def assert_stream_equal(chunked, one):
    assert chunked.shape == one.shape
    scale = max(np.abs(one).max(), 1.0)
    err = np.abs(chunked - one).max() / scale
    assert err < 1e-5, f"relative err {err}"


class TestEquivalence:
    @pytest.mark.parametrize("chunk", [160, 480, 1600, 4000])
    def test_uniform_chunks(self, chunk):
        sig = make_signal(16000, seed=40)
        assert_stream_equal(stream_extract(sig, MFCC13_HTK,
                                           plan(16000, chunk)),
                            one_shot(sig, MFCC13_HTK))

    def test_ragged_chunks(self):
        sig = make_signal(12003, seed=41)
        sizes = [7, 353, 1600, 159, 160, 161, 2048, 4000, 3515]
        assert sum(sizes) == 12003
        assert_stream_equal(stream_extract(sig, MFCC13_HTK, sizes),
                            one_shot(sig, MFCC13_HTK))

    @pytest.mark.parametrize("name", sorted(FLAGS))
    def test_flagged_streaming(self, name):
        cfg = dataclasses.replace(MFCC13_HTK, **FLAGS[name])
        sig = make_signal(8000, seed=42)
        assert_stream_equal(stream_extract(sig, cfg, plan(8000, 480)),
                            one_shot(sig, cfg))

    def test_kaldi_mode_streaming(self):
        cfg = FeatureConfig(kaldi_mode=True, dc_offset=True, window="povey")
        sig = make_signal(8000, seed=43)
        assert_stream_equal(stream_extract(sig, cfg, plan(8000, 1600)),
                            one_shot(sig, cfg))

    @pytest.mark.parametrize("flags", [{}, FLAGS["fused"]],
                             ids=["plain", "fused"])
    def test_use_energy_streaming(self, flags):
        """The fused static step falls back to the staged path for
        use_energy; the frame energy sums stay within 1e-5."""
        cfg = dataclasses.replace(MFCC13_HTK, use_energy=True, **flags)
        sig = make_signal(8000, seed=44)
        assert_stream_equal(stream_extract(sig, cfg, plan(8000, 1600)),
                            one_shot(sig, cfg))


class TestStreamingMechanics:
    def test_rejects_global_configs(self):
        with pytest.raises(ValueError):
            streaming.StreamingFrontend(WHISPER80)
        with pytest.raises(ValueError):
            streaming.StreamingFrontend(FeatureConfig(deltas=True))
        # PLP streams (its tail is frame-local); PNCC is refused as the
        # reference refuses it
        streaming.StreamingFrontend(FeatureConfig(
            n_mels=23, n_mfcc=0, log="none", plp_order=12), device="cpu")
        with pytest.raises(ValueError, match="PNCC"):
            streaming.StreamingFrontend(FeatureConfig(
                n_mels=40, n_mfcc=0, log="none", pncc=True), device="cpu")

    def test_batched_streams(self):
        sigs = np.stack([make_signal(4800, seed=50),
                         make_signal(4800, seed=51)])
        got = stream_extract(sigs, MFCC13_HTK, [4800], batch=True)
        for b in range(2):
            assert_stream_equal(got[b], one_shot(sigs[b], MFCC13_HTK))

    def test_scan_driver_matches_oneshot(self):
        sig = make_signal(16000, seed=52)
        chunks = torch.from_numpy(sig.reshape(10, 1, 1600))
        state = streaming.init_state(1, MFCC13_HTK, device="cpu")
        _, (feats, mask) = streaming.scan_chunks(state, chunks, MFCC13_HTK)
        got = feats[:, 0][mask[:, 0]].numpy()
        assert_stream_equal(got, one_shot(sig, MFCC13_HTK))

    def test_state_checkpoint_roundtrip(self, tmp_path):
        sig = make_signal(6400, seed=53)
        fe = streaming.StreamingFrontend(MFCC13_HTK, device="cpu")
        f1, _ = fe.process(sig[None, :3200])
        path = str(tmp_path / "state.npz")
        streaming.save_state(path, fe.state)
        fe2 = streaming.StreamingFrontend(MFCC13_HTK, device="cpu")
        fe2.state = streaming.load_state(path, fe2.state)
        f2, _ = fe2.process(sig[None, 3200:])
        got = torch.cat([f1[0], f2[0]]).numpy()
        assert_stream_equal(got, one_shot(sig, MFCC13_HTK))

    def test_bitwise_identical_chunkings(self):
        sig = make_signal(8000, seed=55)
        a = stream_extract(sig, MFCC13_HTK, plan(8000, 1600))
        b = stream_extract(sig, MFCC13_HTK, plan(8000, 1600))
        np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("name", ["plain", "fused"])
    def test_hop_aligned_plans(self, name):
        """Same step shapes through the frontend, extract_scan and the scan:
        bitwise. Other hop-aligned plans: within 1e-5 on the CPU (see the
        module docstring)."""
        cfg = dataclasses.replace(MFCC13_HTK, **FLAGS[name])
        sig = make_signal(16000, seed=56)
        a = stream_extract(sig, cfg, plan(16000, 1600))
        for other in ([4800, 1600, 1600, 8000], [160] * 40 + [9600],
                      plan(16000, 320)):
            assert_stream_equal(stream_extract(sig, cfg, other), a)
        es = streaming.extract_scan(sig, cfg, 1600, device="cpu").numpy()
        np.testing.assert_array_equal(es, a)
        chunks = torch.from_numpy(sig.reshape(10, 1, 1600))
        state = streaming.init_state(1, cfg, device="cpu")
        _, feats = streaming.make_scan_fn(cfg, 0)(state, chunks)
        np.testing.assert_array_equal(feats[0].numpy(), a)

    def test_large_chunk_plan_stays_equivalent(self):
        cfg = dataclasses.replace(MFCC13_HTK, **FLAGS["fused"])
        n = 51200                              # 318 frames in the big chunk
        sig = make_signal(n, seed=59)
        big = stream_extract(sig, cfg, [n])
        small = stream_extract(sig, cfg, plan(n, 3200))
        assert_stream_equal(big, small)
        es = streaming.extract_scan(sig, cfg, 3200, device="cpu").numpy()
        np.testing.assert_array_equal(es, small)   # same step shapes

    def test_extract_scan_matches_oneshot(self):
        sig = make_signal(12007, seed=57)
        es = streaming.extract_scan(sig, MFCC13_HTK, 1000,
                                    device="cpu").numpy()
        one = one_shot(sig, MFCC13_HTK)
        assert es.shape == one.shape
        assert_stream_equal(es, one)

    @pytest.mark.parametrize("name", sorted(FLAGS))
    def test_static_matches_dynamic_step(self, name):
        """Static step vs dynamic gather step: the same frames in, so valid
        outputs agree, and fill and carry are equal."""
        cfg = dataclasses.replace(MFCC13_HTK, **FLAGS[name])
        sig = make_signal(4000, seed=58)
        st_s = streaming.init_state(1, cfg, device="cpu")
        st_d = streaming.init_state(1, cfg, device="cpu")
        fill, pos = 0, 0
        for c in (1600, 480, 353, 1567):
            chunk = torch.from_numpy(sig[None, pos: pos + c])
            pos += c
            st_s, f_s = streaming.process_chunk_static(st_s, chunk, cfg, fill)
            st_d, (f_d, m_d) = streaming.process_chunk(st_d, chunk, cfg)
            fill = streaming.next_fill(fill, c, cfg)
            valid = f_d[0][m_d[0]].numpy()
            assert f_s.shape[1] == valid.shape[0]
            if valid.size:
                assert np.abs(f_s[0].numpy() - valid).max() < 1e-5
            assert torch.equal(st_s.fill, st_d.fill)
            assert torch.equal(st_s.buf[0, st_s.buf.shape[1] - fill:],
                               st_d.buf[0, st_d.buf.shape[1] - fill:])
            assert torch.equal(st_s.prev_raw, st_d.prev_raw)

    def test_fill_cycle_period(self):
        fills = streaming.fill_schedule(0, [1600] * 5, MFCC13_HTK)
        assert fills[1:] == [320] * 5
        w, p = streaming._find_cycle(
            streaming.fill_schedule(0, [480] * 20, MFCC13_HTK)[:-1])
        assert p == 1
        # C=165: period hop/gcd(165, hop) = 32 > max_period
        state = streaming.init_state(1, MFCC13_HTK, device="cpu")
        with pytest.raises(ValueError, match="period 32"):
            streaming.scan_chunks_static(state, torch.zeros(60, 1, 165),
                                         MFCC13_HTK)

    def test_state_setter_needs_one_shared_fill(self):
        fe = streaming.StreamingFrontend(MFCC13_HTK, batch_size=2,
                                         device="cpu")
        s = fe.state
        with pytest.raises(ValueError, match="fills must agree"):
            fe.state = s._replace(fill=torch.tensor([0, 160],
                                                    dtype=torch.int32))


def _run_plan(fe, x, plan_, reset_at=None, rows=(0,)):
    outs, pos = [], 0
    for i, c in enumerate(plan_):
        outs.append(fe.process(x[:, pos: pos + c])[0].numpy())
        pos += c
        if reset_at is not None and i == reset_at:
            fe.reset_rows(list(rows))
    return np.concatenate(outs, axis=1)


class TestFrontendResetRows:
    PLAN = [1600, 4800, 1600, 3200, 1600]

    def test_silence_prefix_exact_and_others_untouched(self):
        b = 2
        x = (np.random.default_rng(10).standard_normal((b, sum(self.PLAN)))
             * 0.1).astype(np.float32)
        ref = _run_plan(streaming.StreamingFrontend(MFCC13_HTK, b,
                                                    device="cpu"),
                        x, self.PLAN)
        fe = streaming.StreamingFrontend(MFCC13_HTK, b, device="cpu")
        got = _run_plan(fe, x, self.PLAN, reset_at=1)
        np.testing.assert_array_equal(got[1], ref[1])
        pre = sum(self.PLAN[:2])
        xz = x.copy()
        xz[0, :pre] = 0.0
        oracle = _run_plan(streaming.StreamingFrontend(MFCC13_HTK, b,
                                                       device="cpu"),
                           xz, self.PLAN)
        f_pre = MFCC13_HTK.num_frames(pre)
        np.testing.assert_array_equal(got[0, f_pre:], oracle[0, f_pre:])

    def test_reset_rows_keeps_schedule(self):
        fe = streaming.StreamingFrontend(MFCC13_HTK, 2, device="cpu")
        fe.process((np.random.default_rng(11).standard_normal((2, 1000))
                    * 0.1).astype(np.float32))
        fill = fe._fill
        fe.reset_rows([1])
        assert fe._fill == fill
        assert torch.equal(fe.state.fill, torch.full((2,), fill,
                                                     dtype=torch.int32))
        assert not fe.state.buf[1].any() and fe.state.buf[0].any()


# ---------------------------------------------------------------------------
# The port against tpufeat.streaming on the same chunks
# ---------------------------------------------------------------------------

def _cfgs(name):
    jcfg = dataclasses.replace(JPRESETS["mfcc13"], matmul_precision="highest",
                               **FLAGS[name])
    return jcfg, from_reference(dataclasses.asdict(jcfg))


def _scaled_err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / max(1.0, np.abs(want).max())


def _batch(n=4800, seed=60):
    return (np.random.default_rng(seed).standard_normal((2, n)) * 0.1
            ).astype(np.float32)


def _drive(mod, state, x, cfg, sizes, dynamic):
    """Run the static or the dynamic step of ``mod`` over ``sizes``;
    returns the valid frames of each row and the final state."""
    fill, pos, outs = 0, 0, []
    for c in sizes:
        chunk = x[:, pos: pos + c]
        pos += c
        if mod is jstream:
            chunk = jnp.asarray(chunk)
        else:
            chunk = torch.from_numpy(chunk)
        if dynamic:
            state, (f, m) = mod.process_chunk(state, chunk, cfg)
            f, m = np.asarray(f), np.asarray(m)
            outs.append(np.stack([f[b][m[b]] for b in range(len(f))]))
        else:
            state, f = mod.process_chunk_static(state, chunk, cfg, fill)
            outs.append(np.asarray(f))
        fill = mod.next_fill(fill, c, cfg)
    return np.concatenate(outs, axis=1), state


@pytest.mark.parametrize("driver", ["static_step", "dynamic_step",
                                    "scan_chunks_static", "extract_scan"])
@pytest.mark.parametrize("name", sorted(FLAGS))
def test_matches_tpufeat_streaming(name, driver):
    jcfg, cfg = _cfgs(name)
    x = _batch()
    if driver in ("static_step", "dynamic_step"):
        sizes = [1600, 353, 1247, 1600]
        dyn = driver == "dynamic_step"
        want, jst = _drive(jstream, jstream.init_state(2, jcfg), x, jcfg,
                           sizes, dyn)
        got, st = _drive(streaming,
                         streaming.init_state(2, cfg, device="cpu"), x, cfg,
                         sizes, dyn)
        for leaf, jleaf in zip(st, jst):
            assert leaf.numpy().dtype == np.asarray(jleaf).dtype
            assert np.abs(leaf.numpy() - np.asarray(jleaf)).max() <= 1e-7
    elif driver == "scan_chunks_static":
        chunks = x.reshape(2, 3, 1600).transpose(1, 0, 2)
        _, want = jstream.scan_chunks_static(
            jstream.init_state(2, jcfg), jnp.asarray(chunks), jcfg)
        _, got = streaming.scan_chunks_static(
            streaming.init_state(2, cfg, device="cpu"),
            torch.from_numpy(chunks.copy()), cfg)
    else:
        want = jstream.extract_scan(x, jcfg, 1600)
        got = streaming.extract_scan(x, cfg, 1600, device="cpu")
    want, got = np.asarray(want), np.asarray(got)
    assert got.shape == want.shape
    assert _scaled_err(got, want) <= 1e-5


def test_state_saved_by_tpufeat_continues_in_the_port(tmp_path):
    """The .npz layout is shared: a stream started in the JAX package and
    saved there resumes in the port (and state_from_numpy carries a live
    reference state across)."""
    jcfg, cfg = _cfgs("plain")
    x = _batch(seed=61)
    jfe = jstream.StreamingFrontend(jcfg, batch_size=2)
    f1, _ = jfe.process(x[:, :2000])
    path = str(tmp_path / "jax_state.npz")
    jstream.save_state(path, jfe.state)
    fe = streaming.StreamingFrontend(cfg, batch_size=2, device="cpu")
    fe.state = streaming.load_state(path, fe.state)
    f2, _ = fe.process(x[:, 2000:])
    got = np.concatenate([np.asarray(f1), f2.numpy()], axis=1)
    want = np.asarray(jfeat.extract(x, cfg=jcfg).features)
    assert _scaled_err(got, want) <= 1e-5
    fe3 = streaming.StreamingFrontend(cfg, batch_size=2, device="cpu")
    fe3.state = streaming.state_from_numpy(jfe.state, device="cpu")
    assert fe3.state.fill.dtype == torch.int32
    f3, _ = fe3.process(x[:, 2000:])
    torch.testing.assert_close(f3, f2, rtol=0, atol=0)


def test_state_saved_by_the_port_loads_in_tpufeat(tmp_path):
    _, cfg = _cfgs("plain")
    fe = streaming.StreamingFrontend(cfg, batch_size=2, device="cpu")
    fe.process(_batch(n=1000, seed=62))
    path = str(tmp_path / "torch_state.npz")
    streaming.save_state(path, fe.state)
    back = jstream.load_state(path, jstream.init_state(2))
    for leaf, jleaf in zip(fe.state, back):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))

