"""The port's toolchain shims (``tpufeat_torch.compat``) on the CPU:
``WhisperFeatureExtractor`` against ``tpufeat.compat``'s and against
transformers' own extractor (skipped where transformers is missing), and
the DataLoader integration (``TorchWavDataset``, ``pad_collate``,
``FeatureLoader``) after ``tests/test_torch_data.py``, against the
reference's loader and the port's ``extract``.

Tolerances: the shim against transformers and against the reference's
shim atol 5e-5 (``tests/test_external_parity.py``'s: every side computes
in float32, sums in another order); the loader against the port's
``extract`` of the same padded batch bit for bit (the same call), against
the reference's loader 1e-4 scaled by max(1, |want|.max()), as
``tests/test_torch_extract.py`` holds the port against ``tpufeat.extract``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from tpufeat import compat as jcompat

from tpufeat_torch import compat, extract, io
from tpufeat_torch.config import KALDI39, MFCC13_HTK

CPU = "cpu"


@pytest.fixture(scope="module")
def utts():
    rng = np.random.default_rng(9)
    return [(rng.standard_normal(n) * 0.3).astype(np.float32)
            for n in (16000 * 30, 16000 * 7 + 731, 913)]


@pytest.fixture(scope="module")
def whisper_fe():
    transformers = pytest.importorskip("transformers")
    return transformers.WhisperFeatureExtractor()


def _scaled(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


class TestWhisperShim:
    def test_from_pretrained_local(self, tmp_path):
        cfgfile = {"feature_size": 128, "sampling_rate": 16000,
                   "hop_length": 160, "chunk_length": 30, "n_fft": 400,
                   "padding_value": 0.0,
                   "feature_extractor_type": "WhisperFeatureExtractor"}
        (tmp_path / "preprocessor_config.json").write_text(
            json.dumps(cfgfile))
        fe = compat.WhisperFeatureExtractor.from_pretrained(str(tmp_path),
                                                            device=CPU)
        assert fe.feature_size == 128 and fe.config.n_mels == 128
        fe2 = compat.WhisperFeatureExtractor.from_pretrained(
            str(tmp_path / "preprocessor_config.json"), feature_size=80,
            device=CPU)
        assert fe2.feature_size == 80
        with pytest.raises(ValueError, match="local"):
            compat.WhisperFeatureExtractor.from_pretrained(
                "openai/whisper-tiny")
        cfgfile["feature_extractor_type"] = "Wav2Vec2FeatureExtractor"
        (tmp_path / "preprocessor_config.json").write_text(
            json.dumps(cfgfile))
        with pytest.raises(ValueError, match="semantics only"):
            compat.WhisperFeatureExtractor.from_pretrained(str(tmp_path))

    def test_cpu_route(self):
        """On the CPU the plain path at "highest"; the card takes the fused
        route at bf16x3 (checked on the card)."""
        cfg = compat.WhisperFeatureExtractor(device=CPU).config
        assert not (cfg.use_pallas or cfg.gemm_dft or cfg.fused_framing)
        assert cfg.matmul_precision == "highest"

    def test_matches_reference_shim(self, utts):
        got = compat.WhisperFeatureExtractor(device=CPU)(
            utts, sampling_rate=16000, return_attention_mask=True)
        want = jcompat.WhisperFeatureExtractor()(
            utts, sampling_rate=16000, return_attention_mask=True)
        assert got.input_features.shape == want.input_features.shape \
            == (3, 80, 3000)
        np.testing.assert_allclose(got.input_features, want.input_features,
                                   atol=5e-5)
        np.testing.assert_array_equal(got.attention_mask,
                                      want.attention_mask)

    def test_batch_matches_transformers(self, whisper_fe, utts):
        ref = whisper_fe(utts, sampling_rate=16000, return_tensors="np",
                         padding="max_length", return_attention_mask=True)
        fe = compat.WhisperFeatureExtractor(device=CPU)
        got = fe(utts, sampling_rate=16000, return_attention_mask=True)
        assert isinstance(got["input_features"], np.ndarray)
        np.testing.assert_allclose(got.input_features, ref.input_features,
                                   atol=5e-5)
        # transformers strides a sample mask by hop: ceil(len / hop) ones
        np.testing.assert_array_equal(got.attention_mask,
                                      ref.attention_mask)

    def test_truncation_and_mask(self, whisper_fe):
        rng = np.random.default_rng(10)
        long = (rng.standard_normal(16000 * 35) * 0.3).astype(np.float32)
        ref = whisper_fe([long], sampling_rate=16000, return_tensors="np",
                         padding="max_length")
        got = compat.WhisperFeatureExtractor(device=CPU)(
            [long], return_attention_mask=True)
        np.testing.assert_allclose(got.input_features, ref.input_features,
                                   atol=5e-5)
        assert got.attention_mask.shape == (1, 3000)
        assert got.attention_mask.all()

    def test_padding_value_and_max_length(self):
        x = np.full(8000, 0.1, np.float32)
        fe = compat.WhisperFeatureExtractor(padding_value=0.05, device=CPU)
        jfe = jcompat.WhisperFeatureExtractor(padding_value=0.05)
        got = fe(x, max_length=24000)
        want = jfe(x, max_length=24000)
        assert got.input_features.shape == (1, 80, 150)
        np.testing.assert_allclose(got.input_features, want.input_features,
                                   atol=5e-5)

    def test_pt_tensors(self):
        fe = compat.WhisperFeatureExtractor(device=CPU)
        got = fe(np.zeros(16000, np.float32), return_tensors="pt",
                 return_attention_mask=True)
        assert isinstance(got.input_features, torch.Tensor)
        assert got.input_features.device.type == "cpu"
        assert got.attention_mask.dtype == torch.int32
        np.testing.assert_array_equal(
            got.input_features.numpy(),
            fe(np.zeros(16000, np.float32)).input_features)

    def test_unsupported_corners_raise(self):
        fe = compat.WhisperFeatureExtractor(device=CPU)
        x = np.zeros(100, np.float32)
        with pytest.raises(ValueError, match="max_length"):
            fe(x, padding=False)
        with pytest.raises(ValueError, match="resample"):
            fe(x, sampling_rate=8000)
        with pytest.raises(TypeError, match="unsupported"):
            fe(x, return_token_timestamps=True)
        with pytest.raises(ValueError, match="truncation"):
            fe(np.zeros(16000 * 31, np.float32), truncation=False)
        with pytest.raises(ValueError, match="'np' or 'pt'"):
            fe(x, return_tensors="jax")
        with pytest.raises(ValueError, match="1-D, 2-D"):
            fe(np.zeros((1, 2, 3), np.float32))

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            compat.WhisperFeatureExtractor()


@pytest.fixture()
def wav_dir(tmp_path):
    rng = np.random.default_rng(42)
    paths = []
    for i, n in enumerate([12000, 16000, 7000, 20000, 9000]):
        p = tmp_path / f"utt{i}.wav"
        io.write_wav(str(p), (0.3 * rng.standard_normal(n)).astype(
            np.float32), 16000)
        paths.append(str(p))
    return paths


def _loader(paths, batch_size=3, workers=0, ds=compat.TorchWavDataset,
            collate=compat.pad_collate):
    return torch.utils.data.DataLoader(
        ds(paths), batch_size=batch_size, shuffle=False,
        num_workers=workers, collate_fn=collate)


class TestLoader:
    def test_dataset_items(self, wav_dir):
        ds = compat.TorchWavDataset(wav_dir)
        assert len(ds) == 5
        samples, key = ds[2]
        assert samples.dtype == np.float32 and len(samples) == 7000
        assert key == wav_dir[2]
        np.testing.assert_array_equal(samples,
                                      jcompat.TorchWavDataset(wav_dir)[2][0])

    def test_pad_collate_buckets(self, wav_dir):
        ds = compat.TorchWavDataset(wav_dir)
        batch = compat.pad_collate([ds[0], ds[2]])
        assert batch["signal"].shape == (2, 16000)
        np.testing.assert_array_equal(batch["lengths"], [12000, 7000])
        assert batch["keys"] == [wav_dir[0], wav_dir[2]]
        want = jcompat.pad_collate([ds[0], ds[2]])
        np.testing.assert_array_equal(batch["signal"], want["signal"])
        raw = compat.pad_collate([ds[0][0], ds[2][0]], bucket=False)
        assert raw["signal"].shape[1] == 12000
        assert raw["keys"] == [None, None]

    def test_feature_loader_matches_extract_and_reference(self, wav_dir):
        fl = compat.FeatureLoader(_loader(wav_dir), KALDI39, device=CPU)
        ref = jcompat.FeatureLoader(
            _loader(wav_dir, ds=jcompat.TorchWavDataset,
                    collate=jcompat.pad_collate), KALDI39, return_type="np")
        assert len(fl) == 2
        seen = 0
        for batch, jbatch, plain in zip(fl, ref, _loader(wav_dir)):
            assert isinstance(batch["features"], torch.Tensor)
            assert batch["features"].dtype == torch.float32
            res = extract(plain["signal"], plain["lengths"], KALDI39,
                          device=CPU)
            for key in ("features", "num_frames", "mask"):
                assert torch.equal(batch[key], getattr(res, key)), key
            nf = batch["num_frames"].numpy()
            np.testing.assert_array_equal(nf, jbatch["num_frames"])
            got, want = batch["features"].numpy(), jbatch["features"]
            for b in range(len(nf)):
                assert _scaled(got[b, : nf[b]], want[b, : nf[b]]) <= 1e-4
            assert batch["keys"] == jbatch["keys"]
            seen += len(nf)
        assert seen == 5

    def test_feature_loader_np_mode_and_validation(self, wav_dir):
        batch = next(iter(compat.FeatureLoader(
            _loader(wav_dir[:2], 2), MFCC13_HTK, return_type="np",
            device=CPU)))
        assert isinstance(batch["features"], np.ndarray)
        assert batch["features"].shape[-1] == 13
        assert batch["mask"].dtype == bool
        with pytest.raises(ValueError):
            compat.FeatureLoader(_loader(wav_dir), MFCC13_HTK,
                                 return_type="list", device=CPU)

    def test_rate_mismatch_raises(self, tmp_path):
        p = tmp_path / "8k.wav"
        io.write_wav(str(p), np.zeros(800, np.float32), 8000)
        with pytest.raises(ValueError, match="sample rate 8000"):
            compat.TorchWavDataset([str(p)])[0]
        assert len(compat.TorchWavDataset([str(p)],
                                          expected_rate=None)[0][0]) == 800

    def test_dither_per_batch_generator(self, wav_dir):
        """Two identical batches draw different noise; batch i's noise
        depends on the seed and i alone (not on the batches before it)."""
        cfg = dataclasses.replace(MFCC13_HTK, dither=1e-3)

        def feats(paths, seed):
            g = torch.Generator().manual_seed(seed)
            return [b["features"].numpy() for b in compat.FeatureLoader(
                _loader(paths, 1), cfg, generator=g, device=CPU)]

        a = feats([wav_dir[0], wav_dir[0]], 0)
        assert not np.array_equal(a[0], a[1])
        b = feats([wav_dir[1], wav_dir[0]], 0)
        np.testing.assert_array_equal(a[1], b[1])
        c = feats([wav_dir[0], wav_dir[0]], 1)
        assert not np.array_equal(a[1], c[1])
        with pytest.raises(ValueError, match="generator"):
            next(iter(compat.FeatureLoader(_loader(wav_dir), cfg,
                                           device=CPU)))

    def test_worker_processes_decode(self, wav_dir):
        """Two DataLoader workers decode (numpy only); the main process
        extracts: the same features as without workers."""
        one = [b["features"] for b in compat.FeatureLoader(
            _loader(wav_dir, 2), MFCC13_HTK, device=CPU)]
        two = [b["features"] for b in compat.FeatureLoader(
            _loader(wav_dir, 2, workers=2), MFCC13_HTK, device=CPU)]
        assert sum(f.shape[0] for f in two) == 5
        for x, y in zip(one, two):
            assert torch.equal(x, y)
