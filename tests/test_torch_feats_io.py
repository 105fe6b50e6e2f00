"""``tpufeat_torch.feats_io`` against ``tpufeat.feats_io``: every file one
package writes is byte for byte the file the other writes, and each reads
the other's, for HTK parameter files (plain and ``_C`` compressed), Kaldi
float and double matrix archives with their ``.scp`` index, and float and
double vector archives."""

import numpy as np
import pytest

from tpufeat import feats_io as jio
from tpufeat_torch import feats_io as tio

PACKAGES = {"port": tio, "reference": jio}


def _feats(t=37, d=13, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, d)) * 3).astype(np.float32)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "_C"])
@pytest.mark.parametrize("shape", [(37, 13), (1, 40), (0, 5)])
def test_htk_same_bytes_both_ways(tmp_path, shape, compress):
    f = _feats(*shape, seed=1)
    kind = tio.parm_kind(tio.HTK_MFCC, "0", "D", "A")
    assert kind == jio.parm_kind(jio.HTK_MFCC, "0", "D", "A")
    paths = {}
    for name, mod in PACKAGES.items():
        paths[name] = str(tmp_path / f"{name}.htk")
        mod.write_htk(paths[name], f, frame_shift_s=0.01, kind=kind,
                      compress=compress)
    assert _bytes(paths["port"]) == _bytes(paths["reference"])
    for reader, path in ((tio, paths["reference"]), (jio, paths["port"])):
        got, shift, k = reader.read_htk(path)
        want, shift_w, k_w = jio.read_htk(paths["reference"])
        np.testing.assert_array_equal(got, want)
        assert (shift, k) == (shift_w, k_w)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_kaldi_ark_and_scp_same_bytes_both_ways(tmp_path, dtype):
    utts = {"utt_a": _feats(20, 39, 2), "spk1-utt2": _feats(7, 39, 3),
            "empty": np.zeros((0, 39), np.float32)}
    for name, mod in PACKAGES.items():
        mod.write_kaldi_ark(str(tmp_path / f"{name}.ark"), utts,
                            scp_path=str(tmp_path / f"{name}.scp"),
                            dtype=dtype)
    assert _bytes(tmp_path / "port.ark") == _bytes(tmp_path / "reference.ark")
    port_scp = _bytes(tmp_path / "port.scp").replace(b"port.ark",
                                                     b"reference.ark")
    assert port_scp == _bytes(tmp_path / "reference.scp")
    for reader, other in ((tio, "reference"), (jio, "port")):
        got = reader.read_kaldi_ark(str(tmp_path / f"{other}.ark"))
        assert list(got) == list(utts)
        for key, arr in utts.items():
            np.testing.assert_array_equal(got[key], arr.astype(
                np.float32 if dtype == "f32" else np.float64))
        index = reader.read_kaldi_scp(str(tmp_path / f"{other}.scp"))
        for key, (ark, off) in index.items():
            np.testing.assert_array_equal(
                reader.read_kaldi_matrix(ark, off, key), got[key])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_kaldi_vector_ark_same_bytes_both_ways(tmp_path, dtype):
    vecs = {"a": np.arange(5, dtype=np.float32), "b": _feats(1, 9, 4)[0]}
    for name, mod in PACKAGES.items():
        mod.write_kaldi_vec_ark(str(tmp_path / f"{name}.ark"), vecs,
                                scp_path=str(tmp_path / f"{name}.scp"),
                                dtype=dtype)
    assert _bytes(tmp_path / "port.ark") == _bytes(tmp_path / "reference.ark")
    for reader, other in ((tio, "reference"), (jio, "port")):
        got = reader.read_kaldi_vec_ark(str(tmp_path / f"{other}.ark"))
        for key, vec in vecs.items():
            np.testing.assert_array_equal(got[key], vec.astype(got[key].dtype))
        _, off = reader.read_kaldi_scp(str(tmp_path / f"{other}.scp"))["b"]
        np.testing.assert_array_equal(
            reader.read_kaldi_vector(str(tmp_path / f"{other}.ark"), off),
            got["b"])


def test_ark_keys_and_htk_order_match():
    names = ["a.wav", "a.1.wav", "a.wav", "with space.wav", ".wav", "b"]
    assert tio.ark_keys(names) == jio.ark_keys(names)
    f = _feats(5, 39, 5)
    np.testing.assert_array_equal(tio.to_htk_order(f, 13),
                                  jio.to_htk_order(f, 13))
    np.testing.assert_array_equal(tio.from_htk_order(tio.to_htk_order(f, 13),
                                                     13), f)


def test_readers_refuse_what_the_reference_refuses(tmp_path):
    bad = tmp_path / "bad.ark"
    bad.write_bytes(b"key \0BFM \x04" + b"\xff\xff\xff\x7f" + b"\x04\x01\0\0\0")
    for mod in PACKAGES.values():
        with pytest.raises(ValueError, match="truncated matrix"):
            mod.read_kaldi_ark(str(bad))
        with pytest.raises(ValueError, match="bad Kaldi utterance key"):
            mod.write_kaldi_ark(str(tmp_path / "x.ark"),
                                {"two words": _feats(2, 2)})
        with pytest.raises(ValueError, match="expected"):
            mod.write_htk(str(tmp_path / "x.htk"), np.zeros(3, np.float32))
