"""Feature-file interchange: HTK parameter files and Kaldi binary archives —
the port's own copy of ``tpufeat/feats_io.py``, so files written by either
package read in the other byte for byte.

- **HTK** parameter files (HTKBook §5.10): 12-byte big-endian header
  (nSamples int32, sampPeriod int32 in 100 ns units, sampSize int16 =
  bytes/frame, parmKind int16), then float32 big-endian frames (or the
  ``_C`` compressed int16 form).
- **Kaldi** binary archives (``.ark`` + optional ``.scp`` index): per
  utterance ``"<key> \\0B BFM \\x04<rows> \\x04<cols> <f32 data>"``,
  little-endian row-major, what ``copy-feats ark:...`` produces; ``DM``
  double matrices (CMVN statistics) and ``FV`` / ``DV`` vectors too.

NumPy and the standard library only: features computed on the card reach
these writers as host arrays (``tensor.cpu().numpy()``).
"""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["write_htk", "read_htk", "write_kaldi_ark", "read_kaldi_ark",
           "read_kaldi_scp", "read_kaldi_matrix", "ark_keys",
           "to_htk_order", "from_htk_order",
           "HTK_MFCC", "HTK_FBANK", "HTK_USER", "HTK_PLP",
           "HTK_QUALIFIERS"]


def ark_keys(names) -> list[str]:
    """Collision-safe Kaldi utterance keys for a sequence of file names
    (basenames or relpaths), order-preserving — the ONE sanitization
    shared by the CLI and corpus-driver ark writers: extension stripped,
    whitespace collapsed to '_', empty names fall back to ``utt<i>``,
    and duplicates (same basename in different directories, or inputs
    like ``a.wav`` + ``a.1.wav`` + another ``a.wav``) get a suffix
    extended until free — a silent key collision would drop an
    utterance."""
    taken: set[str] = set()
    out = []
    for i, name in enumerate(names):
        key = "_".join(os.path.splitext(name)[0].split()) or f"utt{i}"
        if key in taken:
            key = f"{key}.{i}"
            while key in taken:
                key += "_"
        taken.add(key)
        out.append(key)
    return out

# HTKBook table of base parameter kinds and qualifier bits.
HTK_MFCC = 6
HTK_FBANK = 7
HTK_USER = 9
HTK_PLP = 11
HTK_QUALIFIERS = {
    "E": 0o000100, "N": 0o000200, "D": 0o000400, "A": 0o001000,
    "C": 0o002000, "Z": 0o004000, "K": 0o010000, "0": 0o020000,
    "V": 0o040000, "T": 0o100000,
}


def parm_kind(base: int, *qualifiers: str) -> int:
    """HTK parmKind word, e.g. ``parm_kind(HTK_MFCC, "0", "D", "A")``."""
    kind = base
    for q in qualifiers:
        kind |= HTK_QUALIFIERS[q.upper()]
    return kind


def to_htk_order(feats: np.ndarray, base_dim: int) -> np.ndarray:
    """Kaldi-style coefficient order -> HTK order, per base-sized block.

    This package stores c0 (or the energy term) as the FIRST column of each
    static/delta/accel block (Kaldi convention); HTKBook §5.10's ``_0``/
    ``_E`` qualifiers put that term LAST in each block. A toolchain honoring
    the parmKind would otherwise read permuted coefficients, so the HTK
    writer path must reorder: [c0, c1..cN | d0, d1..dN | a0, ...] ->
    [c1..cN, c0 | d1..dN, d0 | ...]."""
    feats = np.asarray(feats)
    d = feats.shape[-1]
    if base_dim <= 0 or d % base_dim:
        raise ValueError(f"feature dim {d} is not a multiple of base block "
                         f"size {base_dim}")
    blocks = [feats[..., i: i + base_dim] for i in range(0, d, base_dim)]
    return np.concatenate(
        [np.concatenate([b[..., 1:], b[..., :1]], axis=-1) for b in blocks],
        axis=-1)


def from_htk_order(feats: np.ndarray, base_dim: int) -> np.ndarray:
    """Inverse of :func:`to_htk_order` (HTK block order -> c0-first)."""
    feats = np.asarray(feats)
    d = feats.shape[-1]
    if base_dim <= 0 or d % base_dim:
        raise ValueError(f"feature dim {d} is not a multiple of base block "
                         f"size {base_dim}")
    blocks = [feats[..., i: i + base_dim] for i in range(0, d, base_dim)]
    return np.concatenate(
        [np.concatenate([b[..., -1:], b[..., :-1]], axis=-1) for b in blocks],
        axis=-1)


def write_htk(path: str, feats: np.ndarray, *, frame_shift_s: float = 0.010,
              kind: int = HTK_USER, compress: bool = False) -> None:
    """Write one utterance's [T, D] float features as an HTK file.

    ``kind`` defaults to USER; pass e.g. ``parm_kind(HTK_MFCC, "0")`` for
    MFCCs whose first column is c0 (this package's DCT convention), or
    ``parm_kind(HTK_MFCC, "0", "D", "A")`` for the 39-dim KALDI39 layout.

    ``compress=True`` writes the HTKBook §5.10 ``_C`` format: per-column
    affine int16 quantization ``short = A*x - B`` with the A and B vectors
    stored as float32 in the space of the first four "samples" (hence the
    header's ``nSamples = T + 4`` convention), halving file size at
    ~range/65534 per-column quantization error."""
    feats = np.ascontiguousarray(feats, dtype=np.float32)
    if feats.ndim != 2:
        raise ValueError(f"expected [T, D] features, got {feats.shape}")
    t, d = feats.shape
    period = int(round(frame_shift_s * 1e7))        # 100 ns units
    if not compress:
        with open(path, "wb") as f:
            f.write(struct.pack(">iihH", t, period, 4 * d, kind))
            f.write(feats.astype(">f4").tobytes())
        return
    kind |= HTK_QUALIFIERS["C"]
    x = feats.astype(np.float64)
    xmax = x.max(axis=0) if t else np.zeros(d)
    xmin = x.min(axis=0) if t else np.zeros(d)
    rng = xmax - xmin
    const = rng <= 0
    # HTK scaling: A = 2I/range, B = (max+min)*I/range (I = 32767);
    # constant columns encode as 0 with the value carried entirely in B.
    # Encode with the float32-ROUNDED vectors — the reader can only use
    # what the file stores, so quantizing against anything else would add
    # a decode mismatch on top of the int16 step.
    a = np.where(const, 1.0, 2.0 * 32767.0 / np.where(const, 1.0, rng))
    b = np.where(const, xmax, (xmax + xmin) * 32767.0
                 / np.where(const, 1.0, rng))
    a = a.astype(np.float32).astype(np.float64)
    b = b.astype(np.float32).astype(np.float64)
    q = np.rint(a * x - b)
    if t and (np.abs(q) > 32767).any():             # rint at the extremes
        q = np.clip(q, -32767, 32767)
    with open(path, "wb") as f:
        f.write(struct.pack(">iihH", t + 4, period, 2 * d, kind))
        f.write(a.astype(">f4").tobytes())
        f.write(b.astype(">f4").tobytes())
        f.write(q.astype(">i2").tobytes())


def read_htk(path: str) -> tuple[np.ndarray, float, int]:
    """Read an HTK parameter file -> (feats [T, D] f32, frame_shift_s,
    parmKind)."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) != 12:
            raise ValueError(f"{path}: truncated HTK header")
        t, period, samp_size, kind = struct.unpack(">iihH", header)
        if kind & HTK_QUALIFIERS["K"]:
            raise ValueError(
                f"{path}: CRC HTK files (_K qualifier, parmKind "
                f"0o{kind:o}) are not supported")
        if kind & HTK_QUALIFIERS["C"]:
            # HTKBook §5.10 compressed: nSamples includes the 4 pseudo-
            # samples holding the float32 A/B vectors; data is int16
            if samp_size <= 0 or samp_size % 2:
                raise ValueError(f"{path}: bad compressed sampSize "
                                 f"{samp_size}")
            d = samp_size // 2
            t -= 4
            if t < 0:
                raise ValueError(f"{path}: compressed header nSamples < 4")
            a = np.frombuffer(f.read(4 * d), dtype=">f4").astype(np.float64)
            b = np.frombuffer(f.read(4 * d), dtype=">f4").astype(np.float64)
            if a.size != d or b.size != d or (a == 0).any():
                raise ValueError(f"{path}: bad compression vectors")
            q = np.frombuffer(f.read(t * samp_size), dtype=">i2")
            if q.size != t * d:
                raise ValueError(f"{path}: truncated HTK data "
                                 f"({q.size} of {t * d} values)")
            out = (q.reshape(t, d).astype(np.float64) + b) / a
            return out.astype(np.float32), period / 1e7, kind
        if samp_size <= 0 or samp_size % 4:
            raise ValueError(f"{path}: bad sampSize {samp_size} "
                             "(only float32 parameter files supported)")
        d = samp_size // 4
        data = np.frombuffer(f.read(t * samp_size), dtype=">f4")
    if data.size != t * d:
        raise ValueError(f"{path}: truncated HTK data "
                         f"({data.size} of {t * d} values)")
    return data.reshape(t, d).astype(np.float32), period / 1e7, kind


def write_kaldi_ark(ark_path: str, utts: dict[str, np.ndarray],
                    scp_path: str | None = None, *,
                    dtype: str = "f32") -> None:
    """Write ``{utt_id: [T, D]}`` as a Kaldi binary archive, with an
    optional .scp index ("<key> <ark_path>:<offset>" per line).

    ``dtype="f32"`` writes float matrices (``FM``, what copy-feats
    produces for features); ``dtype="f64"`` writes double matrices
    (``DM``, what compute-cmvn-stats produces for CMVN statistics)."""
    if dtype not in ("f32", "f64"):
        raise ValueError(f"dtype must be 'f32' or 'f64', got {dtype!r}")
    np_dt, token = ((np.float32, b"FM ") if dtype == "f32"
                    else (np.float64, b"DM "))
    # validate everything BEFORE opening (open("wb") truncates an existing
    # archive — a mid-write error must not destroy prior output)
    validated = {}
    for key, feats in utts.items():
        if not key or any(c.isspace() for c in key):
            raise ValueError(f"bad Kaldi utterance key {key!r}")
        feats = np.ascontiguousarray(feats, dtype=np_dt)
        if feats.ndim != 2:
            raise ValueError(f"{key}: expected [T, D], got {feats.shape}")
        validated[key] = feats
    scp_lines = []
    with open(ark_path, "wb") as f:
        for key, feats in validated.items():
            f.write(key.encode())
            f.write(b" ")
            scp_lines.append(f"{key} {ark_path}:{f.tell()}")
            f.write(b"\0B")                          # binary marker
            f.write(token)                           # FM / DM matrix token
            t, d = feats.shape
            f.write(b"\x04" + struct.pack("<i", t))
            f.write(b"\x04" + struct.pack("<i", d))
            f.write(feats.astype(feats.dtype.newbyteorder("<")).tobytes())
    if scp_path:
        with open(scp_path, "w") as f:
            f.write("\n".join(scp_lines) + ("\n" if scp_lines else ""))


def read_kaldi_ark(ark_path: str) -> dict[str, np.ndarray]:
    """Read a binary Kaldi archive -> {utt_id: [T, D]}; ``FM`` matrices
    come back float32, ``DM`` (e.g. CMVN statistics) float64."""
    out: dict[str, np.ndarray] = {}
    with open(ark_path, "rb") as f:
        while True:
            key_bytes = bytearray()
            while True:
                c = f.read(1)
                if not c:                            # clean EOF before a key
                    if key_bytes:
                        raise ValueError(f"{ark_path}: truncated key")
                    return out
                if c == b" ":
                    break
                key_bytes += c
            key = key_bytes.decode()
            if key in out:
                # the writer validates key uniqueness; a repeated id here
                # means a malformed/concatenated archive — overwriting would
                # silently lose the earlier matrix
                raise ValueError(f"{ark_path}: duplicate utterance id "
                                 f"{key!r}")
            out[key] = _read_matrix_body(f, ark_path, key)


def _read_matrix_body(f, ark_path: str, key: str) -> np.ndarray:
    """One binary float matrix starting at the \\0B marker (the position
    a .scp offset points at)."""
    marker = f.read(2)
    if marker != b"\0B":
        raise ValueError(f"{ark_path}: {key}: only binary archives "
                         f"supported (marker {marker!r})")
    token = f.read(3)
    if token not in (b"FM ", b"DM "):
        raise ValueError(f"{ark_path}: {key}: expected a float ('FM ') "
                         f"or double ('DM ') matrix, got {token!r}")
    wdt = ("<f4", np.float32) if token == b"FM " else ("<f8", np.float64)
    dims = []
    for _ in range(2):
        size = f.read(1)
        if size != b"\x04":
            raise ValueError(f"{ark_path}: {key}: bad dim size "
                             f"{size!r}")
        raw = f.read(4)
        if len(raw) != 4:
            raise ValueError(f"{ark_path}: {key}: truncated dim")
        dims.append(struct.unpack("<i", raw)[0])
    t, d = dims
    if t < 0 or d < 0 or t * d > (1 << 31):
        raise ValueError(f"{ark_path}: {key}: implausible matrix "
                         f"dims {t}x{d} (corrupt archive)")
    nbytes = np.dtype(wdt[0]).itemsize * t * d
    buf = f.read(nbytes)
    if len(buf) != nbytes:   # check BYTES: frombuffer on a partial read
        raise ValueError(    # raises an unrelated element-size error
            f"{ark_path}: {key}: truncated matrix")
    return np.frombuffer(buf, dtype=wdt[0]).reshape(t, d).astype(wdt[1])


def write_kaldi_vec_ark(ark_path: str, utts: dict[str, np.ndarray],
                        scp_path: str | None = None, *,
                        dtype: str = "f32") -> None:
    """Write ``{utt_id: [D]}`` as a Kaldi binary VECTOR archive (``FV``
    float / ``DV`` double tokens — the format ``ivector-extract`` and
    ``compute-vad`` emit), with an optional .scp index."""
    if dtype not in ("f32", "f64"):
        raise ValueError(f"dtype must be 'f32' or 'f64', got {dtype!r}")
    np_dt, token = ((np.float32, b"FV ") if dtype == "f32"
                    else (np.float64, b"DV "))
    validated = {}
    for key, vec in utts.items():
        if not key or any(c.isspace() for c in key):
            raise ValueError(f"bad Kaldi utterance key {key!r}")
        vec = np.ascontiguousarray(vec, dtype=np_dt)
        if vec.ndim != 1:
            raise ValueError(f"{key}: expected [D], got {vec.shape}")
        validated[key] = vec
    scp_lines = []
    with open(ark_path, "wb") as f:
        for key, vec in validated.items():
            f.write(key.encode())
            f.write(b" ")
            scp_lines.append(f"{key} {ark_path}:{f.tell()}")
            f.write(b"\0B")
            f.write(token)
            f.write(b"\x04" + struct.pack("<i", vec.shape[0]))
            f.write(vec.astype(vec.dtype.newbyteorder("<")).tobytes())
    if scp_path:
        with open(scp_path, "w") as f:
            f.write("\n".join(scp_lines) + ("\n" if scp_lines else ""))


def read_kaldi_vec_ark(ark_path: str) -> dict[str, np.ndarray]:
    """Read a binary Kaldi vector archive -> ``{utt_id: [D]}`` (``FV``
    float32 / ``DV`` float64)."""
    out: dict[str, np.ndarray] = {}
    with open(ark_path, "rb") as f:
        while True:
            key_bytes = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    if key_bytes:
                        raise ValueError(f"{ark_path}: truncated key")
                    return out
                if c == b" ":
                    break
                key_bytes += c
            key = key_bytes.decode()
            if key in out:
                raise ValueError(f"{ark_path}: duplicate utterance id "
                                 f"{key!r}")
            out[key] = _read_vector_body(f, ark_path, key)


def _read_vector_body(f, ark_path: str, key: str) -> np.ndarray:
    """One binary float/double vector starting at the \\0B marker."""
    marker = f.read(2)
    if marker != b"\0B":
        raise ValueError(f"{ark_path}: {key}: only binary archives "
                         f"supported (marker {marker!r})")
    token = f.read(3)
    if token not in (b"FV ", b"DV "):
        raise ValueError(f"{ark_path}: {key}: expected a float ('FV ') "
                         f"or double ('DV ') vector, got {token!r}")
    wdt = ("<f4", np.float32) if token == b"FV " else ("<f8", np.float64)
    size = f.read(1)
    if size != b"\x04":
        raise ValueError(f"{ark_path}: {key}: bad dim size {size!r}")
    raw = f.read(4)
    if len(raw) != 4:
        raise ValueError(f"{ark_path}: {key}: truncated dim")
    d = struct.unpack("<i", raw)[0]
    if d < 0 or d > (1 << 31):
        raise ValueError(f"{ark_path}: {key}: implausible vector dim {d}")
    nbytes = np.dtype(wdt[0]).itemsize * d
    buf = f.read(nbytes)
    if len(buf) != nbytes:
        raise ValueError(f"{ark_path}: {key}: truncated vector")
    return np.frombuffer(buf, dtype=wdt[0]).astype(wdt[1])


def read_kaldi_vector(ark_path: str, offset: int,
                      key: str = "?") -> np.ndarray:
    """Random-access read of one [D] vector at a .scp offset."""
    with open(ark_path, "rb") as f:
        f.seek(offset)
        return _read_vector_body(f, ark_path, key)


def read_kaldi_scp(scp_path: str) -> dict[str, tuple[str, int]]:
    """Parse a .scp index -> ordered ``{key: (ark_path, offset)}``.

    Offsets point at each matrix's binary marker, so
    :func:`read_kaldi_matrix` fetches single utterances without scanning
    the archive — the random-access half of the Kaldi ark/scp pair."""
    out: dict[str, tuple[str, int]] = {}
    with open(scp_path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                key, rx = line.split(None, 1)
                ark, off = rx.rsplit(":", 1)
                off_i = int(off)
            except ValueError:
                raise ValueError(
                    f"{scp_path}:{ln}: expected '<key> <ark>:<offset>', "
                    f"got {line!r}") from None
            if key in out:
                raise ValueError(f"{scp_path}:{ln}: duplicate key {key!r}")
            out[key] = (ark, off_i)
    return out


def read_kaldi_matrix(ark_path: str, offset: int,
                      key: str = "?") -> np.ndarray:
    """Random-access read of one [T, D] matrix at a .scp offset."""
    with open(ark_path, "rb") as f:
        f.seek(offset)
        return _read_matrix_body(f, ark_path, key)
