"""WAV (RIFF) audio I/O — counterpart of ``tpufeat/io.py``.

A self-contained RIFF chunk-walking parser (stdlib ``wave`` cannot read
WAVE_FORMAT_IEEE_FLOAT or WAVE_FORMAT_EXTENSIBLE files, so it is not used):
8/16/24/32-bit PCM and 32/64-bit IEEE float are decoded, anything else is
rejected loudly. Stdlib and numpy only; the samples come back as numpy and
go to a device through :func:`tpufeat_torch.extract`'s ``device`` argument.
The native C++ decoder of ``cpp_ref/`` (``tpufeat_torch.cpp_golden``) has
the same semantics, and :func:`read_wav` prefers it when it builds.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_wav", "write_wav", "wav_info"]

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _decode_samples(raw: bytes, fmt: int, bits: int) -> np.ndarray:
    if fmt == WAVE_FORMAT_PCM:
        if bits == 16:
            return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        if bits == 8:   # 8-bit PCM is unsigned by spec
            return (np.frombuffer(raw, np.uint8).astype(np.float32)
                    - 128.0) / 128.0
        if bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            v = (b[:, 0].astype(np.int32)
                 | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            return v.astype(np.float32) / 8388608.0
        if bits == 32:
            return np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        raise ValueError(f"unsupported PCM bit depth {bits}")
    if fmt == WAVE_FORMAT_IEEE_FLOAT:
        if bits == 32:
            return np.frombuffer(raw, "<f4").astype(np.float32)
        if bits == 64:
            return np.frombuffer(raw, "<f8").astype(np.float32)
        raise ValueError(f"unsupported float bit depth {bits}")
    raise ValueError(f"unsupported WAVE format tag 0x{fmt:04x} "
                     "(supported: PCM 8/16/24/32-bit, IEEE float 32/64-bit)")


def read_wav(path: str, *, native: bool | None = None,
             channel: "int | str | None" = None) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1), sample_rate).

    Supports PCM 8/16/24/32-bit and IEEE-float 32/64-bit, including
    WAVE_FORMAT_EXTENSIBLE headers; unknown format tags raise ValueError
    instead of decoding garbage. Multi-channel audio is averaged to mono
    by default (the reference is mono-only); ``channel=k`` selects one
    channel instead (telephony stereo keeps one speaker per channel —
    Kaldi's ``extract-channel``/wav channel suffix) and
    ``channel="all"`` returns the full ``[C, N]`` array (microphone
    arrays). ``native=True`` forces the C++ decoder
    (``cpp_golden.read_wav_native``: it raises when the library cannot
    build or load, or the file cannot be read), ``native=False`` this
    parser, and ``None`` prefers the C++ decoder when it builds, with this
    parser reading what it refuses (and raising this parser's error).
    Channel selection routes to this parser: the C++ decoder averages the
    channels itself.
    """
    if native is not False and channel is None:
        from tpufeat_torch import cpp_golden
        if native or cpp_golden.available():
            try:
                return cpp_golden.read_wav_native(path)
            except (ValueError, OSError):
                if native:
                    raise
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = bits = channels = rate = None
    samples = None
    while pos + 8 <= len(data):
        cid, size = data[pos: pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            if size < 16:
                raise ValueError(f"truncated fmt chunk ({size} bytes): {path}")
            fmt, channels, rate = struct.unpack_from("<HHI", body, 0)
            bits = struct.unpack_from("<H", body, 14)[0]
            if fmt == WAVE_FORMAT_EXTENSIBLE:
                if size < 40:
                    raise ValueError(f"truncated extensible fmt chunk: {path}")
                # the real format is the first 2 bytes of the SubFormat GUID
                fmt = struct.unpack_from("<H", body, 24)[0]
            if channels <= 0 or bits <= 0 or bits % 8 or rate <= 0:
                raise ValueError(f"malformed fmt chunk (channels={channels}, "
                                 f"bits={bits}, rate={rate}): {path}")
        elif cid == b"data":
            if fmt is None:
                raise ValueError(f"data chunk before fmt chunk: {path}")
            frame = channels * (bits // 8)
            usable = (len(body) // frame) * frame
            samples = _decode_samples(body[:usable], fmt, bits)
            break
        pos += 8 + size + (size & 1)          # chunks are word-aligned
    if samples is None:
        raise ValueError(f"no data chunk found: {path}")
    if channel == "all":
        # [C, N] for multi-channel consumers (tpufeat/beamform.py)
        samples = np.ascontiguousarray(samples.reshape(-1, channels).T)
    elif channel is not None:
        if not 0 <= channel < channels:
            raise ValueError(f"channel {channel} out of range: {path} has "
                             f"{channels} channel(s)")
        samples = np.ascontiguousarray(
            samples.reshape(-1, channels)[:, channel])
    elif channels > 1:
        samples = samples.reshape(-1, channels).mean(axis=1).astype(np.float32)
    return samples, rate


def wav_info(path: str) -> tuple[int, int]:
    """(mono_sample_count, sample_rate) from the RIFF headers ONLY — no
    sample decode (corpus scans over thousands of files stay cheap)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        channels = bits = rate = None
        while True:
            ch = f.read(8)
            if len(ch) < 8:
                break
            cid, size = ch[:4], struct.unpack("<I", ch[4:])[0]
            if cid == b"fmt ":
                body = f.read(min(size, 40))
                if size < 16:
                    raise ValueError(f"truncated fmt chunk: {path}")
                _, channels, rate = struct.unpack_from("<HHI", body, 0)
                bits = struct.unpack_from("<H", body, 14)[0]
                if channels <= 0 or bits <= 0 or bits % 8 or rate <= 0:
                    raise ValueError(f"malformed fmt chunk: {path}")
                if size > len(body):
                    f.seek(size - len(body) + (size & 1), 1)
                elif size & 1:
                    f.seek(1, 1)
            elif cid == b"data":
                if channels is None:
                    raise ValueError(f"data chunk before fmt chunk: {path}")
                return size // (channels * (bits // 8)), rate
            else:
                f.seek(size + (size & 1), 1)
    raise ValueError(f"no data chunk found: {path}")


_WRITERS = {
    # encoding -> (format tag, bits, array converter)
    "pcm16": (WAVE_FORMAT_PCM, 16, lambda x: np.clip(
        np.round(x * 32768.0), -32768, 32767).astype("<i2").tobytes()),
    "pcm8": (WAVE_FORMAT_PCM, 8, lambda x: (np.clip(
        np.round(x * 128.0), -128, 127) + 128).astype(np.uint8).tobytes()),
    "pcm32": (WAVE_FORMAT_PCM, 32, lambda x: np.clip(
        np.round(x * 2147483648.0), -2147483648, 2147483647)
        .astype("<i4").tobytes()),
    "pcm24": (WAVE_FORMAT_PCM, 24, lambda x: _pack24(x)),
    "float32": (WAVE_FORMAT_IEEE_FLOAT, 32,
                lambda x: x.astype("<f4").tobytes()),
    "float64": (WAVE_FORMAT_IEEE_FLOAT, 64,
                lambda x: x.astype("<f8").tobytes()),
}


def _pack24(x: np.ndarray) -> bytes:
    v = np.clip(np.round(x * 8388608.0), -8388608, 8388607).astype(np.int32)
    v = np.where(v < 0, v + (1 << 24), v).astype(np.uint32)
    out = np.empty((len(v), 3), np.uint8)
    out[:, 0] = v & 0xFF
    out[:, 1] = (v >> 8) & 0xFF
    out[:, 2] = (v >> 16) & 0xFF
    return out.tobytes()


def write_wav(path: str, samples: np.ndarray, sample_rate: int,
              encoding: str = "pcm16") -> None:
    """Write float samples in [-1, 1] as WAV: [N] mono or [N, C]
    interleaved multi-channel (matching :func:`read_wav`'s
    ``channel="all"`` transpose).

    ``encoding``: pcm8 | pcm16 (default, the reference's format) | pcm24 |
    pcm32 | float32 | float64."""
    if encoding not in _WRITERS:
        raise ValueError(f"unknown encoding {encoding!r}; "
                         f"one of {sorted(_WRITERS)}")
    fmt, bits, conv = _WRITERS[encoding]
    arr = np.asarray(samples, dtype=np.float64)
    if arr.ndim not in (1, 2):
        raise ValueError(f"expected [N] or [N, C] samples, "
                         f"got {arr.shape}")
    channels = 1 if arr.ndim == 1 else arr.shape[1]
    if not 1 <= channels <= 0xFFFF:
        raise ValueError(f"bad channel count {channels}")
    payload = conv(arr.reshape(-1))       # row-major == interleaved
    block = bits // 8 * channels
    # RIFF size counts everything after the size field, including the
    # word-alignment pad byte on odd-length data chunks
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + len(payload) + (len(payload) & 1), b"WAVE",
        b"fmt ", 16, fmt, channels, sample_rate, sample_rate * block,
        block, bits,
        b"data", len(payload))
    with open(path, "wb") as f:
        f.write(hdr + payload)
        if len(payload) & 1:
            f.write(b"\x00")
