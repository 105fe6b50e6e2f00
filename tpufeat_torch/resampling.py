"""Rational sample-rate conversion — counterpart of
``tpufeat/resampling.py``.

A block of ``p`` consecutive output samples depends on a fixed window of
``L`` input samples that advances by ``q`` samples a block:

    y[j*p + r] = sum_t  x[j*q + c0 + t] * H[t, r]

with the windowed-sinc filter scipy's ``resample_poly`` designs (Kaiser
beta=5, half length 10*max(p, q), cutoff at the tighter Nyquist), so the
output matches ``scipy.signal.resample_poly`` to float32 precision.

The base path sums the taps in a fixed order, one strided slice of the
input per tap (``x[:, c0 + t :: q]``), an elementwise multiply and an add
each: no frames tensor is built (framing 48 kHz -> 16 kHz at B=128 x 30 s
with L=61 and hop 3 would take 15 GB), and every output is the same
sequence of float32 roundings whatever the call's shape or device. So
:class:`StreamingResampler`, which runs the same sum over its buffer,
gives the bits of :func:`resample` of the whole stream for every chunk
plan and every rate pair (the reference meets that bit for bit only on the
8k/16k/48k family, its matmul's accumulation order varying with the row
count for the 44.1 kHz one).

``resample(..., block=n)`` stacks ``n`` blocks into one matrix
(:func:`resample_matrix_blocked`) and runs two fp32 products over
non-overlapping windows of ``n*q`` samples (the block's own window and the
``L - q`` samples of the next one that its last taps reach): the pitch
tracker's 16 kHz -> 2 kHz decimation with ``block=256``. Its sums go
through BLAS, so it equals the base path to f32 roundoff, not to the bit,
and stays opt-in as in the reference.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tpufeat_torch import features

__all__ = ["resample", "resample_matrix", "resample_matrix_blocked",
           "output_length", "StreamingResampler"]

#: the largest of p and q accepted: the filter's length grows with it
MAX_FACTOR = 2048


def _design_filter(p: int, q: int, beta: float = 5.0) -> np.ndarray:
    """scipy.signal.resample_poly's default FIR: windowed sinc, half length
    10*max(p,q), Kaiser(beta) window, unity DC gain, scaled by p."""
    max_rate = max(p, q)
    f_c = 1.0 / max_rate                      # in Nyquist units (fs = 2)
    half_len = 10 * max_rate
    m = np.arange(2 * half_len + 1, dtype=np.float64) - half_len
    h = f_c * np.sinc(f_c * m) * np.kaiser(2 * half_len + 1, beta)
    h /= h.sum()                              # unity gain at DC
    return h * p


@functools.lru_cache(maxsize=None)
def resample_matrix(p: int, q: int, beta: float = 5.0
                    ) -> tuple[np.ndarray, int]:
    """(H [L, p] float64, c0): the block matrix and the input offset of
    the first tap. Output sample m = j*p + r reads x[n] for n in a window
    around (m*q + D)/p (D: the filter's group delay); block j's window
    starts at j*q + c0. Taps outside the filter's support are zero."""
    h = _design_filter(p, q, beta)
    lh = len(h)
    d = (lh - 1) // 2                         # group delay (odd-length FIR)
    c0 = -(-(d - lh + 1) // p)                # ceil((D - lh + 1) / p)
    n_hi = ((p - 1) * q + d) // p             # last tap row, m = p - 1
    L = n_hi - c0 + 1
    H = np.zeros((L, p), dtype=np.float64)
    for r in range(p):
        for t in range(L):
            k = r * q + d - (c0 + t) * p
            if 0 <= k < lh:
                H[t, r] = h[k]
    return H, c0


@functools.lru_cache(maxsize=None)
def resample_matrix_blocked(p: int, q: int, block: int,
                            beta: float = 5.0) -> tuple[np.ndarray, int]:
    """(H_blk [(block-1)*q + L, block*p], c0): ``block`` base blocks
    stacked into one matrix; column j*p + r is base column r shifted down
    j*q rows: the same taps and filter as :func:`resample_matrix`."""
    H, c0 = resample_matrix(p, q, beta)
    L = H.shape[0]
    Hb = np.zeros(((block - 1) * q + L, block * p), dtype=np.float64)
    for j in range(block):
        Hb[j * q: j * q + L, j * p: (j + 1) * p] = H
    return Hb, c0


def output_length(n: int, p: int, q: int) -> int:
    """scipy.resample_poly's output length: ceil(n * p / q)."""
    return -(-n * p // q)


def _rational(sr_in: int, sr_out: int) -> tuple[int, int]:
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


def _checked_rational(sr_in: int, sr_out: int) -> tuple[int, int]:
    p, q = _rational(sr_in, sr_out)
    if max(p, q) > MAX_FACTOR:
        raise ValueError(
            f"{sr_in} -> {sr_out} Hz reduces to {p}/{q}; filter and matrix "
            f"size scale with max(p, q) = {max(p, q)} (> {MAX_FACTOR}). "
            "Resample via an intermediate standard rate instead.")
    return p, q


@functools.lru_cache(maxsize=64)
def _taps(p: int, q: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(resample_matrix(p, q)[0], dtype=torch.float32,
                           device=device)


def polyphase(x: torch.Tensor, p: int, q: int, n_blocks: int
              ) -> torch.Tensor:
    """[B, M] float32 samples, M >= (n_blocks - 1)*q + L, whose sample 0
    is block 0's first tap -> [B, n_blocks * p]: the fixed-order tap sum
    (one strided slice, multiply and add per tap, in tap order)."""
    H = _taps(p, q, x.device)
    B = x.shape[0]
    span = (n_blocks - 1) * q + 1
    acc = torch.zeros(B, n_blocks, p, dtype=torch.float32, device=x.device)
    term = torch.empty_like(acc)
    for t in range(H.shape[0]):
        torch.mul(x[:, t: t + span: q, None], H[t], out=term)
        acc.add_(term)
    return acc.reshape(B, n_blocks * p)


def _blocked(x: torch.Tensor, p: int, q: int, block: int, n_blocks: int
             ) -> torch.Tensor:
    """The blocked products over non-overlapping windows: [B, M] with M >=
    (n_blocks + 1) * block*q -> [B, n_blocks * block*p]."""
    Hb, _ = resample_matrix_blocked(p, q, block)
    hop = block * q
    tail = Hb.shape[0] - hop                 # L - q rows reach the next hop
    if not 0 < tail <= hop:
        raise ValueError(f"block {block} too small for {p}/{q}")
    B = x.shape[0]
    win = x[:, : (n_blocks + 1) * hop].reshape(B, n_blocks + 1, hop)
    y = features.matmul(win[:, :-1], Hb[:hop]) \
        + features.matmul(win[:, 1:, :tail], Hb[hop:])
    return y.reshape(B, n_blocks * block * p)


def _to_float(signal, device) -> torch.Tensor:
    """int16 PCM scaled to [-1, 1) (``features._prep``'s promotion), any
    other type cast to float32."""
    x = features.placed(signal, device)
    if x.dtype == torch.int16:
        return x.to(torch.float32) / 32768.0
    return x.to(torch.float32)


def resample(signal, sr_in: int, sr_out: int, *, block: int = 1,
             device=None) -> torch.Tensor:
    """Resample [N] or [B, N] audio from sr_in to sr_out Hz -> [(B,)
    ceil(N*p/q)] float32 on the signal's device (numpy goes to ``device``,
    the card unless the caller names the CPU).

    Matches scipy.signal.resample_poly(x, p, q) to float32 precision; the
    edges are zero-padded, so a padded batch row's valid prefix resamples
    as the lone utterance does. ``block > 1``: the blocked products (see
    the module docstring). Rate pairs whose reduced p or q exceed 2048 are
    refused rather than allocating a huge filter."""
    x = _to_float(signal, device)
    if sr_in == sr_out:
        return x
    p, q = _checked_rational(sr_in, sr_out)
    single = x.dim() == 1
    if single:
        x = x[None]
    block = int(block)
    H, c0 = resample_matrix(p, q)
    L = H.shape[0]
    n_in = x.shape[-1]
    n_out = output_length(n_in, p, q)
    per = block * p
    n_blocks = -(-n_out // per)
    pad_l = max(0, -c0)
    need = (n_blocks - 1) * block * q + L if block == 1 \
        else (n_blocks + 1) * block * q
    xp = torch.nn.functional.pad(
        x, (pad_l, max(0, need - pad_l - n_in)))
    y = polyphase(xp, p, q, n_blocks) if block == 1 \
        else _blocked(xp, p, q, block, n_blocks)
    y = y[:, :n_out]
    return y[0] if single else y


class StreamingResampler:
    """The online sibling of :func:`resample`: chunk in, resampled samples
    out. The concatenation of any chunk plan's outputs and :meth:`flush`
    equals ``resample(whole)`` bit for bit, for every rate pair: both run
    :func:`polyphase` on the same window of each output block.

    The state is the < L samples not yet consumed (61 for 48 kHz -> 16
    kHz) and host counters. Blocks are emitted as soon as their window is
    buffered; :meth:`flush` appends the virtual right zero-padding and
    truncates to scipy's ``ceil(n*p/q)`` output length. ``state`` /
    ``set_state`` checkpoint mid-stream (the reference's layout: a state
    the reference saved loads here as numpy)."""

    def __init__(self, sr_in: int, sr_out: int, batch_size: int = 1,
                 device=None):
        self.sr_in, self.sr_out = int(sr_in), int(sr_out)
        self.passthrough = self.sr_in == self.sr_out
        self.batch_size = batch_size
        self.device = features.default_device(device)
        if not self.passthrough:
            self.p, self.q = _checked_rational(self.sr_in, self.sr_out)
            H, c0 = resample_matrix(self.p, self.q)
            self._L = H.shape[0]
            self._pad_l = max(0, -c0)
        self.reset()

    def reset(self) -> None:
        """Start a new stream (the left zero-padding is pre-buffered)."""
        self._total = 0
        self._blocks = 0
        if not self.passthrough:
            self._fill = self._pad_l
            self.buf = torch.zeros(self.batch_size, self._L,
                                   device=self.device)

    def _step(self, chunk: torch.Tensor, n_ready: int) -> torch.Tensor:
        L, q = self._L, self.q
        data = torch.cat([self.buf[:, L - self._fill:], chunk], dim=1)
        total = self._fill + chunk.shape[1]
        new_fill = total - n_ready * q
        self.buf = torch.cat([data.new_zeros(data.shape[0], L - new_fill),
                              data[:, n_ready * q:]], dim=1)
        self._fill = new_fill
        self._blocks += n_ready
        if n_ready == 0:
            return data.new_zeros(data.shape[0], 0)
        return polyphase(data, self.p, q, n_ready)

    def process(self, chunk) -> torch.Tensor:
        """[B, C] (or [C]) samples at sr_in -> [B, n*p] samples at sr_out
        (0 wide while the filter window fills)."""
        chunk = features.placed(chunk, self.device).to(torch.float32)
        if chunk.dim() == 1:
            chunk = chunk[None]
        if chunk.shape[0] != self.batch_size:
            raise ValueError(f"batch {chunk.shape[0]} != resampler batch "
                             f"{self.batch_size}")
        self._total += chunk.shape[1]
        if self.passthrough:
            return chunk
        total = self._fill + chunk.shape[1]
        return self._step(chunk, max(0, (total - self._L) // self.q + 1))

    def flush(self) -> torch.Tensor:
        """End of stream: the zero-padded tail, so that the concatenated
        output is ``output_length(total, p, q)`` samples long."""
        empty = torch.zeros(self.batch_size, 0, device=self.device)
        if self.passthrough:
            return empty
        n_out = output_length(self._total, self.p, self.q)
        n_blocks = -(-n_out // self.p)
        remaining = n_blocks - self._blocks
        if remaining <= 0:
            return empty
        zeros = (remaining - 1) * self.q + self._L - self._fill
        done = self._blocks
        y = self._step(torch.zeros(self.batch_size, zeros,
                                   device=self.device), remaining)
        return y[:, : n_out - done * self.p]

    def reset_rows(self, rows) -> None:
        """Slot recycle: zero the rows' filter carry, leaving the other
        rows and the shared block clock alone. The slot resamples as a
        stream that carried zeros from the start (the filter is linear, so
        a zero carry is the zeros-prefix history); the other rows keep
        their bits."""
        if not self.passthrough:
            from tpufeat_torch.streaming import zero_rows
            self.buf = zero_rows(self.buf, rows)

    def state(self) -> dict:
        s = {"total": self._total, "blocks": self._blocks}
        if not self.passthrough:
            s.update(buf=self.buf, fill=self._fill)
        return s

    def set_state(self, s: dict) -> None:
        self._total = int(s["total"])
        self._blocks = int(s["blocks"])
        if not self.passthrough:
            self.buf = features.on_device(s["buf"], self.device).to(
                torch.float32)
            self._fill = int(s["fill"])
