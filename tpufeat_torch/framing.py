"""Pre-emphasis + overlapped framing — counterpart of ``tpufeat/framing.py``.

Everything is mask-aware: batches are padded to a common length ``N`` and
carry a per-utterance ``lengths`` vector; valid frames never read padding,
so padding contents cannot affect the output. Functions take and return
tensors on whatever device they already live on.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from tpufeat_torch.config import FeatureConfig


def preemphasize(x: torch.Tensor, alpha: float,
                 prev: torch.Tensor | float = 0.0) -> torch.Tensor:
    """y[t] = x[t] - alpha*x[t-1] along the last axis, x[-1] := prev.

    ``prev`` is 0 for one-shot extraction and the carried last raw sample in
    streaming mode (a scalar or one value per stream)."""
    if alpha == 0.0:
        return x
    prev = torch.as_tensor(prev, dtype=x.dtype, device=x.device)
    if prev.dim() == x.dim() - 1:        # per-stream carry, e.g. [B]
        prev = prev[..., None]
    prev = prev.expand(x.shape[:-1] + (1,))
    first = x[..., :1] - alpha * prev
    rest = x[..., 1:] - alpha * x[..., :-1]
    return torch.cat([first, rest], dim=-1)


def num_frames_dynamic(lengths: torch.Tensor,
                       cfg: FeatureConfig) -> torch.Tensor:
    """Per-utterance valid frame count (tensor version of cfg.num_frames)."""
    if cfg.center:
        n = 1 + lengths // cfg.hop_length
        return n - 1 if cfg.drop_last_frame else n
    return torch.clamp(1 + (lengths - cfg.frame_length) // cfg.hop_length,
                       min=0)


def frames_from_buffer(buf: torch.Tensor, n_frames: int, frame_length: int,
                       hop: int) -> torch.Tensor:
    """Overlapped frames [B, n_frames, frame_length]: frame t covers
    ``buf[t*hop : t*hop + frame_length]``; reads past the end of ``buf``
    are zeros. A strided view (``Tensor.unfold``), no copy unless padded."""
    need = (n_frames - 1) * hop + frame_length
    M = buf.shape[-1]
    if M < need:
        buf = F_.pad(buf, (0, need - M))
    return buf[..., :need].unfold(-1, frame_length, hop)


def _reflect_index(pos: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """np.pad(mode="reflect") index math, per utterance.

    Maps a (possibly negative or past-the-end) sample position to the index
    actually read under reflect padding of an utterance of length ``L``:
    period m = 2(L-1), r = |pos| mod m, index = r if r < L else m - r.
    Exact for multi-fold reflection (utterances shorter than the pad).
    L == 1 degenerates to index 0."""
    m = torch.clamp(2 * (lengths - 1), min=1)
    r = pos.abs() % m
    return torch.where(r < lengths, r, m - r)


def framing_buffer(x: torch.Tensor, lengths: torch.Tensor,
                   cfg: FeatureConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Build the framing buffer: frame t covers buf[t*hop : t*hop+fl].

    center=False: the buffer IS the (pre-emphasized) signal.
    center=True (Whisper/torch.stft): frame t starts at t*hop - n_fft//2
    with reflect padding at each utterance's TRUE edges (multi-fold reflect
    indices, so utterances shorter than the pad get exactly
    ``np.pad(mode="reflect")`` semantics and batch padding never leaks in).
    The right reflect only ever influences the ``fl - pad - hop`` samples
    past the true end that the last valid frame reads, so it is one batched
    scatter of that window at each row's own position ``length``.

    Returns (buf [B, M], frame_mask [B, F_max]).
    """
    B, N = x.shape
    fl, hop = cfg.frame_length, cfg.hop_length
    F = cfg.num_frames(N)
    lengths = lengths.to(device=x.device, dtype=torch.int64)
    nf = num_frames_dynamic(lengths, cfg)
    mask = torch.arange(F, device=x.device)[None, :] < nf[:, None]
    if F == 0 or not cfg.center:
        return x, mask
    pad = cfg.n_fft // 2
    if N <= pad:
        raise ValueError(f"centered framing needs > n_fft/2 = {pad} "
                         f"samples, got {N}")
    L = lengths[:, None]
    dist = pad - torch.arange(pad, device=x.device)[None, :]
    left = torch.gather(x, 1, _reflect_index(dist, L).clamp(0, N - 1))
    # overrun: how far past `length` the last VALID frame can read
    over = fl - pad - (hop if cfg.drop_last_frame else 0)
    if over <= 0:
        return torch.cat([left, x], dim=-1), mask
    buf = torch.cat([left, x, x.new_zeros(B, over)], dim=-1)
    j = torch.arange(over, device=x.device)[None, :]
    src = torch.gather(x, 1, _reflect_index(L + j, L).clamp(0, N - 1))
    buf.scatter_(1, pad + L + j, src)
    return buf, mask


def frame_signal(x: torch.Tensor, lengths: torch.Tensor,
                 cfg: FeatureConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Overlapped frames of a padded batch: [B, N] ->
    (frames [B, F_max, frame_length], frame_mask [B, F_max])."""
    buf, mask = framing_buffer(x, lengths, cfg)
    F = cfg.num_frames(x.shape[1])
    if F == 0:
        return x.new_zeros(x.shape[0], 0, cfg.frame_length), mask
    return frames_from_buffer(buf, F, cfg.frame_length, cfg.hop_length), mask


def condition_frames(frames: torch.Tensor, cfg: FeatureConfig) -> torch.Tensor:
    """Per-frame conditioning, *before* the window multiply.

    kaldi_mode applies Kaldi's frame-local order: DC-offset removal, then
    in-frame pre-emphasis with x[-1] := x[0]. (The window itself is applied
    by the caller, or folded into the GEMM-DFT matrices.)"""
    if cfg.kaldi_mode:
        if cfg.dc_offset:
            frames = frames - frames.mean(dim=-1, keepdim=True)
        if cfg.preemphasis:
            first = frames[..., :1] * (1.0 - cfg.preemphasis)
            rest = frames[..., 1:] - cfg.preemphasis * frames[..., :-1]
            frames = torch.cat([first, rest], dim=-1)
    return frames
