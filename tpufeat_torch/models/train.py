"""Serving and training through the front-end and an encoder (config 5) —
counterpart of ``tpufeat/models/train.py``.

Serving: :func:`asr_forward` takes raw audio through
:func:`tpufeat_torch.features.extract` (with the fused flags in ``cfg``,
the hand-written signal kernel) and an encoder to per-frame logits; the
decoders (greedy and prefix-beam CTC, greedy and beam transducer) run on
the host, as in the reference. Training: one CTC step
(:func:`ctc_train_step`) or one RNN-T step (:func:`transducer_train_step`,
the stateless-predictor transducer of :func:`make_transducer`), each with
AdamW at optax's defaults (:func:`adamw`). Every step runs with TF32 off
(``kernels.signal.no_tf32``), the backward pass included.

Departures from the reference:
- a :class:`TrainState` holds the model, its optimizer and the step count,
  and a step updates it in place (torch's idiom) and returns it;
- checkpoints are ``torch.save`` of the state dicts, not orbax;
- the CTC loss is ``F.ctc_loss`` on log-probabilities: on a sequence that
  no alignment fits (more labels and repeats than frames) it gives 0 and
  no gradient (``zero_infinity``), where optax floors the log-probability
  at -1e5 and gives a loss near 1e5; feasible sequences agree;
- :func:`transducer_loss` runs the reference's alpha recursion by
  anti-diagonals (T + U vectorised steps) instead of a scan over T with a
  loop over U inside: the same per-cell formula in the same order;
- ``dryrun_train_step`` (the dp-sharded step on a mesh) waits for the
  port's sharding (ROADMAP.md queue 1, item 13).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpufeat_torch import features
from tpufeat_torch.config import FeatureConfig
from tpufeat_torch.kernels.signal import no_tf32
from tpufeat_torch.models import encoder as enc_lib

__all__ = ["TrainState", "adamw", "make_models", "asr_forward", "ctc_loss",
           "ctc_train_step", "save_train_state", "load_train_state",
           "greedy_ctc_decode", "edit_distance", "edit_alignment",
           "token_error_rate", "transducer_loss", "greedy_transducer_decode",
           "make_transducer", "transducer_train_step",
           "beam_transducer_decode", "prefix_beam_ctc_decode"]

#: optax.adamw's weight decay (torch's AdamW defaults to 1e-2)
WEIGHT_DECAY = 1e-4
#: the transducer loss's log(0) on padded labels, the reference's
NEG = -1e30


@dataclasses.dataclass
class TrainState:
    """A model, its optimizer and the number of steps taken."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def adamw(model: nn.Module, lr: float) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: betas (0.9, 0.999), eps 1e-8, weight decay
    1e-4, over every parameter of ``model``."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=WEIGHT_DECAY)


def device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _encoder_name(arch: str) -> str:
    """The encoder's flax name inside a model."""
    return "WhisperEncoder_0" if arch == "whisper" else "ConformerEncoder_0"


def _encoder(arch: str, dim: int, layers: int, heads: int,
             in_dim: int) -> nn.Module:
    if arch == "whisper":
        return enc_lib.WhisperEncoder(dim=dim, layers=layers, heads=heads,
                                      in_dim=in_dim, device="cpu")
    return enc_lib.ConformerEncoder(dim=dim, layers=layers, heads=heads,
                                    in_dim=in_dim, device="cpu")


class ASRModel(nn.Module):
    """An encoder and a linear head: features [B, T, in_dim] + mask ->
    (logits [B, T', vocab], mask [B, T'])."""

    def __init__(self, dim: int, layers: int, heads: int, vocab: int,
                 arch: str, in_dim: int, device=None):
        super().__init__()
        self.arch = arch
        self.add_module(_encoder_name(arch),
                        _encoder(arch, dim, layers, heads, in_dim))
        self.head = enc_lib.dense(dim, vocab)
        enc_lib.built(self, device)

    @property
    def encoder(self) -> nn.Module:
        return getattr(self, _encoder_name(self.arch))

    def forward(self, mel: torch.Tensor, mask: torch.Tensor):
        x, m2 = self.encoder(mel, mask)
        with no_tf32():
            return self.head(x), m2


def make_models(dim: int = 384, layers: int = 4, heads: int = 6,
                vocab: int = 64, arch: str = "whisper", in_dim: int = 80,
                device=None) -> ASRModel:
    """The CTC model: whisper-tiny's widths and a 64-token head by default;
    ``arch="conformer"`` for a Conformer encoder. ``in_dim``: the
    features' width (80 for ``WHISPER80``, 39 for ``KALDI39``)."""
    return ASRModel(dim, layers, heads, vocab, arch, in_dim, device)


def asr_forward(model: nn.Module, audio, lengths, cfg: FeatureConfig):
    """Raw audio [B, N] (numpy goes to the model's device) -> (logits,
    frame mask): the serving path. The features run under ``no_grad``;
    wrap a serving call in ``torch.no_grad()`` too."""
    with torch.no_grad():
        res = features.extract(audio, lengths, cfg,
                               device=device_of(model))
    return model(res.features.float(), res.mask)


def ctc_loss(logits: torch.Tensor, mask: torch.Tensor, labels,
             label_lengths, *, blank: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood [B] of ``labels`` [B, S]
    (the first ``label_lengths`` of each row) under ``logits`` [B, T, V]
    over the valid frames of ``mask`` [B, T] (a prefix of each row).
    A sequence no alignment fits gives 0 (see the module's notes)."""
    lp = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    dev = logits.device
    return F.ctc_loss(lp, features.on_device(labels, dev).long(),
                      mask.sum(dim=-1), features.on_device(label_lengths,
                                                           dev).long(),
                      blank=blank, reduction="none", zero_infinity=True)


def optimizer_step(state: TrainState, loss_fn
                   ) -> tuple[TrainState, torch.Tensor]:
    """One step of ``state``'s optimizer on ``loss_fn()`` (a scalar
    loss), TF32 off throughout: the shared body of the training steps."""
    with no_tf32():
        loss = loss_fn()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
    state.step += 1
    return state, loss.detach()


def ctc_train_step(state: TrainState, audio, lengths, labels,
                   label_lengths, *, cfg: FeatureConfig
                   ) -> tuple[TrainState, torch.Tensor]:
    """One CTC training step on raw audio: (the updated state, the mean
    loss of the batch before the update)."""
    def loss_fn():
        logits, mask = asr_forward(state.model, audio, lengths, cfg)
        return ctc_loss(logits, mask, labels, label_lengths).mean()
    return optimizer_step(state, loss_fn)


# --- checkpoint/resume for training state ---

def save_train_state(path: str, state: TrainState) -> None:
    """Persist a :class:`TrainState`: the model's and the optimizer's
    state dicts and the step, with ``torch.save``."""
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, path)


def load_train_state(path: str, like: TrainState) -> TrainState:
    """Restore a state saved by :func:`save_train_state` into ``like`` (a
    freshly built model and optimizer of the same shapes) and return it."""
    saved = torch.load(path, map_location=device_of(like.model),
                       weights_only=True)
    like.model.load_state_dict(saved["model"])
    like.optimizer.load_state_dict(saved["optimizer"])
    like.step = int(saved["step"])
    return like


def _host(a) -> np.ndarray:
    """A tensor (anywhere) or array-like as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def greedy_ctc_decode(logits, mask, blank: int = 0) -> list[list[int]]:
    """Greedy CTC decoding: argmax per frame, collapse repeats, drop blanks,
    stop at the first padded frame."""
    ids = _host(torch.as_tensor(logits).argmax(dim=-1))
    valid = _host(mask)
    out = []
    for b in range(ids.shape[0]):
        seq, prev = [], -1
        for t in range(ids.shape[1]):
            if not valid[b, t]:
                break
            tok = int(ids[b, t])
            if tok != prev and tok != blank:
                seq.append(tok)
            prev = tok
        out.append(seq)
    return out


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance between two token sequences (the WER/CER
    core), on the host."""
    return sum(edit_alignment(ref, hyp))


def edit_alignment(ref, hyp) -> tuple[int, int, int]:
    """(substitutions, insertions, deletions) of a minimum-cost alignment,
    preferring substitution on ties, like sclite.
    ``sum(edit_alignment(r, h)) == edit_distance(r, h)``."""
    ref, hyp = list(ref), list(hyp)
    R, H = len(ref), len(hyp)
    # each cell: (total, sub, ins, dele) — counts ride along the DP
    prev = [(j, 0, j, 0) for j in range(H + 1)]
    for i in range(1, R + 1):
        cur = [(i, 0, 0, i)] + [None] * H
        for j in range(1, H + 1):
            diag = prev[j - 1]
            hit = ref[i - 1] == hyp[j - 1]
            best = (diag[0] + (not hit), diag[1] + (not hit), diag[2],
                    diag[3])
            up = prev[j]                                   # deletion
            if up[0] + 1 < best[0]:
                best = (up[0] + 1, up[1], up[2], up[3] + 1)
            left = cur[j - 1]                              # insertion
            if left[0] + 1 < best[0]:
                best = (left[0] + 1, left[1], left[2] + 1, left[3])
            cur[j] = best
        prev = cur
    _, sub, ins, dele = prev[H]
    return sub, ins, dele


def token_error_rate(refs, hyps) -> dict:
    """Corpus token error rate (WER over word ids / CER over char ids): the
    edit distances over the total reference length, with the breakdown
    (``compute-wer``'s). Returns {"ter", "errors", "sub", "ins", "del",
    "ref_tokens", "utterances"}; ter is inf when the references are empty
    and the hypotheses are not."""
    if len(refs) != len(hyps):
        raise ValueError(f"{len(refs)} references vs {len(hyps)} "
                         "hypotheses")
    sub = ins = dele = 0
    for r, h in zip(refs, hyps):
        s, i, d = edit_alignment(r, h)
        sub, ins, dele = sub + s, ins + i, dele + d
    errors = sub + ins + dele
    n_ref = sum(len(list(r)) for r in refs)
    if n_ref == 0:
        ter = 0.0 if errors == 0 else float("inf")
    else:
        ter = errors / n_ref
    return {"ter": ter, "errors": errors, "sub": sub, "ins": ins,
            "del": dele, "ref_tokens": n_ref, "utterances": len(refs)}


# --- RNN-T / transducer objective ---

def transducer_loss(logits: torch.Tensor, logit_lengths, labels,
                    label_lengths, *, blank: int = 0) -> torch.Tensor:
    """RNN-T loss (Graves 2012): ``logits`` [B, T, U+1, V] joint outputs
    over T encoder frames x U+1 prediction states, ``labels`` [B, U] (+
    valid lengths per sequence) -> the negative log marginal over all
    monotonic alignments, [B].

    alpha(t, u) = logaddexp(alpha(t-1, u) + blank(t-1, u),
    alpha(t, u-1) + emit(t, u-1)), alpha(0, 0) = 0, computed one
    anti-diagonal t + u = n at a time: T + U vectorised steps over [B, U+1]
    cells. Padded labels emit at -1e30; a sequence's result is read at
    (tlen-1, llen), so padded frames never reach it. Autograd gives the
    gradient (checked against finite differences in the tests)."""
    lp = torch.log_softmax(logits, dim=-1)
    B, T, U1, V = lp.shape
    U = U1 - 1
    dev = lp.device
    labels = features.on_device(labels, dev).long()
    if tuple(labels.shape) != (B, U):
        raise ValueError(f"labels {tuple(labels.shape)} vs logits U={U}")
    llen = features.on_device(label_lengths, dev).long()
    tlen = features.on_device(logit_lengths, dev).long()
    neg = torch.tensor(NEG, dtype=lp.dtype, device=dev)

    blank_lp = lp[..., blank]                               # [B, T, U+1]
    emit_lp = torch.gather(lp[:, :, :U, :], 3,
                           labels[:, None, :, None].expand(B, T, U, 1))[..., 0]
    u_ix = torch.arange(U, device=dev)
    emit_lp = torch.where(u_ix[None, None, :] < llen[:, None, None],
                          emit_lp, neg)                     # [B, T, U]
    # skewed: row n, column u holds cell (t, u) = (n - u, u); cells off
    # the grid are -1e30
    n_diag = T + U
    t_ix = (torch.arange(n_diag, device=dev)[:, None]
            - torch.arange(U1, device=dev)[None, :])        # [N, U+1]
    on_grid = (t_ix >= 0) & (t_ix < T)
    t_c = t_ix.clamp(0, T - 1)
    cols = torch.arange(U1, device=dev)[None, :]
    blank_sk = torch.where(on_grid, blank_lp[:, t_c, cols], neg)
    emit_sk = torch.where(on_grid[:, :U], emit_lp[:, t_c[:, :U], cols[:, :U]],
                          neg)                              # [B, N, U]
    alpha = torch.cat([torch.zeros((B, 1), dtype=lp.dtype, device=dev),
                       neg.expand(B, U)], dim=1)
    edge = neg.expand(B, 1)
    diags = [alpha]
    for n in range(1, n_diag):
        # cell (t, u) on diagonal n from (t-1, u) by a blank at t-1 and
        # from (t, u-1) by emitting label u-1 at t, both on diagonal n-1
        stay = alpha + blank_sk[:, n - 1]
        move = torch.cat([edge, alpha[:, :U] + emit_sk[:, n - 1]], dim=1)
        alpha = torch.logaddexp(stay, move)
        diags.append(alpha)
    alphas = torch.stack(diags, dim=1)                      # [B, N, U+1]
    rows = torch.arange(B, device=dev)
    a_fin = alphas[rows, tlen - 1 + llen, llen]
    b_fin = blank_lp[rows, tlen - 1, llen]
    return -(a_fin + b_fin)


def greedy_transducer_decode(joint_fn, enc, mask, max_symbols: int = 200,
                             *, blank: int = 0) -> list[int]:
    """Greedy RNN-T decoding on the host (one utterance; the joint is a
    caller-supplied ``joint_fn(enc_frame [D], history list) -> [V]``
    callable). Returns the emitted label list."""
    out = []
    m = _host(mask).astype(bool)
    for t in range(enc.shape[0]):
        if not m[t]:
            break
        emitted = 0
        while emitted < max_symbols:
            k = int(_host(joint_fn(enc[t], out)).argmax())
            if k == blank:
                break
            out.append(k)
            emitted += 1
    return out


class Transducer(nn.Module):
    """Streaming-ASR transducer: encoder + stateless prediction network
    (an embedding sum over the last ``context`` labels) + joint.
    ``forward(mel, mask, labels)`` gives [B, T', U+1, vocab] joint logits
    for :func:`transducer_loss` (the label axis is the blank-prepended
    history positions) and the encoder's mask."""

    def __init__(self, dim: int, layers: int, heads: int, vocab: int,
                 context: int, arch: str, in_dim: int, device=None):
        super().__init__()
        self.context, self.arch = context, arch
        self.add_module(_encoder_name(arch),
                        _encoder(arch, dim, layers, heads, in_dim))
        self.pred_embed = nn.Embedding(vocab + 2, dim)
        with torch.no_grad():     # flax nn.Embed: variance 1/features
            nn.init.normal_(self.pred_embed.weight, 0.0, 1.0 / math.sqrt(dim))
        self.pred_proj = enc_lib.dense(dim, dim)
        self.pred_ln = enc_lib.layer_norm(dim)
        self.joint_enc = enc_lib.dense(dim, dim)
        self.joint_pred = enc_lib.dense(dim, dim)
        self.joint_out = enc_lib.dense(dim, vocab)
        enc_lib.built(self, device)

    @property
    def encoder(self) -> nn.Module:
        return getattr(self, _encoder_name(self.arch))

    def forward(self, mel: torch.Tensor, mask: torch.Tensor, labels):
        x, m2 = self.encoder(mel, mask)                         # [B, T, D]
        labels = features.on_device(labels, x.device).long()
        B, U = labels.shape
        c = self.context
        with no_tf32():
            # prediction input u: the context labels before position u
            # (u=0 sees only padding), embeddings summed
            padded = F.pad(labels + 1, (c, 0))
            hist = torch.zeros((B, U + 1, x.shape[-1]), device=x.device)
            for k in range(c):
                hist = hist + self.pred_embed(
                    padded[:, c - 1 - k: c - 1 - k + U + 1])
            g = F.relu(self.pred_ln(self.pred_proj(hist)))     # [B, U+1, D]
            j = (self.joint_enc(x)[:, :, None, :]
                 + self.joint_pred(g)[:, None, :, :])
            return self.joint_out(torch.tanh(j)), m2


def make_transducer(dim: int = 128, layers: int = 2, heads: int = 4,
                    vocab: int = 64, context: int = 2,
                    arch: str = "conformer", in_dim: int = 80,
                    device=None) -> Transducer:
    """The stateless-predictor transducer (Ghodsi et al. 2020)."""
    return Transducer(dim, layers, heads, vocab, context, arch, in_dim,
                      device)


def transducer_train_step(state: TrainState, audio, lengths, labels,
                          label_lengths, *, cfg: FeatureConfig
                          ) -> tuple[TrainState, torch.Tensor]:
    """One RNN-T training step: raw audio -> front-end -> encoder ->
    stateless prediction and joint -> :func:`transducer_loss` (the mean
    over the batch)."""
    def loss_fn():
        model = state.model
        with torch.no_grad():
            res = features.extract(audio, lengths, cfg,
                                   device=device_of(model))
        logits, mask = model(res.features.float(), res.mask, labels)
        tlen = mask.sum(dim=-1)
        return transducer_loss(logits, tlen, labels, label_lengths).mean()
    return optimizer_step(state, loss_fn)


def beam_transducer_decode(joint_fn, enc, mask, beam: int = 4,
                           max_symbols: int = 200, *,
                           blank: int = 0) -> list[int]:
    """Beam-search RNN-T decoding on the host (one utterance; the same
    ``joint_fn(enc_frame, history) -> [V]`` unnormalized logits callable as
    :func:`greedy_transducer_decode`).

    Time-synchronous, expanded by history length within each frame so that
    identical histories merge once before expansion; blank-consumed masses
    accumulate in the frame's done-set by log-adds, and a frame ends once
    the best pending hypothesis cannot beat the worst retained done score.
    Returns the best label list."""
    m = _host(mask).astype(bool)
    beams = {(): 0.0}                       # history tuple -> logp
    for t in range(enc.shape[0]):
        if not m[t]:
            break
        # bucket the incoming hypotheses by history length; expand
        # shortest-first so extensions merge before their own expansion
        pending: dict = {}
        for hist, lp in beams.items():
            pending.setdefault(len(hist), {})[hist] = lp
        min_len = min(pending) if pending else 0
        done: dict = {}
        length = min_len
        while pending and length <= min_len + max_symbols:
            layer = pending.pop(length, None)
            length += 1
            if not layer:
                continue
            # nothing pending can beat the retained set: stop
            if len(done) >= beam:
                bar = sorted(done.values(), reverse=True)[beam - 1]
                best_pending = max(
                    max(d.values()) for d in ([layer] +
                                              list(pending.values())))
                if best_pending < bar:
                    break
            top = sorted(layer.items(), key=lambda kv: -kv[1])[:beam]
            for hist, lp in top:
                logits = _host(joint_fn(enc[t], list(hist))).astype(
                    np.float64)
                logp = logits - np.logaddexp.reduce(logits)
                b_lp = lp + logp[blank]
                done[hist] = (np.logaddexp(done[hist], b_lp)
                              if hist in done else b_lp)
                nxt = pending.setdefault(len(hist) + 1, {})
                for v in np.argsort(logp)[::-1][:beam]:
                    if v == blank:
                        continue
                    h2 = hist + (int(v),)
                    l2 = lp + logp[v]
                    nxt[h2] = (np.logaddexp(nxt[h2], l2)
                               if h2 in nxt else l2)
        beams = dict(sorted(done.items(), key=lambda kv: -kv[1])[:beam])
    best = max(beams.items(), key=lambda kv: kv[1])[0]
    return list(best)


def prefix_beam_ctc_decode(log_probs, mask, beam: int = 8, *,
                           blank: int = 0) -> list[int]:
    """CTC prefix beam search on the host (Hannun et al.): [T, V]
    log-softmaxed frame posteriors (+ [T] validity mask) -> the best label
    list. Each prefix carries separate blank-ending and nonblank-ending log
    masses so repeats collapse exactly; prefixes merge by log-sum."""
    lp = _host(log_probs).astype(np.float64)
    m = _host(mask).astype(bool)
    NEG_INF = -np.inf

    def lse(a, b):
        if a == NEG_INF:
            return b
        if b == NEG_INF:
            return a
        hi, lo = (a, b) if a >= b else (b, a)
        return hi + math.log1p(math.exp(lo - hi))

    # prefix -> (logp ending in blank, logp ending in its last symbol)
    beams = {(): (0.0, NEG_INF)}
    for t in range(lp.shape[0]):
        if not m[t]:
            break
        nxt: dict = {}

        def add(pref, b_, nb_):
            ob, onb = nxt.get(pref, (NEG_INF, NEG_INF))
            nxt[pref] = (lse(ob, b_), lse(onb, nb_))

        for pref, (pb, pnb) in beams.items():
            total = lse(pb, pnb)
            # blank keeps the prefix, ends in blank
            add(pref, total + lp[t, blank], NEG_INF)
            if pref:
                # repeat the last symbol: only extends the nonblank mass
                add(pref, NEG_INF, pnb + lp[t, pref[-1]])
            for v in range(lp.shape[1]):
                if v == blank:
                    continue
                ext = pref + (v,)
                if pref and v == pref[-1]:
                    # same symbol after a blank -> new occurrence
                    add(ext, NEG_INF, pb + lp[t, v])
                else:
                    add(ext, NEG_INF, total + lp[t, v])
        beams = dict(sorted(nxt.items(),
                            key=lambda kv: -lse(*kv[1]))[:beam])
    best = max(beams.items(), key=lambda kv: lse(*kv[1]))[0]
    return list(best)
