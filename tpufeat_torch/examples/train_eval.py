"""Training + evaluation loop, end to end (config 5).

Raw audio -> front-end (inside the train step) -> tiny Whisper encoder ->
CTC loss -> a few optimization steps -> greedy and prefix-beam decode ->
WER; then the same loop with the RNN-T objective (stateless-predictor
transducer) and beam-search decoding.

    python -m tpufeat_torch.examples.train_eval [--device cpu]
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np


def main(device=None):
    import torch

    from tpufeat_torch import features
    from tpufeat_torch.config import WHISPER80
    from tpufeat_torch.models import train

    device = features.default_device(device)
    cfg = dataclasses.replace(WHISPER80, use_pallas=False)
    rng = np.random.default_rng(0)
    B, n = 2, 8000
    audio = (0.1 * rng.standard_normal((B, n))).astype(np.float32)
    lengths = np.full((B,), n)
    labels = rng.integers(1, 12, (B, 5))
    label_lens = np.full((B,), 5)

    torch.manual_seed(0)
    model = train.make_models(dim=32, layers=1, heads=2, vocab=12,
                              device=device)
    state = train.TrainState(model, train.adamw(model, 3e-3))
    for i in range(5):
        state, loss = train.ctc_train_step(state, audio, lengths, labels,
                                           label_lens, cfg=cfg)
        print(f"step {i}: ctc loss {loss.item():.3f}")

    with torch.no_grad():
        logits, mask = train.asr_forward(model, audio, lengths, cfg)
    hyps = train.greedy_ctc_decode(logits, mask)
    lp = torch.log_softmax(logits, dim=-1)
    beam_hyps = [train.prefix_beam_ctc_decode(lp[b], mask[b], beam=4)
                 for b in range(B)]
    refs = [labels[b, : int(label_lens[b])].tolist() for b in range(B)]
    print("eval greedy:", train.token_error_rate(refs, hyps))
    print("eval beam:  ", train.token_error_rate(refs, beam_hyps))

    # --- the same loop with the RNN-T objective ---------------------------
    torch.manual_seed(1)
    tmodel = train.make_transducer(dim=32, layers=1, heads=2, vocab=12,
                                   arch="whisper", device=device)
    tstate = train.TrainState(tmodel, train.adamw(tmodel, 3e-3))
    for i in range(5):
        tstate, tloss = train.transducer_train_step(
            tstate, audio, lengths, labels, label_lens, cfg=cfg)
        print(f"step {i}: rnnt loss {tloss.item():.3f}")

    # beam decode the first utterance via the trained joint
    with torch.no_grad():
        res = features.extract(audio, lengths, cfg, device=device)

    def joint_fn(frame, history):
        # tiny-demo joint: re-run the (cheap) model on the fixed history
        hist = np.zeros((1, labels.shape[1]), np.int64)
        hist[0, : min(len(history), labels.shape[1])] = \
            history[: labels.shape[1]]
        with torch.no_grad():
            lg, _ = tmodel(res.features[:1], res.mask[:1], hist)
        u = min(len(history), labels.shape[1])
        return lg[0, int(frame[0]), u]

    enc_idx = np.arange(int(res.mask[0].sum()), dtype=np.float32)[:, None]
    hyp = train.beam_transducer_decode(joint_fn, enc_idx[:20],
                                       np.ones(20, bool), beam=2,
                                       max_symbols=3)
    print(f"rnnt beam hypothesis (first 20 frames): {hyp}")


if __name__ == "__main__":
    from tpufeat_torch.examples import run
    sys.exit(run("train_eval", main))
