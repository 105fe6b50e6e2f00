"""Speaker identification + diarization, end to end.

Synthetic "speakers" share a phone inventory (resonator configs over noise
excitation) and differ by a spectral tilt — the structure i-vectors are
built for (identity is a consistent within-gaussian offset across SHARED
phonetic gaussians). MFCC front-end -> UBM -> total-variability extractor
-> utterance i-vectors -> length-normalize -> PLDA -> verification trial
scores, then who-spoke-when on a concatenated recording (RTTM out), and
the live diarizer on the same recording.

    python -m tpufeat_torch.examples.speaker_id [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

N_SPK, N_UTT, N = 6, 8, 32000
PHONES = [(400 + 180 * i, 1300 + 260 * i) for i in range(8)]


def utterance(spk, seed):
    from scipy.signal import lfilter
    r = np.random.default_rng(seed)
    segs = []
    for _ in range(10):                       # shared phone sequence
        f1, f2 = PHONES[r.integers(len(PHONES))]
        x = r.standard_normal(N // 10)
        for f, rad in ((f1, 0.92), (f2, 0.88)):
            th = 2 * np.pi * f / 16000
            x = lfilter([1.0], [1.0, -2 * rad * np.cos(th), rad * rad], x)
        segs.append(x)
    x = np.concatenate(segs)
    x = lfilter([1.0, -0.6 + 0.24 * spk], [1.0], x)   # speaker tilt
    return (x / (np.abs(x).max() + 1e-9) * 0.5).astype(np.float32)


def main(device=None):
    import tpufeat_torch as tt
    from tpufeat_torch import diarization, features
    from tpufeat_torch.config import MFCC13_HTK

    device = features.default_device(device)
    wavs = [[utterance(s, 77 + s * N_UTT + u) for u in range(N_UTT)]
            for s in range(N_SPK)]
    feats = [tt.extract(np.stack(row), cfg=MFCC13_HTK,
                        device=device).features.cpu().numpy()
             for row in wavs]
    utts = [f for row in feats for f in row]
    ids = [s for s in range(N_SPK) for _ in range(N_UTT)]

    # --- train the stack -------------------------------------------------
    ubm = tt.train_diag_ubm(np.concatenate(utts), 8, iters=2,
                            final_iters=4, device=device)
    ext = tt.train_ivector_extractor(ubm, utts, ivector_dim=4, iters=5,
                                     device=device)
    ivs = tt.length_normalize(np.stack(
        [tt.utterance_ivector(ext, f, device=device).cpu().numpy()
         for f in utts]))
    plda = tt.train_plda(ivs, ids, iters=6)

    # --- verification: enroll on even utterances, test on odd ------------
    enroll_sel = list(range(0, len(ids), 2))
    test_sel = list(range(1, len(ids), 2))
    means, counts, spks = tt.ivector_mean(
        ivs[enroll_sel], [ids[i] for i in enroll_sel])
    scores = plda.score(means, ivs[test_sel], n_enroll=counts,
                        device=device).cpu().numpy()
    truth = np.asarray([ids[i] for i in test_sel])
    pred = np.asarray(spks)[scores.argmax(axis=0)]
    acc = (pred == truth).mean()
    same = scores[np.asarray(spks)[:, None] == truth[None, :]]
    diff = scores[np.asarray(spks)[:, None] != truth[None, :]]
    print(f"verification: top-1 id accuracy {acc:.2f}  "
          f"same-spk LLR {same.mean():+.1f}  diff-spk {diff.mean():+.1f}")

    # --- diarization: spk0 | spk5 | spk0 ---------------------------------
    rec = np.concatenate([wavs[0][0], wavs[5][0], wavs[0][1]])
    rec_feats = tt.extract(rec, cfg=MFCC13_HTK,
                           device=device).features.cpu().numpy()
    labels, segments = tt.diarize(ext, plda, rec_feats, num_speakers=2,
                                  device=device)
    diarization.write_rttm(sys.stdout, "demo", segments)

    # --- online: live speaker labels as the stream arrives ---------------
    # known 2-party call: cap the cluster count, spawn eagerly
    sd = tt.StreamingDiarizer(ext, plda, threshold=6.0, max_speakers=2,
                              device=device)
    live = []
    for i in range(0, rec_feats.shape[0], 100):
        labs, _ = sd.process(rec_feats[i: i + 100])
        live.append(labs)
    labs, _ = sd.flush()
    live.append(labs)
    live_labels = np.concatenate(live)
    print(f"online: {sd.num_speakers} speakers discovered live, "
          f"{live_labels.size} frames labeled")
    labels = np.asarray(labels)
    assert live_labels.shape[0] == rec_feats.shape[0]
    assert acc >= 0.6, acc
    assert same.mean() > diff.mean() + 3.0, (same.mean(), diff.mean())
    assert labels[0] == labels[-1] != labels[len(labels) // 2]
    print("ok: speakers identified and diarized")


if __name__ == "__main__":
    from tpufeat_torch.examples import run
    sys.exit(run("speaker_id", main))
