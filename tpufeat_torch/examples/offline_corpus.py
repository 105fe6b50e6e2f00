"""Offline corpus extraction, end to end.

Generates a tiny synthetic WAV corpus, extracts Kaldi-style 39-dim
features with corpus-level CMVN, and writes a Kaldi binary archive — the
batch-production shape.

    python -m tpufeat_torch.examples.offline_corpus [workdir] [--device cpu]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np


def main(workdir=None, device=None):
    from tpufeat_torch import KALDI39, data, feats_io, io, pipeline

    workdir = workdir or tempfile.mkdtemp(prefix="tpufeat_torch_demo_")
    wav_dir = os.path.join(workdir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(6):
        n = int(rng.integers(8000, 32000))
        io.write_wav(os.path.join(wav_dir, f"utt{i}.wav"),
                     (0.3 * rng.standard_normal(n)).astype(np.float32),
                     16000)

    cfg = KALDI39
    stats = {}
    cmvn = data.CmvnStats(cfg.feature_dim)
    utts = {}
    for path, feats in pipeline.extract_corpus(wav_dir, cfg, batch_size=4,
                                               stats=stats, device=device):
        cmvn.accumulate(feats)
        utts[os.path.basename(path)] = feats
    normalized = {feats_io.ark_keys([k])[0]: cmvn.apply(f)
                  for k, f in utts.items()}
    ark = os.path.join(workdir, "feats.ark")
    feats_io.write_kaldi_ark(ark, normalized,
                             scp_path=os.path.join(workdir, "feats.scp"))
    print(f"{len(utts)} utterances -> {ark}")
    print(f"pipeline stats: {stats}")
    back = feats_io.read_kaldi_ark(ark)
    assert len(back) == len(utts)
    print("ark round-trip OK; first utt:",
          next(iter(back.values())).shape)
    return workdir


if __name__ == "__main__":
    from tpufeat_torch.examples import run
    sys.exit(run("offline_corpus", main, "workdir"))
