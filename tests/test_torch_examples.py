"""The port's examples (``tpufeat_torch/examples``) run end to end: each
as ``python -m tpufeat_torch.examples.<name> --device cpu`` in a
subprocess, as a user runs it, to exit code 0 (each asserts its own
outcome: the ark round trip, an endpoint, slot turnovers, speakers told
apart and diarized, falling losses), and a card-less default refused."""

import os
import subprocess
import sys

import pytest

from tpufeat_torch.examples import NAMES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, *args):
    return subprocess.run(
        [sys.executable, "-m", f"tpufeat_torch.examples.{name}", *args],
        capture_output=True, text=True, timeout=600, cwd=ROOT)


@pytest.mark.parametrize("name", NAMES)
def test_example_runs(name, tmp_path):
    args = [str(tmp_path)] if name == "offline_corpus" else []
    out = _run(name, *args, "--device", "cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    expect = {"offline_corpus": "ark round-trip OK",
              "online_serving": "endpoint at",
              "serving_pool": "utterance turnovers",
              "speaker_id": "ok: speakers identified and diarized",
              "train_eval": "rnnt beam hypothesis"}[name]
    assert expect in out.stdout, out.stdout
    if name == "offline_corpus":
        assert (tmp_path / "feats.ark").exists()
    if name == "train_eval":
        losses = [float(line.split()[-1]) for line in out.stdout.splitlines()
                  if line.startswith("step ")]
        assert len(losses) == 10
        assert losses[4] < losses[0] and losses[9] < losses[5], losses


def test_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = _run("online_serving")
    assert out.returncode != 0 and "--device cpu" in out.stderr
