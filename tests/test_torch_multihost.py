"""``tools/multihost_smoke_torch.py --device cpu``: two OS processes start
``torch.distributed`` (gloo), run one sharded classic step over a rows-4
mesh (two shards a rank) and check the shards each holds against the
port's numpy oracle, then time the exchange of one 1024-wide int32 row."""

import json
import os
import subprocess
import sys

import pytest

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                    "multihost_smoke_torch.py")


@pytest.mark.multiprocess
def test_two_gloo_processes_bit_identical_to_oracle():
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK")}
    proc = subprocess.run(
        [sys.executable, TOOL, "--procs", "2", "--local-shards", "2", "--device", "cpu",
         "--timeout", "120"],
        capture_output=True, text=True, timeout=180, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for rank in (0, 1):
        assert f"proc {rank}: 2 shards bit-identical to oracle" in proc.stdout
    timings = [json.loads(l) for l in proc.stdout.splitlines() if l.startswith("{")]
    assert sorted(t["proc"] for t in timings) == [0, 1]
    assert all(t["backend"] == "gloo" and t["exchange_us"] > 0 for t in timings)


def test_the_card_is_the_default():
    """With no --device the tool wants one GPU per rank and refuses at
    once on a host without them."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    proc = subprocess.run([sys.executable, TOOL, "--procs", "2"], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0 and "is_available" in proc.stderr
