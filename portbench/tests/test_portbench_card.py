"""On a card: the command runs each cell for a short window and reports a
correct result in the contract's form (skipped without a card)."""
import json
import subprocess
import sys

import pytest

from portbench.tests.small import BENCH, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_the_command_on_a_card(cell, cuda_card):
    out = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload", cell,
                          "--seed", str(2 ** 32 + 77), "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert "setup_s" in result["metrics"]
