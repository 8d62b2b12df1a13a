"""What the benchmark loads. A run (here a tiny one on the CPU, through the
harness, as `run.py` drives it) loads nothing whose top-level module name
(the part before the first dot, compared whole) is `jax`, `jaxlib`, `flax`
or the JAX package `mrfa_tpu`; the reference loads nothing of the port
`mrfa_tpu_torch` either. Each check runs in a fresh interpreter."""
import json
import subprocess
import sys

from portbench.tests.small import ROOT

REPO = ROOT.parent

RUN = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from portbench import harness
from portbench.tests.small import BENCH, TRAINING, cell_args
sys.path.insert(0, {root!r})
import run  # the command's module, as the command loads it
keys = ("name", "config", "traffic", "chips", "why")  # a training cell beside the benchmark's
bench = dict(BENCH, workloads=BENCH["workloads"] + [{{k: c[k] for k in keys}} for c in TRAINING])
for cell in {cells!r}:
    harness.run(cell, 7, 0.1, False, **cell_args(cell, bench))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
import portbench.reference.serve, portbench.reference.train, portbench.reference.lowp
from portbench.reference.models.mrfa import MRFA
from portbench.tests.small import model_cfg
from portbench.weights import make_weights
cfg = model_cfg("vox1-tpsm")
m = MRFA(cfg, "cpu")
m.load_state_dict(make_weights(cfg, 1, "cpu"))
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True, cwd=REPO)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN.format(repo=str(REPO), root=str(ROOT),
                              cells=["vox1-mtia.serve-s8-bf16-graph", "vox1-tpsm.train-b10-f32"]))
    assert "mrfa_tpu_torch" in names and "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "mrfa_tpu"}


def test_the_reference_loads_neither_jax_nor_the_port():
    names = loaded(REFERENCE.format(repo=str(REPO)))
    assert "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "mrfa_tpu", "mrfa_tpu_torch"}


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        return  # the card's own tests cover a run there
    out = subprocess.run([sys.executable, str(ROOT / "run.py"), "--workload",
                          "vox1-mtia.serve-s1-bf16-graph", "--seed", "3", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
