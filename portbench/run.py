"""Run one cell of the PyTorch port's benchmark once, on the CUDA card of
this machine:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result as one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` `breakdown`, and last `checks`: each number the
correctness check compared, beside its limit); the last lines of standard
error repeat the checks. Without a CUDA card, or with fewer cards than the
cell asks for, it prints no result and exits 2; if JAX or the JAX package
was loaded, it exits 3.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mrfa_tpu")


def loaded_forbidden():
    """Modules whose top-level name (before the first dot) is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(REPO))
    import torch

    from portbench import harness

    bench = harness.load_json(REPO / "BENCHMARK.json")
    chips = harness.cell_spec(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                 "cuda", T_START, bench)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for line in checks:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
