"""The readings the correctness limits are set from, on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] \\
        [--control K] [--seconds S] [--out FILE]

For each seed one run of the cell in this process (the program's readings,
as a benchmark run takes them, after a window of S seconds at the cell's own
load). On the first K seeds also the control: the reference computed in the
precision below the configuration's (the workload's `control`) in the
program's place, against the reference; and, for a training cell, the
planted faults read the same way: half of each batch left out (the mean
over the rest), and the state left unchanged. One JSON line a seed, also
appended to FILE. The benchmark's own runs do not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def serving_control(ctx, entry):
    from portbench import frames
    from portbench.reference.lowp import lower_precision

    model = frames.reference_model(ctx)
    with lower_precision(model, ctx.workload["control"]):
        got = frames.reference_frames(ctx, model, entry.sample.kept, entry.sources, entry.clips)
    return {"control": frames.compare(entry.sample.kept, entry.want, got)}


def training_control(ctx, entry):
    import torch

    from portbench.compare import training_gaps

    program = (entry.losses, entry.grad_norms, entry.change_norms)
    return {
        "control": training_gaps(entry.reference(precision=ctx.workload["control"]), entry.ref),
        "half_batch": training_gaps(entry.reference(rows=entry.batch // 2), entry.ref),
        "unchanged": training_gaps(program[:2] + (torch.zeros_like(entry.change_norms),),
                                   entry.ref),
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=0)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(REPO / "BENCHMARK.json")
    for i, seed in enumerate(args.seeds):
        hook = None
        if i < args.control:
            def hook(ctx, entry):
                kind = "serving" if hasattr(entry, "sample") else "training"
                return (serving_control if kind == "serving" else training_control)(ctx, entry)
        t0 = time.perf_counter()
        result, _ = harness.run(args.workload, seed, args.seconds, False, "cuda",
                                T_START if i == 0 else t0, bench, after_check=hook)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "seconds_total": time.perf_counter() - t0, **result})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
