"""Readings for the limits of the check (portbench/check.py): for each
seed, one run of a cell at its own size with a short window, the
program's readings against the reference (the lower readings) and the
control's, the reference in a precision below the configuration's put in
the program's place (the upper readings). The benchmark's own runs never
run the control.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 \\
        --seconds 4 [--controls tf32]

Prints one JSON line a seed: {"seed", "checks", "controls"}.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--controls", default="tf32")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = harness.cell_spec(json.load(f), args.workload)
    controls = tuple(c for c in args.controls.split(",") if c)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        res = harness.run_cell(spec, seed, args.seconds, False, t0,
                               controls=controls)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "frames": res["attempted"],
                          "checks": {k: v["value"]
                                     for k, v in res["checks"].items()},
                          "controls": res.get("controls", {}),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
