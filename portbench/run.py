"""The port's benchmark: one cell of BENCHMARK.json, once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted` (frames dispatched in the window),
`failed` (frames whose bin or cluster list overflowed), `metrics` (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
`device`, with --trace 1 `breakdown`, and last `checks` (each number the
check compared, with its limit), which also close standard error. Exits
with another code than 0, printing no result, without as many CUDA
devices as the cell asks for, or when JAX or the JAX package is loaded
once the window has closed.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Libraries that would load JAX by themselves, kept from doing so.
    os.environ.setdefault("USE_FLAX", "0")
    # One host thread for tensor and array work on the host (the
    # configuration's `assumed`): the frame loop is host-bound, and a
    # pool of threads on shared cores spreads its runs.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = harness.cell_spec(json.load(f), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"portbench: {spec['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = harness.run_cell(spec, args.seed, args.seconds,
                              bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
