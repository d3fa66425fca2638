"""Per-layer metrics, one module a metric, found by the metric's name in
BENCHMARK.json. Each module names the end-to-end metric it moves
(`MOVES`) and reads the traced run's record with `read(rec)`, returning a
number, or None where the run has nothing to read (the metric is then
left out of the result line). A module whose metric needs a kernel's
launches names the port's entry to capture in the traced frames
(`CAPTURE`, a dotted path under the port's package) and gives
`bound_ms(args, kwargs, rec)` for one captured call; the harness wraps
that entry in the profiled frames and stores the bounds under
rec["captures"][<metric>]. The record's keys are listed in
portbench/harness.py (`run_cell`)."""
