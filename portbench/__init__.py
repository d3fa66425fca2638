"""The benchmark of basicrenderer_tpu_torch, the PyTorch and CUDA port:
BENCHMARK.json's cells, run one a process by `python3 -m portbench.run`.
Configurations, traffic mixes, scenes and per-layer metrics are files of
their own (configs/, traffic/, scenes/, metrics/), found by name; the
plain reference that decides `correct` is under reference/."""
