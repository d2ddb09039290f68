"""The benchmark of the PyTorch and CUDA path tracer
(``real_time_path_tracing_with_spatiotemporal_filtering_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on the card and prints one JSON
line. Configurations, traffic mixes, correctness limits and per-layer
metrics are files found by name (``registry``); the yardstick (traffic
generation, trace arithmetic, peaks, the plain reference and the
comparison) lives here, apart from the program it measures.
"""
