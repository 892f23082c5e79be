"""The port's paper-table emitters (counterparts of the repo's top-level
``benchmarks/``, file by file): the same row names and fields, the same
``name,us_per_call,derived`` CSV line, and for table11-13 the same JSON
artifact, tagged ``meta.framework = "torch"``.  Each runs as
``python -m repro_torch.benchmarks.<name>`` on the card, or on the CPU
with ``--device cpu``; ``check_counts`` gates table11-13's counts against
``benchmarks/baselines/BENCH_core_baseline.json``."""
