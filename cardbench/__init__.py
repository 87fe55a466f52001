"""cardbench: the benchmark of the PyTorch and CUDA port (`repro_torch`) on
one NVIDIA H100.

`python cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` and prints one JSON line.  The
harness finds every configuration, traffic mix, metric reader and limit by
its name (see `cardbench/README.md`).  Nothing here imports `jax` or the
JAX package `repro`; the program under test is `repro_torch`.
"""
