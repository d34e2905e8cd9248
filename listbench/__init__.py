"""The benchmark of ``repro_torch``, LIST's PyTorch and CUDA port, on one
H100: ``python3 listbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the repository's root. ``BENCHMARK.json`` names
the cells; the files under this folder are found by those names."""
