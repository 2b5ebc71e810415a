"""The benchmark of ``pyfilter_tpu_torch`` on one NVIDIA H100: ``python3 -m
benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``,
driven by ``BENCHMARK.json`` and the files this package finds by name."""
