"""The benchmark of kintinuous_tpu_torch, the PyTorch and CUDA port: one
command runs one cell (a configuration under a traffic mix) once,

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON line. Cells, configurations, traffic mixes,
per-layer metrics and the limits of the correctness check are found by
name in BENCHMARK.json, configs/, traffic/, metrics/ and limits/.
"""
