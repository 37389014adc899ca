"""wam_bench: the benchmark of ``webaudio_modem_tpu_torch`` on one GPU.

``python -m wam_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  See ``wam_bench/README.md``.
"""
