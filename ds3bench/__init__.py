"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of the DS3
simulator: ``python3 ds3bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
