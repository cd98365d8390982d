"""The benchmark of the PyTorch and CUDA port (``dsdneo_tpu_torch``).

One command runs one cell of ``BENCHMARK.json`` once, on the card:
``python3 -m portbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``.  See ``portbench/README.md``.
"""
