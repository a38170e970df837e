"""The benchmark of ``rpeflow_tpu_torch`` on NVIDIA H100 cards.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root of the repository declares the cells and
metrics; :mod:`benchmark.harness` finds each cell's data by name. The
benchmark imports only the program's entry points, and nothing of JAX or the
JAX package.
"""
