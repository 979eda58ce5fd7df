"""The benchmark of the PyTorch and CUDA port (``flowdenoising_tpu_torch``).

``python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see
``benchmarks/README.md``.  Nothing here imports JAX or the JAX package.
"""
