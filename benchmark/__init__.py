"""The benchmark of the PyTorch and CUDA port (``mpi_vision_tpu_torch``).

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see ``run.py``.
"""
