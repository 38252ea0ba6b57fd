"""The benchmark of the PyTorch and CUDA port (``crdt_enc_tpu_torch``).

Run one cell with ``python3 -m portbench.run --workload NAME --seed N
--seconds S --trace 0|1``; ``BENCHMARK.json`` at the root names the cells.
"""
