"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``. Nothing here imports JAX or the JAX
package; the program under test is ``repro_torch``, driven through its
serving API, and everything that measures it (traffic, weights, the loop,
the reference, the counts and the peaks) lives here.
"""
