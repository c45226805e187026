"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that measures lives here and imports nothing of
JAX or of the JAX package: traffic generation, the graph generators, the
plain reference that decides ``correct``, the bytes and operations of the
rooflines, the table of peaks and the profiler reductions.  From the port
the benchmark takes only the system under test and its spans.
"""
