"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command, ``python3 perfbench/run.py``, runs one cell of
``BENCHMARK.json`` once (``README.md``)."""
