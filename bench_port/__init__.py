"""The benchmark of the PyTorch/CUDA port, partsbaseddetector_tpu_torch.

``run.py`` runs one cell of ``BENCHMARK.json`` once; everything a cell
needs is found by name under this folder (``configs/``, ``traffic/``,
``workloads/``, ``metrics/``).  ``reference/`` is the plain PyTorch and
NumPy detector that decides ``correct``; ``counts/`` holds the work and
byte counts behind the roofline and utilisation metrics.
"""
