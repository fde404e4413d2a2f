"""The benchmark of concrete_tpu_torch, the PyTorch and CUDA port, on
NVIDIA H100 cards: ``run.py`` runs one cell of ``BENCHMARK.json``."""
