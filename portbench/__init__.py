"""The benchmark of the PyTorch/CUDA port (``unet_bssfp_tpu_torch``): one
cell, a model configuration under a traffic mix, run once by
``python -m portbench.run``. See ``BENCHMARK.json`` at the repository's
root for the cells and metrics, and ``PERF.md`` for why each exists."""
