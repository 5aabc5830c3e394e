"""The benchmark of the PyTorch/CUDA port, mt_renderer_tpu_torch (README.md)."""
