"""The benchmark of the PyTorch and CUDA port (``repro_torch``): batched
window queries through its ``Session`` on one card.  See ``README.md``."""
