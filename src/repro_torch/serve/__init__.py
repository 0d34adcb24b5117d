"""Serving layer: the batched LM request engine."""

from repro_torch.serve.engine import Request, ServeEngine  # noqa: F401
