"""Optimizers, schedules, gradient transformations."""

from repro_torch.optim.grad_compress import int8_compress_hook  # noqa: F401
from repro_torch.optim.optimizers import adafactor, adamw, apply_updates, sgd  # noqa: F401
from repro_torch.optim.schedules import cosine_schedule, linear_warmup  # noqa: F401
