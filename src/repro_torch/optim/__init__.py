"""Optimizer of the adapters (port of ``repro.optim``)."""
from repro_torch.optim import adamw, schedule
