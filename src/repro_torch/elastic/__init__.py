"""Live fused groups (port of ``repro.elastic``, single device)."""
from repro_torch.elastic.runtime import GroupRuntime, TrainReport
