"""Cluster layer (port of ``repro.cluster``).  Trace-driven simulation:
the trace generator, the discrete-event simulator, the baselines'
grouping policies and the evaluation metrics, copies of the reference's
modules.  Cluster control, on one device or on a pool of ranks carved
into per-group submeshes: the controller running many fused groups at
once (``controller``), its chunk-pump control plane
(``control``, a copy), fault injection (``faults``, a copy), the trace
harness driving the live controller (``harness``, a copy) and the
execution backend feeding measured steps into the simulator
(``execution``)."""
from repro_torch.cluster import (baselines, control, controller, execution,
                                 faults, harness, metrics, simulator, trace)

__all__ = ["baselines", "control", "controller", "execution", "faults",
           "harness", "metrics", "simulator", "trace"]
