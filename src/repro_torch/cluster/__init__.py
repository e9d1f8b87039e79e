"""Trace-driven cluster simulation (port of ``repro.cluster``): the trace
generator, the discrete-event simulator, the baselines' grouping policies
and the evaluation metrics, copies of the reference's modules.  The
controller, control plane, faults, harness and execution backend come
with cluster control (ROADMAP queue A, "Cluster control")."""
from repro_torch.cluster import baselines, metrics, simulator, trace

__all__ = ["baselines", "metrics", "simulator", "trace"]
