"""Live fused groups, lossless migration between them, and the elastic
engine that regroups them on the scheduler's decisions (port of
``repro.elastic``, single device)."""
from repro_torch.elastic.engine import ElasticEngine
from repro_torch.elastic.migrate import (JobTrainState, diff_grouping,
                                         fuse_states, unfuse_state)
from repro_torch.elastic.runtime import (GroupRuntime, PendingChunk,
                                         TrainReport)

__all__ = ["ElasticEngine", "GroupRuntime", "PendingChunk", "TrainReport",
           "JobTrainState", "fuse_states", "unfuse_state", "diff_grouping"]
