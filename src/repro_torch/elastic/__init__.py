"""Live fused groups and lossless migration between them (port of
``repro.elastic``, single device)."""
from repro_torch.elastic.migrate import (JobTrainState, diff_grouping,
                                         fuse_states, unfuse_state)
from repro_torch.elastic.runtime import GroupRuntime, TrainReport
