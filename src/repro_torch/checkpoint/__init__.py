from repro_torch.checkpoint.checkpoint import (CheckpointCorrupt, insert_job,
                                               load_job, restore_job,
                                               save_job, slice_job)
