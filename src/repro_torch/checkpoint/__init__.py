from repro_torch.checkpoint.checkpoint import slice_job
