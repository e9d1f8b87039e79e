"""Per-job token streams and fused-batch assembly (port of
``repro.data``)."""
from repro_torch.data.pipeline import FusedBatcher, JobStream, sample_lengths
