from repro_torch.serve.engine import ServeEngine, ServeRequest, ServeResult
from repro_torch.serve.pool import AdapterPool, FusedAdapters
