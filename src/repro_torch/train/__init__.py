"""Training entry points (port of ``repro.train``)."""
