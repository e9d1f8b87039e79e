from repro_torch.sharding.specs import batch_specs, logical_to_mesh, spec_for

__all__ = ["batch_specs", "logical_to_mesh", "spec_for"]
