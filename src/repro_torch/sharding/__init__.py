from repro_torch.sharding.specs import (  # noqa: F401
    PartitionSpec,
    activation_sharding,
    data_axes_of,
    param_specs,
    to_placements,
)
