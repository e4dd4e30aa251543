from repro_torch.tuner.space import framework_space, config_to_parallel_kv  # noqa: F401
from repro_torch.tuner.runner import transfer_tune  # noqa: F401
