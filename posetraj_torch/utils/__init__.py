from posetraj_torch.utils.profiling import StageTimer, trace  # noqa: F401
from posetraj_torch.utils.metrics import MetricsLogger  # noqa: F401
