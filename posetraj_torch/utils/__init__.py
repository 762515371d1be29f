from posetraj_torch.utils.metrics import MetricsLogger  # noqa: F401
