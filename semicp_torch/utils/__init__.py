from semicp_torch.utils.metrics import MetricsLogger, PhaseTimer, drain  # noqa: F401
