from semicp_torch.utils.metrics import (  # noqa: F401
    MetricsLogger,
    PhaseTimer,
    count,
    drain,
    elapsed,
    installed,
    span,
)
