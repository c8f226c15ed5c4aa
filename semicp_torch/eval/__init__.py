from semicp_torch.eval.ate import ate_rmse, rpe, umeyama_alignment  # noqa: F401
from semicp_torch.eval.pairs import em_step, pose_errors, trip_parity  # noqa: F401
