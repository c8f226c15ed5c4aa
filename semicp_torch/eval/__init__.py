from semicp_torch.eval.ate import ate_rmse, rpe, umeyama_alignment  # noqa: F401
