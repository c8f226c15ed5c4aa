from semicp_torch.register.em_icp import AlignResult, align, make_align_fn  # noqa: F401
