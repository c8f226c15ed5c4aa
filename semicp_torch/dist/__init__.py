from semicp_torch.dist.batch import batched_align  # noqa: F401
