from semicp_torch.register.em_icp import (  # noqa: F401
    AlignResult, align, make_align_fn, make_robust_align_fn,
)
from semicp_torch.register.gicp import align_gicp  # noqa: F401
