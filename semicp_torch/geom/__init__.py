from semicp_torch.geom.se3 import (  # noqa: F401
    so3_exp,
    so3_log,
    so3_hat,
    se3_exp,
    se3_log,
    se3_inverse,
    se3_compose,
    se3_apply,
    se3_adjoint,
    se3_identity,
    rotmat_to_quat,
    quat_to_rotmat,
)
from semicp_torch.geom.eig3 import eigh3x3, cholesky3x3, cho_solve3x3  # noqa: F401
from semicp_torch.geom import sym3  # noqa: F401
