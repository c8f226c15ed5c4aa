from semicp_torch.cloud.cloud import Cloud, cloud_from_tensors, make_cloud  # noqa: F401
from semicp_torch.cloud.covariance import estimate_covariances, preprocess_cloud  # noqa: F401
