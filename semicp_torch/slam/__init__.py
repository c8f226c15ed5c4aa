from semicp_torch.slam.pipeline import ScanPrefetcher  # noqa: F401
