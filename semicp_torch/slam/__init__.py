from semicp_torch.slam.pipeline import ScanPrefetcher  # noqa: F401
from semicp_torch.slam.pose_graph import PoseGraph, optimize_pose_graph  # noqa: F401
from semicp_torch.slam.keyframes import KeyframeStore, semantic_descriptor  # noqa: F401
from semicp_torch.slam.loop_closure import (  # noqa: F401
    LoopVerifier, propose_loop_closures, verify_loop_closures_batched,
)
