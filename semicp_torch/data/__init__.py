from semicp_torch.data.kitti import (  # noqa: F401
    load_velodyne_bin,
    load_semantickitti_labels,
    remap_semantickitti,
    load_kitti_poses,
    save_kitti_poses,
    load_kitti_calib,
    SEMANTICKITTI_REMAP,
)
from semicp_torch.data.pcd import load_pcd, save_pcd  # noqa: F401
from semicp_torch.data.synthetic import (  # noqa: F401
    corridor_scene,
    make_scene,
    make_pair,
    make_trajectory,
    render_scan,
)
