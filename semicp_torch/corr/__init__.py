from semicp_torch.corr.bruteforce import class_nn, knn_self  # noqa: F401
from semicp_torch.corr.layout import (  # noqa: F401
    LAYOUT_CM,
    class_morton_order,
    sort_cloud_cm,
    tile_candidates,
    tile_meta,
)
from semicp_torch.corr.nn_dense import class_nn_attrs_dense, sort_cloud_by_class  # noqa: F401
from semicp_torch.corr.nn_sparse import (  # noqa: F401
    class_nn_attrs_plain,
    class_nn_attrs_sparse,
    prepare_sparse,
)
