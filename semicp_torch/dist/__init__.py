from semicp_torch.dist.batch import batched_align, shard_batch  # noqa: F401
from semicp_torch.dist.mesh import Mesh, init_distributed, make_mesh  # noqa: F401
