"""Plain GICP baseline — the EM core with uniform semantic weights.

Port of `semicp/register/gicp.py`: one flag, not a second engine. It is
the ablation of the paper's semantic-weighting claim.
"""

from __future__ import annotations

import dataclasses

from semicp_torch.cloud.cloud import Cloud
from semicp_torch.config import Config
from semicp_torch.register.em_icp import AlignResult, align


def align_gicp(src: Cloud, tgt: Cloud, cfg: Config | None = None, T_init=None) -> AlignResult:
    cfg = cfg or Config()
    cfg = dataclasses.replace(cfg, em=dataclasses.replace(cfg.em, uniform_semantics=True))
    return align(src, tgt, cfg, T_init)
