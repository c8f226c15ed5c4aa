"""Semantic against uniform-weight EM-ICP under label corruption, on the port.

The counterpart of scripts/ablation_bench.py in semicp_torch: the same
sweep (label flips 0, 0.2, 0.4 and 0.6, 3 seeds) on the corridor scene,
geometry that is translation-invariant along x, so that the 0.6 m x
offset is observable only through the labels. At each level it records
the mean translation error of semantic EM-ICP (`align`, alpha 0.9) and of
its uniform-weight ablation (`align_gicp`), 1200 target points at n_pad
4096, 6 classes, em.max_iters 50. The clouds are preprocessed with the
bare CovConfig, as the JAX script does (raw layout: kernel K5 on the
card, then K2, K3 and G1 in each align).

    python scripts/torch_ablation_bench.py [out.json] [--device cpu]

Runs on the card unless given --device cpu; writes its JSON to out.json
(default ABLATION_torch.json), with the card's name and power limit when
it ran on one. The curve is algorithmic: it carries no time.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FLIPS = (0.0, 0.2, 0.4, 0.6)
SEEDS = 3
OFFSET_M, ALPHA, N_PAD = 0.6, 0.9, 4096


def run(flips=FLIPS, seeds=SEEDS, device="cuda") -> dict:
    """The sweep over `flips`, each the mean over seeds 0 .. seeds - 1."""
    from semicp_torch import Config
    from semicp_torch.cloud import make_cloud, preprocess_cloud
    from semicp_torch.data import corridor_scene, make_pair
    from semicp_torch.eval.pairs import pose_errors
    from semicp_torch.register import align, align_gicp
    from semicp_torch.utils.metrics import card_line

    dev = torch.device(device)
    cfg = Config().override({"cloud.n_pad": N_PAD, "cloud.num_classes": 6,
                             "em.alpha": ALPHA, "em.max_iters": 50})
    delta = np.array([OFFSET_M, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)

    def prep(xyz, lab):
        return preprocess_cloud(make_cloud(xyz, lab, n_pad=N_PAD, device=dev), cfg.cov)

    rows = []
    for flip in flips:
        errs_s, errs_u = [], []
        for seed in range(seeds):
            rng = np.random.default_rng(seed)
            tgt, tlab = corridor_scene(rng, 1200)
            src, slab, T_gt = make_pair(rng, tgt, tlab, delta, noise=0.01, dropout=0.2,
                                        n_classes=6, label_flip=flip)
            sc, tc = prep(src, slab), prep(tgt, tlab)
            errs_s.append(pose_errors(align(sc, tc, cfg).T.cpu().numpy(), T_gt)[0])
            errs_u.append(pose_errors(align_gicp(sc, tc, cfg).T.cpu().numpy(), T_gt)[0])
        row = {"label_flip": flip, "trans_err_semantic_m": float(np.mean(errs_s)),
               "trans_err_uniform_m": float(np.mean(errs_u)), "seeds": len(errs_s)}
        rows.append(row)
        print(f"flip={flip:.1f}: semantic {row['trans_err_semantic_m']:.3f} m"
              f"  uniform {row['trans_err_uniform_m']:.3f} m", file=sys.stderr)
    return {"scene": "corridor (x-translation observable only via semantics)",
            "offset_m": OFFSET_M, "alpha": ALPHA, "rows": rows, "device": dev.type,
            "card": card_line() if dev.type == "cuda" else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="ABLATION_torch.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    result = run(device=args.device)
    with open(args.out, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
