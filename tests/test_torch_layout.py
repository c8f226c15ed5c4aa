"""semicp_torch.corr layout (Morton codes, class-major order, tile
metadata, candidate lists) against semicp.corr on the same inputs.

Codes, permutations and metadata are integer or min/max results and
must be identical; candidate lists are compared as sets per query tile
(the nearest-box-first order may break exact box-distance ties
differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semicp.cloud import make_cloud as j_make_cloud
from semicp.corr import layout as jl
from semicp.corr import morton as jm
from semicp.data import make_scene
from semicp_torch.cloud import make_cloud as t_make_cloud
from semicp_torch.corr import layout as tl
from semicp_torch.corr import morton as tm


def scene_clouds(rng, n_points, n_pad, n_classes):
    xyz, lab = make_scene(rng, n_points=n_points, extent=12.0, n_classes=n_classes)
    lab = lab - 1
    # duplicate a block of points so equal (class, code) keys occur and
    # the stable tie-break is exercised
    xyz[:50] = xyz[50:100]
    lab[:50] = lab[50:100]
    return j_make_cloud(xyz, lab, n_pad=n_pad), t_make_cloud(xyz, lab, n_pad=n_pad, device="cpu")


@pytest.mark.parametrize("n_points,n_pad,cell", [(900, 1024, 1.0), (1900, 2048, 2.0),
                                                 (1000, 2048, 0.5)])
def test_morton_codes_and_cm_order_identical(rng, n_points, n_pad, cell):
    K = 6
    cj, ct = scene_clouds(rng, n_points, n_pad, K)
    codes_j = np.asarray(jm.morton_codes(cj.xyz, cj.valid, cell))
    codes_t = tm.morton_codes(ct.xyz, ct.valid, cell).numpy()
    np.testing.assert_array_equal(codes_t, codes_j)
    perm_j = np.asarray(jl.class_morton_order(cj.xyz, cj.label, cj.valid, K, cell))
    perm_t = tl.class_morton_order(ct.xyz, ct.label, ct.valid, K, cell).numpy()
    np.testing.assert_array_equal(perm_t, perm_j)
    sj, st = jl.sort_cloud_cm(cj, K, cell), tl.sort_cloud_cm(ct, K, cell)
    assert st.layout == sj.layout == "cm"
    np.testing.assert_array_equal(st.xyz.numpy(), np.asarray(sj.xyz))
    np.testing.assert_array_equal(st.label.numpy(), np.asarray(sj.label))


@pytest.mark.parametrize("tile", [256, 512])
def test_tile_meta_identical(rng, tile):
    K = 6
    cj, ct = scene_clouds(rng, 1500, 2048, K)
    sj, st = jl.sort_cloud_cm(cj, K, 1.0), tl.sort_cloud_cm(ct, K, 1.0)
    mj = jl.tile_meta(sj.xyz, sj.label, sj.valid, K, tile)
    mt = tl.tile_meta(st.xyz, st.label, st.valid, K, tile)
    for key in ("lo", "hi", "cmin", "cmax"):
        np.testing.assert_array_equal(mt[key].numpy(), np.asarray(mj[key]), err_msg=key)


@pytest.mark.parametrize("gate,ranges", [(2.0, False), (0.7, True)])
def test_tile_candidates_same_sets(rng, gate, ranges):
    K = 6
    cj, ct = scene_clouds(rng, 1900, 2048, K)
    sj, st = jl.sort_cloud_cm(cj, K, 1.0), tl.sort_cloud_cm(ct, K, 1.0)
    qj = jl.tile_meta(sj.xyz, sj.label, sj.valid, K, 256)
    tj = jl.tile_meta(sj.xyz, sj.label, sj.valid, K, 512)
    qt = tl.tile_meta(st.xyz, st.label, st.valid, K, 256)
    tt = tl.tile_meta(st.xyz, st.label, st.valid, K, 512)
    kw_j = dict(q_range=(qj["cmin"], qj["cmax"]), t_range=(tj["cmin"], tj["cmax"])) if ranges else {}
    kw_t = dict(q_range=(qt["cmin"], qt["cmax"]), t_range=(tt["cmin"], tt["cmax"])) if ranges else {}
    cand_j, cnt_j, _ = jl.tile_candidates(qj["lo"], qj["hi"], tj["lo"], tj["hi"], gate, **kw_j)
    cand_t, cnt_t = tl.tile_candidates(qt["lo"], qt["hi"], tt["lo"], tt["hi"], gate, **kw_t)
    cand_j, cnt_j = np.asarray(cand_j), np.asarray(cnt_j)
    cand_t, cnt_t = cand_t.numpy(), cnt_t.numpy()
    np.testing.assert_array_equal(cnt_t, cnt_j)
    assert cnt_t.min() < cand_t.shape[1], "fixture must prune some tiles"
    for i, c in enumerate(cnt_t):
        assert set(cand_t[i, :c]) == set(cand_j[i, :c]), i
        # tail repeats the last real candidate
        if c:
            assert (cand_t[i, c:] == cand_t[i, c - 1]).all()
    # torch-side gate as a 0-dim tensor gives the same lists (no host sync path)
    cand_g, cnt_g = tl.tile_candidates(qt["lo"], qt["hi"], tt["lo"], tt["hi"],
                                       torch.tensor(gate), **kw_t)
    np.testing.assert_array_equal(cnt_g.numpy(), cnt_t)
    np.testing.assert_array_equal(cand_g.numpy(), cand_t)


@pytest.mark.parametrize("cell", [0.5, 2.0])
def test_morton_order_identical(rng, cell):
    """The Morton permutation, invalid points last and equal codes in
    input order (the scene's duplicated block), equal to the JAX one."""
    cj, ct = scene_clouds(rng, 1900, 2048, 6)
    perm_j = np.asarray(jm.morton_order(cj.xyz, cj.valid, cell))
    perm_t = tm.morton_order(ct.xyz, ct.valid, cell).numpy()
    np.testing.assert_array_equal(perm_t, perm_j)
    assert ct.valid.numpy()[perm_t].tolist() == [True] * 1900 + [False] * 148
