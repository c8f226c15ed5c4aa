"""G1d's moment algebra against the JAX package, on the CPU.

G1d (semicp_torch/csrc/gn_solve.cu, the M-step of
`register/gauss_newton.py` `em_tail_dist`) all-reduces 74 float64 sums of
the points once an M-step (`gn_moments_plain`) and forms every GN pass's
system from them (`normal_equations_from_moments`, `gn_solve_moments_plain`:
the float64 mirrors of the kernels' algebra and loop, held here to the
JAX package's `normal_equations_collapsed` and `gn_solve`).

The planes are the E-step's in shape: random SPD A = M M^T + 0.1 I at
N = 4097 points over +-80 m, b = A x and c = x.b + U(0, 1) with x = T* z
plus 3 cm noise, T* the bench delta; so the cost cancels c (~1e8 summed)
against 2 b.p and p.A p down to ~1e3, as on the bench planes. The pass
counts are also held on the same planes over +-20 m.

Tolerances, and why:
- The system from the moments against `normal_equations_collapsed` of
  both packages in float64, at the identity, the bench delta and a far
  pose: H and g within 1e-9 of their largest entry, the cost within 1e-9
  relative. Both are float64 sums of the same products in other orders;
  the cost's cancellation spends a few of float64's sixteen digits.
- The moment rows of W = 2 and 4 contiguous shards (uneven: 4097 points)
  summed against the whole cloud's: each entry within 1e-12 relative
  (float64 sums in another order).
- `gn_solve_moments_plain` against JAX's `gn_solve` (f32 only) and the
  port's `gn_solve_plain` in f32 and in float64: T within 1e-5 of all
  three (the M-step's tolerance in tests/test_torch_register.py), and the
  same GN passes as the float64 one, read from it by running it at
  max_iters = passes and passes - 1. Known differences of the f32
  versions' pass counts over +-80 m, not held: from the identity their
  third step is f32 rounding of the sums (JAX 1.11e-6, against 2.43e-7
  in float64 and 2.45e-7 from the moments), just above step_eps = 1e-6,
  so they take a fourth pass (the moments and float64 3); from the far
  pose they take 5 (JAX) and 6 (the port) against 4.
- The pass counts over +-20 m, where the f32 sums' rounding is smaller
  and every version's last step lies 3x or more below step_eps (JAX's
  2.1e-7 to 3.1e-7) and the step before it 1e-4 or more: the moment loop
  takes the same GN passes as JAX's `gn_solve` and the port's
  `gn_solve_plain` in f32 and in float64, from the identity, the bench
  delta and the far pose, and T within 1e-5 of each.
- The M-step from the summed shard rows against JAX's
  `gn_solve(axis_name=...)` under shard_map on the conftest mesh cut to W
  devices (W = 1, 2, 4; zero planes pad N to a multiple of W, adding
  nothing to any sum): T within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import semicp
import semicp_torch
from semicp.dist import make_mesh as j_make_mesh
from semicp.register.gauss_newton import apply_T_planar as j_apply_T_planar
from semicp.register.gauss_newton import gn_solve as j_gn_solve
from semicp.register.residuals import normal_equations_collapsed as j_normal_eq
from semicp_torch.dist.mesh import shard_bounds
from semicp_torch.geom.se3 import se3_exp
from semicp_torch.register.gauss_newton import (
    GN_MOM,
    apply_T_planar,
    gn_moments_plain,
    gn_solve_moments_plain,
    gn_solve_plain,
    normal_equations_from_moments,
)
from semicp_torch.register.residuals import normal_equations_collapsed as t_normal_eq

N = 4097
DELTA = [0.5, -0.2, 0.05, 0.01, -0.02, 0.04]     # the bench pair's
POSES = {"identity": [0.0] * 6, "delta": DELTA, "far": [3.0, -2.0, 1.0, 0.3, -0.2, 0.5]}


def pose(v, dtype=torch.float64):
    return se3_exp(torch.tensor(v, dtype=torch.float64)).to(dtype)


def make_planes(extent):
    """(z, a6, b3, c, wsum) as float64 numpy arrays over +-extent m, the
    minimum near T*."""
    rng = np.random.default_rng(7)
    M = rng.normal(size=(N, 3, 3))
    A = M @ np.swapaxes(M, -1, -2) + np.eye(3) * 0.1
    a6 = np.stack([A[:, 0, 0], A[:, 1, 1], A[:, 2, 2], A[:, 0, 1], A[:, 0, 2], A[:, 1, 2]])
    z = rng.uniform(-extent, extent, size=(3, N))
    T_star = pose(DELTA).numpy()
    x = T_star[:3, :3] @ z + T_star[:3, 3:] + rng.normal(size=(3, N)) * 0.03
    b3 = np.einsum("nij,jn->in", A, x)
    c = np.einsum("in,in->n", x, b3) + rng.uniform(size=N)
    wsum = rng.uniform(size=N)
    return z, a6, b3, c, wsum


@pytest.fixture(scope="module")
def planes():
    return make_planes(80.0)


def as_torch(arrays, dtype=torch.float64):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in arrays]


@pytest.mark.parametrize("name", list(POSES))
def test_system_from_moments_matches_collapsed(planes, name):
    """H, g and the cost at a pose from the moment row against the port's
    and JAX's normal_equations_collapsed on the points, all float64."""
    z, a6, b3, c, wsum = as_torch(planes)
    T = pose(POSES[name])
    row = gn_moments_plain(z, a6, b3, c, wsum)
    assert row.shape == (GN_MOM,) and row.dtype == torch.float64
    assert torch.all(row[74:] == 0.0) and float(row[73]) == pytest.approx(float(wsum.sum()))
    Hm, gm, cm = (t.numpy() for t in normal_equations_from_moments(row, T))
    refs = [[t.numpy() for t in t_normal_eq(a6, b3, c, apply_T_planar(T, tuple(z)))]]
    with jax.enable_x64(True):
        Tj = jnp.asarray(T.numpy())
        zj, a6j, b3j = (tuple(jnp.asarray(a)) for a in planes[:3])
        refs.append([np.asarray(t) for t in j_normal_eq(a6j, b3j, jnp.asarray(planes[3]),
                                                        j_apply_T_planar(Tj, zj))])
    for H, g, cost in refs:
        assert H.dtype == np.float64 and abs(cost) > 1e2
        np.testing.assert_allclose(Hm, H, rtol=0, atol=1e-9 * np.abs(H).max())
        np.testing.assert_allclose(gm, g, rtol=0, atol=1e-9 * np.abs(g).max())
        np.testing.assert_allclose(cm, cost, rtol=1e-9)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_moments_sum_to_whole(planes, world):
    """The rows of W contiguous shards, as the ranks of dist/align_dist.py
    hold them, add up to the whole cloud's row."""
    arrays = as_torch(planes)
    whole = gn_moments_plain(*arrays)
    parts = []
    for r in range(world):
        lo, hi = shard_bounds(N, world, r)
        parts.append(gn_moments_plain(*(a[..., lo:hi] for a in arrays)))
    total = torch.stack(parts).sum(0)
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=1e-12, atol=0)


def passes_of(solve, max_iters, T_full):
    """Whether `solve(k)` (T after at most k GN passes) ran exactly
    max_iters passes before it stopped: its T at max_iters is T_full, and
    at max_iters - 1 another."""
    if not np.array_equal(solve(max_iters), T_full):
        return False
    return max_iters == 1 or not np.array_equal(solve(max_iters - 1), T_full)


def m_step_solvers(planes, T0, cfg):
    """The moment loop's (T, passes run) from T0, and the M-step on the
    points as k -> T after at most k GN passes: JAX's gn_solve (f32) and
    the port's gn_solve_plain in f32 and in float64."""
    row = gn_moments_plain(*as_torch(planes))
    Tm, _, _, _, passes = gn_solve_moments_plain(T0, row, cfg)

    def port(dtype):
        z, a6, b3, c, _ = as_torch(planes, dtype)
        return lambda k: gn_solve_plain(T0.to(dtype), tuple(z), a6, b3, c,
                                        cfg.__class__(max_iters=k))[0].numpy()

    def ref(k):
        z, a6, b3 = (tuple(jnp.asarray(a.astype(np.float32))) for a in planes[:3])
        return np.asarray(j_gn_solve(jnp.asarray(T0.numpy()), z, a6, b3,
                                     jnp.asarray(planes[3].astype(np.float32)),
                                     semicp.Config().gn.__class__(max_iters=k))[0])

    return Tm.numpy(), int(passes), {"jax": ref, "f32": port(torch.float32),
                                     "float64": port(torch.float64)}


@pytest.mark.parametrize("start", ["identity", "far"])
def test_gn_solve_moments_matches_plain_and_jax(planes, start):
    """The tail kernel's loop on the float64 mirror against the M-step on
    the points: T within 1e-5 of JAX's gn_solve and of the port's
    gn_solve_plain in f32 and in float64, and the same GN passes as the
    float64 one."""
    cfg = semicp_torch.Config().gn
    Tm, passes, solvers = m_step_solvers(planes, pose(POSES[start], torch.float32), cfg)
    assert 2 <= passes <= cfg.max_iters
    for solve in solvers.values():
        np.testing.assert_allclose(Tm, solve(cfg.max_iters), rtol=0, atol=1e-5)
    exact = solvers["float64"]
    assert passes_of(exact, passes, exact(cfg.max_iters)), passes
    np.testing.assert_allclose(Tm, pose(DELTA).numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("start", ["identity", "delta", "far"])
def test_gn_solve_moments_passes_match_f32(start):
    """Over +-20 m, where every version's last step is well below
    step_eps: the moment loop takes the same GN passes as JAX's gn_solve
    and the port's gn_solve_plain in f32 and in float64, with T within
    1e-5 of each."""
    cfg = semicp_torch.Config().gn
    Tm, passes, solvers = m_step_solvers(make_planes(20.0), pose(POSES[start], torch.float32),
                                         cfg)
    assert 2 <= passes < cfg.max_iters
    for name, solve in solvers.items():
        T_full = solve(cfg.max_iters)
        np.testing.assert_allclose(Tm, T_full, rtol=0, atol=1e-5)
        assert passes_of(solve, passes, T_full), (name, passes)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_summed_shard_rows_match_jax_dist(planes, world):
    """The M-step from the sum of W shards' rows (what every rank holds
    after the all-reduce) against JAX's gn_solve(axis_name=...) under
    shard_map over W devices: T within 1e-5."""
    arrays = as_torch(planes)
    row = torch.stack([gn_moments_plain(*(a[..., slice(*shard_bounds(N, world, r))]
                                          for a in arrays)) for r in range(world)]).sum(0)
    cfg = semicp_torch.Config().gn
    Tm = gn_solve_moments_plain(torch.eye(4), row, cfg)[0].numpy()

    pad = -N % world
    z, a6, b3, c = (np.pad(a.astype(np.float32), [(0, 0)] * (a.ndim - 1) + [(0, pad)])
                    for a in planes[:4])
    jcfg = semicp.Config().gn

    def gn(T0, z, a6, b3, c):
        return j_gn_solve(T0, tuple(z), tuple(a6), tuple(b3), c, jcfg, axis_name="blocks")

    mesh = j_make_mesh({"blocks": world}, devices=jax.devices()[:world])
    pl = P(None, "blocks")
    fn = jax.jit(jax.shard_map(gn, mesh=mesh, in_specs=(P(), pl, pl, pl, P("blocks")),
                               out_specs=(P(), P(), P(), P()), check_vma=False))
    Tj = np.asarray(fn(jnp.eye(4), *(jnp.asarray(a) for a in (z, a6, b3, c)))[0])
    np.testing.assert_allclose(Tm, Tj, rtol=0, atol=1e-5)
