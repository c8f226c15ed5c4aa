"""semicp_torch E-step reduction against semicp on the same numpy inputs.

The JAX Pallas kernel runs in interpret mode with tests/test_pallas.py's
tolerances (weights to 1e-5; A, b, c to rtol 3e-3 with atol 2e-3 / 5e-3 /
5e-3): the online softmax and the explicit-weights form sum in different
orders, and the closed-form inverse differs from the adjugate one in
rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semicp.register.pallas_estep import estep_reduce_pallas, estep_reduce_xla
from semicp_torch.register.estep import estep_reduce, estep_reduce_plain

TOLS = {"a6": (3e-3, 2e-3), "b3": (3e-3, 5e-3), "c": (3e-3, 5e-3)}


def make_estep_fixture(rng, K=6, N=1024):
    """NN-kernel-shaped inputs with SPD combined covariances (the fixture
    of tests/test_pallas.py)."""
    spd = rng.normal(size=(N, 3, 3))
    spd = spd @ np.swapaxes(spd, -1, -2) + np.eye(3) * 0.5
    rc = np.stack([spd[:, 0, 0], spd[:, 1, 1], spd[:, 2, 2],
                   spd[:, 0, 1], spd[:, 0, 2], spd[:, 1, 2]]).astype(np.float32)
    spd2 = rng.normal(size=(K, N, 3, 3))
    spd2 = spd2 @ np.swapaxes(spd2, -1, -2) + np.eye(3) * 0.3
    cx = np.stack([spd2[..., 0, 0], spd2[..., 1, 1], spd2[..., 2, 2],
                   spd2[..., 0, 1], spd2[..., 0, 2], spd2[..., 1, 2]], 1).astype(np.float32)
    moved = (rng.normal(size=(3, N)) * 3).astype(np.float32)
    x = moved[None] + rng.normal(size=(K, 3, N)).astype(np.float32)
    attrs = np.concatenate([x, cx, np.zeros((K, 7, N), np.float32)], 1)
    nn_d2 = np.sum((x - moved[None]) ** 2, 1).astype(np.float32)
    nn_d2[rng.uniform(size=(K, N)) < 0.15] = 3.0e37        # missing classes
    log_sem = (rng.normal(size=(K, N)) * 0.5).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    return nn_d2, attrs, rc, moved, log_sem, valid


def assert_close(out_t, out_r):
    a, b, c, w = (np.asarray(o) for o in out_r)
    np.testing.assert_allclose(out_t[3].numpy(), w, atol=1e-5)
    for name, got, ref in zip(("a6", "b3", "c"), out_t[:3], (a, b, c)):
        rtol, atol = TOLS[name]
        np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("K,gate2", [(6, 4.0), (3, 1.0)])
def test_plain_matches_pallas_interpret(rng, K, gate2):
    args = make_estep_fixture(rng, K=K)
    ref = estep_reduce_pallas(*map(jnp.asarray, args), gate2, nb=512, interpret=True)
    out = estep_reduce_plain(*map(torch.from_numpy, args), gate2)
    assert_close(out, ref)


def test_plain_matches_xla_and_weights_sum_to_one(rng):
    args = make_estep_fixture(rng)
    ref = estep_reduce_xla(*map(jnp.asarray, args), 4.0)
    out = estep_reduce_plain(*map(torch.from_numpy, args), 4.0)
    assert_close(out, ref)
    w = out[3].numpy()
    assert ((w == 0) | (np.abs(w - 1.0) < 1e-5)).all()
    # invalid source points get no weight at all
    assert (w[~args[5]] == 0).all()


def test_cpu_dispatch_is_plain(rng):
    args = tuple(map(torch.from_numpy, make_estep_fixture(rng, K=4, N=512)))
    gate2 = torch.tensor(4.0)
    for got, ref in zip(estep_reduce(*args, gate2), estep_reduce_plain(*args, gate2)):
        assert torch.equal(got, ref)
