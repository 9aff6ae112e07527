"""The port's linear Kalman filter (a numpy copy) against the JAX
package's on the same inputs, and the mirrors of tests/test_aux.py's
Kalman tests."""

import numpy as np
import pytest
import torch

from lsc_dr_planner_tpu.utils import kalman as kj
from lsc_dr_planner_tpu_torch.utils import kalman as kt

# One intra-op thread: the suite runs in several worker processes on a
# shared CPU, and torch's spinning thread pool would starve the JAX
# computations of the other workers (small tensors gain nothing from it).
torch.set_num_threads(1)


def test_kalman_tracks_constant_velocity():
    rng = np.random.default_rng(0)
    kf = kt.LinearKalmanFilter(sigma_r=(0.01, 0.01, 0.01))
    v_true = np.array([1.0, -0.5, 0.2])
    for k in range(100):
        t = 0.02 * k
        z = v_true * t + rng.normal(0, 0.003, 3)
        pos, vel = kf.observe(z, t)
    np.testing.assert_allclose(vel, v_true, atol=0.1)
    np.testing.assert_allclose(pos, v_true * t, atol=0.02)


def test_kalman_batched():
    st = kt.kf_init(np.zeros((4, 3)))
    st = kt.kf_step(st, np.ones((4, 3)) * 0.1, 0.1)
    assert st.x.shape == (4, 6)


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)])
def test_kalman_matches_jax_package(batch):
    """The same seeded fixes through both filters: bitwise the same
    states, batched and not, and through the stateful wrapper."""
    rng = np.random.default_rng(3)
    z0 = rng.normal(0, 1, batch + (3,))
    sj, st = kj.kf_init(z0, 0.2, 0.9), kt.kf_init(z0, 0.2, 0.9)
    for k in range(20):
        z = z0 + 0.05 * k + rng.normal(0, 0.01, batch + (3,))
        dt = 0.02 + 0.01 * (k % 3)
        sj = kj.kf_step(sj, z, dt, (5.0, 6.0, 7.0), (0.002, 0.001, 0.003))
        st = kt.kf_step(st, z, dt, (5.0, 6.0, 7.0), (0.002, 0.001, 0.003))
        np.testing.assert_array_equal(st.x, sj.x)
        np.testing.assert_array_equal(st.P, sj.P)
    fj, ft = kj.LinearKalmanFilter(), kt.LinearKalmanFilter()
    for k in range(10):
        z = z0 + 0.1 * k
        for a, b in zip(ft.observe(z, 0.05 * k), fj.observe(z, 0.05 * k)):
            np.testing.assert_array_equal(a, b)
