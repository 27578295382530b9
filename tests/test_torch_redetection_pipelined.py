"""Model redetection in the port's prefused schedule (the maskfusion
segmenter, ``pipelined_multiobject`` with ``fuse_mask_lag``): the
reactivation runs in a pipelined host stage and starts the model at the
finished frame's global pose.  The scenario and its bounds are
tests/test_torch_redetection.py's: the port and the JAX engine reactivate
the same model id, with the same live ids after every frame."""

import pytest

from tests.test_torch_redetection import check_redetection, jax_run


@pytest.fixture(scope="module")
def jax_redetection():
    return jax_run("prefused")


def test_redetection_reactivates_inactive_model(jax_redetection):
    check_redetection(*jax_redetection)
