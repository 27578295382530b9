"""The port's sharded Mask R-CNN train step on 4 ranks, a (2, 2) (dp, mp)
mesh -- HSDP: replicated over dp, sharded over mp by the JAX rule --
against the one-card port step on the same batch, parameters and draws, on
the CPU: the full loss over two steps, the RPN-only warm-up (the heads get
no gradient and stay as initialised), the placements after sharding (the
parameters the rule replicates are held out of FSDP), and the gradients'
global norm of a clipped step (optim.clip_by_global_norm_ over DTensor
shards).  Bounds and their measurement: tests/test_torch_parallel.py."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from maskfusion_tpu_torch.parallel.launch import run_ranks
from maskfusion_tpu_torch.parallel.train import sharded_runs
from tests.test_torch_parallel import (LR, RANK_TIMEOUT_S, TC,
                                       assert_placements_follow_the_rule,
                                       assert_step_matches, inputs, one_card)

CLIP = 1.0


@pytest.fixture(scope="module")
def runs():
    """The two 4-rank runs in one process group -- the full loss with its
    gradients clipped to CLIP (the global norm well above it), two steps;
    the RPN-only warm-up, one step -- started first in a background
    thread; the one-card references computed meanwhile."""
    batch, draws = inputs()
    common = dict(cfg=TC, batch=batch, learning_rate=LR)
    jobs = [dict(common, draws=draws, clip_norm=CLIP),
            dict(common, draws=draws[:1], full_loss=False)]
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(run_ranks, sharded_runs, 4, "gloo", (jobs,),
                             RANK_TIMEOUT_S)
        _, full = one_card(batch, draws, True, CLIP)
        init, rpn = one_card(batch, draws[:1], False)
        sharded = future.result(timeout=2 * RANK_TIMEOUT_S)[0]
    return {"init": init, "ref": {"full": full, "rpn": rpn},
            "sharded": dict(zip(("full", "rpn"), sharded))}


@pytest.mark.parametrize("loss", ["full", "rpn"])
def test_hsdp_step_matches_one_card(runs, loss):
    """Each step's loss and the parameters after it; the full loss with
    its gradients clipped on both sides."""
    assert_step_matches(runs["sharded"][loss][1], runs["ref"][loss])


def test_rpn_only_step_leaves_the_heads(runs):
    """The RPN-only step gives the heads no gradient: under FSDP (and on
    one card) they stay as initialised, the backbone and RPN move."""
    init = runs["init"]
    for steps in (runs["sharded"]["rpn"][1], runs["ref"]["rpn"]):
        params = steps[-1][2]
        for k, v in params.items():
            if k.startswith(("box_head.", "mask_head.")):
                np.testing.assert_array_equal(v, init[k], err_msg=k)
        for k in ("backbone.stem.weight", "rpn.conv.weight"):
            assert not np.array_equal(params[k], init[k]), k


def test_hsdp_placements_follow_the_rule(runs):
    assert_placements_follow_the_rule(runs["sharded"]["full"][0], 4)


def test_clip_counts_the_whole_gradient(runs):
    """The 4-rank step's clipped global norm equals the one-card step's on
    each step (the norm of one rank's shards would be smaller)."""
    for got, want in zip(runs["sharded"]["full"][1], runs["ref"]["full"]):
        norm, ref_norm = got[1], want[1]
        assert ref_norm > CLIP
        assert abs(norm - ref_norm) <= 1e-5 * ref_norm, (norm, ref_norm)
