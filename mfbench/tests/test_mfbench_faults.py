"""The output check catches a broken timed path: each cell driven at a
tiny size on the CPU (the look for a card skipped), with a fault planted
underneath, reads ``correct`` false under the cell's limits."""

import pytest
import torch

from mfbench.tests import tiny


@pytest.fixture
def bench(tmp_path, monkeypatch):
    monkeypatch.setenv("MFBENCH_PATH", str(tmp_path))
    return tiny.make(tmp_path)


def _frozen_global_pose(monkeypatch):
    from maskfusion_tpu_torch.engine import MaskFusion

    stage = MaskFusion.pipelined_device_stage

    def frozen(self, glob_state, *a, **kw):
        out = stage(self, glob_state, *a, **kw)
        return (out[0], glob_state.pose.clone()) + tuple(out[2:])

    monkeypatch.setattr(MaskFusion, "pipelined_device_stage", frozen)


def _half_the_objects(monkeypatch):
    """The object solve leaves the first half of its slots, rounded up (a
    lone object included), where they were."""
    from maskfusion_tpu_torch.engine import MaskFusion

    for name in ("track_objects", "track_objects_win"):
        solve = getattr(MaskFusion, name)

        def half(self, states, *a, _solve=solve, **kw):
            poses, jumps = _solve(self, states, *a, **kw)
            frozen = (len(states) + 1) // 2
            poses = torch.cat([torch.stack(
                [st.pose for st in states[:frozen]]), poses[frozen:]])
            return poses, jumps

        monkeypatch.setattr(MaskFusion, name, half)
    track = MaskFusion.track

    def untracked(self, state, prep, *a, is_object=False, **kw):
        res = track(self, state, prep, *a, is_object=is_object, **kw)
        return res._replace(pose=state.pose.clone()) if is_object else res

    monkeypatch.setattr(MaskFusion, "track", untracked)


def _altered_edges(monkeypatch):
    from maskfusion_tpu_torch.ops import kernels

    plain = kernels.geometric_edge_map_plain
    monkeypatch.setattr(kernels, "geometric_edge_map_plain",
                        lambda *a: plain(*a) * 0.5)


def _unfused(monkeypatch):
    """The fuse stage returns every model's state as it came in."""
    from maskfusion_tpu_torch.engine import MaskFusion

    monkeypatch.setattr(MaskFusion, "fuse_stage",
                        lambda self, glob_state, obj_states, *a, **kw:
                        (glob_state, tuple(obj_states)))


def _closed_gate(monkeypatch):
    """The device stage reports tracking too poor to fuse on every frame."""
    from maskfusion_tpu_torch.engine import MaskFusion

    stage = MaskFusion.pipelined_device_stage

    def closed(self, *a, **kw):
        out = stage(self, *a, **kw)
        return out[:7] + (torch.zeros_like(out[7]),)

    monkeypatch.setattr(MaskFusion, "pipelined_device_stage", closed)


def _altered_scan(monkeypatch):
    """The level-0 scan reports its hits 1% farther than they are."""
    from maskfusion_tpu_torch.ops import kernels

    scan = kernels.predict_l0_scan

    def farther(*a, **kw):
        z, src = scan(*a, **kw)
        return z * 1.01, src

    monkeypatch.setattr(kernels, "predict_l0_scan", farther)


def _altered_segmentation(monkeypatch):
    """The host segmentation labels a band of pixels with the wrong model."""
    from maskfusion_tpu_torch.segmentation.mf_segmentation import \
        MfSegmentation

    perform = MfSegmentation.perform

    def altered(self, *a, **kw):
        res = perform(self, *a, **kw)
        seg = res.full_segmentation.copy()
        seg[:8] = (seg[:8] + 1) % 3
        res.full_segmentation = seg
        return res

    monkeypatch.setattr(MfSegmentation, "perform", altered)


@pytest.mark.parametrize("fault", [_frozen_global_pose, _half_the_objects,
                                   _altered_edges, _unfused, _closed_gate,
                                   _altered_scan, _altered_segmentation])
def test_slam_faults(fault, bench, monkeypatch):
    assert tiny.run("tiny_slam", bench, seed=11, seconds=3.0)["correct"]
    fault(monkeypatch)
    out = tiny.run("tiny_slam", bench, seed=11, seconds=3.0)
    assert not out["correct"], out["checks"]


def _frozen_state(monkeypatch):
    from maskfusion_tpu_torch.maskrcnn.optim import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: None)


def _half_batch(monkeypatch):
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNN

    loss = MaskRCNN.batch_loss

    def half(self, images, *rest, **kw):
        n = images.shape[0] // 2
        return loss(self, images[:n], *(r[:n] if hasattr(r, "shape") else r
                                          for r in rest), **kw)

    monkeypatch.setattr(MaskRCNN, "batch_loss", half)


def _half_batch_mean(monkeypatch):
    """Every image's loss computed, the mean (and so the gradient) taken
    over the first half of the batch."""
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNN

    def half(self, images, gt_boxes, gt_classes, gt_valid, gt_masks, draws,
             full_loss=True):
        losses = [self.train_losses(images[b][None], gt_boxes[b],
                                    gt_classes[b], gt_valid[b], gt_masks[b],
                                    draws[b])["total"]
                  for b in range(images.shape[0])]
        return torch.stack(losses[:len(losses) // 2]).mean()

    monkeypatch.setattr(MaskRCNN, "batch_loss", half)


@pytest.mark.parametrize("fault", [_frozen_state, _half_batch,
                                   _half_batch_mean])
def test_train_faults(fault, bench, monkeypatch):
    assert tiny.run("tiny_train", bench, seed=12, seconds=1.0)["correct"]
    fault(monkeypatch)
    out = tiny.run("tiny_train", bench, seed=12, seconds=1.0)
    assert not out["correct"], out["checks"]


def _altered_rpn(monkeypatch):
    from maskfusion_tpu_torch.maskrcnn.model import RPNHead

    head = RPNHead.forward

    def altered(self, feats):
        logits, deltas = head(self, feats)
        return logits * 1.5, deltas

    monkeypatch.setattr(RPNHead, "forward", altered)


def test_network_fault(bench, monkeypatch):
    assert tiny.run("tiny_nn", bench, seed=13, seconds=4.0)["correct"]
    _altered_rpn(monkeypatch)
    out = tiny.run("tiny_nn", bench, seed=13, seconds=4.0)
    assert not out["correct"], out["checks"]
