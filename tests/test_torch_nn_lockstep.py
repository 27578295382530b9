"""The port engine against the JAX engine on frames labelled by each
package's Mask R-CNN (the trained micro checkpoint), some frames left
unlabelled, both engines on their native host library (mfcore)."""

import numpy as np

from maskfusion_tpu.camera import CameraIntrinsics as JIntrinsics
from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu.maskrcnn import checkpoint_io as jio
from maskfusion_tpu.maskrcnn import inference as jinf
from maskfusion_tpu.maskrcnn import synthetic_shapes as jss
from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.maskrcnn import checkpoint_io as tio
from maskfusion_tpu_torch.maskrcnn import inference as tinf
from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as tss
from tests.test_torch_maskrcnn_inference import (INTR, MICRO, NN_CFG, S,
                                                 _scene)
from tests.torch_helpers import wait_for_jax_pending


def test_lockstep_with_jax_engine_on_nn_labelled_frames():
    """Both engines (the Config default: the prefused schedule; both on
    their native mfcore) on the same eight frames, labelled by each
    package's own micro network, frames 2, 5 and 6 left unlabelled (mask
    None) as frames leave a full delay queue: the two networks' id images
    are equal, and after every frame (the JAX engine's pending frame
    finished first, as the port finishes it on the CPU) the model ids and
    the segmentation agree; after the drain every logged pose agrees to
    1 mm (measured 8e-5 m) and the surfel counts to 1%.  The camera runs on
    its ground-truth pose (still): at 64x64 both packages' camera tracking
    wanders by ~5 mm a frame on this still scene and the two part by up to
    4.8 mm, while the object's own solve, the one the masks drive, stays
    tracked."""
    jparams, _ = jio.load_params(MICRO)
    tparams, _ = tio.load_params(MICRO)
    jnet = jinf.MaskRCNNInference(jss.micro_config(S), params=jparams)
    tnet = tinf.MaskRCNNInference(tss.micro_config(S), params=tparams,
                                  device="cpu")
    rgb, depth, gt_mask = _scene(shaped=True)
    jeng = JMaskFusion(JResolution(S, S), JIntrinsics(*INTR),
                       JConfig(**NN_CFG))
    teng = MaskFusion(Resolution(S, S), CameraIntrinsics(*INTR),
                      Config(**NN_CFG), device="cpu")
    unlabelled = {2, 5, 6}
    for i in range(8):
        jf = JFrameData(rgb=rgb.copy(), depth=depth.copy(),
                        timestamp=float(i))
        tf = FrameData(rgb=rgb.copy(), depth=depth.copy(),
                       timestamp=float(i))
        if i not in unlabelled:
            jnet.execute(jf)
            tnet.execute(tf)
            np.testing.assert_array_equal(tf.mask, jf.mask)
            assert (tf.class_ids, tf.rois) == (jf.class_ids, jf.rois)
            assert len(tf.class_ids) > 1
        wait_for_jax_pending(jeng)
        jeng.process_frame(jf, gt_pose=np.eye(4, dtype=np.float32))
        teng.process_frame(tf, gt_pose=np.eye(4, dtype=np.float32))
        assert [m.model_id for m in teng.models] == \
            [m.model_id for m in jeng.models], i
        if jeng.last_segmentation is not None:
            np.testing.assert_array_equal(teng.last_segmentation,
                                          jeng.last_segmentation)
    jeng.drain_pipeline()
    teng.drain_pipeline()
    assert [m.model_id for m in teng.models] == \
        [m.model_id for m in jeng.models] == [0, 1]
    np.testing.assert_array_equal(teng.last_segmentation,
                                  jeng.last_segmentation)
    for k, (mt, mj) in enumerate(zip(teng.models, jeng.models)):
        pj = np.stack([np.asarray(r["pose"]) for r in mj.pose_log])
        pt = np.stack(teng.pose_log_numpy(k))
        assert pt.shape == pj.shape
        assert np.linalg.norm(pt[:, :3, 3] - pj[:, :3, 3], axis=1).max() \
            <= 1e-3
        assert abs(mt.surfel_count - mj.surfel_count) \
            <= 0.01 * mj.surfel_count
    seg = teng.last_segmentation == 1
    assert (seg & gt_mask).sum() / max((seg | gt_mask).sum(), 1) >= 0.4
