"""Instance segmentation subsystem (ref: Core/Segmentation).

Port of ``maskfusion_tpu/segmentation/__init__.py``.  `create_segmenter` is
the strategy dispatcher (Segmentation::init, Segmentation.cpp:47-66):
'maskfusion' fuses instance masks with geometric edges, 'precomputed' maps
mask labels directly to models, 'cofusion' is the CRF-based variant, whose
superpixels and CRF run on ``device`` (the engine's; the default card)."""

from maskfusion_tpu_torch.segmentation.result import (ModelData,
                                                      SegmentationResult)


def create_segmenter(method: str, config, resolution, intrinsics,
                     device=None):
    if method in ("maskfusion", "mask_fusion"):
        from maskfusion_tpu_torch.segmentation.mf_segmentation import (
            MfSegmentation)
        return MfSegmentation(config, resolution, intrinsics)
    if method == "precomputed":
        from maskfusion_tpu_torch.segmentation.pre_segmentation import (
            PreSegmentation)
        return PreSegmentation(config)
    if method in ("cofusion", "co_fusion"):
        from maskfusion_tpu_torch.segmentation.cf_segmentation import (
            CfSegmentation)
        return CfSegmentation(config, resolution, intrinsics, device)
    raise ValueError(f"unknown segmentation method: {method}")


__all__ = ["SegmentationResult", "ModelData", "create_segmenter"]
