"""Mask R-CNN, the serving half (port of ``maskfusion_tpu/maskrcnn``).

``model`` (the network), ``checkpoint_io`` (the repository's .npz
checkpoints), ``resize`` (OpenCV's two resizes without OpenCV),
``inference`` (inference on its own CUDA stream, the worker, the delay
queue, the toml surface), ``synthetic_shapes`` (the shapes domains and
their evaluations) and ``offline_runner`` (Mask####.png files for
``-maskdir``).  Training comes with a later slice.
"""
