"""Mask R-CNN (port of ``maskfusion_tpu/maskrcnn``).

``model`` (the network and its training losses), ``optim`` (Adam, the
global-norm clip and the schedules as optax computes them),
``checkpoint_io`` (the repository's .npz checkpoints and flax .msgpack
files), ``convert`` (matterport .h5 weights), ``resize`` (OpenCV's two
resizes without OpenCV), ``inference`` (inference on its own CUDA stream,
the worker, the delay queue, the toml surface), ``synthetic_shapes`` (the
shapes domains, their training recipes and evaluations),
``train_checkpoint`` (the recipes' entry point) and ``offline_runner``
(Mask####.png files for ``-maskdir``).  The one-card train step is
``maskfusion_tpu_torch.parallel.train``.
"""
