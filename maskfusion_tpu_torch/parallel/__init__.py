"""Multi-device training and multi-object SLAM (port of
``maskfusion_tpu/parallel``).

The JAX package drives every device from one controller: a
``jax.sharding.Mesh`` and GSPMD sharding annotations.  The port splits the
two uses into PyTorch's idioms:

- ``mesh``, ``train``, ``launch``: the Mask R-CNN train step over a
  (dp, mp) ``DeviceMesh``, one process a rank (``launch.run_ranks``) with
  FSDP2 -- the batch on dp, parameters sharded on mp by the JAX rule
  (HSDP), NCCL between cards; ``create_train_step`` without a mesh is the
  one-card step;
- ``multimodel``: the engine's object models split over a "models" axis
  in one process (``MaskFusion(..., mesh=ModelMesh(devices))``), the
  single-controller contract kept: one host loop, each block of object
  slots solved and fused on its device;
- ``dryrun``: the driver's entry points, ``entry()`` and
  ``dryrun_multichip(n)``.
"""
