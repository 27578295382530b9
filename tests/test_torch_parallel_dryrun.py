"""``parallel.dryrun.dryrun_multichip(4)`` on the CPU: the sharded train
step on 4 gloo ranks and the engine's split object slots in this process,
as tests/test_parallel.py::
test_dryrun_multichip_entrypoint runs the JAX one on 8 virtual devices.
Four ranks keep that test's mp = 2 branch (a (2, 2) mesh: HSDP, and the
dp rows split) at half its ranks: a rank is a process here, with its own
start-up and a full-width ResNet-50-FPN, where the JAX one's devices share
one process.  (The entry's forward: tests/test_torch_parallel.py.)"""

from maskfusion_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_multichip_entrypoint():
    dryrun_multichip(4)

