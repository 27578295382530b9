"""The benchmark of maskfusion_tpu_torch on one NVIDIA H100.

One run measures one cell of ``BENCHMARK.json``:

    python3 mfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric lives in a file of its own, found by name:
``configs/<config>.json``, ``workloads/<cell>.json`` (its config, driver,
traffic parameters and the limits of its output check) and
``metrics/<metric>.py``.  The drivers (``drivers/``) call into the program
and wrap each call with the benchmark's own spans; ``traffic/`` makes the
inputs from the seed on the card; ``reference/`` holds the plain versions
that decide ``correct``.  Nothing here imports ``jax`` or
``maskfusion_tpu``.
"""
