"""-method maskfusion through both CLIs in the exact schedule
(tests/test_torch_cli_multiobject.py's pipelined_cli_case; one schedule a
file keeps each file's run short)."""

import pytest

from tests.test_torch_cli_multiobject import pipelined_cli_case


@pytest.mark.parametrize("pipeline", ["exact"])
def test_cli_maskfusion_pipelined_matches_jax(tmp_path, monkeypatch,
                                              pipeline):
    """Both CLIs with -method maskfusion on four frames of one
    tests/test_io.write_dataset directory (pipelined_cli_case)."""
    pipelined_cli_case(tmp_path, monkeypatch, pipeline)
