"""The query input paths through the port's CLI on the CPU, part 2 (see
tests/test_torch_inputs.py): stdin at -t2, gzipped stdin at -t1, a
gzipped file at -t2 (worker processes)."""

import pytest

from test_torch_cli import one_torch_thread, run_input  # noqa: F401


@pytest.mark.parametrize("name", ["stdin_t2", "stdin_gz_t1", "gz_path_t2"])
def test_query_input_on_cpu(name, monkeypatch, tmp_path):
    run_input(name, monkeypatch, tmp_path)
