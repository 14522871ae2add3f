"""The query input paths through the port's CLI on the CPU: treads.fq on
stdin, plain and gzipped, and a gzipped query file by path, each at -t1
and -t2, held to ref_out.sam without @PG (chip_smoke.QUERY_INPUTS; the
card runs them in tests/test_torch_cuda.py and chip_smoke.py phase 5)."""

import pytest

from test_torch_cli import one_torch_thread, run_input  # noqa: F401


@pytest.mark.parametrize("name", ["stdin_t1", "stdin_gz_t2", "gz_path_t1"])
def test_query_input_on_cpu(name, monkeypatch, tmp_path):
    run_input(name, monkeypatch, tmp_path)
