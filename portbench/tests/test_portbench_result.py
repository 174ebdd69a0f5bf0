"""A whole run on the CPU at a tiny size, past the look for a card: the
result line, the traced run's metrics, the imports of the process."""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

from portbench import run

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["classical_c1.fixed200", "flagship.eval_b1"])
def test_last_line_has_the_contract_keys(name, tiny, capsys):
    cell = tiny(name)
    run.report(run.run_cell(cell, 2 ** 31 + 11, 0.3, False, CPU))
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert [line.split()[1] for line in last] == list(result["checks"])


def test_trace_reads_the_request_window(tiny):
    result = run.run_cell(tiny("classical_c1.fixed200"), 5, 5.0, True, CPU)
    assert result["attempted"] == 3  # the cell's trace_requests and the first
    assert result["device"]["window_s"] > 0 and "breakdown" in result


def test_a_run_imports_no_jax(tmp_path):
    code = (
        "import torch; from conftest import *; from portbench import run\n"
        "import copy\n"
        "cell = copy.deepcopy(run.load_cell('classical_c1.fixed200'))\n"
        "cell.mix.update(batch=1, size=16, pool=1); cell.config.pop('batch'); cell.config.pop('size')\n"
        "cell.workload.update(sample=1, warmup=1); cell.workload['args']['maxit'] = 2\n"
        "run.run_cell(cell, 1, 0.05, False, torch.device('cpu'))\n"
        "print(run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT / "portbench" / "tests",
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
