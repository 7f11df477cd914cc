"""The port's ``latex_table`` against the repository's ``experiments/latex_table.py``:
the same bytes on both reference CSVs, and ``eval_gmm_study`` makes its table with
the port's module, running no file of ``experiments/``."""
import ast
import inspect
import pathlib
import subprocess
import sys

import pytest

from fab_tpu_torch.experiments import eval_gmm_study, latex_table

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = {
    "gmm_study_results": ["--csv", "reports/gmm_study_results.csv", "--problem", "gmm"],
    "gmm_alpha_study": ["--csv", "reports/gmm_alpha_study.csv", "--alpha-study"],
}


def _stdout(argv):
    out = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr.decode()
    return out.stdout


@pytest.mark.parametrize("args", CASES.values(), ids=CASES.keys())
def test_port_table_is_the_scripts_byte_for_byte(args):
    script = _stdout(["experiments/latex_table.py", *args])
    port = _stdout(["-m", "fab_tpu_torch.experiments.latex_table", *args])
    assert script.count(b"\\\\\n") >= 3 and port == script
    assert latex_table.main([a if not a.startswith("reports/") else str(ROOT / a)
                             for a in args]).encode() == script


def test_eval_gmm_study_runs_no_file_of_experiments():
    source = inspect.getsource(eval_gmm_study)
    imported = {a.name for n in ast.walk(ast.parse(source)) if isinstance(n, ast.Import)
                for a in n.names}
    assert "subprocess" not in imported and "latex_table.py" not in source
    assert "latex_table.table(" in source
