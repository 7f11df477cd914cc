"""The port stands alone: fab_tpu_torch and chip_smoke.py import neither JAX nor
fab_tpu, entry points default to the card, and a kernel wrapper never falls back to
its plain version for a tensor that is not on the CPU."""
import argparse
import ast
import inspect
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from fab_tpu_torch.flows import (
    make_masked_affine_maf,
    make_realnvp,
    make_resampled_realnvp,
    make_snf_model,
)
from fab_tpu_torch import bench, bench_scaling
from fab_tpu_torch.demo import aldp_demo, gmm_demo, many_well_demo
from fab_tpu_torch.experiments import (
    aldp_external_anchor,
    aldp_phi_overlay,
    aldp_torsion_scan,
    alpha_study,
    bench_lgcp_kernel,
    eval_gmm_study,
    eval_lgcp_trajectory,
    gmm_fab_cells,
    ground_truth_marginals,
    mw_fab_cells,
    rejection_sampling_vis,
    results_vis,
    run_gmm_ess_ablation,
    run_gmm_method_study,
    run_gmm_method_study_r3,
    run_init_parity_ab,
    run_matmul_cells,
    run_gmm_served,
    run_mw_method_study,
    visualise_marginal_pairs,
)
from fab_tpu_torch.ops.coupling_kernel import fused_coupling_apply
from fab_tpu_torch.ops.realnvp_kernel import fused_realnvp_pass
from fab_tpu_torch.experiments.make_aldp_model import make_aldp_flow, make_aldp_model
from fab_tpu_torch.experiments.setup_run import setup_trainer_and_run_flow
from fab_tpu_torch.targets import GMM, LogGaussianCoxProcess, ManyWellEnergy
from fab_tpu_torch.targets.aldp import AldpBoltzmann
from fab_tpu_torch.train import BufferTrainer, PrioritisedBufferTrainer, Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "fab_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN_MODULES = ("jax", "jaxlib", "optax", "fab_tpu", "flax", "haiku")
FORBIDDEN_TEXT = re.compile(r"import jax|from jax|optax|\bfab_tpu\.")
NOTEBOOKS = sorted((ROOT / "fab_tpu_torch" / "demo").glob("*.ipynb"))
CONFIGS = ROOT / "experiments" / "configs"
# The scripts' mains, each with the arguments it requires.
SCRIPT_MAINS = [
    (bench.main, []),
    (bench_scaling.main, []),
    (bench_lgcp_kernel.main, []),
    (ground_truth_marginals.main, []),
    (alpha_study.main, []),
    (rejection_sampling_vis.main, []),
    (visualise_marginal_pairs.main, ["--checkpoint", "none"]),
    (results_vis.main, ["--config", str(CONFIGS / "gmm.yaml"), "--run", "a=none"]),
    (aldp_torsion_scan.main, []),
    (aldp_phi_overlay.main, []),
    (aldp_external_anchor.main, []),
    (gmm_demo.main, []),
    (many_well_demo.main, []),
    (aldp_demo.main, ["--train"]),
    (run_gmm_method_study.main, []),
    (run_gmm_method_study_r3.main, ["target_kld 0"]),
    (run_gmm_ess_ablation.main, []),
    (run_init_parity_ab.main, []),
    (run_mw_method_study.main, []),
    (run_matmul_cells.main, []),
    (eval_gmm_study.main, []),
    (eval_lgcp_trajectory.main, ["results/torch/lgcp"]),
    (gmm_fab_cells.main, []),
    (mw_fab_cells.main, []),
    (run_gmm_served.main, ["--config", str(CONFIGS / "gmm.yaml")]),
]
SCRIPT_IDS = [m.__module__.rsplit(".", 1)[-1] for m, _ in SCRIPT_MAINS]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_or_fab_tpu(path):
    source = path.read_text()
    assert not FORBIDDEN_TEXT.search(source), FORBIDDEN_TEXT.search(source).group(0)
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN_MODULES, name


def _imported_names(source: str):
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", NOTEBOOKS, ids=lambda p: p.name)
def test_notebook_code_imports_no_jax_or_fab_tpu(path):
    cells = json.loads(path.read_text())["cells"]
    sources = ["".join(c["source"]) for c in cells if c["cell_type"] == "code"]
    assert sources and any("fab_tpu_torch" in src for src in sources)
    for src in sources:
        assert not FORBIDDEN_TEXT.search(src), FORBIDDEN_TEXT.search(src).group(0)
        for name in _imported_names(src):
            assert name.split(".")[0] not in FORBIDDEN_MODULES, name


def test_importing_the_port_loads_no_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT_FILES
        if p.parent != ROOT
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN_MODULES!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "entry",
    [make_realnvp, ManyWellEnergy, LogGaussianCoxProcess, GMM, Trainer, BufferTrainer,
     PrioritisedBufferTrainer, setup_trainer_and_run_flow, AldpBoltzmann, make_aldp_flow,
     make_aldp_model, make_resampled_realnvp, make_snf_model, make_masked_affine_maf,
     bench.measure, bench.make_trainer],
    ids=lambda e: e.__name__,
)
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


@pytest.mark.parametrize("main, argv", SCRIPT_MAINS, ids=SCRIPT_IDS)
def test_scripts_default_to_the_card(main, argv, monkeypatch):
    """Each script's ``--device`` defaults to cuda (its parsed arguments, read before
    anything runs)."""
    parsed = []
    parse_args = argparse.ArgumentParser.parse_args

    def stop_after_parsing(self, *args, **kwargs):
        parsed.append(parse_args(self, *args, **kwargs))
        raise KeyboardInterrupt

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop_after_parsing)
    with pytest.raises(KeyboardInterrupt):
        main(argv)
    assert parsed[0].device == "cuda"


@pytest.mark.parametrize("main, argv", SCRIPT_MAINS, ids=SCRIPT_IDS)
def test_scripts_raise_without_a_card(main, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ManyWellEnergy(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_realnvp(4, n_flow_layers=1, layer_nodes_per_dim=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LogGaussianCoxProcess(grid_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LogGaussianCoxProcess(grid_size=4, in_graph_kernel=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GMM(true_expectation_estimation_n_samples=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AldpBoltzmann()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_aldp_flow(6, (1,), n_blocks=1, hidden_units=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_resampled_realnvp(4, n_flow_layers=1, layer_nodes_per_dim=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_snf_model(4, lambda x: x.sum(-1), n_flow_layers=1, layer_nodes_per_dim=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_masked_affine_maf(4, n_layers=1, hidden_units=4)


def test_wrapper_has_no_fallback_off_the_cpu():
    """A tensor on another device than the CPU never takes the plain version."""
    t = lambda *s: torch.empty(s, device="meta")
    before = fused_realnvp_pass.launches
    with pytest.raises(ValueError, match="unsupported device"):
        fused_realnvp_pass(
            t(8, 4), t(1, 2, 8), t(1, 8), t(1, 8, 8), t(1, 8), t(1, 8, 4), t(1, 4),
            t(1, 4, 4), t(1, 1), inverse=True,
        )
    assert fused_realnvp_pass.launches == before


def test_coupling_wrapper_has_no_fallback_off_the_cpu():
    """K2's wrapper: a tensor on another device than the CPU never takes the plain
    version, and nothing is counted."""
    t = lambda *s: torch.empty(s, device="meta")
    before = fused_coupling_apply.launches
    with pytest.raises(ValueError, match="unsupported device"):
        fused_coupling_apply(
            t(8, 4), t(8, 4), t(4, 128), t(128), t(128, 128), t(128), t(128, 128),
            t(128), 5.0, inverse=True,
        )
    assert fused_coupling_apply.launches == before
