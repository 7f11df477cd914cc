"""The port's bench, bench_scaling and bench_lgcp_kernel on the CPU.

- ``python3 -m fab_tpu_torch.bench --device cpu`` at a small batch and width prints
  exactly one JSON line on stdout, with the keys of the repository's ``bench.py``
  (read from its source), ``mfu`` null and a reason on stderr; its value is the
  compiled step's (``make_train_step``), the eager steps' on stderr before it;
- the bench's settings are ``bench.py``'s (the trainer's hyperparameters, read from
  both sources), and its fused and plain trainers start from the same parameters and
  take the same step (K1's plain version on the CPU: float32, 1e-5);
- ``bench_scaling --check-only --mesh-sizes 1 2`` over gloo prints two lines with
  ``bench_scaling.py``'s keys, ``efficiency_vs_1`` 1.0 on the first; a size above the
  number of cards is not run on the card, and is said so;
- ``bench_lgcp_kernel`` at a small size: its JSON, K2's plain version against the
  plain coupling (exact on the CPU), and the whole flow fused and plain.
"""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from fab_tpu_torch import bench, bench_scaling
from fab_tpu_torch.experiments import bench_lgcp_kernel
from torch_parity_utils import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _printed_keys(path: pathlib.Path):
    """The keys of the dict literals that ``path`` passes to ``json.dumps``."""
    keys = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            keys += [k.value for k in node.args[0].keys]
    return keys


def _run(args, timeout=240):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout, env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_bench_prints_one_json_line_with_bench_py_keys():
    proc = _run(["fab_tpu_torch.bench", "--device", "cpu", "--batch-size", "64",
                 "--layer-nodes-per-dim", "2", "--steps", "2", "--warmup", "1"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert list(line) == _printed_keys(ROOT / "bench.py")
    assert line["mfu"] is None and "mfu null" in proc.stderr
    assert line["value"] > 0 and line["vs_baseline"] > 0 and line["achieved_flops_per_s"] > 0
    assert "K1 per fused step: launches [0], recomputes [29]" in proc.stderr
    # value and vs_baseline are the compiled steps'; the eager ones come first.
    for kind in ("fused", "plain"):
        assert f"{kind} compiled step, first call" in proc.stderr
    assert re.search(r"median step: fused [\d.]+ ms, plain [\d.]+ ms", proc.stderr)
    assert re.search(r"median eager step: fused [\d.]+ ms, plain [\d.]+ ms", proc.stderr)
    rates = dict(re.findall(r"(compiled|eager) samples/s: fused ([\d.]+)", proc.stderr))
    assert set(rates) == {"compiled", "eager"}
    assert float(rates["compiled"]) == pytest.approx(line["value"], rel=0.5)


def test_bench_settings_are_bench_py_settings():
    """The trainer's hyperparameters, as written in both sources."""
    theirs, ours = (ROOT / "bench.py").read_text(), (ROOT / "fab_tpu_torch/bench.py").read_text()
    for pattern in (r"n_ais_intermediate_distributions=4", r"n_outer=1", r"n_leapfrog=5",
                    r"epsilon=1\.0", r"n_intermediate_distributions=4",
                    r'loss_type="fab_alpha_div"', r"max_length=batch_size \* 16",
                    r"min_sample_length=batch_size \* 4", r"make_optimizer\(3e-4, 100\.0\)",
                    r"n_batches_buffer_sampling=8", r"w_adjust_max_clip=10\.0"):
        assert re.search(pattern, theirs) and re.search(pattern, ours), pattern
    assert "dim = 32" in theirs and bench.DIM == 32
    assert "n_flow_layers=10, layer_nodes_per_dim=10, act_norm=False" in theirs
    assert bench.N_LAYERS == 10
    assert re.search(r"def measure_ours\(n_warmup=2, n_steps=10, batch_size=2048", theirs)


def test_bench_fused_and_plain_trainers_take_the_same_step():
    fused = bench.make_trainer("cpu", 3, True, batch_size=32, layer_nodes_per_dim=2)
    plain = bench.make_trainer("cpu", 3, False, batch_size=32, layer_nodes_per_dim=2)
    for a, b in zip(fused.model.flow.state_dict().values(), plain.model.flow.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    states = {}
    for kind, trainer in (("fused", fused), ("plain", plain)):
        gen = torch.Generator().manual_seed(4)
        state = trainer.init_state(gen, batch_size=32)
        states[kind], _, seconds = bench.timed_step(trainer, state, gen, 32, torch.device("cpu"))
        assert seconds > 0
    for a, b in zip(fused.model.flow.parameters(), plain.model.flow.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_bench_result_line_and_peak():
    run = {"seconds": {"fused": [0.5, 0.5], "plain": [0.75, 0.75]}, "flops_per_step": 1e12}
    line = bench.result_line(2048, run, 67e12)
    assert line["value"] == 4096.0 and line["vs_baseline"] == 1.5
    assert line["achieved_flops_per_s"] == 2e12 and line["mfu"] == round(2e12 / 67e12, 6)
    assert bench.result_line(2048, run, None)["mfu"] is None
    assert bench.f32_peak(torch.device("cpu"))[0] is None


def test_bench_scaling_check_only_over_gloo():
    proc = _run(["fab_tpu_torch.bench_scaling", "--device", "cpu", "--check-only",
                 "--mesh-sizes", "1", "2"], timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert [x["n_devices"] for x in lines] == [1, 2]
    keys = _printed_keys(ROOT / "bench_scaling.py")
    assert all(list(x) == keys for x in lines), (lines, keys)
    assert lines[0]["efficiency_vs_1"] == 1.0
    assert all(x["samples_per_s"] > 0 for x in lines)


def test_bench_scaling_runs_no_more_ranks_than_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    launched = []
    monkeypatch.setattr(bench_scaling, "launch", lambda n, *a: launched.append(n) or {
        "samples_per_s": 100.0 * n})
    lines = bench_scaling.main(["--mesh-sizes", "1", "2", "4", "--device", "cuda"])
    assert launched == [1] and [x["n_devices"] for x in lines] == [1]
    assert "sizes [2, 4] not run: NCCL takes one card per rank" in capsys.readouterr().err


def test_bench_lgcp_kernel_on_the_cpu(capsys):
    result = bench_lgcp_kernel.main(["--device", "cpu", "--batch", "8", "--dim", "16",
                                     "--nodes-per-dim", "8", "--layers", "2", "--repeats",
                                     "1", "--rounds", "2"])
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    for mode in ("fwd", "inv"):
        assert result["layer"][mode]["max_abs_err"] == 0.0  # both plain on the CPU
        assert result["layer"][mode]["kernel_ms"] > 0
    for kind in ("fused", "plain"):
        assert result["flow"][kind]["sample_and_log_prob"] > 0
        assert result["flow"][kind]["k2_launches_per_pass"] == 0  # nothing launched here
    assert "bound_ms" not in result["layer"]  # no H100 here
    assert "per-layer:" in out and "(bench_lgcp_kernel.py:82-89's reckoning)" in out


@pytest.mark.parametrize("main", [bench.main, bench_scaling.main, bench_lgcp_kernel.main],
                         ids=["bench", "bench_scaling", "bench_lgcp_kernel"])
def test_benches_raise_without_a_card(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([])
