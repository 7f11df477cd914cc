"""The port's data parallelism (``fab_tpu_torch/parallel/``) on the CPU over gloo,
against its own one-process run (``tests/test_torch_parallel_fab_tpu.py`` holds the
runs against ``fab_tpu`` and through the runners).

- The set-up helpers in one process: ``launcher_env`` / ``initialize`` without a
  launcher, ``make_mesh``'s error without a process group, ``setup_mesh`` with and
  without a launcher (``mesh.n_data=2`` or ``mesh.n_model=2`` without one raises,
  naming the launcher command), the helpers on a mesh that needs no collective
  (``constrain_batch``, ``check_batch``), and ``resolve_device`` under a launcher.
- ``make_mesh`` on 2 ranks: the data mesh, the (1, 2) grid, and the ``ValueError`` for
  a grid the world size does not match.
- 2 ranks against the port's one process at f64 (ranks spawned by
  ``tests/torch_parallel_workers.py``, which loads no JAX): every reduction, each
  loss's value and gradient, and the buffers' add, sample (with and without
  replacement), adjust and gather.
- 2 and 4 ranks against one process, after ``__graft_entry__.dryrun_multichip``:
  ``PrioritisedBufferTrainer`` on ManyWell-4 for 10 steps, ``Trainer`` (GMM,
  Metropolis) and ``BufferTrainer`` for 3. Parameters, Adam's moments and buffer
  priorities agree to 1e-8, the transition state to 1e-9, the buffer's cursor,
  ``n_added`` and finite pattern exactly; every rank holds the same replicated state.
"""
import pathlib

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from fab_tpu_torch.device import resolve_device
from fab_tpu_torch.experiments.setup_run import setup_mesh
from fab_tpu_torch.parallel import distributed, mesh
from fab_tpu_torch.utils.training import apply_overrides, load_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                 "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


@pytest.fixture
def no_launcher(monkeypatch):
    for name in LAUNCHER_VARS:
        monkeypatch.delenv(name, raising=False)


# ------------------------------------------------------------ one process


def test_without_a_launcher_nothing_is_set_up(no_launcher):
    assert distributed.launcher_env() is None
    assert distributed.initialize("cpu") is False
    assert distributed.is_primary() and distributed.n_hosts() == 1
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        mesh.make_mesh()


def test_launcher_env_reads_torchrun_and_fab_tpu_variables(no_launcher, monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    assert distributed.launcher_env() == {
        "init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 3, "local_rank": 0}
    for name, value in (("MASTER_ADDR", "h"), ("MASTER_PORT", "1"), ("RANK", "5"),
                        ("WORLD_SIZE", "8"), ("LOCAL_RANK", "1")):
        monkeypatch.setenv(name, value)
    assert distributed.launcher_env() == {
        "init_method": "env://", "world_size": 8, "rank": 5, "local_rank": 1}


def test_make_mesh_refuses_the_model_axis(units):
    """On 2 ranks: ``make_mesh(n_model=2)`` is the (1, 2) grid (rank r at data index 0,
    model index r); a model axis or a grid the world size does not match raises."""
    for rank, result in enumerate(units[0]):
        assert result["model_mesh"] == (1, 2, 0, rank)
        assert ("mesh.n_data=2 x mesh.n_model=2 but 2 processes were launched"
                in result["grid_mismatch"])
        assert "mesh.n_model=3 does not divide the 2 processes" in result["model_mismatch"]


def _cfg(*overrides):
    return apply_overrides(load_config(str(ROOT / "experiments" / "configs" / "gmm.yaml")),
                           list(overrides))


def test_setup_mesh_without_a_launcher_names_the_launcher(no_launcher, capsys):
    assert setup_mesh(_cfg(), torch.device("cpu")) is None
    (line,) = capsys.readouterr().out.splitlines()
    assert "python3 -m torch.distributed.run --nproc_per_node=N" in line
    assert mesh.active_mesh() is None
    assert setup_mesh(_cfg("mesh.enable=false"), torch.device("cpu")) is None


def test_setup_mesh_refuses_what_one_process_cannot_hold(no_launcher):
    with pytest.raises(ValueError, match="--nproc_per_node=2"):
        setup_mesh(_cfg("mesh.n_data=2"), torch.device("cpu"))
    with pytest.raises(ValueError, match=r"--nproc_per_node=2 .* mesh.n_data=1 "
                                         r"mesh.n_model=2"):
        setup_mesh(_cfg("mesh.n_model=2"), torch.device("cpu"))
    with pytest.raises(ValueError, match=r"--nproc_per_node=4 .* mesh.n_data=2 "
                                         r"mesh.n_model=2"):
        setup_mesh(_cfg("mesh.n_data=2", "mesh.n_model=2"), torch.device("cpu"))


def test_batch_helpers_on_a_mesh():
    """constrain_batch cuts rows [r B / n, (r + 1) B / n) and leaves an undivided
    batch whole; check_batch refuses it; draw_rows draws at the global shape."""
    x = torch.arange(12.0).reshape(6, 2)
    with mesh.use_mesh(mesh.Mesh(n_data=3, rank=1)):
        assert torch.equal(mesh.constrain_batch(x), x[2:4])
        assert torch.equal(mesh.constrain_batch(x[:5]), x[:5])
        assert torch.equal(mesh.constrain_batch(torch.tensor(1.0)), torch.tensor(1.0))
        tree = mesh.constrain_tree_batch({"a": x, "b": (x[:, 0], 3)})
        assert torch.equal(tree["a"], x[2:4]) and torch.equal(tree["b"][0], x[2:4, 0])
        with pytest.raises(ValueError, match="does not divide"):
            mesh.check_batch(4)
        drawn = mesh.draw_rows(lambda g, s: torch.randn(s, generator=g),
                               torch.Generator().manual_seed(0), (2, 5))
        assert torch.equal(drawn, torch.randn(6, 5, generator=torch.Generator()
                                              .manual_seed(0))[2:4])
        assert mesh.global_rows(2) == 6 and not mesh.divides(5)
    assert mesh.active_mesh() is None and torch.equal(mesh.constrain_batch(x), x)


def test_resolve_device_takes_the_launchers_local_rank(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("cuda") == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")


# ------------------------------------------------------------- 2 ranks: units


@pytest.fixture(scope="module")
def units(tmp_path_factory):
    inputs = workers.units_reference()
    ranks = workers.run_ranks("units", 2, inputs, str(tmp_path_factory.mktemp("units")))
    return ranks, workers.units(inputs)


UNIT_KEYS = ["ess", "ess_nomask", "ess_over_p", "log_z", "expectation", "masked_mean",
             "mean", "std", "max", "min", "kth", "logsumexp", "softmax", "normal_draw"]
LOSSES = ["fab_alpha_div", "fab_alpha_div_nomask", "replay", "replay_nomask",
          "reverse_kl", "alpha_2", "alpha_2_unbiased", "nis", "forward_kl", "ub_alpha_2"]


def test_make_mesh_on_two_ranks(units):
    """n_data null is the world size; any other value than the world size raises."""
    for result in units[0]:
        assert result["world_mesh"] is True
        assert "mesh.n_data=3 but 2 processes were launched" in result["n_data_mismatch"]


def test_collectives_without_an_active_mesh_span_the_world(units):
    """With no mesh active (a caller timing a collective, say) the data-axis
    collectives run over the whole process group."""
    for result in units[0]:
        summed, gathered = result["no_mesh_collectives"]
        np.testing.assert_array_equal(summed, [2.0, 2.0])
        np.testing.assert_array_equal(gathered, np.ones((2, 2)))


@pytest.mark.parametrize("key", UNIT_KEYS)
def test_reductions_on_two_ranks_equal_one_process(units, key):
    ranks, expected = units
    for result in ranks:
        workers.close(result[key], expected[key], 1e-12, key)


@pytest.mark.parametrize("name", LOSSES)
def test_loss_shares_sum_to_the_one_process_loss_and_gradient(units, name):
    """Each rank's loss is its share: summed over the ranks, the loss and its
    gradient in log q are the one-process ones."""
    ranks, expected = units
    for result in ranks:
        workers.close(result["loss_" + name], expected["loss_" + name], 1e-12, name)
        workers.close(result["grad_" + name], expected["grad_" + name], 1e-12, name)


@pytest.mark.parametrize("key", ["prioritised_without", "prioritised_with", "uniform"])
def test_sharded_buffer_equals_one_process(units, key):
    """Five adds, a draw of two replay batches (the rows each rank keeps, gathered,
    and their slots), two adjustments with killed rows, then every slot gathered
    into the one-process layout: exactly the one-process buffer."""
    ranks, expected = units
    for result in ranks:
        for field, value in expected[key].items():
            workers.close(result[key][field], value, 0.0, f"{key}.{field}")


# -------------------------------------------------- 2 and 4 ranks: trainers

KINDS = ["prioritised", "buffer", "trainer"]


@pytest.fixture(scope="module")
def one_process():
    return {kind: workers.run_steps(kind) for kind in KINDS}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def on_ranks(request, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp(f"trainers{request.param}"))
    return workers.run_ranks("trainers", request.param, {"kinds": KINDS}, tmp)


@pytest.mark.parametrize("kind", KINDS)
def test_trainer_on_ranks_equals_one_process(on_ranks, one_process, kind):
    """PrioritisedBufferTrainer 10 steps, BufferTrainer and Trainer 3, at f64."""
    info_keys = ["loss", "grad_norm", "ess_ais", "ess_base", "log_Z", "n_valid"]
    if kind == "prioritised":
        info_keys += ["w_adjust_mean", "w_adjust_min", "w_adjust_max", "log_q_x_mean",
                      "sampled_log_w_mean", "sampled_log_w_std"]
    elif kind == "buffer":
        info_keys += ["replay_loss"]
    for rank, result in enumerate(on_ranks):
        workers.check_summary(result[kind], one_process[kind], f"{kind} rank {rank}",
                              info_keys)


def test_replicated_state_is_the_same_on_every_rank(on_ranks):
    """Flow parameters, Adam's state and the transition state are equal bit for bit
    on every rank: the same seed, the same all-reduced values."""
    first = on_ranks[0]
    for result in on_ranks[1:]:
        for kind in KINDS:
            a, b = result[kind], first[kind]
            for name in a["flow"]:
                assert np.array_equal(a["flow"][name], b["flow"][name]), (kind, name)
            for name in a["transition"]:
                assert np.array_equal(a["transition"][name], b["transition"][name])
            assert all(np.array_equal(x, y) for x, y in zip(a["mu"], b["mu"]))
