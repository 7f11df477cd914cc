"""The model axis of the port's mesh (``fab_tpu_torch/parallel/tensor.py``,
``parallel/mesh.py``) on the CPU over gloo, against the port's own one-process run
(``tests/test_torch_model_axis_fab_tpu.py`` holds the runs against ``fab_tpu``).

Ranks are spawned by ``tests/torch_parallel_workers.py`` (torch and the port only).

- The split pattern (``mlp_param_sharding``, ``fab_tpu``'s spec), the refusal of a
  width the model axis does not divide, and ``shard_flow_params`` leaving a plain
  mesh alone, in one process.
- (1, 2), (2, 2) and (1, 4) meshes against one process at f64 to 1e-8: a 3-layer
  MLP split column / row / replicated, its output, x-gradient and parameter
  gradient.
- A (2, 2) mesh against one process at f64 to 1e-8, ``PrioritisedBufferTrainer`` on
  ManyWell-4 (init_state and 3 steps, every update clipped) through the plain
  RealNVP, the fused flow (K1's plain version on gathered weights),
  ``LargeFusedCoupling`` (K2's plain version on gathered weights), a spline flow
  and MAF (its masks cut as its weights): the split init, parameters, Adam's
  moments (shaped like the shards, gathered), the clip's norm, the buffer and info.
- Checkpoints: a (2, 2) run's pickle and DCP checkpoints loaded on a (1, 2) mesh and
  in one process, and a one-process DCP checkpoint loaded on (2, 2), each taking the
  same next step.
"""
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from fab_tpu_torch.flows import make_realnvp
from fab_tpu_torch.flows.mlp import Dense
from fab_tpu_torch.parallel import mesh
from fab_tpu_torch.parallel.tensor import (
    COLUMN,
    ROW,
    mlp_param_sharding,
    shard_flow_params,
    split_layers,
)

# ------------------------------------------------------------ one process


def test_split_pattern_is_fab_tpus():
    """Column / row pairs, a layer left after the last pair replicated
    (``fab_tpu/flows/mlp.py:70-94``)."""
    assert mlp_param_sharding([3, 8, 8, 6]) == (COLUMN, ROW, None)
    assert mlp_param_sharding([3, 8, 6]) == (COLUMN, ROW)
    assert mlp_param_sharding([3, 8, 8, 8, 6]) == (COLUMN, ROW, COLUMN, ROW)
    assert mlp_param_sharding([3, 6]) == (None,)


def test_a_width_the_model_axis_does_not_divide_raises():
    layer = Dense(3, 6, torch.float64)
    with pytest.raises(ValueError, match=r"bijectors.0.mlp.0: its output width 6 does "
                                         r"not divide over the 4 ranks"):
        layer.shard_model_axis(COLUMN, mesh.Mesh(n_data=1, rank=0, n_model=4),
                               "bijectors.0.mlp.0")
    assert layer.split is None and layer.w.shape == (3, 6)


def test_shard_flow_params_leaves_a_plain_mesh_alone():
    """Without a mesh and with n_model == 1 nothing is split (the plain and
    data-parallel paths stay as they were)."""
    flow = make_realnvp(4, 2, 2, dtype=torch.float64, device="cpu")
    before = {k: v.clone() for k, v in flow.state_dict().items()}
    shard_flow_params(flow)
    shard_flow_params(flow, mesh.Mesh(n_data=2, rank=1))
    assert split_layers(flow) == {}
    for k, v in flow.state_dict().items():
        assert v.shape == before[k].shape and torch.equal(v, before[k])


# ------------------------------------------------------------- split MLP

MESHES = [(1, 2), (2, 2), (1, 4)]


@pytest.fixture(scope="module")
def split_mlp(tmp_path_factory):
    rng = np.random.default_rng(4)
    args = {"sizes": [3, 8, 8, 6], "x": rng.standard_normal((16, 3))}
    ranks = {shape: workers.run_ranks(
        "split_mlp", shape[0] * shape[1], dict(args, mesh=shape),
        str(tmp_path_factory.mktemp(f"mlp{shape[0]}{shape[1]}"))) for shape in MESHES}
    return ranks, workers.split_mlp(args)


@pytest.mark.parametrize("key", ["output", "x_grad", "param_grad"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_split_mlp_equals_one_process(split_mlp, shape, key):
    """Megatron's pair: the column layer's input gradient summed over the model group
    (backward), the row layer's products summed before its bias (forward); the
    parameter gradients are the shards of one process's."""
    ranks, expected = split_mlp
    for rank, result in enumerate(ranks[shape]):
        if key == "param_grad":
            for name, value in expected[key].items():
                workers.close(result[key][name], value, 1e-8, f"rank {rank} {name}")
        else:
            workers.close(result[key], expected[key], 1e-8, f"rank {rank} {key}")
        counts = result["counts"]
        # One model all-reduce forward per MLP call (2) and one backward per input
        # gradient (2); the 3 gathers are the test's own (split gradients made whole).
        assert counts["model/all_reduce"] == 4 and counts["model/all_gather"] == 3


# ---------------------------------------------------- trainers on (2, 2)


@pytest.fixture(scope="module")
def one_process():
    return {kind: workers.model_axis_steps(kind) for kind in workers.MODEL_KINDS}


@pytest.fixture(scope="module")
def on_two_by_two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis")
    save = {"pickle": str(tmp / "pickle"), "dcp": str(tmp / "dcp")}
    ranks = workers.run_ranks("model_axis", 4, {"kinds": workers.MODEL_KINDS,
                                                "mesh": (2, 2), "save": save},
                              str(tmp / "ranks"), timeout=240.0)
    return ranks, save


@pytest.mark.parametrize("kind", workers.MODEL_KINDS)
def test_trainer_on_a_two_by_two_mesh_equals_one_process(on_two_by_two, one_process, kind):
    """init_state and 3 PrioritisedBufferTrainer steps at f64: flow, Adam's moments
    (gathered), transition state, buffer and info to 1e-8."""
    keys = ["loss", "grad_norm", "ess_ais", "ess_base", "n_valid", "w_adjust_mean",
            "w_adjust_max", "log_q_x_mean", "sampled_log_w_mean", "sampled_log_w_std"]
    for rank, result in enumerate(on_two_by_two[0]):
        workers.check_summary(result[kind]["steps"], one_process[kind]["steps"],
                              f"{kind} rank {rank}", keys)


@pytest.mark.parametrize("kind", ["realnvp", "maf"])
def test_split_init_equals_the_one_process_init(on_two_by_two, one_process, kind):
    """init_state on the mesh: the flow initialised whole from the shared generator
    and split, the buffer filled; gathered, it is one process's init."""
    for rank, result in enumerate(on_two_by_two[0]):
        workers.check_summary(result[kind]["init"], one_process[kind]["init"],
                              f"{kind} init rank {rank}")


def test_clip_norm_and_adam_moments_on_the_mesh(on_two_by_two, one_process):
    """The global norm the guard and the clip see adds the shards' squares over the
    model group and counts replicated tensors once: the logged grad_norm is one
    process's (and above the clip, so every update was clipped); Adam's moments are
    shaped like the shards and, gathered, one process's."""
    expected = one_process["realnvp"]["steps"]
    assert expected["info"]["grad_norm"] > 0.05
    for result in on_two_by_two[0]:
        steps = result["realnvp"]["steps"]
        workers.close(steps["info"]["grad_norm"], expected["info"]["grad_norm"], 1e-8,
                      "grad_norm")
        for mine, theirs in zip(steps["mu"] + steps["nu"], expected["mu"] + expected["nu"]):
            workers.close(mine, theirs, 1e-8, "Adam moment")


def test_collectives_by_axis_on_the_mesh(on_two_by_two):
    """Every rank issues the same collectives; both axes carry some."""
    counts = [r["counts"] for r in on_two_by_two[0]]
    assert all(c == counts[0] for c in counts)
    for key in ("data/all_reduce", "data/all_gather", "model/all_reduce",
                "model/all_gather"):
        assert counts[0][key] > 0, key


# ------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def resumed(on_two_by_two, tmp_path_factory):
    """The (2, 2) run's checkpoints loaded on (1, 2) and in one process, and a
    one-process DCP checkpoint loaded on (2, 2)."""
    _, save = on_two_by_two
    tmp = tmp_path_factory.mktemp("resume")
    pickle_path = f"{save['pickle']}/iter_{workers.MODEL_STEPS}/state.pkl"
    out = {}
    for backend, source in (("pickle", pickle_path), ("dcp", save["dcp"])):
        out[backend] = (workers.model_axis_resume({backend: source}),
                        workers.run_ranks("model_axis_resume", 2,
                                          {backend: source, "mesh": (1, 2)},
                                          str(tmp / f"{backend}12")))
    trainer = workers.build_model_axis("realnvp")
    state = trainer.init_state(torch.Generator().manual_seed(5), batch_size=workers.BATCH)
    state, _ = trainer.train_step(state, torch.Generator().manual_seed(6), workers.BATCH)
    trainer.save_checkpoint_dcp(state, str(tmp / "one_process_dcp"))
    out["dcp_from_one_process"] = (
        workers.model_axis_resume({"dcp": str(tmp / "one_process_dcp")}),
        workers.run_ranks("model_axis_resume", 4,
                          {"dcp": str(tmp / "one_process_dcp"), "mesh": (2, 2)},
                          str(tmp / "dcp22")))
    return out


@pytest.mark.parametrize("case", ["pickle", "dcp", "dcp_from_one_process"])
def test_checkpoints_move_between_mesh_shapes(resumed, on_two_by_two, case):
    """The loaded state is the saved one in every layout (the pickle holds whole
    tensors), and the next step on the other mesh is one process's, to 1e-8."""
    expected, ranks = resumed[case]
    if case != "dcp_from_one_process":
        saved = on_two_by_two[0][0]["realnvp"]["steps"]
        workers.check_summary(expected["loaded"], saved, f"{case} loaded in one process")
    for rank, result in enumerate(ranks):
        assert result["step"] == expected["step"]
        workers.check_summary(result["loaded"], expected["loaded"], f"{case} rank {rank}")
        workers.check_summary(result["next"], expected["next"], f"{case} next rank {rank}",
                              ["loss", "grad_norm"])
