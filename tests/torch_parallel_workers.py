"""Workers for the port's data-parallel tests: n processes on the CPU over gloo.

Imports torch and fab_tpu_torch only, so each rank is a fresh interpreter with no
JAX. ``run_ranks`` starts the ranks as

    python3 tests/torch_parallel_workers.py <task> <rank> <world> <port> <args.pkl> <out>

and returns each rank's result; a rank that fails or outlives ``timeout`` fails the
call (every rank is then killed), and a collective that waits more than
``GROUP_TIMEOUT`` raises inside its rank. The scenarios are plain functions, so a
test runs the same code in its own process, without a mesh, as the one-process
reference.
"""
from __future__ import annotations

import builtins
import datetime
import os
import pickle
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
BATCH = 64


# ----------------------------------------------------------------- launching


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task: str, world: int, args, tmp_dir: str, timeout: float = 180.0,
              launcher_env: bool = False):
    """Run ``task`` on ``world`` ranks; returns the list of their results. With
    ``launcher_env`` the ranks get a launcher's variables (MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE, LOCAL_RANK) and set up no process group themselves."""
    os.makedirs(tmp_dir, exist_ok=True)
    args_path = os.path.join(tmp_dir, f"{task}_args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        if launcher_env:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                       WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
        out = os.path.join(tmp_dir, f"{task}_rank{rank}.pkl")
        log = open(os.path.join(tmp_dir, f"{task}_rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, str(rank), str(world),
             str(port), args_path, out], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log, out))
    deadline = time.time() + timeout
    try:
        for proc, _, _ in procs:
            proc.wait(timeout=max(deadline - time.time(), 1.0))
    except subprocess.TimeoutExpired:
        for proc, _, _ in procs:
            proc.kill()
        raise AssertionError(f"{task} on {world} ranks outlived {timeout} s: "
                             + _logs(procs))
    finally:
        for proc, log, _ in procs:
            proc.wait()
            log.close()
    bad = [p.returncode for p, _, _ in procs if p.returncode != 0]
    assert not bad, f"{task} on {world} ranks failed {bad}: " + _logs(procs)
    results = []
    for _, _, out in procs:
        with open(out, "rb") as f:
            results.append(pickle.load(f))
    return results


def _logs(procs) -> str:
    text = []
    for rank, (_, log, _) in enumerate(procs):
        with open(log.name) as f:
            text.append(f"--- rank {rank}\n" + f.read()[-4000:])
    return "\n".join(text)


# ------------------------------------------------------------------- scenarios


def build(kind: str, dtype=torch.float64):
    """A small f64 trainer on the CPU: ``prioritised`` (ManyWell-4, HMC, the
    prioritised buffer), ``buffer`` (ManyWell-4, the uniform buffer, log-weight
    clip) or ``trainer`` (GMM, Metropolis AIS, the plain Trainer)."""
    from fab_tpu_torch.buffer import PrioritisedReplayBuffer, ReplayBuffer
    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo, Metropolis
    from fab_tpu_torch.targets import GMM, ManyWellEnergy
    from fab_tpu_torch.train import (
        BufferTrainer,
        PrioritisedBufferTrainer,
        Trainer,
        make_optimizer,
    )

    dim = 2 if kind == "trainer" else 4
    flow = make_realnvp(dim, n_flow_layers=2, layer_nodes_per_dim=4, dtype=dtype,
                        device="cpu")
    if kind == "trainer":
        target = GMM(dim=2, n_mixes=4, loc_scaling=5.0, n_test_set_samples=64,
                     true_expectation_estimation_n_samples=1000, dtype=dtype, device="cpu")
        op = Metropolis(n_ais_intermediate_distributions=2, n_updates=2, max_step_size=1.0,
                        min_step_size=0.5)
    else:
        target = ManyWellEnergy(dim, device="cpu")
        op = HamiltonianMonteCarlo(n_ais_intermediate_distributions=2, n_leapfrog=2,
                                   epsilon=1.0)
    model = FABModel.create(flow, target, transition_operator=op,
                            n_intermediate_distributions=2)
    optimizer = make_optimizer(1e-3, 100.0)
    common = dict(dtype=dtype, device="cpu")
    if kind == "prioritised":
        buffer = PrioritisedReplayBuffer(dim=dim, max_length=8 * BATCH,
                                         min_sample_length=2 * BATCH, batch_size=BATCH)
        return PrioritisedBufferTrainer(model, optimizer, buffer, n_batches_buffer_sampling=2,
                                        **common)
    if kind == "buffer":
        buffer = ReplayBuffer(dim=dim, max_length=8 * BATCH, min_sample_length=2 * BATCH,
                              temperature=0.5, batch_size=BATCH)
        return BufferTrainer(model, optimizer, buffer, n_batches_buffer_sampling=2,
                             clip_ais_weights_frac=0.1, **common)
    return Trainer(model, optimizer, **common)


STEPS = {"prioritised": 10, "buffer": 3, "trainer": 3}


def run_steps(kind: str, seed: int = 0):
    """init_state and STEPS[kind] train steps at BATCH rows; the summary of the
    end state (buffer in the one-process layout) and of the last step's info."""
    trainer = build(kind)
    generator = torch.Generator().manual_seed(seed)
    if kind == "trainer":
        state = trainer.init_state(generator)
    else:
        state = trainer.init_state(generator, batch_size=BATCH)
    for _ in range(STEPS[kind]):
        state, info = trainer.train_step(state, generator, BATCH)
    return summary(trainer, state, info)


def _np(t):
    return t.detach().cpu().numpy().copy()


def summary(trainer, state, info=None) -> dict:
    """numpy copies of the flow, Adam's state, the transition state, the buffer (in
    the one-process layout: a collective under a mesh) and the info's scalars;
    parameters and moments split over a model axis are gathered whole."""
    from fab_tpu_torch.parallel.tensor import gather_state

    flow = trainer.model.flow
    names = trainer._param_names()
    whole = lambda values: list(gather_state(flow, dict(zip(names, values))).values())
    out = {
        "flow": {k: _np(v) for k, v in gather_state(flow, flow.state_dict()).items()},
        "transition": {k: _np(v) for k, v in state.transition_state.items()},
        "count": int(state.opt_state.count),
        "mu": [_np(m) for m in whole(state.opt_state.mu)],
        "nu": [_np(v) for v in whole(state.opt_state.nu)],
        "step": state.step,
    }
    if hasattr(state, "buffer_state"):
        out["buffer"] = {k: _np(v) for k, v in
                         trainer.buffer.gather(state.buffer_state)._asdict().items()}
    if info is not None:
        info = dict(info)
        info.pop("transition", None)
        out["info"] = {k: float(v) for k, v in info.items()}
    return out


# ------------------------------------------------------------- comparisons


def close(actual, expected, tol, what):
    actual, expected = np.asarray(actual), np.asarray(expected)
    if expected.dtype.kind == "f":
        assert (np.isfinite(actual) == np.isfinite(expected)).all(), what
        finite = np.isfinite(expected)
        np.testing.assert_allclose(actual[finite], expected[finite], rtol=tol, atol=tol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(actual, expected, err_msg=what)


def check_summary(result, expected, what, info_keys=()):
    for name, value in expected["flow"].items():
        close(result["flow"][name], value, 1e-8, f"{what} flow {name}")
    for mine, theirs in zip(result["mu"] + result["nu"], expected["mu"] + expected["nu"]):
        close(mine, theirs, 1e-8, f"{what} Adam moment")
    assert result["count"] == expected["count"] and result["step"] == expected["step"]
    for name, value in expected["transition"].items():
        close(result["transition"][name], value, 1e-9, f"{what} transition {name}")
    if "buffer" in expected:
        buffer, ref = result["buffer"], expected["buffer"]
        assert int(buffer["cursor"]) == int(ref["cursor"])
        assert int(buffer["n_added"]) == int(ref["n_added"])
        for field in ref:
            close(buffer[field], ref[field], 1e-8, f"{what} buffer {field}")
    for key in info_keys:
        close(result["info"][key], expected["info"][key], 1e-8, f"{what} info {key}")


# ---------------------------------------------------------------- rank tasks


def task_trainers(args):
    """Every trainer scenario on the mesh."""
    return {kind: run_steps(kind) for kind in args["kinds"]}


def units_reference(seed: int = 3):
    """The inputs of ``task_units``: a global batch and a buffer's worth of rows."""
    rng = np.random.default_rng(seed)
    n, dim, length = 2 * BATCH, 3, 8 * BATCH
    log_w = rng.standard_normal(n) * 2
    log_w[::9] = -np.inf
    return {
        "x": rng.standard_normal((n, dim)),
        "log_w": log_w,
        "mask": rng.random(n) > 0.25,
        "log_q": rng.standard_normal(n),
        "log_p": rng.standard_normal(n),
        "buffer": [(rng.standard_normal((BATCH, dim)), rng.standard_normal(BATCH) * 2,
                    rng.standard_normal(BATCH), rng.random(BATCH) > 0.1)
                   for _ in range(5)],
        "length": length,
    }


def units(inputs) -> dict:
    """Reductions, losses (value and gradient) and buffer operations on
    ``units_reference`` inputs: under a mesh on this rank's rows, each result made
    whole the way a test compares it (gathered rows, summed shares)."""
    from fab_tpu_torch import losses
    from fab_tpu_torch.buffer import PrioritisedReplayBuffer, ReplayBuffer
    from fab_tpu_torch.parallel import mesh
    from fab_tpu_torch.utils import numerical

    t = lambda a: mesh.constrain_batch(torch.as_tensor(a))
    x, log_w, mask = t(inputs["x"]), t(inputs["log_w"]), t(inputs["mask"])
    log_q = t(inputs["log_q"]).requires_grad_(True)
    log_p = t(inputs["log_p"])
    whole = (lambda v: v) if mesh.active_mesh() is None else mesh.all_gather_rows
    total = (lambda v: v) if mesh.active_mesh() is None else mesh.all_reduce
    out = {
        "ess": numerical.effective_sample_size(log_w, mask),
        "ess_nomask": numerical.effective_sample_size(torch.where(mask, log_w, 0.0)),
        "ess_over_p": numerical.effective_sample_size_over_p(log_w, mask),
        "log_z": numerical.log_z_estimate(log_w, mask),
        "expectation": numerical.importance_weighted_expectation(
            lambda v: v.sum(-1), x, log_w, mask),
        "masked_mean": mesh.masked_mean(x[:, 0], mask),
        "mean": mesh.mean_all(x), "std": mesh.std_all(x), "max": mesh.max_all(x),
        "min": mesh.min_all(x), "kth": mesh.kth_largest(log_w, 7),
        "logsumexp": mesh.logsumexp(log_w), "softmax": whole(mesh.softmax(log_w)),
        "normal_draw": whole(mesh.draw_rows(
            lambda g, s, *a: torch.randn(s, generator=g, dtype=torch.float64),
            torch.Generator().manual_seed(5), (x.shape[0], 3))),
    }
    loss_values = {
        "fab_alpha_div": losses.fab_alpha_div(log_q, log_w, 2.0, mask),
        "fab_alpha_div_nomask": losses.fab_alpha_div(log_q, torch.where(mask, log_w, 0.0),
                                                     -1.0),
        "replay": losses.buffer_replay_loss(log_q, log_p, 2.0, 10.0, mask)[0],
        "replay_nomask": losses.buffer_replay_loss(log_q, log_p, 2.0, 10.0)[0],
        "reverse_kl": losses.flow_reverse_kl(log_q, log_p, mask),
        "alpha_2": losses.flow_alpha_2_div(log_q, log_p, mask),
        "alpha_2_unbiased": losses.flow_alpha_2_div_unbiased(log_q, log_p, mask),
        "nis": losses.flow_alpha_2_div_nis(log_q, log_p),
        "forward_kl": losses.forward_kl(log_q),
        "ub_alpha_2": losses.fab_ub_alpha_2_div(log_q, log_p, log_w, mask),
    }
    for name, loss in loss_values.items():
        (grad,) = torch.autograd.grad(loss, log_q)
        out["loss_" + name] = total(loss.detach())
        out["grad_" + name] = whole(grad)

    for replacement in (False, True):
        buf = PrioritisedReplayBuffer(dim=3, max_length=inputs["length"], min_sample_length=8,
                                      sample_with_replacement=replacement, batch_size=BATCH)
        state = buf.init(torch.float64)
        for bx, blw, blq, bm in inputs["buffer"]:
            state = buf.add(state, t(bx), t(blw), t(blq), t(bm))
        generator = torch.Generator().manual_seed(11)
        xs, lws, lqs, idx = buf.sample_n_batches(state, generator, BATCH, 2)
        adj = torch.where(idx % 5 == 0, torch.nan, 0.1 * lqs)
        for b in range(2):
            state = buf.adjust(state, adj[b], lqs[b] + 1.0, idx[b])
        key = f"prioritised_{'with' if replacement else 'without'}"
        rows = lambda v: whole(v.transpose(0, 1).reshape((-1,) + v.shape[2:]))
        out[key] = {"x": rows(xs), "log_w": rows(lws), "idx": rows(idx),
                    **{k: v for k, v in buf.gather(state)._asdict().items()}}
    ubuf = ReplayBuffer(dim=3, max_length=inputs["length"], min_sample_length=8,
                        temperature=0.7, batch_size=BATCH)
    ustate = ubuf.init(torch.float64)
    for bx, blw, _, bm in inputs["buffer"]:
        ustate = ubuf.add(ustate, t(bx), t(blw), t(bm))
    ux, ulw = ubuf.sample(ustate, torch.Generator().manual_seed(13), BATCH)
    out["uniform"] = {"x": whole(ux), "log_w": whole(ulw),
                      **{k: v for k, v in ubuf.gather(ustate)._asdict().items()}}
    return _to_numpy(out)


def _to_numpy(tree):
    if torch.is_tensor(tree):
        return _np(tree)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree


def task_units(args):
    """``units`` on the mesh, and ``make_mesh``'s answers for an n_data other than the
    world size, for ``n_model=2`` and for grids the world size does not match."""
    from fab_tpu_torch.parallel import mesh

    out = units(args)
    try:
        mesh.make_mesh(n_data=mesh.active_mesh().n_data + 1)
        out["n_data_mismatch"] = "accepted"
    except ValueError as e:
        out["n_data_mismatch"] = str(e)
    out["world_mesh"] = mesh.make_mesh() == mesh.active_mesh()
    with mesh.use_mesh(None):
        one = torch.ones(2, dtype=torch.float64)
        out["no_mesh_collectives"] = (_np(mesh.all_reduce(one)),
                                      _np(mesh.all_gather_rows(one[None])))
    grid = mesh.make_mesh(n_model=2)
    out["model_mesh"] = (grid.n_data, grid.n_model, grid.data_index, grid.model_index)
    for key, shape in (("grid_mismatch", (2, 2)), ("model_mismatch", (None, 3))):
        try:
            mesh.make_mesh(*shape)
            out[key] = "accepted"
        except ValueError as e:
            out[key] = str(e)
    return out


def _replayed_trainer(args):
    """The trainer and state of ``task_replayed_step``: set up as
    ``tests/torch_parity_utils.py``'s ``check_train_step`` sets it up (the buffer
    given in the one-process layout; the flow split over the mesh's model axis, if it
    has one), or from ``args["checkpoint"]`` (``load_state``)."""
    from fab_tpu_torch.buffer import PrioritisedBufferState, PrioritisedReplayBuffer
    from fab_tpu_torch.flows import make_realnvp
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.parallel.tensor import shard_flow_params
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo
    from fab_tpu_torch.targets import ManyWellEnergy
    from fab_tpu_torch.train import BufferTrainState, PrioritisedBufferTrainer, make_optimizer

    dim, batch = args["dim"], args["batch"]
    flow = make_realnvp(dim, n_flow_layers=args["n_layers"],
                        layer_nodes_per_dim=args["nodes"], dtype=torch.float64, device="cpu")
    if "flow" in args:
        flow.load_state_dict({k: torch.as_tensor(v) for k, v in args["flow"].items()})
    model = FABModel.create(flow, ManyWellEnergy(dim, device="cpu"),
                            transition_operator=HamiltonianMonteCarlo(**args["hmc"]),
                            n_intermediate_distributions=args["n_dists"])
    buffer = PrioritisedReplayBuffer(dim=dim, max_length=512, min_sample_length=128,
                                     batch_size=batch)
    trainer = PrioritisedBufferTrainer(
        model, make_optimizer(1e-2, 100.0), buffer,
        n_batches_buffer_sampling=args["n_batches"], w_adjust_max_clip=10.0,
        dtype=torch.float64, device="cpu")
    if "checkpoint" in args:
        state, _ = trainer.load_state(args["checkpoint"])
    else:
        full = PrioritisedBufferState(
            **{k: torch.as_tensor(v) for k, v in args["buffer"].items()})
        shard_flow_params(flow)
        state = BufferTrainState(
            transition_state={k: torch.as_tensor(v) for k, v in args["transition"].items()},
            opt_state=trainer.optimizer.init(trainer.params),
            buffer_state=buffer.scatter(full), step=0)
    return trainer, state


def _replay_noise(noise):
    """The port's draws replaced by ``noise``'s arrays, in call order (at the global
    shape: every rank draws them all); returns the queues, to check they are used."""
    from fab_tpu_torch import random as port_random

    queues = {kind: list(values) for kind, values in noise.items()}

    def replay(kind):
        def draw(generator, shape, dtype, device):
            value = queues[kind].pop(0)
            assert tuple(value.shape) == tuple(shape), (kind, value.shape, shape)
            return torch.tensor(value, dtype=dtype, device=device)
        return draw

    for kind in queues:
        setattr(port_random, kind, replay(kind))
    return queues


def task_replayed_step(args):
    """One PrioritisedBufferTrainer step (``_replayed_trainer``) on replayed noise;
    with ``args["save"]`` the state after the step is saved there as a pickle
    checkpoint."""
    trainer, state = _replayed_trainer(args)
    queues = _replay_noise(args["noise"])
    state, info = trainer.train_step(state, None, args["batch"])
    assert not any(queues.values()), {k: len(v) for k, v in queues.items()}
    if "save" in args:
        trainer.checkpoints_dir = args["save"]
        trainer.save_checkpoint(state, state.step)
    return summary(trainer, state, info)


def _same(a, b) -> bool:
    """Two summaries equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b, equal_nan=np.asarray(a).dtype.kind == "f")


def task_compiled_step(args):
    """The compiled step on the mesh, from ``_replayed_trainer``'s state: 3 eager
    ``train_step`` calls, 3 ``make_train_step`` calls and one
    ``make_scanned_train_step(b, 3)`` from one seed (whether the three summaries are
    equal bit for bit), then one ``make_train_step`` call of a fresh trainer on the
    replayed noise (its summary, against ``fab_tpu``'s step)."""
    from fab_tpu_torch import graph

    batch = args["batch"]
    runs = {}
    for mode in ("eager", "step", "scanned"):
        trainer, state = _replayed_trainer(args)
        gen = torch.Generator().manual_seed(7)
        if mode == "scanned":
            state, info = trainer.make_scanned_train_step(batch, 3)(state, gen)
        else:
            step = (trainer.make_train_step(batch) if mode == "step"
                    else lambda s, g: trainer.train_step(s, g, batch))
            for _ in range(3):
                state, info = step(state, gen)
        runs[mode] = summary(trainer, state, info)
    trainer, state = _replayed_trainer(args)
    queues = _replay_noise(args["noise"])
    state, info = trainer.make_train_step(batch)(state, None)
    assert not any(queues.values()), {k: len(v) for k, v in queues.items()}
    program = trainer._program(batch)
    return dict(summary(trainer, state, info), supported=graph.graph_supported(trainer),
                replays=program.replays, has_graph=program.graph is not None,
                bitwise={mode: _same(runs["eager"], runs[mode]) for mode in ("step", "scanned")})


class _WriteLog:
    """Records the paths this process opens for writing."""

    def __init__(self):
        self.paths = []
        self._open = builtins.open

    def __call__(self, file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+"):
            self.paths.append(str(file))
        return self._open(file, mode, *args, **kwargs)


def task_runner(args):
    """A runner's ``main`` under a launcher's variables, then one more train step
    from a fixed generator; also the files this rank opened for writing."""
    import importlib

    runner = importlib.import_module(f"fab_tpu_torch.experiments.{args['runner']}")
    writes = _WriteLog()
    builtins.open = writes
    try:
        trainer, state = runner.main(args["argv"])
    finally:
        builtins.open = writes._open
    next_state, info = trainer.train_step(state, torch.Generator().manual_seed(99),
                                          args["batch"])
    return {"writes": writes.paths, "step": state.step,
            "next": summary(trainer, next_state, info),
            "logger_rows": len(getattr(trainer.logger, "rows", []))}


def _dcp_trainer(args):
    trainer = build("prioritised")
    generator = torch.Generator().manual_seed(args.get("seed", 0))
    state = trainer.init_state(generator, batch_size=BATCH)
    for _ in range(2):
        state, _ = trainer.train_step(state, generator, BATCH)
    return trainer, state


def task_dcp_save(args):
    """Two steps on the mesh, then the state saved with DCP and as a pickle
    checkpoint (rank 0 writes the pickle); the summary of the saved state."""
    trainer, state = _dcp_trainer(args)
    trainer.save_checkpoint_dcp(state, args["dcp"])
    trainer.checkpoints_dir = args["pickle_dir"]
    trainer.save_checkpoint(state, state.step)
    return summary(trainer, state)


def task_dcp_load(args):
    """A DCP checkpoint (any world size) loaded onto the mesh; the summary of the
    loaded state, and of one more step."""
    trainer = build("prioritised")
    state, step = trainer.load_state_dcp(args["dcp"])
    loaded = summary(trainer, state)
    state, info = trainer.train_step(state, torch.Generator().manual_seed(7), BATCH)
    return {"loaded": loaded, "next": summary(trainer, state, info), "step": step}


# ------------------------------------------------------------- the model axis


def split_mlp(inputs) -> dict:
    """A 3-layer f64 MLP (``inputs["sizes"]``, column / row / replicated under a
    model mesh) on ``inputs["x"]``: this rank's rows of the output, their x-gradient
    and the parameter gradients of (output ** 2).sum() over the global batch, made
    whole (parameters gathered over the model group, rows over the data group)."""
    from fab_tpu_torch.flows.mlp import Dense, mlp_apply, mlp_init, shard_mlp
    from fab_tpu_torch.parallel import mesh
    from fab_tpu_torch.parallel.tensor import gather_state

    sizes = inputs["sizes"]
    layers = torch.nn.ModuleList(Dense(i, o, torch.float64)
                                 for i, o in zip(sizes[:-1], sizes[1:]))
    values = mlp_init(sizes, torch.Generator().manual_seed(1), zero_init_last=False,
                      dtype=torch.float64)
    for layer, (w, b) in zip(layers, values):
        layer.assign(w, b)
    active = mesh.active_mesh()
    if active is not None:
        shard_mlp(layers, sizes, active, "mlp")
    x = mesh.constrain_batch(torch.as_tensor(inputs["x"])).requires_grad_(True)
    y = mlp_apply(layers, x)
    loss = (y ** 2).sum()
    grads = dict(zip([n for n, _ in layers.named_parameters()],
                     torch.autograd.grad(loss, [x] + list(layers.parameters()))[1:]))
    x_grad = torch.autograd.grad(mlp_apply(layers, x).sum(), x)[0]
    whole = (lambda v: v) if active is None else mesh.all_gather_rows
    param_grads = gather_state(layers, grads)
    if active is not None:
        param_grads = {k: mesh.all_reduce(v) for k, v in param_grads.items()}
    return _to_numpy({"output": whole(y.detach()), "x_grad": whole(x_grad),
                      "param_grad": param_grads,
                      "counts": {"/".join(k): v for k, v in mesh.COUNTS.items()}})


def task_split_mlp(args):
    return split_mlp(args)


MODEL_KINDS = ["realnvp", "fused", "large", "spline", "maf"]
MODEL_STEPS = 3


def build_model_axis(kind: str):
    """A small f64 PrioritisedBufferTrainer on ManyWell-4 (HMC) whose flow is
    ``kind``: the plain RealNVP, the fused one (K1's plain version on the CPU), one
    of LargeFusedCouplings (K2's plain version), a spline flow or MAF, every
    conditioner of width 8 (split over 2 or 4 model ranks). The clip (0.05) is
    below the gradients' norm, so every update clips."""
    from fab_tpu_torch.buffer import PrioritisedReplayBuffer
    from fab_tpu_torch.flows import Flow, make_masked_affine_maf, make_realnvp
    from fab_tpu_torch.flows.base import DiagGaussianBase
    from fab_tpu_torch.flows.large_coupling import LargeFusedCoupling
    from fab_tpu_torch.flows.linear import LULinear
    from fab_tpu_torch.flows.splines import SplineCoupling
    from fab_tpu_torch.model import FABModel
    from fab_tpu_torch.sampling import HamiltonianMonteCarlo
    from fab_tpu_torch.targets import ManyWellEnergy
    from fab_tpu_torch.train import PrioritisedBufferTrainer, make_optimizer

    dim, common = 4, dict(dtype=torch.float64, device="cpu")
    if kind == "spline":
        bijectors = []
        for i in range(2):
            bijectors += [SplineCoupling(dim, 8, n_bins=4, tail_bound=4.0, swap=i % 2 == 1,
                                         **common), LULinear(dim, **common)]
        flow = Flow(dim, bijectors, DiagGaussianBase(dim, **common))
    elif kind == "maf":
        flow = make_masked_affine_maf(dim, n_layers=2, hidden_units=8, **common)
    else:
        flow = make_realnvp(dim, n_flow_layers=2, layer_nodes_per_dim=2,
                            fused=kind == "fused", fused_coupling=kind == "large", **common)
    for bij in flow.bijectors:
        if isinstance(bij, LargeFusedCoupling):
            # K2's gate takes float32 only; its CPU version (the plain one) takes any
            # dtype, so the gathered-weight path runs here at f64.
            bij._kernel_ok = lambda z: True
    model = FABModel.create(flow, ManyWellEnergy(dim, device="cpu"),
                            transition_operator=HamiltonianMonteCarlo(
                                n_ais_intermediate_distributions=2, n_leapfrog=2,
                                epsilon=0.5),
                            n_intermediate_distributions=2)
    buffer = PrioritisedReplayBuffer(dim=dim, max_length=8 * BATCH,
                                     min_sample_length=2 * BATCH, batch_size=BATCH)
    return PrioritisedBufferTrainer(model, make_optimizer(1e-3, 0.05), buffer,
                                    n_batches_buffer_sampling=2, **common)


def model_axis_steps(kind: str, save: dict = None) -> dict:
    """init_state (summarised) and MODEL_STEPS steps of ``build_model_axis(kind)``
    (summarised, with the last step's info); with ``save`` the end state is also
    written as a pickle checkpoint (``save["pickle"]``) and with DCP
    (``save["dcp"]``)."""
    trainer = build_model_axis(kind)
    generator = torch.Generator().manual_seed(0)
    state = trainer.init_state(generator, batch_size=BATCH)
    out = {"init": summary(trainer, state)}
    for _ in range(MODEL_STEPS):
        state, info = trainer.train_step(state, generator, BATCH)
    out["steps"] = summary(trainer, state, info)
    if save:
        trainer.checkpoints_dir = save["pickle"]
        trainer.save_checkpoint(state, state.step)
        trainer.save_checkpoint_dcp(state, save["dcp"])
    return out


def task_model_axis(args):
    """``model_axis_steps`` for every kind in ``args["kinds"]`` (the first one also
    saves, if ``args["save"]``), and the collectives by (axis, kind)."""
    from fab_tpu_torch.parallel import mesh

    mesh.COUNTS.clear()
    out = {kind: model_axis_steps(kind, args.get("save") if i == 0 else None)
           for i, kind in enumerate(args["kinds"])}
    out["counts"] = {"/".join(k): v for k, v in mesh.COUNTS.items()}
    return out


def model_axis_resume(args) -> dict:
    """A realnvp ``build_model_axis`` trainer loaded from ``args["pickle"]`` (a
    ``state.pkl``) or ``args["dcp"]`` (a directory), then one step from a fixed
    generator: the summaries of the loaded state and of that step."""
    trainer = build_model_axis("realnvp")
    if "pickle" in args:
        state, step = trainer.load_state(args["pickle"])
    else:
        state, step = trainer.load_state_dcp(args["dcp"])
    loaded = summary(trainer, state)
    state, info = trainer.train_step(state, torch.Generator().manual_seed(7), BATCH)
    return {"loaded": loaded, "next": summary(trainer, state, info), "step": step}


def task_model_axis_resume(args):
    return model_axis_resume(args)


TASKS = {name[len("task_"):]: fn for name, fn in globals().items()
         if name.startswith("task_")}


def main(argv) -> int:
    task, rank, world, port, args_path, out = argv
    torch.set_num_threads(1)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    from fab_tpu_torch.parallel import distributed, mesh

    try:
        if not args.get("launcher_env"):
            distributed.initialize("cpu", init_method=f"tcp://127.0.0.1:{port}",
                                   world_size=int(world), rank=int(rank),
                                   timeout=GROUP_TIMEOUT)
            mesh.activate_mesh(mesh.make_mesh(*args.get("mesh", (None, 1))))
        result = TASKS[task](args)
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        distributed.shutdown()
    with open(out, "wb") as f:
        pickle.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
