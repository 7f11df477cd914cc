"""The port's public surface against fab_tpu's.

Every module of ``fab_tpu/`` is read with ``ast``. For each public function and
class, its counterpart in ``fab_tpu_torch/`` (same module path and name, or the
rename in ``MODULES`` / ``NAMES``) must exist, and so must each of its public
parameters (for a class: ``__init__``'s parameters, dataclass fields, class
attributes and public methods and properties; the port's counterpart may inherit
them or set them on ``self``). A method's own parameters are not compared: they are
JAX's explicit ``params`` and ``key`` arguments, which the parity tests of each
module hold. What has no counterpart is in ``REASONS`` with a one-line reason, and
every entry there must still be a gap.

The options filled to close gaps are then held against fab_tpu on shared numpy
inputs: the chirality masks exactly, ESS, log-probs and bijector outputs to 1e-12 in
float64, the rest exactly.
"""
import ast
import dataclasses
import importlib
import inspect
import math
import pathlib
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from fab_tpu.flows.base import Flow as JaxFlow
from fab_tpu.flows.base import UniformGaussianBase as JaxUniformGaussianBase
from fab_tpu.flows.defensive import DefensiveMixture as JaxDefensiveMixture
from fab_tpu.flows.splines import PeriodicShift as JaxPeriodicShift
from fab_tpu.native import AldpEnergyServer as JaxAldpEnergyServer
from fab_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fab_tpu.sampling import HamiltonianMonteCarlo as JaxHMC
from fab_tpu.sampling import Metropolis as JaxMetropolis
from fab_tpu.targets.aldp import IND_CIRC_DIH as JAX_IND_CIRC_DIH
from fab_tpu.targets.aldp import AldpBoltzmann as JaxAldp
from fab_tpu.targets.base import TargetDistribution as JaxTargetDistribution
from fab_tpu.train import guarded_update as jax_guarded_update
from fab_tpu.utils import aldp_eval as jax_eval
from fab_tpu.utils.numerical import effective_sample_size as jax_ess
from fab_tpu_torch.flows import make_realnvp
from fab_tpu_torch.flows.base import DiagGaussianBase, Flow, UniformGaussianBase
from fab_tpu_torch.flows.defensive import DefensiveMixture
from fab_tpu_torch.flows.snf import make_snf_model
from fab_tpu_torch.flows.splines import PeriodicShift
from fab_tpu_torch.native import AldpEnergyServer
from fab_tpu_torch.parallel import mesh as port_mesh
from fab_tpu_torch.sampling import HamiltonianMonteCarlo, Metropolis
from fab_tpu_torch.targets.aldp import AldpBoltzmann
from fab_tpu_torch.targets.base import TargetDistribution
from fab_tpu_torch.train import guarded_update, make_optimizer
from fab_tpu_torch.utils import aldp_eval
from fab_tpu_torch.utils.numerical import effective_sample_size
from torch_parity_utils import assert_close, make_flow_pair, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "fab_tpu"
DT = torch.float64
GOLDEN = pathlib.Path(__file__).parent / "data" / "aldp_openmm_min_energy_nm.npy"

# fab_tpu modules whose counterpart has another path.
MODULES = {
    "wrappers/flax_module.py": "wrappers/module.py",
    "wrappers/haiku_module.py": "wrappers/module.py",
    "wrappers/jax_dist.py": "wrappers/torch_dist.py",
}
# Public names whose counterpart has another name or module.
NAMES = {
    ("checkpoint.py", "save_checkpoint_orbax"): ("checkpoint.py", "save_checkpoint_dcp"),
    ("checkpoint.py", "load_checkpoint_orbax"): ("checkpoint.py", "load_checkpoint_dcp"),
    ("parallel/mesh.py", "shard_flow_params"): ("parallel/tensor.py", "shard_flow_params"),
    ("utils/aldp_eval.py", "make_chirality_filter_jax"):
        ("utils/aldp_eval.py", "make_chirality_filter"),
    ("wrappers/flax_module.py", "WrappedFlaxFlow"): ("wrappers/module.py", "WrappedModuleFlow"),
    ("wrappers/haiku_module.py", "WrappedHaikuFlow"):
        ("wrappers/module.py", "WrappedModuleFlow"),
    ("wrappers/jax_dist.py", "WrappedJaxDist"): ("wrappers/torch_dist.py", "WrappedTorchDist"),
}

INIT = "JAX's parameter pytree maker: the port's parameters live in the nn.Module, made when it is built"
SHARDING = ("a JAX PartitionSpec tree: the port splits a module over the model axis in place "
            "(shard_model_axis, parallel/tensor.py)")
KEY = "a JAX PRNG key: the port's counterpart takes a torch.Generator (generator)"
PARAMS = "a JAX parameter pytree: the port's parameters live in the nn.Module it is given"
PALLAS = "Pallas tiling / interpret mode: the CUDA kernels pick their own tiles"
NO_PARAMS = "a target's init / sharding hooks: the wrapped distribution holds no parameters"
TRAIN_PARAMS = ("{flow, transition}: the flow's parameters live in model.flow, the "
                "transition's state is transition_state")
# Each public parameter, field or method of fab_tpu with no counterpart, and why.
REASONS = {
    **dict.fromkeys([
        "flows/autoregressive.py:MaskedAffineAutoregressive.init",
        "flows/autoregressive.py:Permutation.init", "flows/base.py:Bijector.init",
        "flows/base.py:DiagGaussianBase.init", "flows/base.py:UniformGaussianBase.init",
        "flows/base.py:Flow.init", "flows/coupling.py:AffineCoupling.init",
        "flows/defensive.py:DefensiveMixture.init", "flows/large_coupling.py:LargeFusedCoupling.init",
        "flows/linear.py:LULinear.init", "flows/linear.py:ActNorm.init",
        "flows/resampled.py:ResampledGaussianBase.init",
        "flows/snf.py:MetropolisSamplingLayer.init", "flows/snf.py:StochasticFlow.init",
        "flows/splines.py:SplineCoupling.init", "flows/splines.py:PeriodicShift.init",
        "wrappers/flax_module.py:WrappedFlaxFlow.init",
        "wrappers/haiku_module.py:WrappedHaikuFlow.init",
    ], INIT),
    **dict.fromkeys([
        "flows/autoregressive.py:MaskedAffineAutoregressive.param_sharding",
        "flows/autoregressive.py:Permutation.param_sharding",
        "flows/base.py:Bijector.param_sharding", "flows/base.py:Flow.param_sharding",
        "flows/coupling.py:AffineCoupling.param_sharding",
        "flows/large_coupling.py:LargeFusedCoupling.param_sharding",
        "flows/linear.py:LULinear.param_sharding", "flows/linear.py:ActNorm.param_sharding",
        "flows/snf.py:MetropolisSamplingLayer.param_sharding",
        "flows/snf.py:StochasticFlow.param_sharding",
        "flows/splines.py:SplineCoupling.param_sharding",
        "flows/splines.py:PeriodicShift.param_sharding",
        "wrappers/flax_module.py:WrappedFlaxFlow.param_sharding",
        "wrappers/haiku_module.py:WrappedHaikuFlow.param_sharding",
    ], SHARDING),
    **dict.fromkeys([
        "flows/base.py:flow_log_prob(key)", "flows/factory.py:data_dependent_init(key)",
        "flows/mlp.py:mlp_init(key)", "sampling/point.py:resample(key)",
        "sampling/rejection.py:rejection_sampling(key)",
        "utils/numerical.py:mc_estimate_true_expectation(key)",
    ], KEY),
    **dict.fromkeys([
        "flows/base.py:flow_log_prob(params)", "flows/factory.py:data_dependent_init(params)",
        "flows/mlp.py:mlp_apply(params)", "parallel/mesh.py:shard_flow_params(flow_params)",
    ], PARAMS),
    **dict.fromkeys([
        "flows/fused.py:FusedRealNVPFlow.tile_b", "flows/large_coupling.py:LargeFusedCoupling.batch_tile",
        "flows/large_coupling.py:LargeFusedCoupling.interpret",
        "ops/coupling_kernel.py:fused_coupling_apply(batch_tile)",
        "ops/coupling_kernel.py:fused_coupling_apply(interpret)",
        "ops/realnvp_kernel.py:fused_realnvp_pass(tile_b)",
    ], PALLAS),
    **dict.fromkeys(["wrappers/jax_dist.py:WrappedJaxDist.init",
                     "wrappers/jax_dist.py:WrappedJaxDist.param_sharding",
                     "wrappers/torch_dist.py:WrappedTorchDist.init",
                     "wrappers/torch_dist.py:WrappedTorchDist.param_sharding"], NO_PARAMS),
    **dict.fromkeys(["train.py:TrainState.params", "train.py:BufferTrainState.params"],
                    TRAIN_PARAMS),
    "flows/mlp.py:mlp_param_sharding(model_axis)":
        "the model axis is the mesh's one model axis (parallel/tensor.py), not a named one",
    "native/__init__.py:AldpEnergyServer.energy_jax":
        "the JAX pure_callback: the port's differentiable call is AldpEnergyServer.energy",
    "parallel/distributed.py:initialize(coordinator_address)":
        "renamed init_method (a torch.distributed URL, tcp://host:port)",
    "parallel/distributed.py:initialize(num_processes)": "renamed world_size",
    "parallel/distributed.py:initialize(process_id)": "renamed rank",
    "parallel/mesh.py:data_sharding":
        "a JAX NamedSharding: a port process holds its own rows (constrain_batch)",
    "parallel/mesh.py:replicated_sharding":
        "a JAX NamedSharding: a port process holds whole replicated tensors (replicate)",
    "targets/gmm.py:GMM(expectation_key)": "renamed expectation_generator (a torch.Generator)",
    "train.py:Trainer(lr_schedule)":
        "fab_tpu takes it and discards it (train.py:188): a schedule is the optimizer's",
    "wrappers/haiku_module.py:WrappedHaikuFlow.transformed":
        "a haiku MultiTransformed: the port wraps an nn.Module (WrappedModuleFlow.module)",
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def _port_module(rel: str):
    rel = MODULES.get(rel, rel)
    name = "fab_tpu_torch." + rel[:-3].replace("/", ".")
    return importlib.import_module(name.removesuffix(".__init__"))


def _counterpart(rel: str, name: str):
    port_rel, port_name = NAMES.get((rel, name), (rel, name))
    return getattr(_port_module(port_rel), port_name, None)


def _members(cls) -> set:
    """What an instance of the port's ``cls`` offers: attributes of the class and
    its bases, their annotations, and the names their methods set on ``self``."""
    names = set(dir(cls))
    for k in inspect.getmro(cls):
        names |= set(getattr(k, "__annotations__", {}))
        if not k.__module__.startswith("fab_tpu_torch"):
            continue
        for node in ast.walk(ast.parse(textwrap.dedent(inspect.getsource(k)))):
            if (isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Store)
                    and isinstance(node.value, ast.Name) and node.value.id == "self"):
                names.add(node.attr)
    return names


def _signature_names(obj) -> set:
    try:
        return set(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return set()


def _class_gaps(key: str, node: ast.ClassDef, cls) -> list:
    members, init = _members(cls), _signature_names(cls)
    gaps = []
    for item in node.body:
        if isinstance(item, ast.FunctionDef) and item.name == "__init__":
            gaps += [f"{key}({p})" for p in _params(item) if p not in init]
        elif isinstance(item, ast.FunctionDef) and _public(item.name):
            names = [item.name]
        elif isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
            names = [item.target.id]
        elif isinstance(item, ast.Assign):
            names = [t.id for t in item.targets if isinstance(t, ast.Name)]
        else:
            continue
        if not isinstance(item, ast.FunctionDef) or item.name != "__init__":
            gaps += [f"{key}.{n}" for n in names
                     if _public(n) and n not in members and n not in init]
    return gaps


def module_gaps(rel: str) -> list:
    """The public members of fab_tpu's module ``rel`` with no counterpart."""
    gaps = []
    for node in ast.parse((JAX_ROOT / rel).read_text()).body:
        if not isinstance(node, (ast.FunctionDef, ast.ClassDef)) or not _public(node.name):
            continue
        key = f"{rel}:{node.name}"
        obj = _counterpart(rel, node.name)
        if obj is None:
            gaps.append(key)
        elif isinstance(node, ast.FunctionDef):
            names = _signature_names(obj)
            gaps += [f"{key}({p})" for p in _params(node) if p not in names]
        else:
            gaps += _class_gaps(key, node, obj)
    return gaps


JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py"))


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_module_has_a_counterpart_for_every_public_member(rel):
    missing = [g for g in module_gaps(rel) if g not in REASONS]
    assert not missing, f"no counterpart in fab_tpu_torch and no reason: {missing}"


def test_every_reason_is_for_a_gap():
    gaps = {g for rel in JAX_MODULES for g in module_gaps(rel)}
    stale = sorted(set(REASONS) - gaps)
    assert not stale, f"these have a counterpart now; drop their reasons: {stale}"
    assert all(k.split(":")[0] in JAX_MODULES for k in REASONS)


# ------------------------------------------------------------ the filled options


@pytest.mark.parametrize("with_mask", [False, True])
def test_ess_of_normalised_weights_matches_fab_tpu(with_mask):
    rng = np.random.default_rng(0)
    w = rng.random(64)
    w /= w.sum()
    mask = rng.random(64) > 0.3 if with_mask else None
    with jax.enable_x64():
        expected = float(jax_ess(jnp.asarray(w), None if mask is None else jnp.asarray(mask),
                                 normalised=True))
    actual = effective_sample_size(torch.tensor(w, dtype=DT),
                                   None if mask is None else torch.tensor(mask),
                                   normalised=True)
    assert_close(actual, expected, 1e-12)
    log_w = torch.tensor(np.log(w), dtype=DT)
    assert_close(effective_sample_size(log_w, normalised=False), effective_sample_size(log_w),
                 0.0)


CHIRALITY_OPTIONS = {
    "scale_shift": dict(scale=(0.7, 1.0), shift=(0.3, 0.0)),
    "threshold": dict(scale=(0.7, 1.0), shift=(0.3, 0.0), threshold=0.5),
    "raw": dict(raw=True),
    "raw_ind_mean_diff": dict(raw=True, ind=(40, 45), mean_diff=1.0, threshold=1.2),
    "scale_only_raw": dict(scale=(2.0, 0.5), raw=True),
}


def _dihedral_rows(n=400, seed=1):
    return np.random.default_rng(seed).uniform(-math.pi, math.pi, (n, 60))


@pytest.mark.parametrize("kw", CHIRALITY_OPTIONS.values(), ids=CHIRALITY_OPTIONS)
def test_filter_chirality_options_match_fab_tpu(kw):
    z = _dihedral_rows()
    keep = aldp_eval.filter_chirality(z, **kw)
    keep_j = jax_eval.filter_chirality(z, **kw)
    assert keep.dtype == bool and 0 < keep.sum() < len(z)
    np.testing.assert_array_equal(keep, keep_j)


@pytest.mark.parametrize("kw", CHIRALITY_OPTIONS.values(), ids=CHIRALITY_OPTIONS)
def test_make_chirality_filter_options_match_fab_tpu(kw):
    z = _dihedral_rows(seed=2)
    mask = np.random.default_rng(3).random(len(z)) > 0.2
    out = aldp_eval.make_chirality_filter(min_frac=0.05, **kw)(torch.tensor(z), torch.tensor(mask))
    with jax.enable_x64():
        out_j = jax_eval.make_chirality_filter_jax(min_frac=0.05, **kw)(jnp.asarray(z),
                                                                      jnp.asarray(mask))
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_j))


def test_chirality_filters_need_scale_and_shift_unless_raw():
    z = _dihedral_rows(8)
    for fn in (aldp_eval.filter_chirality, jax_eval.filter_chirality):
        with pytest.raises(ValueError, match="raw=True"):
            fn(z)
        with pytest.raises(ValueError, match="raw=True"):
            fn(z, scale=(1.0, 1.0))
    for fn in (aldp_eval.make_chirality_filter, jax_eval.make_chirality_filter_jax):
        with pytest.raises(ValueError, match="raw=True"):
            fn()


def test_chirality_scale_shift_at_other_dims_matches_fab_tpu():
    rng = np.random.default_rng(4)
    transform = type("T", (), {"std": rng.random(60) + 0.5, "mean": rng.standard_normal(60)})
    for ind in (aldp_eval.CHIRALITY_DIMS, (3, 17)):
        assert (aldp_eval.chirality_scale_shift(transform, ind)
                == jax_eval.chirality_scale_shift(transform, ind))


def test_uniform_gaussian_base_circular_bound_matches_fab_tpu():
    dim, circ, bound = 5, (0, 3), 2.0
    z = np.random.default_rng(5).uniform(-3.0, 3.0, (64, dim))
    base = UniformGaussianBase(dim, circ, circular_bound=bound, dtype=DT)
    with jax.enable_x64():
        base_j = JaxUniformGaussianBase(dim=dim, circular_dims=circ, circular_bound=bound)
        expected = np.asarray(base_j.log_prob({}, jnp.asarray(z)))
    actual = base.log_prob(torch.tensor(z)).numpy()
    assert np.isinf(expected).any() and np.isfinite(expected).any()
    np.testing.assert_array_equal(np.isinf(actual), np.isinf(expected))
    ok = np.isfinite(expected)
    assert_close(actual[ok], expected[ok], 1e-12)
    draws, log_q = base.sample_and_log_prob(256, torch.Generator().manual_seed(0))
    assert draws[:, list(circ)].abs().max() <= bound and torch.isfinite(log_q).all()
    assert UniformGaussianBase(dim, circ).circular_bound == JaxUniformGaussianBase(
        dim=dim, circular_dims=circ).circular_bound == math.pi


def test_periodic_shift_bound_matches_fab_tpu():
    dim, circ, bound = 6, (0, 3, 4), 1.5
    x = np.random.default_rng(6).uniform(-bound, bound, (32, dim))
    shift = PeriodicShift(dim, circ, 2.3, bound=bound)
    with jax.enable_x64():
        shift_j = JaxPeriodicShift(circular_dims=circ, shift=2.3, bound=bound)
        fwd_j = np.asarray(shift_j.forward_and_log_det({}, jnp.asarray(x))[0])
        inv_j = np.asarray(shift_j.inverse_and_log_det({}, jnp.asarray(x))[0])
    assert_close(shift.forward_and_log_det(torch.tensor(x))[0], fwd_j, 1e-12)
    assert_close(shift.inverse_and_log_det(torch.tensor(x))[0], inv_j, 1e-12)
    assert shift.bound == bound and PeriodicShift(dim, circ, 1.0).bound == math.pi


def test_flow_base_dist_defaults_to_a_diag_gaussian_as_in_fab_tpu():
    """A Flow built without a base gets a zero-initialised diagonal Gaussian, as
    fab_tpu's Flow with ``base_dist=None``; ``base_dist`` is the base."""
    dim = 4
    with jax.enable_x64():
        jax_flow, params, flow = make_flow_pair(dim, 2, 2, DT, seed=3)
        jax_flow = dataclasses.replace(jax_flow, base_dist=None)
        params = dict(params, base=jax_flow.base.init(jnp.float64))
        x = np.random.default_rng(7).standard_normal((16, dim))
        expected = np.asarray(jax_flow.log_prob(params, jnp.asarray(x)))
    bare = Flow(dim, list(flow.bijectors)).to(DT)
    assert isinstance(bare.base, DiagGaussianBase) and bare.base_dist is bare.base
    assert_close(bare.log_prob(torch.tensor(x)), expected, 1e-12)
    assert bare.event_shape == jax_flow.event_shape == (dim,)


def test_event_shapes_and_snf_layers_match_fab_tpu():
    dim = 3
    flow = make_realnvp(dim, n_flow_layers=1, layer_nodes_per_dim=2, dtype=DT, device="cpu")
    snf = make_snf_model(dim, lambda x: -(x**2).sum(-1), n_flow_layers=2,
                         layer_nodes_per_dim=2, dtype=DT, device="cpu")
    mixture = DefensiveMixture(flow)
    mixture_j = JaxDefensiveMixture(JaxFlow(dim, ()))
    assert flow.event_shape == snf.event_shape == mixture.event_shape == mixture_j.event_shape
    assert mixture.dim == mixture_j.dim == dim
    assert snf.layers is snf.bijectors
    x, _ = snf.sample_and_log_prob(8, torch.Generator().manual_seed(1))
    assert torch.equal(snf.sample(8, torch.Generator().manual_seed(1)), x)


def test_target_distribution_base_raises_as_fab_tpus():
    for target in (TargetDistribution(), JaxTargetDistribution()):
        with pytest.raises(NotImplementedError):
            target.sample(None, 4)
        with pytest.raises(NotImplementedError):
            target.performance_metrics(None, None)


def test_init_info_matches_fab_tpu():
    pairs = [(HamiltonianMonteCarlo(2, n_outer=3), JaxHMC(2, n_outer=3)),
             (Metropolis(2, n_updates=4), JaxMetropolis(2, n_updates=4))]
    for op, op_j in pairs:
        info, info_j = op.init_info(), op_j.init_info()
        assert sorted(info) == sorted(info_j) == ["avg_distance", "p_accept"]
        for k in info:
            assert info[k].dtype == torch.float32
            np.testing.assert_array_equal(info[k].numpy(), np.asarray(info_j[k]))


def test_energy_server_atoms_out_matches_fab_tpu():
    """The count needs no built library: both methods return a constant."""
    server = object.__new__(AldpEnergyServer)
    assert server.n_atoms_out() == JaxAldpEnergyServer.n_atoms_out(None) == 22


def test_aldp_ind_circ_dih_matches_fab_tpu(tmp_path):
    """A non-default set of circular dihedrals changes the transform's statistics
    and circular dims as in fab_tpu; the default is fab_tpu's."""
    path = tmp_path / "golden_angstrom.npy"
    np.save(path, np.load(GOLDEN).reshape(1, 66) * 10.0)
    ind = JAX_IND_CIRC_DIH[:5]
    with jax.enable_x64():
        target_j = JaxAldp(data_path=str(path), ind_circ_dih=ind)
    target = AldpBoltzmann(data_path=str(path), ind_circ_dih=ind, dtype=DT, device="cpu")
    default = AldpBoltzmann(data_path=str(path), dtype=DT, device="cpu")
    assert tuple(target.transform.circular_dims) == tuple(target_j.transform.circular_dims)
    assert len(target.transform.circular_dims) < len(default.transform.circular_dims)
    for name in ("mean", "std"):
        assert_close(np.asarray(getattr(target.transform, name)),
                     np.asarray(getattr(target_j.transform, name)), 1e-12, name)
    assert inspect.signature(AldpBoltzmann).parameters["ind_circ_dih"].default == \
        inspect.signature(JaxAldp).parameters["ind_circ_dih"].default


def test_guarded_update_takes_flow_params_as_fab_tpu():
    rng = np.random.default_rng(8)
    w0, g = rng.standard_normal((3, 4)), rng.standard_normal((3, 4))
    w = torch.tensor(w0)
    opt = make_optimizer(1e-2, 1.0)
    state, norm, ok = guarded_update(opt, [torch.tensor(g)], opt.init([w]), flow_params=[w],
                                     loss=torch.tensor(1.0, dtype=DT))
    with jax.enable_x64():
        from fab_tpu.train import make_optimizer as jax_make_optimizer

        opt_j = jax_make_optimizer(1e-2, 1.0)
        w_j, _, norm_j, ok_j = jax_guarded_update(
            opt_j, [jnp.asarray(g)], opt_j.init([jnp.asarray(w0)]),
            flow_params=[jnp.asarray(w0)], loss=jnp.asarray(1.0))
    assert bool(ok) and bool(ok_j)
    assert_close(w, np.asarray(w_j[0]), 1e-12)
    assert_close(norm, float(norm_j), 1e-12)
    assert isinstance(optax.global_norm([jnp.asarray(g)]), jax.Array)


def test_make_mesh_devices_as_fab_tpu():
    """Over one process, a grid of the listed devices; a list that does not fit the
    processes raises in both packages."""
    mesh_j = jax_make_mesh(devices=jax.devices()[:1])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0", world_size=1, rank=0)
    try:
        mesh = port_mesh.make_mesh(devices=[torch.device("cpu")])
        assert (mesh.n_data, mesh.n_model) == (mesh_j.shape["data"], mesh_j.shape["model"])
        with pytest.raises(ValueError, match="one process per card"):
            port_mesh.make_mesh(devices=[torch.device("cpu")] * 2)
    finally:
        dist.destroy_process_group()
    with pytest.raises(AssertionError):
        jax_make_mesh(n_data=2, devices=jax.devices()[:1])
