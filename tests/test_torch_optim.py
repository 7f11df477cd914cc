"""Parity of the port's LR schedules, Adamax and scheduled Adam with fab_tpu's
``make_optimizer`` (optax) on the CPU, in float64.

- Every schedule (constant, cosine, cosine restarts, exponential; with and without a
  linear warm-up) per update count against the optax schedule fab_tpu builds, read
  off the update optax makes from a unit gradient: 1e-12.
- Adamax and scheduled Adam updates over 10 steps on shared gradients (clipping on):
  parameters and moments, 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fab_tpu.train import make_optimizer as jax_make_optimizer
from fab_tpu_torch.train import LRSchedule, make_optimizer

TOTAL, WARMUP = 40, 6
SCHEDULES = [
    (None, 0), (None, WARMUP), ("cosine", 0), ("cosine", WARMUP),
    ("cosine_restart", 0), ("cosine_restart", WARMUP), ("exponential", 0),
    ("exponential", WARMUP),
]


def _kw(schedule, warmup, **extra):
    return dict(schedule=schedule, total_steps=TOTAL, warmup_steps=warmup,
                decay_rate=0.05, **extra)


def _optax_lrs(schedule, warmup, n, **extra):
    """The LR of each of n updates of fab_tpu's optimizer, read off the update
    optax makes from a constant unit gradient (Adam's direction is then 1 / (1 +
    eps) at every step)."""
    with jax.enable_x64():
        opt = jax_make_optimizer(0.3, None, **_kw(schedule, warmup, **extra))
        params = {"w": jnp.ones((1,), jnp.float64)}
        state = opt.init(params)
        lrs = []
        for _ in range(n):
            updates, state = opt.update({"w": jnp.ones((1,), jnp.float64)}, state, params)
            # Adam's direction for a constant gradient is 1 / (1 + eps).
            lrs.append(-float(updates["w"][0]) * (1 + 1e-8))
    return np.array(lrs)


@pytest.mark.parametrize("schedule,warmup", SCHEDULES,
                         ids=[f"{s}-warmup{w}" for s, w in SCHEDULES])
def test_lr_per_update_matches_optax(schedule, warmup):
    n = TOTAL + 8  # past the end of the schedule
    expected = _optax_lrs(schedule, warmup, n)
    port = make_optimizer(0.3, None, **_kw(schedule, warmup))
    counts = torch.arange(n, dtype=torch.int32)
    got = np.array([float(port.learning_rate(c)) for c in counts])
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12)
    if warmup:
        assert got[0] == 0.0  # optax reads the count before its increment


def test_restart_period_and_schedule_values():
    """An explicit restart period, and a few values against optax's own schedule
    functions (join_schedules shifts each piece's count by its boundary)."""
    n = TOTAL + 3
    expected = _optax_lrs("cosine_restart", 0, n, restart_period=7)
    port = make_optimizer(0.3, None, **_kw("cosine_restart", 0, restart_period=7))
    got = np.array([float(port.learning_rate(torch.tensor(c))) for c in range(n)])
    np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12)
    with jax.enable_x64():
        warm = optax.join_schedules(
            [optax.linear_schedule(0.0, 0.3, WARMUP),
             optax.cosine_decay_schedule(0.3, TOTAL - WARMUP, alpha=0.05)], [WARMUP])
        sched = LRSchedule(0.3, "cosine", TOTAL, WARMUP, 0.05)
        for c in (0, 1, WARMUP - 1, WARMUP, WARMUP + 1, TOTAL - 1, TOTAL, TOTAL + 5):
            expected = float(warm(jnp.asarray(c, jnp.int32)))  # optax counts in int32
            assert abs(float(sched(torch.tensor(c))) - expected) < 1e-12, c


def test_bad_schedule_and_optimizer_raise():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(1e-3, optimizer="sgd")
    with pytest.raises(ValueError, match="unknown schedule"):
        make_optimizer(1e-3, schedule="nonsense", total_steps=10)
    with pytest.raises(ValueError, match="total_steps"):
        make_optimizer(1e-3, schedule="cosine")


@pytest.mark.parametrize("optimizer,schedule,warmup", [
    ("adamax", None, 0), ("adamax", "cosine", 3), ("adam", "cosine", 3),
    ("adam", "exponential", 0), ("adamax", "cosine_restart", 2),
])
def test_updates_over_ten_steps_match_optax(optimizer, schedule, warmup):
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (4,), (2,)]
    params = [rng.standard_normal(s) for s in shapes]
    grads = [[rng.standard_normal(s) * (1 + 5 * (t % 3)) for s in shapes] for t in range(10)]
    kw = dict(optimizer=optimizer, schedule=schedule, total_steps=12, warmup_steps=warmup,
              decay_rate=0.1)
    with jax.enable_x64():
        opt_j = jax_make_optimizer(0.05, 4.0, **kw)
        p_j = [jnp.asarray(p) for p in params]
        state_j = opt_j.init(p_j)
        for g in grads:
            updates, state_j = opt_j.update([jnp.asarray(x) for x in g], state_j, p_j)
            p_j = optax.apply_updates(p_j, updates)
        adam_j = state_j[1][0]
    opt = make_optimizer(0.05, 4.0, **kw)
    p = [torch.tensor(x) for x in params]
    state = opt.init(p)
    for g in grads:
        updates, state = opt.update([torch.tensor(x) for x in g], state)
        p = [a + u for a, u in zip(p, updates)]
    assert int(state.count) == int(adam_j.count) == 10
    for a, b in zip(p, p_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)
    for a, b in zip(state.mu + state.nu, list(adam_j.mu) + list(adam_j.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-10)
