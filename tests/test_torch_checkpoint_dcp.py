"""The sharded checkpoint backend (``fab_tpu_torch/checkpoint.py``:
``save_checkpoint_dcp`` / ``load_checkpoint_dcp`` over ``torch.distributed.checkpoint``),
the counterpart of fab_tpu's orbax pair (``tests/test_train.py``'s
``test_orbax_checkpoint_roundtrip``), on the CPU.

- A round trip of a prioritised trainer's state in one process, exact, and the
  resumed run's next step equal to the uninterrupted run's.
- A 2-rank save (each rank writing its buffer shard) loaded by one process, and a
  one-process save loaded by 2 ranks (the buffer re-sharded): the loaded state is
  the saved one, and the DCP and pickle backends hold the same values.
"""
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from fab_tpu_torch.checkpoint import load_checkpoint_dcp, save_checkpoint_dcp


def _equal(a, b, what=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _close(a, b, tol, what=""):
    if isinstance(a, dict):
        for k in b:
            _close(a[k], b[k], tol, f"{what}.{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{what}[{i}]")
    else:
        a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
        assert (np.isfinite(a) == np.isfinite(b)).all(), what
        finite = np.isfinite(b)
        np.testing.assert_allclose(a[finite], b[finite], rtol=tol, atol=tol, err_msg=what)


def _saved(tmp_path):
    """A prioritised trainer's state after init_state and two steps, saved both ways."""
    trainer, state = workers._dcp_trainer({})
    trainer.save_checkpoint_dcp(state, str(tmp_path / "dcp"))
    trainer.checkpoints_dir = str(tmp_path / "pickle")
    trainer.save_checkpoint(state, state.step)
    return trainer, state


def test_plain_tree_round_trip(tmp_path):
    state = {"params": {"w": torch.randn(16, 4, dtype=torch.float64)},
             "buffer": torch.arange(32.0).reshape(32, 1), "step": torch.tensor(7)}
    save_checkpoint_dcp(str(tmp_path / "ckpt"), state)
    restored = load_checkpoint_dcp(str(tmp_path / "ckpt"))
    _equal({k: v for k, v in restored.items()}, state)
    target = {"params": {"w": torch.zeros(16, 4, dtype=torch.float64)},
              "buffer": torch.zeros(32, 1), "step": torch.tensor(0)}
    assert load_checkpoint_dcp(str(tmp_path / "ckpt"), target) is target
    _equal(target, state)


def test_trainer_round_trip_in_one_process(tmp_path):
    """Exact, and the resumed state's next step is the uninterrupted one's."""
    trainer, state = _saved(tmp_path)
    saved = workers.summary(trainer, state)
    after, info = trainer.train_step(state, torch.Generator().manual_seed(7), workers.BATCH)
    uninterrupted = workers.summary(trainer, after, info)

    fresh = workers.build("prioritised")
    loaded, step = fresh.load_state_dcp(str(tmp_path / "dcp"))
    assert step == 2
    _equal(workers.summary(fresh, loaded), saved)
    resumed, info = fresh.train_step(loaded, torch.Generator().manual_seed(7), workers.BATCH)
    _equal(workers.summary(fresh, resumed, info), uninterrupted)


def test_dcp_and_pickle_hold_the_same_values(tmp_path):
    trainer, state = _saved(tmp_path)
    from_dcp = workers.build("prioritised")
    from_pickle = workers.build("prioritised")
    a, _ = from_dcp.load_state_dcp(str(tmp_path / "dcp"))
    b, _ = from_pickle.load_state(str(tmp_path / "pickle" / "iter_2" / "state.pkl"))
    _equal(workers.summary(from_dcp, a), workers.summary(from_pickle, b))
    # Read whole, with no target: the buffer's slots as [L / B, B, ...] blocks.
    whole = load_checkpoint_dcp(str(tmp_path / "dcp"))
    blocks = whole["buffer_state"]
    assert tuple(blocks["x"].shape) == (8, workers.BATCH, 4)
    np.testing.assert_array_equal(blocks["log_w"].reshape(-1).numpy(),
                                  state.buffer_state.log_w.numpy())


@pytest.fixture(scope="module")
def two_rank_save(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dcp2")
    args = {"dcp": str(tmp / "dcp"), "pickle_dir": str(tmp / "pickle")}
    return tmp, workers.run_ranks("dcp_save", 2, args, str(tmp / "ranks"))


def test_two_rank_save_loads_in_one_process(two_rank_save):
    """Both ranks saved the same state (buffer gathered for the comparison); one
    process loads it whole, and it equals that state and the one-process run."""
    tmp, ranks = two_rank_save
    _equal(ranks[0], ranks[1])
    trainer = workers.build("prioritised")
    state, step = trainer.load_state_dcp(str(tmp / "dcp"))
    assert step == 2
    _equal(workers.summary(trainer, state), ranks[0])
    reference, ref_state = workers._dcp_trainer({})
    _close(ranks[0], workers.summary(reference, ref_state), 1e-8)


def test_two_rank_dcp_and_pickle_hold_the_same_values(two_rank_save):
    tmp, ranks = two_rank_save
    trainer = workers.build("prioritised")
    state, _ = trainer.load_state(str(tmp / "pickle" / "iter_2" / "state.pkl"))
    _equal(workers.summary(trainer, state), ranks[0])


def test_one_process_save_loads_on_two_ranks(tmp_path):
    """The buffer re-sharded onto 2 ranks: each holds the saved state (gathered for
    the comparison), and the next step equals one process's."""
    trainer, state = _saved(tmp_path)
    saved = workers.summary(trainer, state)
    after, info = trainer.train_step(state, torch.Generator().manual_seed(7), workers.BATCH)
    expected_next = workers.summary(trainer, after, info)
    ranks = workers.run_ranks("dcp_load", 2, {"dcp": str(tmp_path / "dcp")},
                              str(tmp_path / "ranks"))
    for result in ranks:
        assert result["step"] == 2
        _equal(result["loaded"], saved)
        _close(result["next"], expected_next, 1e-8)
