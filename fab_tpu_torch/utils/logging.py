"""Loggers with a write/close interface (``fab_tpu/utils/logging.py``): an in-memory
dict-of-lists history (optionally pickled), an incremental CSV writer, a Weights &
Biases sink (``wandb`` is imported when one is made) and a fan-out to several
loggers. Under a process group the list and CSV loggers write on the primary rank
(rank 0) only: the others keep nothing and touch no file.
"""
from __future__ import annotations

import csv
import os
import pickle
from typing import Any, Dict, List, Mapping

from fab_tpu_torch.parallel.distributed import is_primary

LoggingData = Mapping[str, Any]


def _scalar(value):
    return float(value) if hasattr(value, "__float__") else value


class Logger:
    def write(self, data: LoggingData) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class ListLogger(Logger):
    """Dict-of-lists history, pickled every ``save_period`` writes if ``save``."""

    def __init__(self, save: bool = False, save_path: str = "logging_hist.pkl",
                 save_period: int = 100):
        self.save = save
        self.save_path = save_path
        self.save_period = save_period
        self.history: Dict[str, List[Any]] = {}
        self.iter = 0
        self.primary = is_primary()
        if save and self.primary:
            os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)

    def write(self, data: LoggingData) -> None:
        if not self.primary:
            return
        for key, value in data.items():
            self.history.setdefault(key, []).append(_scalar(value))
        self.iter += 1
        if self.save and self.iter % self.save_period == 0:
            self._dump()

    def _dump(self) -> None:
        with open(self.save_path, "wb") as f:
            pickle.dump(self.history, f)

    def close(self) -> None:
        if self.save and self.primary:
            self._dump()


class CSVLogger(Logger):
    """Incremental CSV writer. Rows may have different keys; the header is the union
    seen so far, and the file is rewritten every ``save_period`` rows and on close."""

    def __init__(self, save_path: str = "logging_hist.csv", save_period: int = 100):
        self.save_path = save_path
        self.save_period = save_period
        self.rows: List[Dict[str, Any]] = []
        self.columns: List[str] = []
        self._unflushed = 0
        self.primary = is_primary()
        if self.primary:
            os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)

    def _add_columns(self, row: Mapping[str, Any]) -> None:
        for k in row:
            if k not in self.columns:
                self.columns.append(k)

    def write(self, data: LoggingData) -> None:
        if not self.primary:
            return
        row = {k: _scalar(v) for k, v in data.items()}
        self._add_columns(row)
        self.rows.append(row)
        self._unflushed += 1
        if self._unflushed >= self.save_period:
            self._flush()

    def resume_from(self, max_step: int) -> None:
        """Reload the existing CSV, dropping rows past ``max_step`` (rows without a
        'step' value are kept), for a run resumed from a checkpoint."""
        if not self.primary or not os.path.exists(self.save_path):
            return
        with open(self.save_path) as f:
            rows = list(csv.DictReader(f))
        self.rows = [r for r in rows if not r.get("step") or float(r["step"]) <= max_step]
        for r in self.rows:
            self._add_columns(r)
        self._flush()

    def _flush(self) -> None:
        with open(self.save_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self.columns, restval="")
            writer.writeheader()
            writer.writerows(self.rows)
        self._unflushed = 0

    def close(self) -> None:
        if self.primary:
            self._flush()


class WandbLogger(Logger):
    """Weights & Biases sink; ``init_kwargs`` go to ``wandb.init``. Needs the
    ``wandb`` package, imported here, when the logger is made."""

    def __init__(self, **init_kwargs):
        import wandb

        self.run = wandb.init(**init_kwargs)
        self.iter = 0

    def write(self, data: LoggingData) -> None:
        self.run.log({k: _scalar(v) for k, v in data.items()}, step=self.iter)
        self.iter += 1

    def close(self) -> None:
        self.run.finish()


class ChainLogger(Logger):
    """Writes to, and closes, each of several loggers in turn."""

    def __init__(self, loggers: List[Logger]):
        self.loggers = loggers

    def write(self, data: LoggingData) -> None:
        for logger in self.loggers:
            logger.write(data)

    def close(self) -> None:
        for logger in self.loggers:
            logger.close()
