"""Config loading, dotted overrides, precision, checkpoint-directory resolution and
dataset iteration (``fab_tpu/utils/training.py``).

The configs are the repository's YAML files. PyYAML is not among the packages the
card machine has, so ``read_yaml`` is the port's own reader of the subset the configs
use: block maps nested by indentation, plain and quoted scalars, and comments. Plain
scalars resolve as ``yaml.safe_load`` (YAML 1.1) resolves them: ``null``/``~``, the
1.1 booleans, ints with ``_`` separators, and floats only with a dot or as
``.inf``/``.nan`` (so ``1e-4`` stays the string ``"1e-4"``, which callers cast with
``float()``, and ``1.e+8`` and ``5.e-4`` are floats). Anything else (sequences, flow
collections, anchors, block scalars, tabs) raises.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch


class ConfigDict(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def from_nested(cls, data: Dict) -> "ConfigDict":
        out = cls()
        for k, v in data.items():
            out[k] = cls.from_nested(v) if isinstance(v, dict) else v
        return out


# YAML 1.1 plain-scalar resolution (PyYAML's resolver.py).
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$"
)
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
        |[-+]?0[0-7_]+
        |[-+]?(?:0|[1-9][0-9_]*)
        |[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    re.X,
)


def _sexagesimal(digits: str) -> float:
    value = 0.0
    for part in digits.split(":"):
        value = value * 60 + float(part)
    return value


def _to_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text.startswith("-") else 1
    text = text.lstrip("+-")
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text.startswith("0"):
        return sign * int(text, 8)
    if ":" in text:
        return sign * int(_sexagesimal(text))
    return sign * int(text)


def _to_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text.startswith("-") else 1.0
    text = text.lstrip("+-")
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text)
    return sign * float(text)


def resolve_scalar(text: str) -> Any:
    """A plain scalar's value under YAML 1.1 (as ``yaml.safe_load`` reads it)."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _INT.match(text):
        return _to_int(text)
    if _FLOAT.match(text):
        return _to_float(text)
    return text


def _value(text: str, where: str) -> Any:
    """A scalar after ``key:`` (its comment already removed)."""
    if text[:1] in ("'", '"'):
        quote = text[0]
        if len(text) < 2 or text[-1] != quote:
            raise ValueError(f"{where}: unsupported quoted scalar {text!r}")
        body = text[1:-1]
        return body.replace("''", "'") if quote == "'" else body.encode().decode("unicode_escape")
    if text[:1] in "[{&*!|>%@`" or text == "-" or text.startswith("- "):
        raise ValueError(f"{where}: unsupported YAML construct {text!r}")
    return resolve_scalar(text)


def _strip_comment(line: str) -> str:
    """The line without a comment: ``#`` at the start or after a space, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(text: str, name: str = "<yaml>") -> Any:
    """Parse the block-map YAML of the repository's configs (see the module
    docstring); returns nested dicts, or None for an empty document."""
    lines: List[Tuple[int, int, str]] = []
    for number, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError(f"{name}:{number}: tab indentation")
        body = _strip_comment(raw).rstrip()
        if body.strip() in ("", "---"):
            continue
        lines.append((number, len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None

    def block(i: int, indent: int) -> Tuple[Dict[str, Any], int]:
        out: Dict[str, Any] = {}
        while i < len(lines):
            number, col, body = lines[i]
            if col < indent:
                break
            where = f"{name}:{number}"
            if col > indent:
                raise ValueError(f"{where}: unexpected indentation")
            key, sep, rest = body.partition(":")
            if not sep or (rest and not rest.startswith(" ")):
                raise ValueError(f"{where}: expected 'key: value', got {body!r}")
            key = key.strip()
            if key[:1] in ("'", '"', "-", "?", "[", "{"):
                raise ValueError(f"{where}: unsupported key {key!r}")
            rest = rest.strip()
            i += 1
            if rest:
                out[key] = _value(rest, where)
            elif i < len(lines) and lines[i][1] > indent:
                out[key], i = block(i, lines[i][1])
            else:
                out[key] = None
        return out, i

    tree, end = block(0, lines[0][1])
    if end != len(lines):
        raise ValueError(f"{name}:{lines[end][0]}: unexpected indentation")
    return tree


def load_config(path: str) -> ConfigDict:
    """Load a YAML config file into a ConfigDict."""
    with open(path) as f:
        return ConfigDict.from_nested(read_yaml(f.read(), path) or {})


def apply_overrides(cfg: ConfigDict, overrides) -> ConfigDict:
    """Apply dotted-path overrides such as ``training.seed=1``; each value is read as
    a YAML scalar (``null``, ``true``, ``3``, ``1e-4`` ...)."""
    for override in overrides or []:
        path, value = override.split("=", 1)
        node = cfg
        *parents, leaf = path.split(".")
        for p in parents:
            node = node[p]
        node[leaf] = _value(value.strip(), f"override {override!r}")
    return cfg


def maybe_enable_x64(cfg: ConfigDict) -> torch.dtype:
    """The compute dtype the config asks for: float64 if ``training.use_64_bit``,
    else float32. Nothing global is switched: callers build their targets, flows and
    trainers in this dtype."""
    if cfg.get("training") and cfg.training.get("use_64_bit"):
        return torch.float64
    return torch.float32


def get_latest_checkpoint_dir(base_dir: str) -> Optional[str]:
    """The newest run directory (by modification time) under ``base_dir`` that holds a
    ``model_checkpoints/iter_*`` entry, else the newest run directory, else None."""
    if not os.path.isdir(base_dir):
        return None
    subdirs = sorted(
        (
            os.path.join(base_dir, d)
            for d in os.listdir(base_dir)
            if os.path.isdir(os.path.join(base_dir, d))
        ),
        key=os.path.getmtime,
    )
    with_ckpt = [
        d for d in subdirs if glob.glob(os.path.join(d, "model_checkpoints", "iter_*"))
    ]
    if with_ckpt:
        return with_ckpt[-1]
    return subdirs[-1] if subdirs else None


class DatasetIterator:
    """Batched iteration over a fixed test set."""

    def __init__(self, batch_size: int, dataset):
        self.dataset = dataset
        self.batch_size = min(batch_size, dataset.shape[0])
        self.test_set_n_points = dataset.shape[0]

    def __iter__(self) -> Iterator:
        for start in range(0, self.test_set_n_points, self.batch_size):
            yield self.dataset[start : start + self.batch_size]
