"""JSON files that keep measurements across processes: the autotuner's
geometries (`ops/sort/autotune.py`) and the stream ceiling
(`bench/roofline.py`), each keyed by device name and shape."""

from __future__ import annotations

import json
import os


def load(path: str) -> dict:
    """The cached dict, or {} when the file does not exist."""
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}


def save(path: str, d: dict) -> None:
    """Write `d` to `path` through a temporary file and a rename, so a
    reader never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(d, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
