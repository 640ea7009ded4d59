"""Small host utilities: the run directory and the config JSON beside it.

The port's copy of what the CLIs need from the JAX package's
``utils/util.py``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict


def mkdir_if_not_exist(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def save_dic_to_json(dic: Dict[str, Any], path: str) -> None:
    """Write the run's config as JSON (the reference dumps its parsed args
    into the run directory)."""
    with open(path, "w") as f:
        json.dump(dic, f, indent=2, sort_keys=True, default=str)
