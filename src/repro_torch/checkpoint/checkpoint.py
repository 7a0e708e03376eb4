"""What serving reads of a trainer checkpoint.

Layout (written by ``repro.checkpoint.checkpoint.save_checkpoint``):
``<dir>/step_<n:012d>/`` holds one ``.npy`` per leaf and a ``manifest.json``
written last, ``{"step": n, "leaves": [{"key": "state/params/...", "file":
"leaf_00000.npy", "shape": [...], "dtype": "..."}, ...]}``. A step directory
without a manifest is incomplete and is skipped.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional

MANIFEST = "manifest.json"


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:012d}")


def _valid_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, MANIFEST)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """The newest step with a complete manifest, or None."""
    steps = _valid_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> Dict[str, Any]:
    with open(os.path.join(step_dir(directory, step), MANIFEST)) as f:
        return json.load(f)
