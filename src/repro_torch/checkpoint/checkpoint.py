"""Fault-tolerant checkpoints, in the on-disk layout of
``repro.checkpoint.checkpoint``, so a checkpoint written by either package
restores in the other.

Layout: ``<dir>/step_<n:012d>/`` holds one ``.npy`` per leaf and a
``manifest.json`` written last, ``{"step": n, "leaves": [{"key":
"state/params/...", "file": "leaf_00000.npy", "shape": [...], "dtype":
"..."}, ...]}``. Leaves are keyed by their path in the tree (dict keys,
NamedTuple field names, tuple indices, joined by "/"; None is no leaf), in
the order JAX flattens the same tree (dict keys sorted). A step is written
to a temporary directory and renamed into place, so a save cut short never
leaves a step with a manifest. bf16 leaves are stored as their raw 2-byte
words (numpy ``V2``), as numpy saves JAX's bf16 arrays.

``CheckpointManager`` adds retention (keep the last k), async saves (a host
snapshot is taken at once, written on a background thread) and resume from
the newest step that restores.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"
_BF16_WORD = np.dtype("V2")


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


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix or "leaf", tree)]
    out = []
    for k, v in items:
        out.extend(flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(tree: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by ``leaves[key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(
            _unflatten(getattr(tree, f), leaves, f"{prefix}/{f}" if prefix else f)
            for f in tree._fields
        ))
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            _unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree)
        )
    return leaves[prefix or "leaf"]


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to save, manifest dtype name) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORD), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype == _BF16_WORD or arr.dtype.name == "bfloat16":
        return arr.view(_BF16_WORD), "bfloat16"
    return arr, str(arr.dtype)


def _snapshot(tree: Any) -> List[Tuple[str, np.ndarray, str]]:
    return [(key, *_host(leaf)) for key, leaf in flatten_with_paths(tree)]


def _write(directory: str, step: int, leaves: List[Tuple[str, np.ndarray, str]]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = step_dir(directory, step)
    tmp = final + f".tmp.{os.getpid()}.{threading.get_ident()}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": [], "time": time.time()}
    for i, (key, arr, dtype) in enumerate(leaves):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype}
        )
    # the manifest is written last: its presence marks the step complete
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Atomic checkpoint write of a tree of tensors / numpy arrays. Returns
    the step's path."""
    return _write(directory, step, _snapshot(tree))


def _as_template(arr: np.ndarray, tmpl: Any) -> Any:
    if isinstance(tmpl, torch.Tensor):
        if tmpl.dtype == torch.bfloat16:
            if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vf":
                raise ValueError(f"cannot restore a {arr.dtype} leaf into bf16")
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        else:
            if arr.dtype == _BF16_WORD:
                raise ValueError(f"cannot restore a bf16 leaf into {tmpl.dtype}")
            t = torch.from_numpy(np.array(arr))
        return t.to(dtype=tmpl.dtype, device=tmpl.device)
    return arr.astype(np.asarray(tmpl).dtype)


def restore_checkpoint(
    directory: str,
    template: Any,
    step: Optional[int] = None,
    *,
    resharder: Optional[Callable[[str, np.ndarray, Any], Any]] = None,
) -> Tuple[Any, int]:
    """Restore into the structure, dtypes and devices of ``template`` (a
    tree of tensors or numpy arrays). A step that fails to restore
    (missing leaf, shape mismatch, unreadable file) is skipped for the one
    before it."""
    steps = _valid_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    if not steps:
        raise FileNotFoundError(f"no valid checkpoint in {directory}")
    flat = flatten_with_paths(template)
    last_err: Optional[BaseException] = None
    for s in reversed(steps):
        path = step_dir(directory, s)
        try:
            with open(os.path.join(path, MANIFEST)) as f:
                by_key = {m["key"]: m for m in json.load(f)["leaves"]}
            leaves = {}
            for key, tmpl in flat:
                arr = np.load(os.path.join(path, by_key[key]["file"]))
                if resharder is not None:
                    arr = resharder(key, arr, tmpl)
                if tuple(arr.shape) != tuple(tmpl.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: checkpoint {tuple(arr.shape)} vs "
                        f"template {tuple(tmpl.shape)} (pass a resharder)"
                    )
                leaves[key] = _as_template(arr, tmpl)
            return _unflatten(template, leaves), s
        except (KeyError, ValueError, OSError, json.JSONDecodeError) as e:
            last_err = e  # corrupt or incompatible: try the previous step
    raise RuntimeError(f"all checkpoints in {directory} failed to restore: {last_err}")


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, *, block: bool = False) -> None:
        """Snapshot ``tree`` to the host now; write it now (``block``) or on
        a background thread. A failed background write raises at the next
        ``save`` or ``wait``."""
        self.wait()
        snapshot = _snapshot(tree)

        def write():
            try:
                _write(self.directory, step, snapshot)
                self._gc()
            except BaseException as e:  # raised on the caller's thread at wait()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template: Any) -> Tuple[Any, int]:
        return restore_checkpoint(self.directory, template)

    def _gc(self) -> None:
        for s in _valid_steps(self.directory)[: -self.keep]:
            shutil.rmtree(step_dir(self.directory, s), ignore_errors=True)
