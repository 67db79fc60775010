"""Async checkpointing with the reference's on-disk layout (port of
:mod:`repro.checkpoint.ckpt`, one device).

Layout (one directory per step):

    <dir>/step_<N>/
        manifest.json            — leaf paths, shapes, dtypes, step
        <leaf-path>.shard0.npy   — one file per leaf
        _COMMITTED               — written last; restore ignores
                                   uncommitted (crashed) checkpoints

A leaf's path joins its keys with ``/``: a dict key as it is, a
NamedTuple field as ``.<field>`` (``.params/blocks/...``,
``.opt/.mu/...``), a tuple index as its number — the names the
reference's ``tree_flatten_with_path`` gives, so each package reads the
other's checkpoints (the reference's stacked ``[L, ...]`` blocks go
through :func:`repro_torch.convert.train_state`; the port's state goes
out in the reference's layout through :func:`repro_torch.convert.
to_reference`).  bf16 is stored as its uint16 bits (``tensor.view(
torch.int16)``) with the dtype string ``"bfloat16"``; no ``ml_dtypes``.
A reference checkpoint's shards (one per leaf on one device) are
assembled by their index.

Async mode: device -> host copies happen synchronously, file writes on a
background thread; ``wait()`` joins before the next save.  Files are
written into ``step_<N>.tmp`` and renamed when committed.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"
_COMMITTED = "_COMMITTED"

# shared holder for the async writer thread (save() joins the previous
# write; wait() joins the outstanding one)
_WRITER = {"thread": None}


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every tensor or array leaf, in the reference's
    order (dict keys sorted, tuple fields in order; ``None`` has none)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [("." + f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, node in items:
        out += _leaf_paths(node, f"{prefix}/{key}" if prefix else key)
    return out


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(savable array, the reference's dtype string) of a tensor or numpy
    array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":            # an ml_dtypes array
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _from_saved(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.astype(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def save(state, step: int, directory: str, asynchronous: bool = False,
         _thread_holder: Dict = _WRITER):
    """Save a tree (NamedTuples, dicts, tuples) of tensors or arrays."""
    prev = _thread_holder.get("thread")
    if prev is not None:
        prev.join()

    stepdir = os.path.join(directory, f"step_{step:08d}")
    tmpdir = stepdir + ".tmp"
    if os.path.exists(tmpdir):
        shutil.rmtree(tmpdir)
    os.makedirs(tmpdir, exist_ok=True)

    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    writes: List[Tuple[str, np.ndarray]] = []
    for name, leaf in _leaf_paths(state):
        arr, dtype = _to_host(leaf)
        fname = f"{name.replace('/', '__')}.shard0.npy"
        manifest["leaves"][name] = {
            "shape": list(arr.shape), "dtype": dtype,
            "shards": [{"file": fname, "index": None}]}
        writes.append((os.path.join(tmpdir, fname), arr))

    def _write():
        for path, data in writes:
            np.save(path, data)
        with open(os.path.join(tmpdir, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmpdir, _COMMITTED), "w") as f:
            f.write("ok")
        if os.path.exists(stepdir):
            shutil.rmtree(stepdir)
        os.rename(tmpdir, stepdir)

    if asynchronous:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _thread_holder["thread"] = t
    else:
        _write()
        _thread_holder["thread"] = None
    return stepdir


def wait(_thread_holder: Dict = _WRITER):
    t = _thread_holder.get("thread")
    if t is not None:
        t.join()


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, _COMMITTED)):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def _assemble(entry: Dict, stepdir: str) -> torch.Tensor:
    """One leaf as a CPU tensor: a single whole shard, or the reference's
    shards placed by their index."""
    shards = entry["shards"]
    if len(shards) == 1 and shards[0]["index"] is None:
        return _from_saved(np.load(os.path.join(stepdir, shards[0]["file"])),
                           entry["dtype"])
    out = None
    for sh in shards:
        data = _from_saved(np.load(os.path.join(stepdir, sh["file"])),
                           entry["dtype"])
        if out is None:
            out = torch.zeros(tuple(entry["shape"]), dtype=data.dtype)
        idx = tuple(slice(*s) if s is not None else slice(None)
                    for s in sh["index"])
        out[idx] = data
    return out


def _stepdir(directory: str, step: Optional[int]) -> Tuple[str, int]:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    return os.path.join(directory, f"step_{step:08d}"), step


def load(directory: str, step: Optional[int] = None
         ) -> Tuple[Dict[str, Any], int]:
    """Every leaf of a checkpoint (the latest committed one by default) as
    nested dicts keyed by its path's parts, CPU tensors at the leaves —
    the form :func:`repro_torch.convert.train_state` reads a reference
    checkpoint in."""
    stepdir, step = _stepdir(directory, step)
    with open(os.path.join(stepdir, _MANIFEST)) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    for name, entry in manifest["leaves"].items():
        *parents, last = name.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = _assemble(entry, stepdir)
    return tree, step


def restore(directory: str, target, step: Optional[int] = None):
    """Restore into the structure of ``target`` (a tree of tensors, each
    leaf restored onto its target leaf's device in the saved dtype);
    returns (tree, step)."""
    stepdir, step = _stepdir(directory, step)
    with open(os.path.join(stepdir, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = iter([_assemble(manifest["leaves"][name], stepdir).to(
        leaf.device) for name, leaf in _leaf_paths(target)])

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*[rebuild(getattr(node, f))
                                for f in node._fields])
        if isinstance(node, (tuple, list)):
            return type(node)(rebuild(v) for v in node)
        return next(leaves)
    return rebuild(target), step
