"""Async checkpointing with the reference's on-disk layout (port of
:mod:`repro.checkpoint.ckpt`).

Layout (one directory per step):

    <dir>/step_<N>/
        manifest.json            — leaf paths, shapes, dtypes, step, and
                                   each shard's file and global index
        <leaf-path>.shard<i>.npy — one file per leaf on one device; under a
                                   mesh one per block (``i`` the rank that
                                   wrote it; one rank of each replicated
                                   block writes)
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
A reference checkpoint's shards are placed by their index, whatever mesh
wrote them.

Async mode: device -> host copies happen synchronously, file writes on a
background thread; ``wait()`` joins before the next save.  Files are
written into ``step_<N>.tmp`` and renamed when committed.  Under a mesh
(``ctx`` and the leaves' ``specs``) every rank writes its blocks, and rank
0 commits after a barrier: the save is synchronous.  :func:`restore` with
a ``ctx`` reads only the rank's block of each leaf, from any mesh's
shards (elastic re-placement, :mod:`repro_torch.checkpoint.elastic`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import sharding

_MANIFEST = "manifest.json"
_COMMITTED = "_COMMITTED"

# shared holder for the async writer thread (save() joins the previous
# write; wait() joins the outstanding one)
_WRITER = {"thread": None}


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _leaf_paths(tree, prefix: str = "", specs=None) -> List[Tuple[str, Any]]:
    """(path, leaf) of every tensor or array leaf, in the reference's
    order (dict keys sorted, tuple fields in order; ``None`` has none);
    with ``specs`` (a tree like ``tree`` with a spec tuple at each leaf)
    (path, leaf, spec)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k], None if specs is None else specs[k])
                 for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [("." + f, getattr(tree, f),
                  None if specs is None else getattr(specs, f))
                 for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v, None if specs is None else specs[i])
                 for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)] if specs is None else \
            [(prefix, tree, specs)]
    out = []
    for key, node, spec in items:
        out += _leaf_paths(node, f"{prefix}/{key}" if prefix else key, spec)
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
         _thread_holder: Dict = _WRITER, ctx=None, specs=None):
    """Save a tree (NamedTuples, dicts, tuples) of tensors or arrays; under
    a mesh each rank's blocks (``specs``: a tree like ``state`` of the
    leaves' specs)."""
    prev = _thread_holder.get("thread")
    if prev is not None:
        prev.join()
    if sharding.active(ctx):
        return _save_sharded(state, step, directory, ctx, specs)

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


def _save_sharded(state, step: int, directory: str, ctx, specs) -> str:
    """Every rank writes the blocks it is the first replica of; rank 0
    writes the manifest of all of them and commits after a barrier."""
    mesh = ctx.mesh
    world = mesh.group(mesh.axis_names).group
    stepdir = os.path.join(directory, f"step_{step:08d}")
    tmpdir = stepdir + ".tmp"
    if mesh.rank == 0:
        if os.path.exists(tmpdir):
            shutil.rmtree(tmpdir)
        os.makedirs(tmpdir, exist_ok=True)
    torch.distributed.barrier(group=world)

    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    for name, leaf, spec in _leaf_paths(state, specs=specs):
        arr, dtype = _to_host(leaf)
        axes = sharding.sharded_axes(spec)
        shape = [n * (ctx.size_of(spec[i]) if i < len(spec)
                      and spec[i] is not None else 1)
                 for i, n in enumerate(arr.shape)]
        entry = {"shape": shape, "dtype": dtype, "shards": []}
        for r in range(mesh.size):
            c = mesh.coords(r)
            if any(c[a] for a in mesh.axis_names if a not in axes):
                continue                    # another replica writes it
            blk = sharding.block(tuple(shape), spec, ctx, r)
            index = [None if i >= len(spec) or spec[i] is None
                     else [b.start, b.stop] for i, b in enumerate(blk)]
            fname = f"{name.replace('/', '__')}.shard{r}.npy"
            entry["shards"].append({"file": fname, "index": index})
            if r == mesh.rank:
                np.save(os.path.join(tmpdir, fname), arr)
        manifest["leaves"][name] = entry
    torch.distributed.barrier(group=world)
    if mesh.rank == 0:
        with open(os.path.join(tmpdir, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmpdir, _COMMITTED), "w") as f:
            f.write("ok")
        if os.path.exists(stepdir):
            shutil.rmtree(stepdir)
        os.rename(tmpdir, stepdir)
    torch.distributed.barrier(group=world)
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


def _assemble(entry: Dict, stepdir: str, region=None) -> torch.Tensor:
    """One leaf (or its ``region``, a slice of each dimension) as a CPU
    tensor, from its shards placed by their index; only the parts of the
    shards that overlap the region are read."""
    shape = tuple(entry["shape"])
    region = tuple(slice(None) for _ in shape) if region is None else region
    want = [r.indices(n)[:2] for r, n in zip(region, shape)]
    out = None
    for sh in entry["shards"]:
        index = sh["index"] if sh["index"] is not None else \
            [None] * len(shape)
        have = [(0, n) if ix is None else tuple(ix)
                for ix, n in zip(index, shape)]
        lo = [max(w[0], h[0]) for w, h in zip(want, have)]
        hi = [min(w[1], h[1]) for w, h in zip(want, have)]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        data = np.load(os.path.join(stepdir, sh["file"]), mmap_mode="r")
        if out is None:
            out = np.zeros([w[1] - w[0] for w in want], dtype=data.dtype)
        out[tuple(slice(a - w[0], b - w[0])
                  for a, b, w in zip(lo, hi, want))] = \
            data[tuple(slice(a - h[0], b - h[0])
                       for a, b, h in zip(lo, hi, have))]
    return _from_saved(out, entry["dtype"])


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


def restore(directory: str, target, step: Optional[int] = None, ctx=None,
            specs=None, device=None):
    """Restore into the structure of ``target`` (a tree of tensors, each
    leaf restored onto its target leaf's device, or ``device``, in the
    saved dtype); under a mesh (``ctx`` and ``specs``, a tree like
    ``target`` of the leaves' specs) each leaf's block of this rank, read
    from whatever mesh's shards; returns (tree, step)."""
    stepdir, step = _stepdir(directory, step)
    with open(os.path.join(stepdir, _MANIFEST)) as f:
        manifest = json.load(f)

    def read(name, leaf, spec=None):
        entry = manifest["leaves"][name]
        region = None if spec is None else \
            sharding.block(tuple(entry["shape"]), spec, ctx)
        return _assemble(entry, stepdir, region).to(
            leaf.device if device is None else device)
    if sharding.active(ctx):
        leaves = iter([read(*x) for x in _leaf_paths(target, specs=specs)])
    else:
        leaves = iter([read(*x) for x in _leaf_paths(target)])

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
