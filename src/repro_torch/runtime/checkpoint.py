"""Fault-tolerant checkpointing: atomic, async.

Port of ``repro/runtime/checkpoint.py`` with its on-disk format, so a
checkpoint written by either package loads in the other: one
``arrays.npz`` of flattened key/value arrays and a JSON manifest (step,
keys, dtypes, tree structure, time, meta) in a ``step_<10 digits>``
directory, written to a temporary directory that is atomically renamed (a
crash mid-write never corrupts the latest checkpoint). A key is the leaf's
path as the reference's ``jax.tree_util.tree_flatten_with_path`` spells it
for the same tree (``[0]/['blocks']/['attn']/['wq']/['w']``, ``[1]/.step``):
dicts in sorted key order, a NamedTuple's fields as ``.name``, tuple and
list items as ``[i]``, ``None`` an empty subtree. bf16 is stored as its
``uint16`` view with ``bfloat16`` named under ``dtypes``, as the reference
stores ml_dtypes' bf16; the manifest's ``treedef`` follows the reference's
``PyTreeDef`` string. ``AsyncCheckpointer`` copies the tree to the host
and serializes it on a worker thread while the next step runs.

DTensor leaves (a state laid out over a device mesh, launch/train.py's
``mesh=``) are gathered whole (``full_tensor``, a collective every rank
joins) and written by rank 0 alone, in the same format, so a checkpoint
saved over 4 ranks loads over 2, or into the reference.
``load(..., shardings=...)`` is the reference's reshard-on-load: each
leaf is read whole on every rank and laid out by the NamedSharding at its
place (parallel/sharding.py) on that sharding's mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(path entry, child) pairs of a node, as jax spells the entries;
    None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    if tree is None:
        return []
    return None


def _flatten(tree) -> Dict[str, Any]:
    flat: Dict[str, Any] = {}

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            flat["/".join(path)] = node
            return
        for entry, child in kids:
            walk(child, path + (entry,))

    walk(tree, ())
    return flat


def _rebuild(like, leaves: Dict[str, Any], path=()):
    """A tree of ``like``'s structure with the leaf at each key from
    ``leaves``."""
    kids = _children(like)
    if kids is None:
        return leaves["/".join(path)]
    built = [_rebuild(c, leaves, path + (e,)) for e, c in kids]
    if isinstance(like, dict):
        return {k: v for k, v in zip(sorted(like), built)}
    if _is_namedtuple(like):
        return type(like)(*built)
    if isinstance(like, (tuple, list)):
        return type(like)(built)
    return None


def _treedef(tree) -> str:
    """The reference's ``str(jax.tree_util.tree_structure(tree))``."""
    def node(t) -> str:
        kids = _children(t)
        if kids is None:
            return "*"
        if t is None:
            return "None"
        parts = [node(c) for _, c in kids]
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {p}" for k, p in
                                   zip(sorted(t), parts)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(parts) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"

    return f"PyTreeDef({node(tree)})"


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's full value (gathered over its mesh); a tensor as it
    is."""
    from repro_torch.parallel.act_sharding import is_dtensor
    return t.full_tensor() if is_dtensor(t) else t


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of a running
    process group, or a process without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """(array npz can hold, the true dtype's name when it is a view: bf16,
    which numpy lacks, as its uint16 bits)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf), None
    t = _whole(leaf.detach()).cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _host(tree):
    """A copy of ``tree`` with every tensor on the host."""
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            return _whole(tree.detach()).to("cpu", copy=True)
        return tree
    leaves = {k: _host(v) for k, v in _flatten(tree).items()}
    return _rebuild(tree, leaves)


def save(ckpt_dir: str | Path, step: int, tree, *, meta: Optional[dict] = None,
         keep: int = 3) -> Path:
    """Atomic synchronous save. Returns the checkpoint path. Every rank
    of a process group calls it (DTensor leaves are gathered); rank 0
    writes."""
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:010d}"
    if not _writer():
        for leaf in _flatten(tree).values():
            if isinstance(leaf, torch.Tensor):
                _whole(leaf)
        return final
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        arrays, dtypes = {}, {}
        for k, leaf in _flatten(tree).items():
            arrays[k], name = _to_numpy(leaf)
            if name is not None:
                dtypes[k] = name
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "dtypes": dtypes,
            "treedef": _treedef(tree),
            "time": time.time(),
            "meta": meta or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: Path, keep: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(ckpt_dir.glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _from_numpy(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name is None:
        return torch.from_numpy(arr)
    if dtype_name != "bfloat16":
        raise TypeError(f"checkpoint dtype {dtype_name!r} is not one the "
                        f"port stores")
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


def load(ckpt_dir: str | Path, tree_like, *, step: Optional[int] = None,
         shardings=None):
    """Restore into the structure of ``tree_like`` -> (tree, manifest);
    each leaf lands on the device of the tensor it replaces (the host for
    any other leaf), or, where ``shardings`` (a tree of ``tree_like``'s
    structure) holds a NamedSharding, is laid out by it as a DTensor."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        assert step is not None, f"no checkpoints in {ckpt_dir}"
    path = ckpt_dir / f"step_{step:010d}"
    manifest = json.loads((path / "manifest.json").read_text())
    data = np.load(path / "arrays.npz")

    flat_like = _flatten(tree_like)
    assert set(flat_like.keys()) == set(manifest["keys"]), (
        "checkpoint/tree structure mismatch")
    flat_sh = _flatten(shardings) if shardings is not None else {}
    dtypes = manifest.get("dtypes", {})
    leaves = {}
    for key, like in flat_like.items():
        t = _from_numpy(data[key], dtypes.get(key))
        sh = flat_sh.get(key)
        if sh is not None:
            leaves[key] = _distribute(t, sh)
            continue
        device = like.device if isinstance(like, torch.Tensor) else "cpu"
        leaves[key] = t.to(device)
    return _rebuild(tree_like, leaves), manifest


def _distribute(t: torch.Tensor, sharding):
    """A whole leaf as a DTensor laid out by ``sharding`` on its mesh's
    device (every rank holds the whole leaf, so no rank sends)."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    if mesh.device_type == "cuda":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    return distribute_tensor(t, mesh, sharding.placements,
                             src_data_rank=None)


class AsyncCheckpointer:
    """Background-thread checkpoint writer (single in-flight save).

    ``save`` copies the tensors to the host synchronously (cheap against a
    step; DTensor leaves gathered, every rank joining) and serializes on
    the worker thread (rank 0's); ``wait`` joins before exit
    or the next save. A failure in the worker is raised by the next call.
    """

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, meta: Optional[dict] = None):
        self.wait()
        host_tree = _host(tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, meta=meta,
                     keep=self.keep)
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
