"""Model/optimizer checkpointing: flat-key npz store with step metadata
(counterpart of ``repro.ckpt.store``; the files are the same).

A tree (nested dicts, lists and tuples of tensors, as in
:mod:`repro_torch.optim.adamw`) is flattened with the reference's
path-derived keys (``trunk/0/w``, ``opt/mu/embed/table``...), so a
checkpoint either package writes in one process restores in the other,
key for key and value for value.  Files, per step: ``ckpt_XXXXXXXX.params.npz``,
``.opt.npz``, ``.meta.json``, ``.plan.json`` (the
:class:`~repro_torch.exec.plan.ExecutionPlan` that ran) and the directory's
``latest.json``.

A leaf split over a mesh (a ``torch.distributed`` ``DTensor`` with a
``Shard`` placement) is saved **per shard**, never whole: its distinct
slices land as ``<key>::shard<j>`` entries, ordered by offset and written
once however many data replicas hold them, with the offsets under the meta
file's ``shard_layout``.  In a process group every rank calls
:func:`save`; the shards reach rank 0 one leaf at a time and rank 0 writes
the files.  A replicated ``DTensor`` is saved once, as a plain leaf.

:func:`restore` rebuilds the template's tree and places each leaf where
the template's leaf lives: on its device and in its dtype, and for a
``DTensor`` template as this rank's slice under the template's mesh and
placements (a checkpoint written under one mesh restores under another,
or on one device).  A Python ``int`` leaf (AdamW's ``step``) restores as
an ``int``.  bfloat16 leaves are written as float32 (numpy has no
bfloat16) and cast back on restore, which loses nothing.  The reference
writes a bfloat16 leaf as it is, which numpy stores as the opaque 2-byte
``|V2``; such an array is read as its ``uint16`` bits and viewed as
``torch.bfloat16`` (:func:`_from_numpy`), so it restores bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _flatten_with_keys(tree, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's leaf order (dict keys
    sorted); ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_keys(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in _flatten_with_keys(t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its leaves replaced, in order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, leaves) for t in tree)
    return next(leaves)


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def _is_split(leaf) -> bool:
    from torch.distributed.tensor import Shard
    return _is_dtensor(leaf) and any(isinstance(p, Shard)
                                     for p in leaf.placements)


def _shard_index(leaf) -> List[List[int]]:
    """``[[start, stop], ...]`` per dim of this rank's slice of ``leaf``."""
    from repro_torch.launch.sharding import local_bounds
    return local_bounds(leaf.shape, leaf.device_mesh, leaf.placements)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, dict]]:
    """``(arrays, layout)`` on rank 0 (``({}, {})`` elsewhere): flat-key
    arrays ready for npz, and the shard layout of every split leaf."""
    import torch.distributed as dist
    arrays: Dict[str, np.ndarray] = {}
    layout: Dict[str, dict] = {}
    root = _rank() == 0
    for key, leaf in _flatten_with_keys(tree):
        if not _is_split(leaf):
            if root:
                arrays[key] = _to_numpy(
                    leaf.to_local() if _is_dtensor(leaf) else leaf)
            continue
        mine = (_shard_index(leaf), _to_numpy(leaf.to_local()))
        shards = [None] * dist.get_world_size() if root else None
        dist.gather_object(mine, shards, dst=0)
        if not root:
            continue
        unique = {}
        for idx, data in shards:
            unique.setdefault(tuple(map(tuple, idx)), data)
        indices = sorted(unique)
        for j, idx in enumerate(indices):
            arrays[f"{key}::shard{j}"] = unique[idx]
        layout[key] = {"shape": list(leaf.shape),
                       "indices": [list(map(list, i)) for i in indices]}
    return arrays, layout


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def save(directory: str, step: int, params: Any,
         opt_state: Optional[Any] = None, extra: Optional[dict] = None,
         plan=None) -> str:
    """Write step ``step``'s params (and optimizer state, metadata
    ``extra`` and ``plan``) into ``directory``; returns the path prefix.
    In a process group every rank calls it."""
    path = os.path.join(directory, f"ckpt_{step:08d}")
    root = _rank() == 0
    if root:
        os.makedirs(directory, exist_ok=True)
    shard_layout: Dict[str, dict] = {}
    for kind, tree in (("params", params), ("opt", opt_state)):
        if tree is None:
            continue
        arrays, layout = _flatten(tree)
        if root:
            np.savez(f"{path}.{kind}.npz", **arrays)
        if layout:
            shard_layout[kind] = layout
    if root:
        meta = {"step": step, **(extra or {})}
        if shard_layout:
            meta["shard_layout"] = shard_layout
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
        if plan is not None:
            with open(path + ".plan.json", "w") as f:
                f.write(plan.to_json())
        with open(os.path.join(directory, "latest.json"), "w") as f:
            json.dump({"step": step}, f)
    _barrier()  # every rank sees the files once save returns
    return path


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "latest.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)["step"]


def _resolve_step(directory: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    return step


def _assemble(data, key: str, layout: dict) -> np.ndarray:
    """Reassemble one split leaf from its ``key::shard<j>`` pieces, in the
    shards' dtype (``|V2`` for the reference's bfloat16 shards: the bytes
    are copied as they are)."""
    spec = layout[key]
    out = np.empty(spec["shape"], dtype=data[f"{key}::shard0"].dtype)
    for j, idx in enumerate(spec["indices"]):
        out[tuple(slice(a, b) for a, b in idx)] = data[f"{key}::shard{j}"]
    return out


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """``arr`` as a CPU tensor; a ``|V2`` array (a bfloat16 leaf the
    reference wrote, which numpy cannot name) as ``torch.bfloat16``, bit
    for bit: its ``uint16`` bits, reinterpreted."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        bits = arr.view(np.uint16).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _place(arr: np.ndarray, leaf, key: str):
    """``arr`` where the template ``leaf`` lives."""
    if isinstance(leaf, (int, float)):
        return type(leaf)(_from_numpy(arr).item())
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"{key}: checkpoint shape {arr.shape}, template "
                         f"{tuple(leaf.shape)}")
    t = _from_numpy(arr)
    if _is_dtensor(leaf):
        from torch.distributed.tensor import DTensor
        bounds = _shard_index(leaf)
        local = t[tuple(slice(a, b) for a, b in bounds)]
        local = local.to(device=leaf.to_local().device, dtype=leaf.dtype)
        return DTensor.from_local(local.contiguous(), leaf.device_mesh,
                                  leaf.placements, run_check=False,
                                  shape=leaf.shape, stride=leaf.stride())
    device = torch.device("cpu") if leaf.device.type == "meta" \
        else leaf.device
    return t.to(device=device, dtype=leaf.dtype)


def restore(directory: str, template: Any, step: Optional[int] = None,
            kind: str = "params"):
    """The tree saved under ``kind`` at ``step`` (default: the latest),
    with ``template``'s structure, each leaf placed where the template's
    lives (see the module docstring).  A leaf saved per shard is
    reassembled from its pieces."""
    step = _resolve_step(directory, step)
    with np.load(os.path.join(directory,
                              f"ckpt_{step:08d}.{kind}.npz")) as data:
        layout = restore_meta(directory, step).get("shard_layout", {}) \
            .get(kind, {})
        out = []
        for key, leaf in _flatten_with_keys(template):
            arr = np.asarray(data[key]) if key in data.files \
                else _assemble(data, key, layout)
            out.append(_place(arr, leaf, key))
    return _rebuild(template, iter(out))


def restore_meta(directory: str, step: Optional[int] = None) -> dict:
    step = _resolve_step(directory, step)
    with open(os.path.join(directory, f"ckpt_{step:08d}.meta.json")) as f:
        return json.load(f)


def restore_plan(directory: str, step: Optional[int] = None):
    """The :class:`~repro_torch.exec.plan.ExecutionPlan` saved next to the
    arrays (a reference plan loads with its names mapped), or ``None`` for
    a checkpoint written without one."""
    from repro_torch.exec.plan import ExecutionPlan
    step = _resolve_step(directory, step)
    p = os.path.join(directory, f"ckpt_{step:08d}.plan.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return ExecutionPlan.from_json(f.read())
