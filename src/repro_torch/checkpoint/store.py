"""Checkpointing with async save, retention and restore onto a device.

The reference package's on-disk format, so each package reads the other's
checkpoints: one directory per step, ``step_<n:08d>``, holding

  * ``meta.json``   — tree skeleton, per-leaf global shape/dtype, step,
                      wall-clock, user metadata;
  * ``shard_<host>.npz`` — the leaves' data, keyed by
                      ``<leaf-path>|<index window>`` (one window covering
                      the whole leaf: ``0:;0:`` for a 2-d leaf, as the
                      reference writes a single-device array).

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits under a
``BF16::``-prefixed key, and :func:`restore_onto_device` views uint16 back
as bf16 (unless ``dtypes`` names another type); :func:`restore_onto_mesh`
lays the tree out as DTensors on a mesh, each rank its own shard. Writes
are atomic (tmp dir +
rename), so a preemption mid-save never corrupts the latest complete step.
``CheckpointManager`` adds background saves, retention and draining.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# tree <-> flat path helpers (the reference's, for its paths and skeletons)
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict[str, Any], skeleton: Any, prefix: str = "") -> Any:
    if isinstance(skeleton, dict):
        return {
            k: _unflatten(flat, skeleton[k], f"{prefix}.{k}" if prefix else str(k))
            for k in skeleton
        }
    if isinstance(skeleton, (tuple, list)):
        seq = [_unflatten(flat, v, f"{prefix}[{i}]") for i, v in enumerate(skeleton)]
        return tuple(seq) if isinstance(skeleton, tuple) else seq
    return flat[prefix]


def _skeleton(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        seq = [_skeleton(v) for v in tree]
        return seq if isinstance(tree, list) else {"__tuple__": seq}
    return None


def _from_skeleton(sk: Any) -> Any:
    if isinstance(sk, dict):
        if "__tuple__" in sk and len(sk) == 1:
            return tuple(_from_skeleton(v) for v in sk["__tuple__"])
        return {k: _from_skeleton(v) for k, v in sk.items()}
    if isinstance(sk, list):
        return [_from_skeleton(v) for v in sk]
    return None


def _parse_index(key: str, shape: tuple[int, ...]) -> tuple:
    out = []
    if not key:
        return tuple(slice(0, d) for d in shape)
    for part, dim in zip(key.split(";"), shape):
        a, b = part.split(":")
        out.append(slice(int(a), int(b) if b else dim))
    return tuple(out)


def _host(leaf: Any) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array (bf16 as its uint16 bits) and its dtype name."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def snapshot(tree: Any) -> Any:
    """A copy of every tensor leaf in host memory, taken now: a tensor
    updated in place afterwards (the optimizer's next step) does not reach
    the copy."""
    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            seq = [copy(v) for v in x]
            return tuple(seq) if isinstance(x, tuple) else seq
        if torch.is_tensor(x):
            return x.detach().to("cpu", copy=True)
        return np.array(x)

    return copy(tree)


# ---------------------------------------------------------------------------
# save / load
# ---------------------------------------------------------------------------


def save_checkpoint(directory: str, step: int, tree: Any, metadata: Optional[dict] = None,
                    host_id: int = 0) -> str:
    """Write ``tree`` (params/opt-state/anything) as step-<step> atomically."""
    flat = _flatten(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=directory)
    try:
        leaves_meta = {}
        packed: dict[str, np.ndarray] = {}
        for path, leaf in flat.items():
            arr, dtype = _host(leaf)
            leaves_meta[path] = {"shape": list(arr.shape), "dtype": dtype}
            window = ";".join("0:" for _ in arr.shape)
            key = f"{path}|{window}"
            packed[("BF16::" + key) if dtype == "bfloat16" else key] = arr
        np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **packed)
        meta = {
            "step": step,
            "time": time.time(),
            "skeleton": _skeleton(tree),
            "leaves": leaves_meta,
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _assemble_global(path_meta: dict, pieces: list[tuple[tuple, np.ndarray]]):
    shape = tuple(path_meta["shape"])
    dtype = path_meta["dtype"]
    if dtype == "bfloat16":
        out = np.zeros(shape, np.uint16)
        for idx, arr in pieces:
            out[idx] = arr
        return out  # restore_onto_device views it as bf16
    out = np.zeros(shape, np.dtype(dtype))
    for idx, arr in pieces:
        out[idx] = arr
    return out


def _complete_steps(directory: str) -> list[int]:
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and os.path.exists(os.path.join(directory, d, "meta.json"))
    )


def load_checkpoint(directory: str, step: Optional[int] = None) -> tuple[int, Any, dict]:
    """Load the given (or latest complete) step as numpy global arrays."""
    if step is None:
        steps = _complete_steps(directory)
        if not steps:
            raise FileNotFoundError(f"no complete checkpoints in {directory}")
        step = steps[-1]
    ckpt = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    pieces: dict[str, list[tuple[tuple, np.ndarray]]] = {}
    for fn in os.listdir(ckpt):
        if not fn.startswith("shard_"):
            continue
        with np.load(os.path.join(ckpt, fn)) as z:
            for key in z.files:
                raw = key.removeprefix("BF16::")
                path, _, idx_key = raw.partition("|")
                shape = tuple(meta["leaves"][path]["shape"])
                pieces.setdefault(path, []).append((_parse_index(idx_key, shape), z[key]))
    flat = {path: _assemble_global(meta["leaves"][path], pieces[path])
            for path in meta["leaves"]}
    tree = _unflatten(flat, _from_skeleton(meta["skeleton"]))
    return step, tree, meta


def restore_onto_device(np_tree: Any, device=None, dtypes: Optional[dict[str, str]] = None
                        ) -> Any:
    """The loaded numpy tree as tensors on ``device`` (the card unless asked
    otherwise): the reference's ``restore_onto_mesh`` onto one device. A
    uint16 leaf is bf16 unless ``dtypes`` (by flat path) says otherwise, the
    reference's re-view rule."""
    dev = resolve_device(device)
    flat_t = _flatten(np_tree)

    def place(path):
        arr = np.asarray(flat_t[path])
        want_bf16 = dtypes and dtypes.get(path) == "bfloat16"
        if arr.dtype == np.uint16 and (want_bf16 or dtypes is None):
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(arr).to(dev)

    flat_out = {p: place(p) for p in flat_t}
    return _unflatten(flat_out, _skeleton(np_tree))


def restore_onto_mesh(np_tree: Any, shardings: Any, dtypes: Optional[dict[str, str]] = None
                      ) -> Any:
    """Elastic restore: the loaded global numpy tree as DTensors laid out by
    ``shardings`` (a tree of :class:`~repro_torch.models.base.Sharding`,
    from ``shardings_for``; its mesh may have another shape than the
    writer's). Each rank slices its own shard from the global array and
    wraps it (``DTensor.from_local``): no scatter, no collective. A leaf
    without a sharding is a plain tensor on the mesh's device; a uint16
    leaf is bf16 unless ``dtypes`` says otherwise, as in
    :func:`restore_onto_device`."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.models.base import from_local

    flat_t = _flatten(np_tree)
    flat_s = _flatten(shardings)

    def tensor(arr, path):
        want_bf16 = dtypes and dtypes.get(path) == "bfloat16"
        if arr.dtype == np.uint16 and (want_bf16 or dtypes is None):
            return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(arr)

    def own(arr):
        # a contiguous copy of its own; a 0-d leaf (a step count) stays 0-d,
        # where np.ascontiguousarray would give it one dimension
        return np.array(arr, order="C", copy=True)

    def place(path):
        arr = np.asarray(flat_t[path])
        sh = flat_s.get(path)
        if sh is None:
            dev = next(iter(flat_s.values())).mesh.device_type if flat_s else "cpu"
            return tensor(own(arr), path).to(dev)
        shape, offset = compute_local_shape_and_global_offset(arr.shape, sh.mesh, sh.placements)
        window = tuple(slice(o, o + n) for o, n in zip(offset, shape))
        local = tensor(own(arr[window] if arr.ndim else arr), path).to(sh.mesh.device_type)
        return from_local(local, sh.mesh, sh.placements, arr.shape)

    flat_out = {p: place(p) for p in flat_t}
    return _unflatten(flat_out, _skeleton(np_tree))


# ---------------------------------------------------------------------------
# manager: async save, retention, preemption draining
# ---------------------------------------------------------------------------


class CheckpointManager:
    """Background-thread checkpointer with retention + preemption support.

    ``save()`` copies every leaf to host memory before it returns (blocking:
    the train loop's optimizer updates the same tensors in place at the next
    step), then writes in a worker thread so the train loop never waits on
    disk. ``flush()`` joins outstanding writes (call on preemption signal /
    shutdown). ``last`` holds the last save's snapshot and write seconds and
    the bytes written."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self.last: dict = {}

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             blocking: bool = False) -> None:
        self.flush()  # one in-flight write at a time
        t0 = time.perf_counter()
        host_tree = snapshot(tree)
        self.last = {"step": step, "snapshot_s": time.perf_counter() - t0}

        def work():
            try:
                t1 = time.perf_counter()
                path = save_checkpoint(self.directory, step, host_tree, metadata)
                self.last["write_s"] = time.perf_counter() - t1
                self.last["bytes"] = sum(os.path.getsize(os.path.join(path, f))
                                         for f in os.listdir(path))
                self._retain()
            except BaseException as e:  # surfaced on next flush()
                self._err = e

        if blocking:
            work()
            self._raise_pending()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def flush(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def latest_step(self) -> Optional[int]:
        try:
            steps = _complete_steps(self.directory)
            return steps[-1] if steps else None
        except FileNotFoundError:
            return None

    def _retain(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
