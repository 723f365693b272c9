"""Sharded, atomic, async checkpointing: the port of
``repro.checkpoint.manager``, with the same on-disk layout and manifest.

Layout (one directory per step)::

    <root>/step_000123.tmp-<nonce>/   # written here first
        manifest.json                  # pytree paths, shapes, dtypes, meta
        shard_000.npz ... shard_NNN.npz
    <root>/step_000123/               # atomic os.replace on completion

Properties:
  * **atomic**: readers only ever see complete checkpoints (rename barrier);
    a crash mid-write leaves a ``.tmp-*`` directory that is skipped and
    removed after an hour.
  * **sharded**: leaves are packed into ~``shard_mb`` NPZ shards; each leaf
    records its shard and key in the manifest.
  * **async**: ``save`` copies the state to host memory and returns; a
    writer thread drains a queue; ``wait()`` joins outstanding writes.
  * **self-describing**: the manifest stores each leaf's key path (JAX's
    ``keystr``), so a restore checks structure and shapes and reports the
    differences.

A state is any pytree of tensors (``repro_torch.train.tree``). A
``TrainState`` is written as its ``to_tree()``, in the reference's layout,
so a checkpoint the reference wrote of a model's ``TrainState`` restores
into the port's, and the other way round. Leaves go through numpy. A
bfloat16 leaf, a dtype numpy lacks, is written as the reference's npz
holds one, its 2-byte bits as ``|V2`` records with manifest dtype
``"bfloat16"``, and read back through an int16 view.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import re
import shutil
import threading
import time
import uuid
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train.tree import flatten_with_paths, unflatten

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _as_tree(state):
    return state.to_tree() if hasattr(state, "to_tree") else state


def _host_copy(x) -> tuple[np.ndarray, str]:
    """(the leaf as a host array, its manifest dtype)."""
    if isinstance(x, torch.Tensor):
        host = x.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:  # numpy has no bfloat16: its bits, as |V2
            return host.view(torch.int16).numpy().view("V2"), "bfloat16"
        arr = host.numpy()
    else:
        arr = np.array(x)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


@dataclasses.dataclass
class CheckpointManager:
    root: str
    keep: int = 3
    shard_mb: int = 128
    async_writes: bool = True

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._errors: list = []
        self._thread: Optional[threading.Thread] = None
        if self.async_writes:
            self._thread = threading.Thread(target=self._writer_loop, daemon=True)
            self._thread.start()

    # ----------------------------- write path -----------------------------

    def save(self, step: int, state: Any, meta: Optional[dict] = None) -> None:
        """Snapshot to host memory now; write (possibly async) afterwards."""
        paths, _ = flatten_with_paths(_as_tree(state))
        host = [(k, *_host_copy(v)) for k, v in paths]
        if self.async_writes:
            self._q.put((step, host, meta or {}))
        else:
            self._write(step, host, meta or {})

    def wait(self) -> None:
        if self.async_writes:
            self._q.join()
        if self._errors:
            raise RuntimeError(f"checkpoint writer failed: {self._errors[0]}")

    def _writer_loop(self):
        while True:
            item = self._q.get()
            try:
                self._write(*item)
            except Exception as e:  # surfaced by wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _write(self, step: int, host_leaves, meta: dict) -> None:
        final = os.path.join(self.root, f"step_{step:09d}")
        tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        limit = self.shard_mb * (1 << 20)
        shards: list[dict] = []
        cur: dict = {}
        cur_bytes = 0
        manifest_leaves = []
        for i, (key, arr, dtype) in enumerate(host_leaves):
            name = f"leaf_{i:05d}"
            if cur_bytes + arr.nbytes > limit and cur:
                shards.append(cur)
                cur, cur_bytes = {}, 0
            cur[name] = arr
            cur_bytes += arr.nbytes
            manifest_leaves.append(
                {
                    "path": key,
                    "shard": len(shards),
                    "name": name,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                }
            )
        if cur:
            shards.append(cur)
        for si, shard in enumerate(shards):
            np.savez(os.path.join(tmp, f"shard_{si:03d}.npz"), **shard)
        manifest = {"step": step, "leaves": manifest_leaves, "meta": meta}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
        self._gc()

    def _gc(self) -> None:
        steps = self.available_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.root, f"step_{s:09d}"), ignore_errors=True)
        # remove stale tmp dirs from crashed writers
        for d in os.listdir(self.root):
            if ".tmp-" in d:
                full = os.path.join(self.root, d)
                try:
                    if os.path.getmtime(full) < time.time() - 3600:
                        shutil.rmtree(full, ignore_errors=True)
                except OSError:
                    pass

    # ----------------------------- read path ------------------------------

    def available_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.root, d, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(
        self,
        abstract_state: Any,
        step: Optional[int] = None,
        *,
        device=None,
    ) -> tuple[Any, dict]:
        """Restore into the structure of ``abstract_state`` (tensors of any
        device, ``meta`` included: only shapes and dtypes are read; a
        ``TrainState`` with a module is rebuilt by its ``from_tree``).
        Leaves are placed on ``device`` (``cuda`` unless ``"cpu"``), the
        counterpart of the reference's ``shardings``. Returns (state,
        manifest meta)."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        paths, treedef = flatten_with_paths(_as_tree(abstract_state))
        want = [k for k, _ in paths]
        have = {l["path"]: l for l in manifest["leaves"]}
        missing = [k for k in want if k not in have]
        extra = [k for k in have if k not in want]
        if missing or extra:
            raise ValueError(
                f"checkpoint structure mismatch: missing={missing[:5]} extra={extra[:5]}"
            )
        cache: dict[int, Any] = {}

        def shard_file(si: int):
            if si not in cache:
                cache[si] = np.load(os.path.join(d, f"shard_{si:03d}.npz"))
            return cache[si]

        restored = []
        try:
            for k, ref in paths:
                entry = have[k]
                arr = shard_file(entry["shard"])[entry["name"]]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(f"shape mismatch at {k}: {arr.shape} vs {tuple(ref.shape)}")
                tensor = _from_host(arr)
                if tensor.dtype != ref.dtype:
                    tensor = tensor.to(ref.dtype)
                restored.append(tensor.to(dev))
        finally:
            for npz in cache.values():
                npz.close()
        state = unflatten(treedef, restored)
        if hasattr(abstract_state, "from_tree"):
            state = abstract_state.from_tree(state)
        return state, manifest["meta"]

    # --------------------------- trainer hook ------------------------------

    def every_n_steps_hook(self, n: int, meta: Optional[dict] = None):
        def hook(step: int, state, metrics):
            if (step + 1) % n == 0:
                self.save(step + 1, state, {**(meta or {}), "metrics": metrics})

        return hook
