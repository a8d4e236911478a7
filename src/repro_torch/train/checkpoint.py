"""Checkpoints: one ``.npy`` per leaf under an atomically renamed step
directory (the port of ``repro.train.checkpoint``, same layout):

    <dir>/step_000000042.tmp/...   (written)
    <dir>/step_000000042/          (renamed when complete)
      MANIFEST.json                {step, keys, dtypes}
      <key with / as __>.npy       one file per leaf

Keys follow the reference's path rule (dict keys, NamedTuple fields by
name, joined by ``/``: ``params/embed/tok``, ``opt/step``,
``opt/m/...``), so each package reads the other's float32 and int32
checkpoints.  numpy has no bfloat16: a bfloat16 leaf is stored as its
uint16 bits and listed under the manifest's added ``dtypes`` key (which
the reference ignores), and restores exactly.  Saves snapshot to host
memory at once and write on a background thread; the last ``keep`` steps
stay.

A leaf stored over a mesh (:class:`~repro_torch.dist.sharding.Sharded`)
is saved whole, its blocks assembled on the host, so the files are the
same whatever the mesh; :meth:`CheckpointManager.restore` with
``shardings`` (the per-leaf specs) and ``mesh`` cuts each leaf onto that
mesh, which may have another shape than the one that saved it (the
elastic restore).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import Sharded, assemble, cut, is_spec
from repro_torch.tree import leaves_with_paths, unflatten_like


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _to_numpy(t: torch.Tensor) -> tuple:
    """(numpy array, dtype name to record or None)."""
    # a copy, never a view: the trainer updates params and moments in
    # place while a save may still be writing
    if isinstance(t, Sharded):
        t = assemble(t.map_blocks(lambda b: b.detach()), "cpu")
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _from_numpy(arr: np.ndarray, dtype: Optional[str], device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))   # 0-d stays 0-d
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, blocking: Optional[bool] = None):
        """Snapshot ``tree`` to host memory now, write it (on a thread by
        default), rename the step directory into place, drop old steps."""
        host = {_key(path): _to_numpy(leaf)
                for path, leaf in leaves_with_paths(tree)}
        self.wait()  # one save in flight at a time

        def write():
            tmp = self._step_dir(step) + ".tmp"
            final = self._step_dir(step)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            manifest = dict(step=step, keys=sorted(host),
                            dtypes={k: d for k, (_, d) in host.items() if d})
            for key, (arr, _) in host.items():
                np.save(os.path.join(tmp, key.replace("/", "__") + ".npy"),
                        arr)
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            self._gc()

        blocking = (not self.async_save) if blocking is None else blocking
        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def restore(self, step: Optional[int], tree_like: Any,
                device=None, shardings: Any = None, mesh=None) -> Any:
        """The checkpoint of ``step`` (None: the latest) in the structure
        of ``tree_like`` (its leaves may be meta tensors), each leaf a
        tensor on ``device`` (default the CPU) in the dtype it was saved
        in.  With ``shardings`` (a tree of specs parallel to
        ``tree_like``, the reference's argument) and ``mesh``, each leaf
        of a spec with entries is cut into its blocks on ``mesh``
        (a scalar stays one tensor on the mesh's first device)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        device = torch.device("cpu") if device is None else device
        values = {}
        for path, _ in leaves_with_paths(tree_like):
            key = _key(path)
            if key not in manifest["keys"]:
                raise KeyError(f"checkpoint missing {key}")
            arr = np.load(os.path.join(d, key.replace("/", "__") + ".npy"))
            values[path] = _from_numpy(arr, dtypes.get(key), device)
        if shardings is not None:
            spec_of = dict(leaves_with_paths(shardings, is_leaf=is_spec))
            for path, t in values.items():
                spec = spec_of[path]
                values[path] = (cut(t, spec, mesh) if len(spec)
                                else t.to(mesh.devices[0]))
        return unflatten_like(tree_like, values)
