"""Async, atomic checkpointing of nested dicts of tensors.

  * save is ASYNC: every leaf is copied to the host at once (so training
    may update its tensors in place afterwards), then written on a
    background thread while the train loop keeps stepping;
  * atomic commit: write to `step_<n>.tmp/`, fsync, rename to `step_<n>/`
    — a crash mid-write never corrupts the latest checkpoint;
  * integrity: every leaf gets a crc32 recorded in the manifest, verified
    on restore;
  * layout: one `.npy` per leaf, keyed by its "/"-joined dict path, as
    the reference writes them, so a checkpoint of the reference's (fp32
    and integer leaves) restores here.  numpy has no bfloat16: a bf16
    leaf is stored as its uint16 bit patterns with "dtype": "bfloat16"
    in the manifest and restored bit for bit;
  * retention: keep the last `keep` checkpoints.

`restore(device=)` puts every leaf on one device, the card unless
device="cpu" is asked for; `restore(shardings=)` places them on a mesh
as DTensors, which is where elastic restarts reshard.

A tree with DTensor leaves is one state spread over the ranks of a
torch.distributed world: every rank calls save (each leaf's global value
is gathered on every rank), rank 0 alone writes the checkpoint, and the
ranks meet at a barrier once it is on disk (before a synchronous save
returns; in the next save or wait() after an asynchronous one), so that
they may share one directory.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch

from ..kernels.ops import resolve_device
from ..tree import tree_from_leaves, tree_leaves, tree_map


def _flatten(tree) -> dict:
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in tree_leaves(tree)}


def _host_copy(leaf) -> tuple[np.ndarray, str]:
    """(a host array that owns its memory, the manifest's dtype name)."""
    if not torch.is_tensor(leaf):
        arr = np.array(leaf, copy=True)
        return arr, str(arr.dtype)
    leaf = leaf.detach()
    if hasattr(leaf, "full_tensor"):        # a DTensor: its global value
        leaf = leaf.full_tensor()
    t = leaf.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _crc(arr: np.ndarray) -> int:
    """crc32 of the array's bytes in C order (the reference's)."""
    return zlib.crc32(np.ascontiguousarray(arr))


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._barrier = False        # ranks meet once the save is on disk

    # ------------------------------------------------------------------ #
    def save(self, step: int, tree, meta: dict | None = None,
             async_: bool = True):
        """Checkpoint `tree` (nested dicts of tensors or numpy arrays) as
        `step`.  The leaves are copied to the host before save returns."""
        flat = _flatten(tree)
        sharded = any(hasattr(v, "full_tensor") for v in flat.values())
        host = {k: _host_copy(v) for k, v in flat.items()}

        def write():
            tmp = self.dir / f"step_{step:010d}.tmp"
            final = self.dir / f"step_{step:010d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            manifest = {"step": step, "meta": meta or {}, "leaves": {}}
            for k, (arr, dtype) in host.items():
                fname = k.replace("/", "__") + ".npy"
                np.save(tmp / fname, arr)
                manifest["leaves"][k] = {
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "crc32": _crc(arr),
                }
            with open(tmp / "manifest.json", "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        def write_async():
            try:
                write()
            except BaseException as e:       # raised again by wait()
                self._error = e

        self.wait()
        self._barrier = sharded and _world_size() > 1
        # of a sharded tree, rank 0 writes the whole
        writes = not sharded or torch.distributed.get_rank() == 0
        if writes and async_:
            self._thread = threading.Thread(target=write_async, daemon=True)
            self._thread.start()
        elif writes:
            write_async()          # its error raised by wait(), after the
        if not async_:             # barrier
            self.wait()

    def wait(self):
        """Block until the last asynchronous save is on disk; raise what
        it raised.  After a save of DTensor leaves every rank of the
        world must call it (a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            torch.distributed.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ------------------------------------------------------------------ #
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith("step_") \
                    and not p.name.endswith(".tmp"):
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *, template=None,
                device="cuda", shardings=None, verify: bool = True):
        """Returns (tree, meta).  Leaves are tensors on `device` (the card
        unless device="cpu"; "cuda" without CUDA raises), in the dtype
        they were saved in.  With
        `template` (nested dicts of anything, of the target layout) they
        are put in that layout, and a leaf the template has and the
        checkpoint lacks raises KeyError; otherwise a flat {path: tensor}
        dict is returned.  With verify, a leaf whose crc32 differs from
        the manifest's raises IOError.  `shardings` (the template's
        layout, each leaf a (DeviceMesh, PS) pair) places every leaf on
        its mesh as a DTensor, each rank keeping its shard (`device` is
        then the mesh's)."""
        dev = resolve_device(device) if shardings is None else "cpu"
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {}
        for k, info in manifest["leaves"].items():
            arr = np.load(d / info["file"])
            if verify and _crc(arr) != info["crc32"]:
                raise IOError(f"checksum mismatch for {k} at step {step}")
            if not arr.flags.c_contiguous:
                arr = np.ascontiguousarray(arr)
            t = torch.from_numpy(arr)
            if info["dtype"] == "bfloat16":
                t = t.view(torch.int16).view(torch.bfloat16)
            flat[k] = t.to(dev)
        if template is None:
            return flat, manifest["meta"]
        paths = [path for path, _ in tree_leaves(template)]
        missing = {"/".join(map(str, p)) for p in paths} - set(flat)
        if missing:
            raise KeyError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
        tree = tree_from_leaves(
            (p, flat["/".join(map(str, p))]) for p in paths)
        if shardings is not None:
            from ..runtime.elastic import place
            tree = tree_map(lambda x, ms: place(x, *ms), tree, shardings)
        return tree, manifest["meta"]
