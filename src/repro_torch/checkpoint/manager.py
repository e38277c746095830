"""Checkpointing with Dash-style instant recovery (paper Sec. 4.8, applied to
the trainer itself) — the port of ``repro.checkpoint.manager``, with its
commit protocol line for line and its on-disk format, so either package
restores the other's commits.

Design goals mirrored from the paper:
  * atomic commit — per-tensor files written to a staging dir, manifest last,
    then one atomic rename; a crash mid-save never corrupts the latest commit
    (the allocate-activate discipline of PMDK).
  * instant restart — ``restore_manifest`` reads ONLY the manifest (a clean
    marker + global version + tensor index): O(1) in model size. Tensor bytes
    are loaded lazily per tensor on first access via memory-mapped ``.npy``
    files.
  * clean marker + version V — a dirty restart bumps V.

Commit protocol: tensors land in a staging dir, the manifest is written
last, ONE atomic ``rename`` publishes the commit, and ``LATEST`` is
repointed with an atomic ``os.replace``. Re-saving an existing step moves
the old commit aside to ``.trash_<step>_<pid>`` first; the sweep at open
drops staging dirs and restores a moved-aside commit whose step dir is
missing. ``latest_step`` falls back to the newest ``step_*`` dir whose
manifest parses when ``LATEST`` is missing or dangling.

The format is the reference's: a tree flattens to ``/``-joined keys as
``jax.tree_util`` names them (dict keys sorted; a NamedTuple field
``.name``; a sequence index), each key a ``.npy`` file named with ``/`` ->
``__``, and the manifest ``{"step", "clean", "version", "created",
"tensors": {key: {"file", "shape", "dtype"}}}``. Tensors are copied to the
host on the caller's thread (the snapshot; its seconds are kept apart from
the write's in ``saves``) and written on a background thread unless the
save blocks. A card tensor is copied into one pinned host buffer that the
manager keeps and reuses from save to save, so a save first waits for the
previous write: at full width a pageable copy into fresh host memory took
~7 s a 14.6 GB commit. The files are written by ``WRITERS`` threads.
``restore_tree`` loads into the template's tensors in place: at full width
a second copy of the state would not fit the card.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


class LazyTensor:
    """Handle that materializes (mmap) its tensor on first access."""

    __slots__ = ("path", "_arr")

    def __init__(self, path: Path):
        self.path = path
        self._arr = None

    def get(self) -> np.ndarray:
        if self._arr is None:
            self._arr = np.load(self.path, mmap_mode="r")
        return self._arr


def _walk(tree, path, leaf):
    """``tree`` rebuilt with every leaf replaced by ``leaf(key, value)``, in
    ``jax.tree_util``'s order and names; None holds no leaf."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(tree[k], path + [str(k)], leaf) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(getattr(tree, f), path + [f".{f}"], leaf)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, path + [str(i)], leaf) for i, v in enumerate(tree))
    return leaf("/".join(path), tree)


#: threads that write a commit's files
WRITERS = 4
#: byte alignment of each tensor in the pinned snapshot buffer
_ALIGN = 64


def flatten(tree) -> dict:
    """Stable path -> leaf flattening, by the commit's keys."""
    out = {}

    def put(key, value):
        out[key] = value
    _walk(tree, [], put)
    return out


def _to_host(value) -> np.ndarray:
    """A host copy of a leaf: the training state changes in place while an
    async save writes it, so a CPU tensor or an array is copied too."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(value)


class _PinnedSnapshot:
    """One pinned host buffer holding a copy of every card tensor of a
    tree, laid out by key and reused while the keys, shapes and dtypes stay
    the same."""

    def __init__(self):
        self.layout = None
        self.buf = None

    def copy(self, leaves: dict) -> dict:
        """key -> numpy view of the buffer, filled from ``leaves`` (card
        tensors); one synchronisation at the end."""
        layout, off = {}, 0
        for k, t in leaves.items():
            layout[k] = (off, tuple(t.shape), t.dtype)
            off += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        if layout != self.layout:
            self.layout, self.buf = None, None
            self.buf = torch.empty(max(off, 1), dtype=torch.uint8, pin_memory=True)
            self.layout = layout
        out = {}
        for k, t in leaves.items():
            o, shape, dtype = layout[k]
            n = t.numel() * t.element_size()
            view = self.buf[o:o + n].view(dtype).view(shape)
            view.copy_(t.detach(), non_blocking=True)
            out[k] = view
        torch.cuda.synchronize()
        return {k: v.numpy() for k, v in out.items()}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        #: one record a save: step, bytes, host copy and write seconds
        self.saves: list = []
        #: the last ``restore_tree``: bytes and seconds
        self.last_restore: dict = {}
        self._pinned = _PinnedSnapshot()
        self._recover_crashed_saves()

    def _recover_crashed_saves(self):
        """Sweep the artifacts a crash mid-save can leave: stage dirs are
        uncommitted garbage (dropped); a ``.trash_<step>`` whose step dir is
        MISSING is the only copy of that step — the crash hit between the
        move-aside and the commit rename — and is restored."""
        for d in self.dir.iterdir():
            if not d.is_dir():
                continue
            if d.name.startswith(".stage_"):
                shutil.rmtree(d, ignore_errors=True)
            elif d.name.startswith(".trash_"):
                step = int(d.name.split("_")[1])
                final = self.dir / f"step_{step:010d}"
                if final.exists():
                    shutil.rmtree(d, ignore_errors=True)
                else:
                    d.rename(final)

    # ----- save ---------------------------------------------------------

    def save(self, step: int, tree: Any, *, clean: bool = True, version: int = 1,
             blocking: bool = True):
        """Snapshot to the host on the caller thread, serialize on a
        background thread unless blocking. The previous write lands first:
        its snapshot buffer is reused."""
        self.wait()
        t0 = time.perf_counter()
        flat = flatten(tree)
        card = {k: v for k, v in flat.items() if isinstance(v, torch.Tensor) and v.is_cuda}
        pinned = self._pinned.copy(card) if card else {}
        host = {k: pinned[k] if k in pinned else _to_host(v) for k, v in flat.items()}
        record = {"step": step, "bytes": sum(a.nbytes for a in host.values()),
                  "copy_s": time.perf_counter() - t0}
        self.saves.append(record)

        def work():
            t1 = time.perf_counter()
            self._write_commit(step, host, clean, version)
            record["write_s"] = time.perf_counter() - t1

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def save_sharded(self, step: int, state, layout, mesh, *, clean: bool = True,
                     version: int = 1):
        """Commit a state sharded on ``mesh`` in the reference's format:
        full leaves, written once. Collective over the mesh: every leaf of
        the masters, ``m`` and ``v`` is all-gathered (``layout``: the
        state's placements, ``train.steps.mesh_layout``) and copied to the
        host, the mesh's first rank writes the commit (blocking), and every
        rank returns once it is published."""
        from repro_torch.parallel.collectives import all_reduce_, group_for
        from repro_torch.parallel.sharding import tree_map
        from repro_torch.train.steps import gather_tree
        ranks = torch.as_tensor(mesh.mesh).flatten().tolist()
        writer = torch.distributed.get_rank() == ranks[0]

        def full(tree):
            out = gather_tree(tree, layout, mesh)
            return tree_map(lambda t: t.detach().cpu().numpy(), out) if writer else None
        params, m, v = full(state.params), full(state.opt.m), full(state.opt.v)
        if writer:
            host = type(state)(params=params,
                               opt=type(state.opt)(m, v, state.opt.count.cpu().numpy()),
                               step=state.step.cpu().numpy())
            self.save(step, host, clean=clean, version=version, blocking=True)
        # the commit is published before any rank returns: reading the
        # reduced flag back waits for every rank's arrival (a NCCL
        # collective returns to the host before it has run)
        float(all_reduce_(torch.zeros(1, device=state.step.device),
                          group_for(mesh, tuple(mesh.mesh_dim_names)))[0])

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write_commit(self, step: int, host: dict, clean: bool, version: int):
        stage = self.dir / f".stage_{step}_{os.getpid()}"
        if stage.exists():
            shutil.rmtree(stage)
        stage.mkdir(parents=True)
        index = {k: {"file": k.replace("/", "__") + ".npy", "shape": list(arr.shape),
                     "dtype": str(arr.dtype)} for k, arr in host.items()}
        with ThreadPoolExecutor(WRITERS) as pool:
            list(pool.map(lambda k: np.save(stage / index[k]["file"], host[k]), host))
        manifest = {"step": step, "clean": clean, "version": version,
                    "created": time.time(), "tensors": index}
        (stage / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:010d}"
        trash = None
        if final.exists():
            # re-saving an existing step: move the old commit aside instead
            # of deleting it — a crash between rmtree and rename must not
            # lose the only copy of the step
            trash = self.dir / f".trash_{step}_{os.getpid()}"
            if trash.exists():
                shutil.rmtree(trash)
            final.rename(trash)
        stage.rename(final)                                   # atomic commit
        (self.dir / "LATEST.tmp").write_text(final.name)
        os.replace(self.dir / "LATEST.tmp", self.dir / "LATEST")
        if trash is not None:
            shutil.rmtree(trash, ignore_errors=True)
        self._gc()

    def _gc(self):
        commits = sorted(d for d in self.dir.iterdir()
                         if d.is_dir() and d.name.startswith("step_"))
        for d in commits[:-self.keep]:
            shutil.rmtree(d, ignore_errors=True)

    # ----- restore ------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """Newest committed step. LATEST is the fast path; when it is
        missing or dangling (crash between the commit rename and the
        ``os.replace``), fall back to the newest ``step_*`` directory whose
        manifest parses — a committed rename IS a valid commit even if the
        pointer write was lost."""
        latest = self.dir / "LATEST"
        if latest.exists():
            name = latest.read_text().strip()
            if (self.dir / name / "manifest.json").exists():
                return int(name.split("_")[-1])
        best = None
        for d in sorted(self.dir.iterdir(), reverse=True):
            if not (d.is_dir() and d.name.startswith("step_")):
                continue
            try:
                json.loads((d / "manifest.json").read_text())
            except (OSError, ValueError):
                continue
            best = int(d.name.split("_")[-1])
            break
        return best

    def restore_manifest(self):
        """INSTANT restore: read manifest only, bump version if dirty.
        Returns (manifest, lazy_tensors, restore_seconds)."""
        t0 = time.perf_counter()
        step = self.latest_step()
        if step is None:
            return None, None, time.perf_counter() - t0
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        if not manifest["clean"]:
            manifest["version"] += 1      # the paper's V bump on dirty restart
        lazy = {k: LazyTensor(d / v["file"]) for k, v in manifest["tensors"].items()}
        return manifest, lazy, time.perf_counter() - t0

    def restore_tree(self, template: Any, lazy: dict):
        """Materialize the full tree (the eager path of the trainer's
        restart). Each tensor leaf of ``template`` is loaded in place from its
        mmap'd file (shape and dtype must match), and a template of tensors
        only comes back as itself; any other leaf becomes the loaded array in
        a rebuilt tree."""
        t0 = time.perf_counter()
        seen = {"bytes": 0, "arrays": 0, "cuda": False}

        @torch.no_grad()
        def load(key, leaf):
            arr = lazy[key].get()
            seen["bytes"] += arr.nbytes
            if not isinstance(leaf, torch.Tensor):
                seen["arrays"] += 1
                return np.asarray(arr)
            src = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            if tuple(arr.shape) != tuple(leaf.shape) or src != leaf.dtype:
                raise ValueError(f"{key}: the commit holds {arr.dtype}{list(arr.shape)} for "
                                 f"{leaf.dtype}{list(leaf.shape)}")
            with warnings.catch_warnings():          # a read-only map, only read
                warnings.simplefilter("ignore", UserWarning)
                leaf.copy_(torch.from_numpy(arr))
            seen["cuda"] |= leaf.is_cuda
            return leaf

        tree = _walk(template, [], load)
        if seen["cuda"]:
            torch.cuda.synchronize()
        self.last_restore = {"bytes": seen["bytes"], "seconds": time.perf_counter() - t0}
        return tree if seen["arrays"] else template

    def mark_dirty(self, step: int):
        """Flip the latest commit's clean marker (called when training starts
        — mirrors 'set clean=false and start handling requests')."""
        s = self.latest_step()
        if s is None:
            return
        d = self.dir / f"step_{s:010d}"
        m = json.loads((d / "manifest.json").read_text())
        m["clean"] = False
        (d / "manifest.json").write_text(json.dumps(m))
