"""Atomic, resumable checkpoints of the port's training state: the JAX
package's ``repro.checkpoint.checkpointer`` over tensors.

Layout (one directory a step):

    ckpt_dir/step_000000123/
        manifest.json     # keys, shapes, dtypes, each file's sha256, extra
        data_00000.npz    # the leaves (files of at most 2 GiB)

A tree is nested dicts of tensors (or numpy arrays); a leaf's key is its
path joined by "/" -- for a train state the port's parameter and state
names, e.g. ``params/blocks.0.mlp.wi``, ``opt/m/embed``, ``opt/step``.

* Atomic: a step is written to ``.tmp-step_X`` and published by one
  ``os.rename``, so a crash never leaves a readable half-written step.
* Integrity: :func:`latest_valid` skips any step whose files do not hash
  to the manifest's sha256 (a torn write).
* Async: :func:`save_async` copies the tree to host memory first (so
  training may write the live tensors at once) and writes in a thread.
* bfloat16 leaves are stored as their uint16 bits, the manifest keeping
  the dtype.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
import re
import shutil

import numpy as np
import torch

__all__ = ["save", "save_async", "latest_valid", "restore",
           "corrupt_for_test"]

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _leaves(tree, path=()):
    """(key, leaf) of every leaf of nested dicts, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield "/".join(path), tree


def _storable(x) -> tuple[np.ndarray, str]:
    """(numpy array to store, logical dtype name) of a leaf."""
    if torch.is_tensor(x):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    a = np.asarray(x)
    return a, a.dtype.name


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None,
         max_bytes_per_file: int = 2 << 30) -> str:
    """Synchronous atomic save of ``tree`` as step ``step``.  Returns the
    published directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:09d}"
    tmp = os.path.join(ckpt_dir, f".tmp-{name}")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    files, keys, cur, cur_bytes = [], {}, {}, 0

    def flush():
        nonlocal cur, cur_bytes
        if cur:
            fname = f"data_{len(files):05d}.npz"
            np.savez(os.path.join(tmp, fname), **cur)
            files.append(fname)
            cur, cur_bytes = {}, 0

    for key, leaf in _leaves(tree):
        a, dtype = _storable(leaf)
        if cur and cur_bytes + a.nbytes > max_bytes_per_file:
            flush()
        cur[key.replace("/", "__")] = a
        keys[key] = {"file": f"data_{len(files):05d}.npz",
                     "shape": list(a.shape), "dtype": dtype}
        cur_bytes += a.nbytes
    flush()
    manifest = {"format": 1, "step": step, "extra": extra or {},
                "keys": keys,
                "hashes": {f: _sha256(os.path.join(tmp, f)) for f in files}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _snapshot(tree):
    """A host copy of every leaf (tensors stay tensors, on the CPU)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


def save_async(ckpt_dir: str, step: int, tree, extra: dict | None = None):
    """Copy ``tree`` to host memory now, write it in a worker thread.
    Returns the future (its result the published directory)."""
    snap = _snapshot(tree)
    pool = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
    try:
        return pool.submit(save, ckpt_dir, step, snap, extra)
    finally:
        pool.shutdown(wait=False)       # the thread ends with the write


def _is_valid(step_dir: str) -> bool:
    try:
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
        return all(_sha256(os.path.join(step_dir, fname)) == want
                   for fname, want in manifest["hashes"].items())
    except (OSError, ValueError, KeyError):
        return False


def latest_valid(ckpt_dir: str) -> str | None:
    """The newest step directory whose files pass their hashes (corrupt
    ones skipped), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    for d in sorted((d for d in os.listdir(ckpt_dir) if _STEP_RE.match(d)),
                    reverse=True):
        full = os.path.join(ckpt_dir, d)
        if _is_valid(full):
            return full
    return None


def restore(step_dir: str, like_tree):
    """Load a step into the structure of ``like_tree``: a tensor leaf is
    overwritten in place (same shape and dtype required, so a captured
    train step keeps its addresses), any other leaf is replaced by the
    stored numpy array.  Returns (tree, extra, step)."""
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    files: dict = {}

    def stored(key):
        rec = manifest["keys"][key]
        if rec["file"] not in files:
            with np.load(os.path.join(step_dir, rec["file"])) as z:
                files[rec["file"]] = dict(z)
        a = files[rec["file"]][key.replace("/", "__")]
        return a, rec["dtype"]

    def fill(tree, path=()):
        if isinstance(tree, dict):
            return {k: fill(v, path + (str(k),)) for k, v in tree.items()}
        key = "/".join(path)
        a, dtype = stored(key)
        if not torch.is_tensor(tree):
            return a
        if list(a.shape) != list(tree.shape):
            raise ValueError(f"{key}: stored shape {list(a.shape)}, "
                             f"state {list(tree.shape)}")
        if dtype == "bfloat16":
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        if t.dtype != tree.dtype:
            raise ValueError(f"{key}: stored {dtype}, state {tree.dtype}")
        with torch.no_grad():
            tree.copy_(t)
        return tree

    return fill(like_tree), manifest["extra"], manifest["step"]


def corrupt_for_test(step_dir: str):
    """Flip a byte of the first data file (for the fault-tolerance
    tests)."""
    for f in sorted(os.listdir(step_dir)):
        if f.startswith("data_"):
            with open(os.path.join(step_dir, f), "r+b") as fh:
                fh.seek(10)
                b = fh.read(1)
                fh.seek(10)
                fh.write(bytes([b[0] ^ 0xFF]))
            return
