"""Durable, crash-atomic, device-portable checkpointing, as
``apex_tpu/resilience/durable.py``.

A checkpoint written with one ``torch.save`` is a pickle that a
preemption mid-write leaves unreadable, silently.  This manager makes the
failure modes explicit:

- **crash-atomic commit**: a snapshot is staged in a ``.tmp-*`` sibling
  directory, every file is fsync'd, the manifest is written last, the
  directory fsync'd, then renamed into place and the parent directory
  fsync'd.  A crash at any point leaves the previous snapshots untouched
  or an ignorable tmp dir, never a half-checkpoint that parses.
- **per-leaf checksums**: the manifest records a sha256 per leaf file;
  :meth:`DurableCheckpointManager.restore` verifies every one and skips a
  corrupted or truncated snapshot for the newest older one that verifies
  (what was skipped, and why, is kept on ``last_restore``).
- **async save off the step path**: :meth:`DurableCheckpointManager.save`
  copies every leaf to the host on the calling thread, before it
  returns: the next step updates the masters, the moments and the step
  counts in place (K11) and writes the gradient buffers (K6), so a copy
  left to the writer thread would serialize a state the next step is
  already changing.  The card's leaves go into one pinned host buffer
  (asynchronous copies, one wait).  Serialization, fsync and retention
  run on a writer thread, which writes each leaf's npy header and then
  its data straight from the host copy while one more thread hashes the
  leaves, then flushes the files on a pool of threads (hashing and file
  IO release the interpreter lock, so the training thread keeps queueing
  steps); ``wait()`` re-raises a background failure.
- **device-portable**: leaves are stored as full host arrays, and on
  restore each goes to the device and dtype of its template tensor, in
  place: a snapshot saved on the card restores bit for bit into a CPU
  template, and the other way round.

The on-disk format is the JAX package's, so a snapshot written by either
package verifies and reads in the other: leaves are named by their tree
path in ``jax.tree_util.keystr``'s spelling (``['opt_state'].m['w']``;
dict keys sorted, the canonical flatten order), saved as
``leaf_%05d.npy`` with ``allow_pickle=False``; the manifest records each
leaf's sha256, shape, dtype and byte count.  bf16 has no numpy dtype: a
bf16 leaf is stored as the JAX package stores one, its 2-byte words in a
``V2`` npy array under the manifest dtype ``"bfloat16"``, and read back
into bf16 tensors bit for bit.

Layout::

    dir/
      step_00000012/
        manifest.json      # {"format":1,"step":12,"leaves":{keystr: {...}}}
        leaf_00000.npy ...
      step_00000009/ ...
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import queue
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

# torch is imported inside the functions that take tensors: verifying
# and digesting snapshots (the fleet's supervisors) needs only numpy

MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"
FORMAT = 1
#: the manifest's dtype of a bf16 leaf (numpy spells it as ``V2``)
BF16 = "bfloat16"
#: threads hashing a snapshot's leaves while they are read back (a
#: restore: the training thread waits for it); a commit hashes on one
#: thread beside the writer, so that the training thread, which keeps
#: queueing steps, meets fewer threads at the interpreter lock
HASH_THREADS = 4
#: threads flushing a commit's leaf files to disk, after all are written
FSYNC_THREADS = 8


def _step_dirname(step: int) -> str:
    return f"{_STEP_PREFIX}{int(step):08d}"


def _fsync_dir(path: str) -> None:
    _fsync_file(path)


# -- trees ------------------------------------------------------------------

def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves_with_path(tree: Any, prefix: str = ""
                          ) -> Iterator[Tuple[str, Any]]:
    """``(keystr, leaf)`` of a nested dict / list / tuple / NamedTuple
    tree in the JAX package's flatten order and spelling: dict keys
    sorted, ``['key']`` for a dict entry, ``[i]`` for a sequence item,
    ``.field`` for a NamedTuple field; ``None`` holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from tree_leaves_with_path(v, f"{prefix}.{name}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any,
                       prefix: str = "") -> Any:
    """``tree`` with every leaf replaced by ``fn(keystr, leaf)``, visited
    in :func:`tree_leaves_with_path`'s order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}[{k!r}]")
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, f"{prefix}.{name}")
                            for name, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def pinned_views(specs: List[Tuple[Tuple[int, ...], "torch.dtype"]]
                 ) -> List["torch.Tensor"]:
    """One CPU tensor per ``(shape, dtype)``, each a view of one pinned
    host buffer (64-byte aligned offsets): the staging area of the copies
    between the card and the host, which run at the link's rate only
    from pinned memory."""
    import torch
    sizes = [int(np.prod(shape, dtype=np.int64))
             * torch.empty((), dtype=dt).element_size()
             for shape, dt in specs]
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // 64) * 64
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    return [buf[o:o + n].view(dt).view(shape)
            for (shape, dt), o, n in zip(specs, offsets, sizes)]


def host_copies(leaves: List[Any]) -> List[Any]:
    """Host copies of ``leaves``, complete when this returns: a card
    tensor becomes a view of one pinned buffer (the copies queued
    together on the current stream, then one wait), a CPU tensor a clone
    (a later in-place step must not reach it), anything else a numpy
    array."""
    import torch
    out: List[Any] = [None] * len(leaves)
    on_card = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            on_card.append(i)
        elif isinstance(leaf, torch.Tensor):
            out[i] = leaf.detach().clone()
        else:
            out[i] = np.array(leaf)
    if on_card:
        views = pinned_views([(tuple(leaves[i].shape), leaves[i].dtype)
                              for i in on_card])
        for i, v in zip(on_card, views):
            v.copy_(leaves[i].detach(), non_blocking=True)
            out[i] = v
        for dev in {leaves[i].device for i in on_card}:
            torch.cuda.current_stream(dev).synchronize()
    return out


def host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """``(numpy array, manifest dtype)`` of a host leaf; bf16 as its
    2-byte words (``V2``) under ``"bfloat16"``."""
    import torch
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(
                np.dtype("V2")), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def as_tensor(value: Any, dtype: Optional[str] = None) -> "torch.Tensor":
    """A CPU tensor of a stored leaf: a ``V2`` array (or one whose
    manifest dtype is ``"bfloat16"``) is read back as bf16 bit for bit;
    a tensor passes through."""
    import torch
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.kind == "V" or dtype == BF16:
        if arr.dtype.itemsize != 2:
            raise TypeError(f"cannot read a {arr.dtype} leaf as bf16")
        return torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _flatten_payload(payload: Any) -> List[Tuple[str, np.ndarray, str]]:
    """Nested payload -> ``[(keystr, host array, manifest dtype)]`` in
    canonical flatten order."""
    return [(key,) + host_array(leaf)
            for key, leaf in tree_leaves_with_path(payload)]


def _npy_parts(arr: np.ndarray) -> Tuple[bytes, memoryview]:
    """The bytes ``np.save(f, arr, allow_pickle=False)`` writes (for
    bf16's ``V2`` words, those it writes for an ml_dtypes ``bfloat16``
    array), as the header and a view of the array's own data (no
    copy)."""
    if arr.dtype.hasobject:
        raise ValueError("an object array needs pickle, which snapshots "
                         "do not allow")
    if not arr.flags["C_CONTIGUOUS"]:
        arr = arr.copy(order="C")   # (ascontiguousarray makes 0-d 1-d)
    header = np.lib.format.header_data_from_array_1_0(arr)
    if arr.dtype == np.dtype("V2"):
        # bf16's words: the descr numpy writes for the JAX package's
        # bfloat16 leaf, so that both packages write the same bytes
        header["descr"] = "<V2"
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(head, header)
    return head.getvalue(), memoryview(arr.reshape(-1).view(np.uint8))


def _write_file(path: str, *parts) -> None:
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        for part in parts:
            view = memoryview(part)
            while view:
                view = view[os.write(fd, view):]
    finally:
        os.close(fd)


def _fsync_file(path: str) -> None:
    """Flush a written file's data to disk (fsync applies to the file,
    whichever descriptor asks)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _sha256(*parts) -> str:
    h = hashlib.sha256()
    for part in parts:
        h.update(part)
    return h.hexdigest()


def _parse_npy(raw: bytes) -> np.ndarray:
    """The array of an npy file's bytes, a read-only view of ``raw`` (no
    copy); ``ValueError`` when it does not parse or holds objects."""
    f = io.BytesIO(raw)
    version = np.lib.format.read_magic(f)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read(f)
    if dtype.hasobject:
        raise ValueError("the leaf holds objects (pickle)")
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.frombuffer(raw, dtype=dtype, count=count, offset=f.tell())
    return arr.reshape(shape, order="F" if fortran else "C")


# -- snapshots --------------------------------------------------------------

def write_snapshot(directory: str, step: int, payload: Any,
                   fsync: bool = True) -> str:
    """Stage and atomically commit one snapshot; returns its path.

    A re-save of an existing step never deletes the old snapshot before
    the new one is committed: the old directory is renamed to an
    ``.old-*`` sibling, the new one renamed into place, and only then is
    the aside copy dropped.  A crash in any window leaves a good copy of
    the step, under its final name or under the aside name that
    :func:`recover_asides` (run by every manager construction) renames
    back."""
    final = os.path.join(directory, _step_dirname(step))
    tmp = os.path.join(directory,
                       f".tmp-{_step_dirname(step)}-{os.getpid()}-"
                       f"{threading.get_ident()}")
    os.makedirs(tmp)
    aside = None
    try:
        leaves: Dict[str, Dict[str, Any]] = {}
        with ThreadPoolExecutor(1) as hasher:
            written = []
            for i, (key, arr, dtype) in enumerate(_flatten_payload(payload)):
                fname = f"leaf_{i:05d}.npy"
                head, data = _npy_parts(arr)
                digest = hasher.submit(_sha256, head, data)
                _write_file(os.path.join(tmp, fname), head, data)
                written.append((key, fname, digest, list(arr.shape), dtype,
                                len(head) + data.nbytes))
            if fsync:   # every leaf on disk before the manifest is written
                with ThreadPoolExecutor(FSYNC_THREADS) as pool:
                    list(pool.map(_fsync_file, [os.path.join(tmp, w[1])
                                                for w in written]))
            for key, fname, digest, shape, dtype, nbytes in written:
                leaves[key] = {
                    "file": fname,
                    "sha256": digest.result(),
                    "shape": shape,
                    "dtype": dtype,
                    "bytes": nbytes,
                }
        manifest = {"format": FORMAT, "step": int(step), "leaves": leaves}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        if fsync:
            _fsync_dir(tmp)
        if os.path.exists(final):
            # a re-save: the old snapshot survives until the new one is
            # committed (rename it aside, commit, drop the aside copy)
            aside = os.path.join(
                directory,
                f".old-{_step_dirname(step)}-{os.getpid()}-"
                f"{threading.get_ident()}")
            if os.path.exists(aside):
                shutil.rmtree(aside)
            os.replace(final, aside)
        os.replace(tmp, final)
        if fsync:
            _fsync_dir(directory)
        if aside is not None:
            shutil.rmtree(aside, ignore_errors=True)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if aside is not None and not os.path.exists(final) \
                and os.path.isdir(aside):
            os.replace(aside, final)   # put the old snapshot back
        raise


def recover_asides(directory: str) -> List[str]:
    """Finish re-saves cut between the rename-aside and the commit: an
    ``.old-step_*`` sibling whose ``step_*`` directory is missing is the
    last good snapshot of that step and is renamed back; one whose step
    directory exists is post-commit garbage and is dropped.  Returns the
    restored paths.  Run by every :class:`DurableCheckpointManager`
    construction, before the ``.tmp-*`` sweep."""
    restored: List[str] = []
    for name in sorted(os.listdir(directory)):
        if not name.startswith(".old-" + _STEP_PREFIX):
            continue
        # ".old-step_00000012-<pid>-<tid>" -> "step_00000012"
        stepdir = name[len(".old-"):].split("-")[0]
        final = os.path.join(directory, stepdir)
        aside = os.path.join(directory, name)
        if os.path.isdir(final):
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.replace(aside, final)
            restored.append(final)
    return restored


def verify_snapshot(path: str) -> Tuple[bool, List[str]]:
    """Checksum-verify one snapshot directory (manifest and every leaf)."""
    problems: List[str] = []
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, [f"manifest unreadable: {e}"]
    if manifest.get("format") != FORMAT:
        return False, [f"unknown snapshot format {manifest.get('format')!r}"]
    for key, meta in manifest.get("leaves", {}).items():
        try:
            with open(os.path.join(path, meta["file"]), "rb") as f:
                raw = f.read()
        except OSError as e:
            problems.append(f"{key}: leaf file unreadable: {e}")
            continue
        if hashlib.sha256(raw).hexdigest() != meta["sha256"]:
            problems.append(
                f"{key}: checksum mismatch in {meta['file']} "
                f"({len(raw)} bytes on disk, {meta['bytes']} expected)")
    return not problems, problems


def read_snapshot(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load a snapshot, verifying every checksum as it reads (one pass of
    IO, the hashing on a pool of threads): ``({keystr: numpy array},
    manifest)``, each array a read-only view of its file's bytes, bf16
    leaves as ``V2`` arrays (:func:`as_tensor` reads them).  A malformed
    snapshot (manifest unreadable or of another format, a leaf file
    missing, a checksum mismatch, an npy that does not parse) raises
    :class:`CheckpointCorruptError`.  Any other ``OSError`` propagates
    as it is: a transient read failure says nothing of the snapshot, and
    a restore retried by ``retry_io`` must retry it, not fall back to an
    older step."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except FileNotFoundError as e:
        raise CheckpointCorruptError(f"{path}: manifest missing: {e}")
    except ValueError as e:
        raise CheckpointCorruptError(f"{path}: manifest unreadable: {e}")
    if manifest.get("format") != FORMAT:
        raise CheckpointCorruptError(
            f"{path}: unknown snapshot format {manifest.get('format')!r}")
    values: Dict[str, np.ndarray] = {}
    with ThreadPoolExecutor(HASH_THREADS) as pool:
        jobs = []

        def check(upto: int) -> None:
            """Verify the leaves read so far, in manifest order (the first
            mismatch raises, as a sequential read would have)."""
            while len(values) < upto:
                key, meta, raw, digest = jobs[len(values)]
                if digest.result() != meta["sha256"]:
                    raise CheckpointCorruptError(
                        f"{path}: {key}: checksum mismatch in "
                        f"{meta['file']} ({len(raw)} bytes on disk, "
                        f"{meta['bytes']} expected)")
                try:
                    values[key] = _parse_npy(raw)
                except ValueError as e:
                    raise CheckpointCorruptError(
                        f"{path}: {key}: unparsable npy payload: {e}")

        for key, meta in manifest.get("leaves", {}).items():
            try:
                with open(os.path.join(path, meta["file"]), "rb") as f:
                    raw = f.read()
            except FileNotFoundError as e:
                check(len(jobs))
                # a leaf the manifest names but the disk lacks: the
                # snapshot's structure is broken (a truncated commit)
                raise CheckpointCorruptError(
                    f"{path}: {key}: leaf file missing: {e}")
            jobs.append((key, meta, raw, pool.submit(_sha256, raw)))
        check(len(jobs))
    return values, manifest


class CheckpointCorruptError(RuntimeError):
    """No snapshot in the directory survived checksum verification."""


class DurableCheckpointManager:
    """Crash-atomic checkpointing of an amp training state
    (:class:`~apex_tpu_torch.amp.Amp`, through
    :mod:`apex_tpu_torch.checkpoint`) with retention, async save,
    checksum-verified restore with fallback, and device-portable restore
    (see the module docstring)::

        mgr = DurableCheckpointManager(dir, max_to_keep=3)
        mgr.save(step, amp, extras={"epoch": e})   # async, off the step path
        amp, extras = mgr.restore(amp, extras=...)  # in place
        mgr.wait(); mgr.close()

    ``io_hook(op)`` (op ``"save"`` or ``"restore"``) runs before each IO
    operation: the fault injector's seam for slow or flaky IO.
    ``on_commit(step, path)`` runs after a snapshot commits: the
    injector's seam for corruption after the commit.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True, fsync: bool = True,
                 io_hook: Optional[Callable[[str], None]] = None,
                 on_commit: Optional[Callable[[int, str], None]] = None,
                 io_retries: int = 3, io_backoff_s: float = 0.05):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = int(max_to_keep)
        self._io_retries = int(io_retries)
        self._io_backoff_s = float(io_backoff_s)
        self._fsync = fsync
        self._io_hook = io_hook
        self._on_commit = on_commit
        self._async = async_save
        self._queue: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self.last_restore: Optional[Dict[str, Any]] = None
        # a crash between a re-save's rename-aside and its commit left the
        # step's last good snapshot under an .old-* name: restore it
        # first, then sweep the .tmp-* staging dirs
        recover_asides(self._dir)
        for name in os.listdir(self._dir):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(self._dir, name),
                              ignore_errors=True)

    # -- background writer ------------------------------------------------
    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._drain, name="apex-tpu-torch-ckpt-writer",
                daemon=True)
            self._worker.start()

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                self._queue.task_done()
                return
            step, payload = job
            try:
                self._commit_with_retry(step, payload)
            except BaseException as e:  # surfaced on wait() / next save()
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def _raise_pending(self) -> None:
        if self._errors:
            err = self._errors.pop(0)
            raise RuntimeError(
                f"background checkpoint save failed: {err!r}") from err

    # -- API ---------------------------------------------------------------
    def save(self, step: int, state: Any,
             extras: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot ``state`` (an :class:`~apex_tpu_torch.amp.Amp`) and
        ``extras``; the training loop does not wait for the disk.  The
        copy to the host happens here, on the calling thread, and is
        complete when this returns: the next step may change every
        tensor in place.  Serialization, fsync and retention run on the
        writer thread (call :meth:`wait` or :meth:`close` before exiting;
        ``restore`` and ``latest_step`` wait)."""
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        self._raise_pending()
        from apex_tpu_torch import checkpoint as ckpt
        payload = ckpt.state_dict(state, extras)   # host copy, race-free
        if not self._async:
            self._commit_with_retry(int(step), payload)
            return
        self._ensure_worker()
        self._queue.put((int(step), payload))

    def _commit_with_retry(self, step: int, payload: Any) -> str:
        # transient IO (OSError) retries here, wherever the commit runs
        from apex_tpu_torch.resilience.loop import retry_io
        return retry_io(lambda: self._commit(step, payload),
                        retries=self._io_retries,
                        backoff_s=self._io_backoff_s)

    def _commit(self, step: int, payload: Any) -> str:
        if self._io_hook is not None:
            self._io_hook("save")
        path = write_snapshot(self._dir, step, payload, fsync=self._fsync)
        self._retain()
        if self._on_commit is not None:
            self._on_commit(step, path)
        return path

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self._max_to_keep] if self._max_to_keep > 0 else []:
            shutil.rmtree(os.path.join(self._dir, _step_dirname(s)),
                          ignore_errors=True)

    def wait(self) -> None:
        """Block until every queued save has committed; re-raise the
        first background failure."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        self.wait()
        self._closed = True
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)           # stop the writer: a closed
            self._worker.join(timeout=5.0)  # manager leaves no thread
        self._worker = None

    def all_steps(self) -> List[int]:
        """Committed snapshot steps, oldest first (no verification)."""
        steps = []
        for name in os.listdir(self._dir):
            if name.startswith(_STEP_PREFIX):
                try:
                    steps.append(int(name[len(_STEP_PREFIX):]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path_of(self, step: int) -> str:
        return os.path.join(self._dir, _step_dirname(step))

    def restore(self, template: Any, step: Optional[int] = None,
                extras: Optional[Dict[str, Any]] = None) -> Tuple[Any, Dict]:
        """Restore the given (or the newest verifying) step into
        ``template`` (an :class:`~apex_tpu_torch.amp.Amp`), in place, and
        return ``(template, extras)``.

        Every leaf checksum is verified; a snapshot that fails (truncated
        by a preemption, corrupted on disk) is skipped for the next older
        one, unless ``step`` pins one, which fails hard.  Each leaf goes
        to the device and dtype of its template tensor: the masters,
        moments and step counts are copied into the template's own
        tensors, so that the optimizer's chunk tables and its step-count
        views stay valid.  ``extras`` is the structure saved beside the
        state; its tensors are filled in place, its other leaves
        returned as read.  ``last_restore`` records the chosen step and
        any skipped snapshots; when every snapshot fails this raises
        :class:`CheckpointCorruptError` and changes nothing."""
        from apex_tpu_torch import checkpoint as ckpt
        self.wait()
        if self._io_hook is not None:
            self._io_hook("restore")
        candidates = [int(step)] if step is not None \
            else list(reversed(self.all_steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        skipped: List[Dict[str, Any]] = []
        for s in candidates:
            path = self.path_of(s)
            if not os.path.isdir(path):
                if step is not None:
                    raise FileNotFoundError(f"no snapshot for step {s} in "
                                            f"{self._dir}")
                continue
            try:    # the read verifies every checksum in the same pass
                values, manifest = read_snapshot(path)
            except CheckpointCorruptError as e:
                if step is not None:
                    raise
                skipped.append({"step": s, "problems": [str(e)]})
                continue
            target = ckpt.payload_template(template, extras)
            target_keys = [k for k, _ in tree_leaves_with_path(target)]
            ckpt.check_same_structure(set(values), set(target_keys),
                                      context=f"snapshot step {s}")
            metas = manifest["leaves"]
            payload = tree_map_with_path(
                lambda k, _t: as_tensor(values[k], metas[k]["dtype"]),
                target)
            state, ex = ckpt.load_state_dict(template, payload)
            ex = place_like(ex, extras) if extras else ex
            self.last_restore = {"step": s, "skipped": skipped}
            return state, ex
        raise CheckpointCorruptError(
            f"every snapshot in {self._dir} failed verification: {skipped}")


def place_like(values: Any, template: Any) -> Any:
    """Each restored leaf onto its template leaf: a tensor template is
    filled in place (``copy_``: its device and dtype) and returned; a
    Python number comes back as its own type; anything else as read."""
    import torch
    flat = dict(tree_leaves_with_path(values))

    def place(path, t):
        v = flat[path]
        if isinstance(t, torch.Tensor):
            with torch.no_grad():
                t.copy_(as_tensor(v))
            return t
        if isinstance(t, (bool, int, float)):
            return type(t)(np.asarray(v).item())
        return v.numpy() if isinstance(v, torch.Tensor) else v
    return tree_map_with_path(place, template)

