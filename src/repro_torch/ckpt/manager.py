"""Fault-tolerant checkpointing and the sweep journal, for torch tensors.

The on-disk formats are the reference package's, byte for byte, so a
journal or checkpoint written by either package loads in the other:

  * atomic: write to ``step_N.tmp`` then os.replace/os.rename -> a reader
    never sees a torn checkpoint; crash mid-save leaves the previous
    checkpoint intact.
  * keep-N GC with monotonic step metadata.
  * async: saves are enqueued to ONE persistent writer thread per
    directory (the caller donates a host snapshot and keeps going);
    ``wait()`` drains the queue.
  * three on-disk layouts:
      - **wal** (opt-in, ``wal=True``; the sweep journal): every publish
        is ONE append of a crc-framed record to ``journal.wal`` through
        a long-lived fd.  A frame is the magic ``RJRNL1\\n``, a 4-byte
        little-endian header length, a JSON header (step, meta,
        manifest, array order, payload length, crc32) and the raw
        C-order bytes of the arrays.  Appends use ``O_APPEND`` (one
        ``write(2)`` per frame); a crash mid-append leaves a torn tail
        that the reader skips by re-syncing on the next frame magic, so
        records appended after a torn frame are still recovered.
        ``remove`` appends a tombstone.
      - **compact** (small payloads when ``wal=False``): one ``step_N``
        *file* — magic + JSON header (meta + manifest + crc32) + raw
        ``np.lib.format`` array records — published with a single
        buffered write and ``os.replace`` of a pre-created spool file.
      - **directory** (large payloads): ``step_N/`` with ``arrays.npz``
        + ``meta.json``, streamed by ``np.savez``.
    Readers are layout-agnostic: per-step files/dirs and the log are
    merged, and every layout validates a manifest (the wal/compact ones
    additionally a payload crc32) before trusting any array.
  * device-free format: arrays are saved as host numpy keyed by their
    path in a nest of dicts, lists and tuples; `restore` moves them to
    the device it is given (one device: nothing is sharded).

``defer_snapshot=True`` enqueues device tensors as they are and lets the
writer thread copy them to the host in ONE batched transfer (every
tensor viewed as bytes, concatenated on the device, one ``.cpu()``), so
the copy overlaps the caller's next work instead of stalling it.
"""

from __future__ import annotations

import atexit
import io
import json
import os
import queue
import shutil
import threading
import time
import zipfile
import zlib

import numpy as np
import torch

from ..device import resolve_device
from ..runtime import faults


class CheckpointCorruptError(RuntimeError):
    """A checkpoint/journal step exists on disk but cannot be trusted:
    unreadable metadata, unreadable arrays, or a manifest mismatch.
    Readers treat the step as absent (re-do the work) rather than
    consuming torn state."""


def _flatten(tree, prefix: str = "") -> dict:
    """``{"a/0/b": leaf}`` for a nest of dicts, lists and tuples, in the
    order (and with the key spelling) of the reference's pytree paths:
    dict keys sorted, sequence items by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(like, flat: dict, prefix: str = ""):
    """Rebuild the structure of ``like`` with leaves taken from ``flat``."""
    if isinstance(like, dict):
        return {
            k: _unflatten(like[k], flat, f"{prefix}/{k}" if prefix else str(k))
            for k in like
        }
    if isinstance(like, (list, tuple)):
        vals = [
            _unflatten(v, flat, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(like)
        ]
        return type(like)(vals)
    return flat[prefix]


# numpy's savez cannot store bfloat16 or fp8: they are saved as a
# same-width unsigned integer view, with the logical dtype in the
# manifest (the reference's encoding).  Restore views them back.
_ENCODE_VIEW = {
    torch.bfloat16: ("bfloat16", torch.uint16),
    torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
    torch.float8_e5m2: ("float8_e5m2", torch.uint8),
}
_DECODE_VIEW = {name: (np.dtype(str(view).removeprefix("torch.")), dt)
                for dt, (name, view) in _ENCODE_VIEW.items()}


class _Encoded(tuple):
    """``(host array, manifest dtype name)`` of one snapshotted leaf."""


def _host_dtype(dt: torch.dtype) -> tuple[np.dtype, str]:
    """The numpy dtype a tensor of ``dt`` is stored as, and its manifest
    name."""
    name, view = _ENCODE_VIEW.get(dt, (None, dt))
    npdt = torch.empty(0, dtype=view).numpy().dtype
    return npdt, name or str(npdt)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def _decode_bytes(buf: np.ndarray, t: torch.Tensor) -> _Encoded:
    npdt, name = _host_dtype(t.dtype)
    return _Encoded((buf.view(npdt).reshape(tuple(t.shape)).copy(), name))


def _snapshot(arrays: dict) -> dict:
    """Every leaf of ``arrays`` as an `_Encoded` host array (a copy).
    Device tensors cross in ONE transfer: each viewed as bytes,
    concatenated on the device, one ``.cpu()``, then split and viewed
    back."""
    out, dev = {}, {}
    for k, v in arrays.items():
        if isinstance(v, _Encoded):
            out[k] = v
        elif isinstance(v, torch.Tensor) and v.device.type != "cpu":
            dev[k] = v
        elif isinstance(v, torch.Tensor):
            out[k] = _decode_bytes(_bytes(v).numpy(), v)
        else:
            arr = np.asarray(v)
            out[k] = _Encoded((arr, str(arr.dtype)))
    if dev:
        host = torch.cat([_bytes(v) for v in dev.values()]).cpu().numpy()
        off = 0
        for k, v in dev.items():
            n = v.numel() * v.element_size()
            out[k] = _decode_bytes(host[off:off + n], v)
            off += n
    return {k: out[k] for k in arrays}


_MAGIC = b"RCKPT1\n"
_WMAGIC = b"RJRNL1\n"  # frame magic of the append-only journal log
_COMPACT_LIMIT = 4 << 20  # payloads up to 4 MiB use the single-file layout
_IDLE_S = 60.0  # writer thread parks itself after this much idle time


class _DirWriter:
    """One async writer (queue + lazy thread) per checkpoint directory,
    shared process-wide.  Sharing per directory means a *later*
    `CheckpointManager` on the same directory drains publishes enqueued
    by an earlier one — the journal-resume scan does exactly that — so
    async saves need no drain barrier on the success path."""

    def __init__(self) -> None:
        self.q: queue.Queue = queue.Queue()
        self.thread: threading.Thread | None = None
        self.exc: BaseException | None = None

    def put(self, item) -> None:
        with _WRITERS_LOCK:
            self.q.put(item)
            if self.thread is None or not self.thread.is_alive():
                self.thread = threading.Thread(target=self._loop, daemon=True)
                self.thread.start()

    def _loop(self) -> None:
        while True:
            try:
                mgr, step, arrays, meta, ready = self.q.get(timeout=_IDLE_S)
            except queue.Empty:
                with _WRITERS_LOCK:
                    if self.q.empty():
                        self.thread = None
                        return
                continue
            try:
                if ready is not None:
                    ready.synchronize()  # the caller's stream produced them
                mgr._write(step, arrays, meta)
            except BaseException as e:  # surfaced at the next drain()
                self.exc = e
            finally:
                self.q.task_done()
            if self.q.empty():
                mgr._replenish_spool()

    def drain(self) -> None:
        self.q.join()
        exc, self.exc = self.exc, None
        if exc is not None:
            raise exc


_WRITERS: dict[str, _DirWriter] = {}
_WRITERS_LOCK = threading.Lock()
_EXIT_DRAIN_S = 60.0


@atexit.register
def _drain_at_exit() -> None:
    """Let in-flight publishes finish before the interpreter shuts down
    (bounded, so a hung writer cannot hold the exit).  A daemon writer
    cut off mid-publish by finalization aborts the process instead."""
    deadline = time.monotonic() + _EXIT_DRAIN_S
    for w in list(_WRITERS.values()):
        while w.q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.001)


def _dir_writer(directory: str) -> _DirWriter:
    key = os.path.realpath(directory)
    with _WRITERS_LOCK:
        w = _WRITERS.get(key)
        if w is None:
            w = _WRITERS[key] = _DirWriter()
        return w


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = True, wal: bool = False,
                 defer_snapshot: bool = False):
        self.dir = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self.wal = wal
        # defer_snapshot: enqueue device tensors as they are and let the
        # writer thread copy them to the host (one batched transfer).
        # Only safe when the saved tensors are not mutated afterwards.
        self.defer_snapshot = defer_snapshot
        os.makedirs(directory, exist_ok=True)
        # In-memory view of published steps so the per-publish GC does
        # not pay a listdir.  Seeded from disk on first use.
        self._known: set[int] | None = None
        # Append-only log state (written when wal=True; *read* always,
        # so any manager on the directory sees log-published steps).
        self._wal_path = os.path.join(directory, "journal.wal")
        self._wal_fd = None
        self._wal_lock = threading.Lock()
        self._wal_cache: "dict[int, tuple[dict, bytes]] | None" = None
        # Compact publishes rename a pre-created spool file, so the
        # publish itself is truncate-write+rename.
        self._spool = os.path.join(directory, "journal.spool")
        self._replenish_spool()
        self._w = _dir_writer(directory) if async_save else None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree, meta: dict | None = None) -> None:
        """Snapshot ``tree`` (a nest of dicts/lists/tuples of tensors,
        arrays or scalars) and publish it as ``step``.

        With ``async_save`` the call returns immediately: the snapshot is
        enqueued to the directory's shared writer thread, so saves
        publish in call order and ``wait()`` drains the queue.  A write
        failure is re-raised at the next ``wait()``.
        """
        flat = _flatten(tree)
        ready = None
        if self.defer_snapshot and self._w is not None:
            cuda = [v for v in flat.values()
                    if isinstance(v, torch.Tensor) and v.device.type == "cuda"]
            if cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(cuda[0].device))
        else:
            flat = _snapshot(flat)
        if self._w is not None:
            self._w.put((self, step, flat, meta or {}, ready))
        else:
            self._write(step, flat, meta or {})

    def _replenish_spool(self) -> None:
        if self.wal:
            return  # log appends reuse one fd; no spool file needed
        try:
            open(self._spool, "ab").close()
        except OSError:
            pass  # the publish open("wb") will create it instead

    def _write(self, step: int, arrays: dict, meta: dict) -> None:
        final = os.path.join(self.dir, f"step_{step}")
        faults.inject("journal.write", detail=final)
        tmp = final + ".tmp"
        encoded, manifest, total = {}, {}, 0
        # deferred snapshots arrive as device tensors: one batched copy
        for k, (enc, name) in _snapshot(arrays).items():
            encoded[k] = enc
            manifest[k] = dict(shape=list(enc.shape), dtype=name)
            total += enc.nbytes
        doc = dict(step=step, time=time.time(), meta=meta, manifest=manifest)
        if total <= _COMPACT_LIMIT and self.wal:
            self._write_wal(step, encoded, doc, final)
        elif total <= _COMPACT_LIMIT:
            self._write_compact(final, encoded, doc)
            if self._w is None:  # sync mode: no writer to replenish it
                self._replenish_spool()
        else:
            self._write_dir(tmp, final, encoded, doc)
        self._gc(step)

    def _wal_append(self, frame: bytes) -> None:
        with self._wal_lock:
            if self._wal_fd is None:
                self._wal_fd = open(self._wal_path, "ab")
            self._wal_fd.write(frame)  # O_APPEND: one atomic write(2)
            self._wal_fd.flush()

    def _write_wal(self, step: int, encoded: dict, doc: dict,
                   final: str) -> None:
        order = list(encoded)
        payload = b"".join(np.asarray(encoded[k]).tobytes() for k in order)
        head = dict(doc, format="wal1", order=order, plen=len(payload),
                    crc32=zlib.crc32(payload))
        hb = json.dumps(head).encode()
        self._wal_append(
            b"".join([_WMAGIC, len(hb).to_bytes(4, "little"), hb, payload])
        )
        with self._wal_lock:
            if self._wal_cache is not None:
                self._wal_cache[step] = (head, payload)
        # Chaos hook: a torn/corrupt append that survives the flush —
        # the reader must skip the damaged frame via the crc check and
        # re-sync on the next magic, never consume it.
        faults.corrupt_file("journal.write", self._wal_path, detail=final)

    def _wal_evict(self, step: int) -> None:
        hb = json.dumps(dict(evict=step, time=time.time())).encode()
        self._wal_append(
            b"".join([_WMAGIC, len(hb).to_bytes(4, "little"), hb])
        )
        with self._wal_lock:
            if self._wal_cache is not None:
                self._wal_cache.pop(step, None)

    def _scan_wal(self) -> "dict[int, tuple[dict, bytes]]":
        """Parse ``journal.wal`` into ``{step: (head, payload)}``.

        Torn or corrupt frames are skipped by re-syncing on the next
        frame magic, so a damaged frame never hides records appended
        after it.  Tombstone frames drop earlier steps; the last record
        for a step wins.  The parse is cached — this manager's own
        appends keep it coherent."""
        if self._wal_cache is not None:
            return self._wal_cache
        out: "dict[int, tuple[dict, bytes]]" = {}
        try:
            with open(self._wal_path, "rb") as f:
                blob = f.read()
        except OSError:
            self._wal_cache = out
            return out
        i, n = 0, len(blob)
        while i < n:
            j = blob.find(_WMAGIC, i)
            if j < 0:
                break
            k = j + len(_WMAGIC)
            try:
                hlen = int.from_bytes(blob[k:k + 4], "little")
                if not 0 < hlen <= n - k - 4:
                    raise ValueError("torn header")
                head = json.loads(blob[k + 4:k + 4 + hlen].decode())
                plen = int(head.get("plen", 0))
                start = k + 4 + hlen
                if start + plen > n:
                    raise ValueError("torn payload")
                payload = blob[start:start + plen]
                if "evict" in head:
                    out.pop(int(head["evict"]), None)
                elif zlib.crc32(payload) != head.get("crc32"):
                    raise ValueError("payload crc mismatch")
                else:
                    out[int(head["step"])] = (head, payload)
                i = start + plen
            except (ValueError, KeyError, TypeError, UnicodeDecodeError,
                    json.JSONDecodeError):
                i = k  # damaged frame: re-sync at the next magic
        self._wal_cache = out
        return out

    def _read_wal_step(self, step: int) -> tuple[dict, dict]:
        rec = self._scan_wal().get(step)
        if rec is None:
            raise KeyError(f"step {step} not in {self._wal_path}")
        head, payload = rec
        raw, off = {}, 0
        for key in head["order"]:
            want = head["manifest"][key]
            name = want["dtype"]  # bfloat16/fp8 are stored as their views
            edt = _DECODE_VIEW[name][0] if name in _DECODE_VIEW else np.dtype(name)
            count = int(np.prod(want["shape"], dtype=np.int64))
            raw[key] = np.frombuffer(
                payload, dtype=edt, count=count, offset=off
            ).reshape(want["shape"])
            off += count * edt.itemsize
        return raw, head

    def _write_compact(self, final: str, encoded: dict, doc: dict) -> None:
        body = io.BytesIO()
        order = []
        for k, enc in encoded.items():
            order.append(k)
            # NB: not ascontiguousarray — it promotes 0-d arrays to 1-d.
            np.lib.format.write_array(body, np.asarray(enc),
                                      allow_pickle=False)
        body = body.getvalue()
        doc = dict(doc, format="compact1", order=order, crc32=zlib.crc32(body))
        head = json.dumps(doc).encode()
        blob = b"".join([_MAGIC, len(head).to_bytes(8, "little"), head, body])
        spool = self._spool
        try:
            with open(spool, "wb") as f:
                f.write(blob)
        except IsADirectoryError:  # something squatted on the spool path
            shutil.rmtree(spool)
            with open(spool, "wb") as f:
                f.write(blob)
        # Chaos hook: a torn write that survives the atomic publish.
        faults.corrupt_file("journal.write", spool, detail=final)
        try:
            os.replace(spool, final)  # atomic publish
        except (IsADirectoryError, OSError):
            # replacing a directory step: clear it and retry once
            if not os.path.isdir(final):
                raise
            shutil.rmtree(final)
            os.replace(spool, final)

    def _write_dir(self, tmp: str, final: str, encoded: dict,
                   doc: dict) -> None:
        if os.path.isfile(tmp):
            os.remove(tmp)
        elif os.path.isdir(tmp):  # stale crashed writer: start clean
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **encoded)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(doc, f)
        # Chaos hook — see _write_compact.
        faults.corrupt_file(
            "journal.write", os.path.join(tmp, "arrays.npz"), detail=final
        )
        if os.path.exists(final):
            self._rm(final)
        os.rename(tmp, final)  # atomic publish

    def wait(self) -> None:
        """Block until every save enqueued for this directory has
        published; re-raise the first writer failure since the last
        wait, if any."""
        if self._w is not None:
            self._w.drain()

    def _rm(self, path: str) -> None:
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            try:
                os.remove(path)
            except OSError:
                pass

    def _gc(self, published: int | None = None) -> None:
        if self._known is None:
            self._known = set(self.steps())
        if published is not None:
            self._known.add(published)
        if len(self._known) <= self.keep_n:
            return
        for s in sorted(self._known)[: -self.keep_n]:
            self.remove(s)

    # -- restore ---------------------------------------------------------------

    def steps(self) -> list[int]:
        out = set()
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.add(int(name.split("_")[1]))
                except ValueError:
                    pass
        out.update(self._scan_wal())
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def remove(self, step: int) -> None:
        """Drop one published step (used to evict corrupt journal
        entries so the work is redone instead of re-tripping on them)."""
        self._rm(os.path.join(self.dir, f"step_{step}"))
        if step in self._scan_wal():
            self._wal_evict(step)
        if self._known is not None:
            self._known.discard(step)

    def _read_compact(self, path: str) -> tuple[dict[str, np.ndarray], dict]:
        with open(path, "rb") as f:
            blob = f.read()
        if not blob.startswith(_MAGIC):
            raise ValueError("bad compact-checkpoint magic")
        off = len(_MAGIC)
        n = int.from_bytes(blob[off:off + 8], "little")
        meta = json.loads(blob[off + 8:off + 8 + n].decode())
        body = blob[off + 8 + n:]
        if zlib.crc32(body) != meta.get("crc32"):
            raise ValueError("compact-checkpoint payload crc mismatch")
        buf = io.BytesIO(body)
        raw = {}
        for key in meta["order"]:
            raw[key] = np.lib.format.read_array(buf, allow_pickle=False)
        return raw, meta

    def load_arrays(self, step: int) -> tuple[dict[str, np.ndarray], dict]:
        """Raw structure-free restore: ``(arrays, meta)`` for one step, as
        host numpy (bfloat16/fp8 arrays as their unsigned integer view;
        the manifest names the logical dtype).

        This is the journal-consumer path (`core.sweep_runner`), where the
        reader discovers what was written.  Every array is validated
        against the step's manifest; any unreadable or inconsistent state
        raises `CheckpointCorruptError` so callers can evict the step and
        redo its work.
        """
        path = os.path.join(self.dir, f"step_{step}")
        try:
            if os.path.isfile(path):
                raw, meta = self._read_compact(path)
            elif os.path.isdir(path):
                with open(os.path.join(path, "meta.json")) as f:
                    meta = json.load(f)
                raw = {}
                with np.load(os.path.join(path, "arrays.npz")) as data:
                    for key in data.files:
                        raw[key] = data[key]
            else:
                raw, meta = self._read_wal_step(step)
            manifest = meta["manifest"]
            if set(raw) != set(manifest):
                raise ValueError(
                    f"manifest names {sorted(manifest)} != stored "
                    f"{sorted(raw)}"
                )
            out: dict[str, np.ndarray] = {}
            for key, want in manifest.items():
                arr = raw[key]
                if list(arr.shape) != want["shape"]:
                    raise ValueError(f"manifest shape mismatch for {key}")
                out[key] = np.array(arr)
        except (OSError, ValueError, KeyError, EOFError, UnicodeDecodeError,
                json.JSONDecodeError, zipfile.BadZipFile) as e:
            raise CheckpointCorruptError(
                f"checkpoint step {step} in {self.dir} is unreadable: "
                f"{type(e).__name__}: {e}"
            ) from e
        return out, meta

    def restore(self, like_tree, step: int | None = None,
                device: "str | torch.device | None" = None):
        """Restore into the structure of ``like_tree`` as tensors on
        ``device`` (default ``cuda``, raising without a card; ``"cpu"``
        keeps them on the host).  Returns ``(tree, meta)``."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        data, meta = self.load_arrays(step)
        flat = _flatten(like_tree)
        vals = {}
        for key, like in flat.items():
            if key not in data:
                raise KeyError(f"checkpoint missing array {key!r}")
            arr = data[key]
            if hasattr(like, "shape") and tuple(arr.shape) != tuple(like.shape):
                raise ValueError(
                    f"shape mismatch for {key}: ckpt {arr.shape} vs model {like.shape}"
                )
            t = torch.from_numpy(arr)
            name = meta["manifest"][key]["dtype"]
            if name in _DECODE_VIEW:
                t = t.view(_DECODE_VIEW[name][1])
            vals[key] = t.to(dev)
        return _unflatten(like_tree, vals), meta
