"""CheckpointStore: the versioned on-disk layout of aligned snapshots.

Copy of ``windflow_tpu/checkpoint/store.py``. Layout under one root
directory::

    <root>/
      ckpt_0000000003.inprogress/     # staging: blobs land here first
        reduce_1a2b3c4d__0.blob
        source_5e6f7a8b__0.blob
      ckpt_0000000002/                # committed: manifest present
        manifest.json
        *.blob

Every write is crash-safe by construction: blobs and the manifest are
written to a ``.tmp`` sibling and published with ``os.replace`` (atomic
rename on POSIX), and a checkpoint becomes visible as a whole only when
its staging directory is renamed to the final name. A crash at any point
leaves either the previous committed checkpoint intact or an
``.inprogress`` directory that restore ignores. Retention keeps the last
``retain`` committed checkpoints.

Blob files are named ``<sanitized-op-name>_<crc32>__<replica>.blob`` (the
crc disambiguates op names that sanitize identically); each blob pickles
``{"op": <exact name>, "replica": idx, "state": <replica state dict>}``
so restore matches replicas by exact name, never by file name.

Content integrity: every blob's sha256 digest is recorded in the manifest
at snapshot time, and restore re-hashes each blob before unpickling it —
a torn, truncated or bit-flipped blob raises ``CorruptCheckpointError``
naming the bad file instead of feeding garbage state into the graph.

Incremental checkpoints (``CheckpointStore(..., delta=True)``, the
graph's ``with_checkpointing(delta=True)``; the JAX package's
``WF_CKPT_DELTA``) add two manifest maps. Manifests without them restore
as before, and the store reads both kinds whatever its own switch:

- ``refs: {fname: ancestor_ckpt_id}``: this epoch's blob is byte-identical
  to the named committed ancestor's (same payload digest), so the file is
  referenced, not rewritten. A ref always names the directory that
  physically holds the bytes (one hop, never a ref of a ref).
- ``deps: {fname: [base_ckpt_ids]}``: this epoch's blob is a state delta
  (``delta.py``) patching the named base epochs' same-name blob;
  ``load_states`` materializes the full state before returning it.

``verify()`` hashes the transitive closure (refs and deps), so a corrupt
ancestor flags every dependent epoch; ``prune`` keeps the closure of the
retained epochs alive.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import shutil
import sqlite3
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..basic import CorruptCheckpointError, WindFlowError
from . import delta as _delta

MANIFEST = "manifest.json"
FORMAT_VERSION = 1

_CKPT_RE = re.compile(r"^ckpt_(\d{10})$")

__all__ = ["CheckpointStore", "CorruptCheckpointError", "blob_name"]


def _hash_bytes(data: bytes) -> str:
    return "sha256:" + hashlib.sha256(data).hexdigest()


def _hash_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def blob_name(op_name: str, replica_idx: int) -> str:
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in op_name)
    crc = zlib.crc32(op_name.encode("utf-8", "surrogatepass")) & 0xFFFFFFFF
    return f"{safe}_{crc:08x}__{replica_idx}.blob"


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointStore:
    # per-root store locks (process-wide): retain-K prune and a concurrent
    # restore's blob reads of the SAME root serialize here, so prune can
    # never delete a checkpoint mid-read
    _root_locks: Dict[str, threading.RLock] = {}
    _root_guard = threading.Lock()

    @classmethod
    def _lock_of(cls, root: str) -> threading.RLock:
        key = os.path.abspath(root)
        with cls._root_guard:
            lock = cls._root_locks.get(key)
            if lock is None:
                lock = cls._root_locks[key] = threading.RLock()
            return lock

    def __init__(self, root: str, retain: int = 3,
                 delta: bool = False) -> None:
        self.root = root
        self.retain = max(1, int(retain))
        # record an unchanged blob as a ref to its ancestor (incremental
        # checkpoints); reading refs and deps needs no switch
        self.delta = bool(delta)
        os.makedirs(root, exist_ok=True)
        # digests of staged blobs, ckpt_id -> {fname: "sha256:..."}, hashed
        # from the in-memory payload at write time; commit() folds them
        # into the manifest
        self._digests: Dict[int, Dict[str, str]] = {}
        self._digest_lock = threading.Lock()
        # digest-verification failures observed by this instance
        # (Checkpoint_verify_failures)
        self.verify_failures = 0
        # incremental staging state: per-epoch blob refs (fname -> the
        # ancestor cid physically holding identical bytes) and state-delta
        # deps (fname -> the base cids the state patches), folded into the
        # manifest at commit
        self._refs: Dict[int, Dict[str, int]] = {}
        self._deps: Dict[int, Dict[str, List[int]]] = {}
        self._ref_base: Dict[int, Optional[int]] = {}
        self._manifest_cache: Dict[int, Dict[str, Any]] = {}
        # blobs not written in full form (ref'd or delta-form), the bytes
        # those cost, and the bytes of full blobs (this instance)
        self.delta_blobs = 0
        self.delta_bytes = 0
        self.full_bytes = 0

    # -- paths -------------------------------------------------------------
    def _dirname(self, ckpt_id: int, staging: bool = False) -> str:
        d = os.path.join(self.root, f"ckpt_{ckpt_id:010d}")
        return d + ".inprogress" if staging else d

    def begin(self, ckpt_id: int) -> None:
        """Start (or restart) staging for a checkpoint: stale debris from a
        crashed attempt at the same id must not leak into the manifest."""
        staging = self._dirname(ckpt_id, staging=True)
        shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging, exist_ok=True)
        with self._digest_lock:
            self._digests.pop(ckpt_id, None)
            self._refs.pop(ckpt_id, None)
            self._deps.pop(ckpt_id, None)
            # the dedup base of this epoch's blobs: the latest epoch
            # COMMITTED when staging opened
            self._ref_base[ckpt_id] = self.latest() if self.delta else None

    def _committed_manifest(self, cid: int) -> Optional[Dict[str, Any]]:
        """Manifest of a committed epoch, cached (committed manifests never
        change; ``prune`` evicts what it deletes)."""
        with self._digest_lock:
            m = self._manifest_cache.get(cid)
        if m is not None:
            return m
        try:
            m = self.load_manifest(self._dirname(cid))
        except (FileNotFoundError, CorruptCheckpointError):
            return None
        with self._digest_lock:
            self._manifest_cache[cid] = m
        return m

    # -- writes ------------------------------------------------------------
    def write_blob(self, ckpt_id: int, op_name: str, replica_idx: int,
                   state: Any) -> int:
        """Pickle one replica's snapshot into the staging dir (atomic
        tmp+rename). Returns the logical byte size of the snapshot.

        With ``delta`` on, a payload whose digest equals the previous
        committed epoch's same-name blob is recorded as a manifest ref
        instead of rewritten: zero bytes for an unchanged replica."""
        staging = self._dirname(ckpt_id, staging=True)
        os.makedirs(staging, exist_ok=True)
        payload = pickle.dumps(
            {"op": op_name, "replica": replica_idx, "state": state},
            protocol=pickle.HIGHEST_PROTOCOL)
        fname = blob_name(op_name, replica_idx)
        digest = _hash_bytes(payload)
        bases = _delta.delta_bases(state)
        with self._digest_lock:
            self._digests.setdefault(ckpt_id, {})[fname] = digest
            if bases:
                self._deps.setdefault(ckpt_id, {})[fname] = sorted(
                    int(b) for b in bases)
            else:
                self._deps.get(ckpt_id, {}).pop(fname, None)
            base_cid = self._ref_base.get(ckpt_id)
        if base_cid is not None:
            bman = self._committed_manifest(base_cid)
            if bman is not None and \
                    (bman.get("digests") or {}).get(fname) == digest:
                # identical bytes already on disk: resolve through the
                # base's own refs so the ref points one hop at the
                # directory physically holding the blob
                phys = int((bman.get("refs") or {}).get(fname, base_cid))
                with self._digest_lock:
                    self._refs.setdefault(ckpt_id, {})[fname] = phys
                    self.delta_blobs += 1
                return len(payload)
        with self._digest_lock:
            self._refs.get(ckpt_id, {}).pop(fname, None)
            if bases:
                self.delta_blobs += 1
                self.delta_bytes += len(payload)
            else:
                self.full_bytes += len(payload)
        _atomic_write(os.path.join(staging, fname), payload)
        return len(payload)

    def staged_blobs(self, ckpt_id: int) -> List[str]:
        staging = self._dirname(ckpt_id, staging=True)
        try:
            return sorted(f for f in os.listdir(staging)
                          if f.endswith(".blob"))
        except FileNotFoundError:
            return []

    def commit(self, ckpt_id: int, manifest: Dict[str, Any]) -> str:
        """Finalize: manifest into staging, then one atomic directory
        rename makes the whole checkpoint visible. Prunes old ones."""
        staging = self._dirname(ckpt_id, staging=True)
        final = self._dirname(ckpt_id)
        manifest = dict(manifest)
        manifest.setdefault("format", FORMAT_VERSION)
        manifest["ckpt_id"] = ckpt_id
        with self._digest_lock:
            cached = self._digests.pop(ckpt_id, {})
            refs = dict(self._refs.pop(ckpt_id, {}))
            deps = dict(self._deps.pop(ckpt_id, {}))
            self._ref_base.pop(ckpt_id, None)
        staged = self.staged_blobs(ckpt_id)
        # a blob both staged and ref'd (re-written within one epoch) has
        # identical bytes either way: prefer the local file
        refs = {f: c for f, c in refs.items() if f not in staged}
        manifest["blobs"] = sorted(set(staged) | set(refs))
        if refs:
            manifest["refs"] = {f: int(c) for f, c in sorted(refs.items())}
        if deps:
            manifest["deps"] = {f: [int(x) for x in b]
                                for f, b in sorted(deps.items())}
        # blobs written through another store instance are not in the
        # cache: hash the file (a ref'd blob always is: a ref needs it)
        manifest["digests"] = {
            fname: cached.get(fname)
            or _hash_file(os.path.join(staging, fname))
            for fname in manifest["blobs"]}
        _atomic_write(os.path.join(staging, MANIFEST),
                      json.dumps(manifest, indent=1).encode())
        shutil.rmtree(final, ignore_errors=True)  # same-id re-commit
        os.replace(staging, final)
        with self._digest_lock:
            self._manifest_cache[ckpt_id] = manifest
        self.prune()
        return final

    def prune(self) -> None:
        # the sweep holds the per-root store lock: a concurrent restore
        # reading this root (load_states) holds the same lock for its whole
        # blob read, so retention never deletes a checkpoint mid-read
        with self._lock_of(self.root):
            done = self.completed_ids()
            # keep the last `retain` epochs PLUS the closure of every epoch
            # they reference or depend on: a delta chain's ancestor is
            # never dropped while a retained manifest resolves into it
            keep = set(done[-self.retain:])
            frontier = list(keep)
            while frontier:
                m = self._committed_manifest(frontier.pop())
                if m is None:
                    continue
                targets = {int(c) for c in (m.get("refs") or {}).values()}
                for bases in (m.get("deps") or {}).values():
                    targets.update(int(b) for b in bases)
                for t in targets - keep:
                    keep.add(t)
                    frontier.append(t)
            for cid in done:
                if cid not in keep:
                    shutil.rmtree(self._dirname(cid), ignore_errors=True)
                    with self._digest_lock:
                        self._manifest_cache.pop(cid, None)
            # staging debris older than the newest committed checkpoint can
            # never complete (its coordinator is gone)
            if done:
                for name in os.listdir(self.root):
                    if name.endswith(".inprogress"):
                        m = _CKPT_RE.match(name[:-len(".inprogress")])
                        if m and int(m.group(1)) <= done[-1]:
                            shutil.rmtree(os.path.join(self.root, name),
                                          ignore_errors=True)

    # -- reads -------------------------------------------------------------
    def completed_ids(self) -> List[int]:
        out = []
        try:
            names = os.listdir(self.root)
        except FileNotFoundError:
            return []
        for name in names:
            m = _CKPT_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name, MANIFEST)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        ids = self.completed_ids()
        return ids[-1] if ids else None

    def checkpoint_dir(self, ckpt_id: int) -> Optional[str]:
        """Directory holding a checkpoint's blobs: the committed dir when
        present, else the staging dir (diagnostics and tests only —
        restore goes through ``resolve`` and accepts committed checkpoints
        only)."""
        final = self._dirname(ckpt_id)
        if os.path.isdir(final):
            return final
        staging = self._dirname(ckpt_id, staging=True)
        return staging if os.path.isdir(staging) else None

    @staticmethod
    def load_manifest(ckpt_dir: str) -> Dict[str, Any]:
        path = os.path.join(ckpt_dir, MANIFEST)
        try:
            with open(path) as f:
                return json.load(f)
        except FileNotFoundError:
            raise
        except (ValueError, UnicodeDecodeError, OSError) as e:
            raise CorruptCheckpointError(
                f"checkpoint manifest {path}: undecodable "
                f"({type(e).__name__}: {e})") from e

    @staticmethod
    def load_blob(ckpt_dir: str, fname: str) -> Dict[str, Any]:
        with open(os.path.join(ckpt_dir, fname), "rb") as f:
            return pickle.load(f)

    @classmethod
    def resolve(cls, path: str) -> Tuple[int, str, Dict[str, Any]]:
        """Resolve a restore target: either one checkpoint directory (has a
        manifest) or a store root (picks the latest committed
        checkpoint). Returns ``(ckpt_id, dir, manifest)``."""
        if os.path.exists(os.path.join(path, MANIFEST)):
            manifest = cls.load_manifest(path)
            return int(manifest["ckpt_id"]), path, manifest
        store = cls(path)
        cid = store.latest()
        if cid is None:
            raise WindFlowError(
                f"restore_from={path!r}: no committed checkpoint found "
                "(expected a checkpoint directory with a manifest.json or "
                "a store root containing ckpt_* directories)")
        d = store._dirname(cid)
        return cid, d, cls.load_manifest(d)

    def load_states(self, ckpt_dir: str, manifest: Dict[str, Any]
                    ) -> Dict[Tuple[str, int], Any]:
        """All replica states of one checkpoint, keyed (op name, idx). The
        whole read holds the checkpoint root's store lock, so a concurrent
        ``prune`` cannot remove the blobs halfway through. Each blob is
        re-hashed against the manifest's digest BEFORE it is unpickled; a
        mismatch, a missing blob or an undecodable pickle raises
        ``CorruptCheckpointError`` naming the bad file.

        Incremental epochs restore transparently: a ref'd blob is read
        from the ancestor directory holding it, and a delta-form state is
        materialized against its base epoch's blob, so the caller always
        receives FULL states. A missing or corrupt ancestor anywhere in
        the chain raises ``CorruptCheckpointError``."""
        root = os.path.dirname(os.path.abspath(ckpt_dir)) or self.root
        out: Dict[Tuple[str, int], Any] = {}
        with self._lock_of(root):
            for fname in manifest.get("blobs", []):
                state, op, rep = self._load_state_chain(root, ckpt_dir,
                                                        manifest, fname)
                out[(op, rep)] = state
        return out

    def _load_state_chain(self, root: str, ckpt_dir: str,
                          manifest: Dict[str, Any], fname: str
                          ) -> Tuple[Any, str, int]:
        """One blob's FULL state: read from where it physically lies (its
        own directory or the ref'd ancestor's), then materialize a delta
        form against the base epochs' same-name blob (recursive; engine
        chains are one hop deep and a base is always a FULL snapshot)."""
        refs = manifest.get("refs") or {}
        blob_dir = ckpt_dir
        if fname in refs:
            blob_dir = os.path.join(root, f"ckpt_{int(refs[fname]):010d}")
        blob = self._read_blob_checked(
            blob_dir, fname, (manifest.get("digests") or {}).get(fname))
        state = blob["state"]
        bases = _delta.delta_bases(state)
        if bases:
            where = os.path.join(ckpt_dir, fname)
            base_states: Dict[int, Any] = {}
            for bcid in sorted(bases):
                bdir = os.path.join(root, f"ckpt_{int(bcid):010d}")
                try:
                    bman = self.load_manifest(bdir)
                except FileNotFoundError as e:
                    self.verify_failures += 1
                    raise CorruptCheckpointError(
                        f"checkpoint blob {where}: state delta references "
                        f"epoch {bcid}, whose manifest is missing "
                        "(ancestor pruned or lost) — the delta chain "
                        "cannot be materialized") from e
                base_states[bcid] = self._load_state_chain(
                    root, bdir, bman, fname)[0]
            try:
                state = _delta.materialize(state, base_states)
            except (ValueError, KeyError, IndexError, TypeError,
                    sqlite3.DatabaseError) as e:
                self.verify_failures += 1
                raise CorruptCheckpointError(
                    f"checkpoint blob {where}: delta materialization "
                    f"failed ({type(e).__name__}: {e})") from e
        return state, blob["op"], int(blob["replica"])

    def _read_blob_checked(self, blob_dir: str, fname: str,
                           want: Optional[str]) -> Dict[str, Any]:
        path = os.path.join(blob_dir, fname)
        if want is None:
            self.verify_failures += 1
            raise CorruptCheckpointError(
                f"checkpoint blob {path}: the manifest records no digest "
                "for it")
        try:
            got = _hash_file(path)
        except OSError as e:
            self.verify_failures += 1
            raise CorruptCheckpointError(
                f"checkpoint blob {path}: unreadable "
                f"({type(e).__name__}: {e})") from e
        if got != want:
            self.verify_failures += 1
            raise CorruptCheckpointError(
                f"checkpoint blob {path}: content digest mismatch "
                f"(manifest {want}, file {got}) — the blob is torn or "
                "corrupted on disk")
        try:
            return self.load_blob(blob_dir, fname)
        except Exception as e:
            # the digest matched, yet the pickle is undecodable: still
            # corruption
            self.verify_failures += 1
            raise CorruptCheckpointError(
                f"checkpoint blob {path}: undecodable "
                f"({type(e).__name__}: {e})") from e

    # -- integrity ---------------------------------------------------------
    def verify(self, ckpt_id: Optional[int] = None
               ) -> Dict[int, Dict[str, Any]]:
        """Offline integrity sweep: re-hash every blob of one (or every)
        committed checkpoint against its manifest, WITHOUT unpickling
        anything. Returns ``{ckpt_id: {"ok", "problems", "blobs", "bytes",
        "digested"}}``; never raises on corruption, so a damaged store can
        be surveyed in one call. Incremental epochs are checked over their
        transitive closure: a ref'd blob is hashed where it lies, and a
        delta blob's base epoch is verified for the same blob name, so one
        corrupt ancestor flags every epoch whose chain passes through it."""
        ids = [ckpt_id] if ckpt_id is not None else self.completed_ids()
        report: Dict[int, Dict[str, Any]] = {}
        memo: Dict[Tuple[int, str], List[str]] = {}
        manifests: Dict[int, Any] = {}
        with self._lock_of(self.root):
            for cid in ids:
                manifest = self._verify_manifest_of(cid, manifests)
                if isinstance(manifest, str):  # the load error
                    report[cid] = {"ok": False, "problems": [manifest],
                                   "blobs": 0, "bytes": 0,
                                   "digested": False}
                    continue
                problems: List[str] = []
                nbytes = 0
                for fname in manifest.get("blobs", []):
                    probs, size = self._verify_blob_closure(
                        cid, fname, memo, manifests)
                    problems.extend(probs)
                    nbytes += size
                report[cid] = {"ok": not problems, "problems": problems,
                               "blobs": len(manifest.get("blobs", [])),
                               "bytes": nbytes,
                               "digested": bool(manifest.get("digests"))}
        return report

    def _verify_manifest_of(self, cid: int, manifests: Dict[int, Any]):
        """A manifest, or its load error as a string (once per sweep)."""
        if cid not in manifests:
            try:
                manifests[cid] = self.load_manifest(self._dirname(cid))
            except (FileNotFoundError, CorruptCheckpointError) as e:
                manifests[cid] = str(e)
        return manifests[cid]

    def _verify_blob_closure(self, cid: int, fname: str,
                             memo: Dict[Tuple[int, str], List[str]],
                             manifests: Dict[int, Any]
                             ) -> Tuple[List[str], int]:
        """Problems of one blob AND of everything it refs or depends on,
        with shared ancestors hashed once per sweep (``memo``). Returns
        (problems, the blob's physical bytes)."""
        key = (cid, fname)
        if key in memo:
            return memo[key], 0
        memo[key] = probs = []
        manifest = self._verify_manifest_of(cid, manifests)
        if isinstance(manifest, str):
            probs.append(f"{fname}: epoch {cid}: {manifest}")
            return probs, 0
        phys_cid = int((manifest.get("refs") or {}).get(fname, cid))
        path = os.path.join(self._dirname(phys_cid), fname)
        nbytes = 0
        got = None
        try:
            nbytes = os.path.getsize(path)
            got = _hash_file(path)
        except OSError as e:
            probs.append(f"{fname}: unreadable ({type(e).__name__}: {e})")
        want = (manifest.get("digests") or {}).get(fname)
        if want is not None and got is not None and got != want:
            probs.append(f"{fname}: digest mismatch "
                         f"(manifest {want}, file {got})")
        for bcid in (manifest.get("deps") or {}).get(fname, []):
            sub, _ = self._verify_blob_closure(int(bcid), fname, memo,
                                               manifests)
            for p in sub:
                tail = p[len(fname) + 2:] if p.startswith(fname) else p
                probs.append(f"{fname}: delta base epoch {bcid}: {tail}")
        return probs, nbytes

    def quarantine(self, ckpt_id: int) -> Optional[str]:
        """Move a corrupt committed checkpoint out of the restore set by
        renaming ``ckpt_N`` to ``ckpt_N.corrupt`` (no longer a checkpoint
        name, so ``completed_ids``/``latest`` skip it; the data is kept for
        post-mortem). Returns the quarantine path, or None when the
        directory is already gone."""
        with self._lock_of(self.root):
            d = self._dirname(ckpt_id)
            if not os.path.isdir(d):
                return None
            dst = d + ".corrupt"
            shutil.rmtree(dst, ignore_errors=True)
            try:
                os.replace(d, dst)
            except OSError:
                # a rename that fails must not leave the checkpoint in
                # the restore set
                shutil.rmtree(d, ignore_errors=True)
                return None
            return dst
