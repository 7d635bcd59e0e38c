"""DBHandle: durable keyed state on sqlite, one database file per owner.

The port's copy of ``windflow_tpu/persistent/db_handle.py`` (parity:
``wf/persistent/db_handle.hpp:54-345``; the reference opens one RocksDB
instance per replica, here sqlite3 from the standard library gives the
same embedded ordered key-value store: one file per replica, one ``kv``
table, WAL mode). Keys are pickled; values go through the owner's
``serialize`` / ``deserialize`` (pickle by default). A side table holds
the exactly-once sink's 2PC markers (``meta_get`` / ``meta_put``), so an
epoch marker and its data commit in one sqlite transaction. The tier
plane's cold store and the persistent operators share the class.

The default directory is a per-process folder under the system's temp
directory; the JAX package's ``WF_DB_DIR`` is the ``db_dir`` argument
(``with_db_path`` on the persistent builders).
"""

from __future__ import annotations

import os
import pickle
import sqlite3
import tempfile
from typing import Any, Callable, Iterator, Optional, Tuple


def default_db_dir() -> str:
    """Reference: path per pid (``db_handle.hpp:87``)."""
    d = os.path.join(tempfile.gettempdir(),
                     f"windflow_tpu_torch_db_{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    return d


class DBHandle:
    def __init__(self, name: str,
                 serialize: Optional[Callable[[Any], bytes]] = None,
                 deserialize: Optional[Callable[[bytes], Any]] = None,
                 db_dir: Optional[str] = None,
                 shared: bool = False) -> None:
        if db_dir is not None:
            os.makedirs(db_dir, exist_ok=True)
        self.path = os.path.join(db_dir or default_db_dir(), f"{name}.db")
        self._ser = serialize or pickle.dumps
        self._de = deserialize or pickle.loads
        # handles are built on the main thread and then used by exactly one
        # worker thread; sqlite's same-thread guard must not apply
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)")
        self._conn.commit()

    def _kbytes(self, key: Any) -> bytes:
        return pickle.dumps(key)

    def get(self, key: Any, default: Any = None) -> Any:
        row = self._conn.execute("SELECT v FROM kv WHERE k = ?",
                                 (self._kbytes(key),)).fetchone()
        if row is None:
            return default
        return self._de(row[0])

    def put(self, key: Any, value: Any) -> None:
        self._conn.execute(
            "INSERT INTO kv (k, v) VALUES (?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
            (self._kbytes(key), self._ser(value)))

    def put_many(self, items) -> None:
        """Batched upsert (one executemany) — the tiered cold store's
        demote path writes whole victim batches, never one row at a
        time."""
        self._conn.executemany(
            "INSERT INTO kv (k, v) VALUES (?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
            [(self._kbytes(k), self._ser(v)) for k, v in items])

    def delete(self, key: Any) -> None:
        self._conn.execute("DELETE FROM kv WHERE k = ?", (self._kbytes(key),))

    def delete_many(self, keys) -> None:
        self._conn.executemany("DELETE FROM kv WHERE k = ?",
                               [(self._kbytes(k),) for k in keys])

    def clear(self) -> None:
        """Drop every row (a fresh owner claiming a reused db path must
        not inherit a previous run's state)."""
        self._conn.execute("DELETE FROM kv")
        self._conn.commit()

    def contains(self, key: Any) -> bool:
        return self._conn.execute("SELECT 1 FROM kv WHERE k = ?",
                                  (self._kbytes(key),)).fetchone() is not None

    def items(self) -> Iterator[Tuple[Any, Any]]:
        for k, v in self._conn.execute("SELECT k, v FROM kv"):
            yield pickle.loads(k), self._de(v)

    def keys(self):
        for k, in self._conn.execute("SELECT k FROM kv"):
            yield pickle.loads(k)

    def __len__(self) -> int:
        return self._conn.execute("SELECT COUNT(*) FROM kv").fetchone()[0]

    # -- transaction metadata (exactly-once sinks) -------------------------
    # One tiny side table holds the 2PC bookkeeping INSIDE the same
    # database file, so an epoch marker and its data commit in one sqlite
    # transaction and snapshot/restore carries both: 'fence' (replica
    # generation — stale writers are refused), 'epoch' (last pre-committed
    # epoch) and 'finalized' (last epoch the coordinator finalized).
    def _ensure_meta(self) -> None:
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS wf_txn (k TEXT PRIMARY KEY, v INTEGER)")

    def meta_get(self, key: str) -> Optional[int]:
        self._ensure_meta()
        row = self._conn.execute("SELECT v FROM wf_txn WHERE k = ?",
                                 (key,)).fetchone()
        return None if row is None else int(row[0])

    def meta_put(self, key: str, value: int) -> None:
        self._ensure_meta()
        self._conn.execute(
            "INSERT INTO wf_txn (k, v) VALUES (?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v = excluded.v", (key, int(value)))

    def commit(self) -> None:
        """Durable, atomic commit of all pending puts/deletes.

        The transaction itself was always atomic (sqlite journal), but the
        original in-place flow left committed rows in the ``-wal`` side
        file until some later automatic checkpoint: a crash that lost or
        orphaned the WAL (or any backup/copy of just the ``.db`` file)
        silently dropped the last commits. ``commit()`` now folds the WAL
        into the main database through sqlite's atomic checkpoint
        protocol, so after it returns the ``.db`` file alone is a
        complete, self-contained image of the committed state."""
        self._conn.commit()
        try:
            self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        except sqlite3.DatabaseError:  # pragma: no cover - locked reader
            pass

    def close(self) -> None:
        self.commit()
        self._conn.close()

    # -- checkpointing (windflow_tpu.checkpoint) ---------------------------
    def snapshot_bytes(self) -> bytes:
        """Consistent point-in-time image of the whole database (sqlite
        online backup of the live connection), as bytes for a checkpoint
        blob. Pending writes are committed first."""
        self._conn.commit()
        fd, tmp = tempfile.mkstemp(suffix=".snap",
                                   dir=os.path.dirname(self.path) or ".")
        os.close(fd)
        try:
            dst = sqlite3.connect(tmp)
            try:
                self._conn.backup(dst)
            finally:
                dst.close()
            with open(tmp, "rb") as f:
                return f.read()
        finally:
            os.unlink(tmp)

    def restore_bytes(self, data: bytes) -> None:
        """Replace the database's entire contents with a ``snapshot_bytes``
        image (crash recovery: the on-disk file may hold post-checkpoint
        writes from the crashed run). Staged via temp file + atomic rename
        so a crash mid-restore cannot leave a torn image behind."""
        tmp = self.path + ".restore.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        final = self.path + ".restore"
        os.replace(tmp, final)
        # the backup destination must hold no open transaction
        self._conn.commit()
        try:
            src = sqlite3.connect(final)
            try:
                src.backup(self._conn)
            finally:
                src.close()
            self.commit()
        finally:
            os.unlink(final)

    def export_to(self, path: str) -> None:
        """Write a standalone copy of the database to ``path`` via temp
        file + atomic rename: readers of ``path`` see either the previous
        complete export or the new one, never a torn file."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self.snapshot_bytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
