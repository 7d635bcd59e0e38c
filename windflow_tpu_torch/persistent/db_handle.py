"""DBHandle: an embedded keyed store on sqlite, one database file per
owner.

Trimmed copy of ``windflow_tpu/persistent/db_handle.py`` (parity:
``wf/persistent/db_handle.hpp:54-345``, RocksDB there): the batched
upserts and deletes, iteration, and the online-backup image the tier
plane's cold store checkpoints through. Keys and values are pickled.
The default directory is a per-process folder under the system's temp
directory; the port reads no environment variable of its own.
"""

from __future__ import annotations

import os
import pickle
import sqlite3
import tempfile
from typing import Any, Iterator, Optional, Tuple


def default_db_dir() -> str:
    """Reference: path per pid (``db_handle.hpp:87``)."""
    d = os.path.join(tempfile.gettempdir(),
                     f"windflow_tpu_torch_db_{os.getpid()}")
    os.makedirs(d, exist_ok=True)
    return d


class DBHandle:
    def __init__(self, name: str, db_dir: Optional[str] = None) -> None:
        if db_dir is not None:
            os.makedirs(db_dir, exist_ok=True)
        self.path = os.path.join(db_dir or default_db_dir(), f"{name}.db")
        # built on the main thread, then used by exactly one worker
        # thread: sqlite's same-thread guard must not apply
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)")
        self._conn.commit()

    @staticmethod
    def _kbytes(key: Any) -> bytes:
        return pickle.dumps(key)

    def get(self, key: Any, default: Any = None) -> Any:
        row = self._conn.execute("SELECT v FROM kv WHERE k = ?",
                                 (self._kbytes(key),)).fetchone()
        return default if row is None else pickle.loads(row[0])

    def put_many(self, items) -> None:
        """Batched upsert (one executemany): the cold store writes whole
        victim batches, never one row at a time."""
        self._conn.executemany(
            "INSERT INTO kv (k, v) VALUES (?, ?) "
            "ON CONFLICT(k) DO UPDATE SET v = excluded.v",
            [(self._kbytes(k), pickle.dumps(v)) for k, v in items])

    def delete_many(self, keys) -> None:
        self._conn.executemany("DELETE FROM kv WHERE k = ?",
                               [(self._kbytes(k),) for k in keys])

    def clear(self) -> None:
        """Drop every row (a fresh owner claiming a reused path must not
        inherit a previous run's state)."""
        self._conn.execute("DELETE FROM kv")
        self._conn.commit()

    def items(self) -> Iterator[Tuple[Any, Any]]:
        for k, v in self._conn.execute("SELECT k, v FROM kv"):
            yield pickle.loads(k), pickle.loads(v)

    def __len__(self) -> int:
        return self._conn.execute("SELECT COUNT(*) FROM kv").fetchone()[0]

    def commit(self) -> None:
        """Commit pending writes and fold sqlite's WAL into the database
        file, so the ``.db`` file alone holds the committed state."""
        self._conn.commit()
        try:
            self._conn.execute("PRAGMA wal_checkpoint(TRUNCATE)")
        except sqlite3.DatabaseError:  # pragma: no cover - locked reader
            pass

    def close(self) -> None:
        self.commit()
        self._conn.close()

    def snapshot_bytes(self) -> bytes:
        """Point-in-time image of the whole database (sqlite online backup
        of the live connection), pending writes committed first."""
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
        """Replace the database's contents with a ``snapshot_bytes`` image,
        staged through a temp file and an atomic rename."""
        tmp = self.path + ".restore.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        final = self.path + ".restore"
        os.replace(tmp, final)
        self._conn.commit()  # the backup target holds no open transaction
        try:
            src = sqlite3.connect(final)
            try:
                src.backup(self._conn)
            finally:
                src.close()
            self.commit()
        finally:
            os.unlink(final)
