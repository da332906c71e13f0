"""Shared artifact store: the campaign trace cache, for many writers.

A store is a directory of ``<key>.json`` artifacts.  On top of that layout
:class:`ArtifactStore` gives what concurrent writers — worker processes,
threads of one campaign, or two campaign invocations sharing a directory —
need:

  * **write-if-absent** puts: exactly one writer of a key wins and every
    other is told so (it re-reads the winner's bytes instead of
    clobbering), so artifacts stay byte-identical across racers;
  * **advisory write locks** (``O_EXCL`` lockfiles), so a worker about to
    spend seconds computing a key can find another already doing it and
    wait for its artifact instead of computing it twice;
  * stale-lock breaking (lockfile mtime beyond a TTL), so a crashed writer
    never wedges a key.

``put`` publishes a complete temp file with ``os.link``, which fails with
``EEXIST`` when the key exists: of any number of racers exactly one link
succeeds.  (Checking for the key and then renaming over it, as the JAX
package's store does, lets two racers both report a win.)

Layout inside one store directory::

    <root>/<key>.json        per-job artifacts
    <root>/<key>.json.lock   advisory write locks (transient)
    <root>/ledger.jsonl      job ledger (repro_torch.cluster.ledger)
    <root>/ledger.lock       ledger mutation lock
    <root>/leases/<key>.json live lease records; mtime == last heartbeat
    <root>/campaign.json     campaign manifest for
                             ``python -m repro_torch worker``

Stdlib-only: campaign planning and ``--status`` load no kernel library.
Every read of the time goes through this module's ``time``.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

# A writer that holds a key lock longer than this without producing the
# artifact is presumed dead; contenders break the lock and recompute.
DEFAULT_LOCK_STALE_S = 600.0


class ArtifactStore:
    """Content-hash-keyed JSON artifact directory, safe for concurrent
    writers across threads, processes, and separate invocations."""

    def __init__(self, root: str, *,
                 lock_stale_s: float = DEFAULT_LOCK_STALE_S):
        self.root = str(root)
        self.lock_stale_s = float(lock_stale_s)
        os.makedirs(self.root, exist_ok=True)

    # -- paths ---------------------------------------------------------
    def path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def _lock_path(self, key: str) -> str:
        return self.path(key) + ".lock"

    @property
    def lease_dir(self) -> str:
        return os.path.join(self.root, "leases")

    @property
    def ledger_path(self) -> str:
        return os.path.join(self.root, "ledger.jsonl")

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, "campaign.json")

    # -- artifacts -----------------------------------------------------
    def exists(self, key: str) -> bool:
        return os.path.exists(self.path(key))

    def load(self, key: str):
        """The artifact dict, or None if absent (never a partial: a key
        appears only as a complete file)."""
        try:
            with open(self.path(key)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def put(self, key: str, artifact: dict) -> bool:
        """Atomic write-if-absent.  Returns True when this call's bytes
        became the artifact, False when another writer already won — the
        caller should :meth:`load` the canonical copy.  Serialization is
        compact ``json.dump`` in insertion order, so thread- and
        process-scheduler artifacts stay byte-identical."""
        path = self.path(key)
        if os.path.exists(path):
            return False
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(artifact, f, default=repr)
            try:
                os.link(tmp, path)       # atomic publish, fails if present
            except FileExistsError:
                return False
            return True
        finally:
            os.unlink(tmp)

    def wait_for(self, key: str, *, timeout_s: float,
                 poll_s: float = 0.05):
        """Poll for another writer's artifact; None on timeout (caller
        should then compute the key itself — ``put`` stays clobber-safe).
        Returns early if the contended write lock disappears without an
        artifact (the other writer failed)."""
        deadline = time.monotonic() + timeout_s
        lock = self._lock_path(key)
        while time.monotonic() < deadline:
            art = self.load(key)
            if art is not None:
                return art
            if not os.path.exists(lock):
                return self.load(key)    # writer gone; one last look
            time.sleep(poll_s)
        return self.load(key)

    # -- advisory write locks ------------------------------------------
    def acquire_write_lock(self, key: str, owner: str) -> bool:
        """O_EXCL lockfile; True if acquired.  A stale lock (holder died
        mid-compute) is broken and re-contended once."""
        path = self._lock_path(key)
        for _ in range(2):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if not self._break_if_stale(path):
                    return False
                continue
            now = time.time()
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps({"owner": owner, "pid": os.getpid(),
                                    "t": now}))
            os.utime(path, (now, now))
            return True
        return False

    def release_write_lock(self, key: str) -> None:
        try:
            os.unlink(self._lock_path(key))
        except FileNotFoundError:
            pass

    def _break_if_stale(self, lock_path: str) -> bool:
        try:
            age = time.time() - os.stat(lock_path).st_mtime
        except FileNotFoundError:
            return True                  # holder released between checks
        if age <= self.lock_stale_s:
            return False
        try:
            os.unlink(lock_path)
        except FileNotFoundError:
            pass
        return True

    # -- manifest ------------------------------------------------------
    def write_manifest(self, manifest: dict) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(manifest, f, indent=2, sort_keys=True)
            os.replace(tmp, self.manifest_path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def read_manifest(self) -> dict:
        with open(self.manifest_path) as f:
            return json.load(f)
