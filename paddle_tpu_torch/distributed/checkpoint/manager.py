"""The atomic commit protocol of the checkpoint manager (the part of
paddle_tpu/distributed/checkpoint/manager.py that live-engine snapshots
need, ``serving/snapshot.py``).

``commit_dir(base_dir, "step_XXXXXXXX", writer)``:
  1. a hidden ``_tmp_step_XXXXXXXX.{pid}`` directory is made;
  2. ``writer(tmp)`` writes and fsyncs the payload files and returns the
     bytes it wrote;
  3. ``MANIFEST.json`` (each file's sha256 and size) is written last and
     fsynced;
  4. an existing step directory of the same name is renamed aside;
  5. one atomic ``os.rename(tmp, final)`` commits, then the parent
     directory is fsynced and the displaced directory deleted.
A crash at any point leaves every committed step intact; an uncommitted
temp directory is invisible to readers and swept by ``sweep_stale_tmp``
once its process is dead; a committed directory damaged afterwards fails
``_verify_manifest``.

Still to port (ROADMAP.md A.6): ``CheckpointManager`` itself (retention,
async saves, auto-resume, its preemption handler), the sharded tensor
store it writes, and the ``FLAGS_checkpoint_kill_point`` SIGKILL matrix
(``_maybe_kill``) that proves the protocol crash-consistent.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

__all__ = ["commit_dir", "sweep_stale_tmp", "write_fsynced"]

_MANIFEST = "MANIFEST.json"
_STEP_RE = re.compile(r"^step_(\d{8})$")
_TMP_RE = re.compile(r"^_(?:tmp|old)_step_\d{8}\.(\d+)$")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_fsynced(path: str, fill) -> int:
    """Write a file with ``fill(f)`` on its binary handle, flush and fsync
    it.  Returns its size."""
    with open(path, "wb") as f:
        fill(f)
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(path)


def commit_dir(base_dir, final_name, writer, manifest_extra=None):
    """The atomic commit (module docstring).  ``final_name`` must be
    step-tagged (``step_XXXXXXXX``), so that a crash's leftovers match the
    sweep's pattern.  Returns ``(final_path, bytes_written)``."""
    if not _STEP_RE.match(final_name):
        raise ValueError(f"commit_dir final_name must be step-tagged (step_XXXXXXXX, "
                         f"sweepable after a crash): got {final_name!r}")
    tmp = os.path.join(base_dir, f"_tmp_{final_name}.{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    written = writer(tmp)

    manifest = {
        "format": 1,
        "files": {name: {"sha256": _sha256_file(os.path.join(tmp, name)),
                         "size": os.path.getsize(os.path.join(tmp, name))}
                  for name in sorted(os.listdir(tmp))},
    }
    if manifest_extra:
        manifest.update(manifest_extra)
    data = json.dumps(manifest, indent=1, sort_keys=True).encode()
    written += write_fsynced(os.path.join(tmp, _MANIFEST), lambda f: f.write(data))

    final = os.path.join(base_dir, final_name)
    displaced = None
    if os.path.exists(final):  # a step saved again
        displaced = os.path.join(base_dir, f"_old_{final_name}.{os.getpid()}")
        shutil.rmtree(displaced, ignore_errors=True)
        os.rename(final, displaced)
    os.rename(tmp, final)  # the commit point: atomic within one file system
    _fsync_dir(base_dir)
    if displaced is not None:
        shutil.rmtree(displaced, ignore_errors=True)
    return final, written


def _verify_manifest(path: str, mpath: str) -> bool:
    """Does every file the manifest lists have its size and sha256?  A
    torn or unparsable manifest, or a missing file, is False."""
    try:
        with open(mpath) as f:
            files = json.load(f)["files"]
    except (OSError, ValueError, KeyError):
        return False
    for name, rec in files.items():
        fpath = os.path.join(path, name)
        try:
            if os.path.getsize(fpath) != rec["size"] or _sha256_file(fpath) != rec["sha256"]:
                return False
        except (OSError, KeyError):
            return False
    return True


def sweep_stale_tmp(base_dir) -> int:
    """Delete the ``_tmp_*`` / ``_old_*`` directories whose process is dead
    (a killed process leaves at most its write in flight; committed steps
    are never touched).  Returns how many were swept."""
    swept = 0
    for name in os.listdir(base_dir):
        m = _TMP_RE.match(name)
        if not m:
            continue
        pid = int(m.group(1))
        if pid == os.getpid():
            continue  # possibly this process's own write in flight
        try:
            os.kill(pid, 0)
            continue  # its owner is alive
        except ProcessLookupError:
            pass
        except OSError:
            continue  # EPERM: alive under another user
        shutil.rmtree(os.path.join(base_dir, name), ignore_errors=True)
        swept += 1
    return swept
