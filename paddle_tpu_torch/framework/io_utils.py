"""``paddle.save`` / ``paddle.load`` (counterpart of
paddle_tpu/framework/io_utils.py).

The JAX package pickles a nested structure whose tensors became numpy
arrays.  Here the structure is written by ``torch.save`` with its tensors
copied to the host, and read back with ``torch.load(weights_only=True)``:
tensors, numbers, strings and the containers load, and no pickled
callable can run.  Writes go to a temporary file in the same directory,
are flushed to disk and renamed over the target (``atomic_write``), so a
crash leaves the old file or the new one, never a torn one.
``async_save=True`` takes the host copy at once and writes on a thread;
``wait_async_save()`` joins the writes and raises the first failure.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

__all__ = ["save", "load", "wait_async_save", "atomic_write"]


@contextlib.contextmanager
def atomic_write(path, mode: str = "wb"):
    """A handle on a temporary file beside ``path``, renamed over it once
    the block ends without an error (and removed if it raises)."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    f = open(tmp, mode)
    try:
        yield f
        f.flush()
        os.fsync(f.fileno())
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_to_host(v) for v in obj]
        return out if isinstance(obj, list) else tuple(out)
    return obj


_async_saves: list = []  # (thread, path, error box)
_locks: dict = {}
_locks_guard = threading.Lock()


def _lock_for(path):
    with _locks_guard:
        return _locks.setdefault(os.path.abspath(path), threading.Lock())


def save(obj, path, protocol=4, async_save=False, **configs):
    """``paddle.save``: ``obj`` (a state dict, or any nesting of dicts,
    lists and tuples of tensors and plain values) to ``path``.  ``protocol``
    is accepted for the reference's signature; torch's own pickle protocol
    is used, the one ``torch.load(weights_only=True)`` reads."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    host = _to_host(obj)  # the snapshot: later changes to the tensors are not saved

    def write():
        with _lock_for(path), atomic_write(path) as f:
            torch.save(host, f)  # torch's protocol: the weights-only reader takes it

    if not async_save:
        write()
        return None
    err: list = []

    def guarded():
        try:
            write()
        except BaseException as e:  # raised again by wait_async_save
            err.append(e)

    t = threading.Thread(target=guarded, name=f"paddle_tpu_torch save {os.path.basename(path)}")
    t.start()
    _async_saves.append((t, path, err))
    return t


def wait_async_save():
    """Join every pending ``async_save`` write; raise the first failure."""
    global _async_saves
    pending, _async_saves = _async_saves, []
    failed = None
    for t, path, err in pending:
        t.join()
        if err and failed is None:
            failed = (path, err[0])
    if failed is not None:
        raise RuntimeError(f"async save to {failed[0]!r} failed") from failed[1]


def load(path, return_numpy=False, **configs):
    """``paddle.load``: what ``save`` wrote, its tensors on the host (numpy
    arrays with ``return_numpy``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not return_numpy:
        return obj

    def to_numpy(o):
        if isinstance(o, torch.Tensor):
            return (o.float() if o.dtype == torch.bfloat16 else o).numpy()
        if isinstance(o, dict):
            return {k: to_numpy(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            out = [to_numpy(v) for v in o]
            return out if isinstance(o, list) else tuple(out)
        return o

    return to_numpy(obj)
