"""Safe writes to files that several processes share (capture files and
stage artifacts under one cache directory): a reader sees either no file
or a complete one, and one writer at a time builds it."""

from __future__ import annotations

import contextlib
import fcntl
import os


@contextlib.contextmanager
def file_lock(path: str):
    """Hold an exclusive advisory lock on `path + ".lock"` for the block."""
    with open(path + ".lock", "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


@contextlib.contextmanager
def atomic_write(path: str):
    """Yield a binary file object that replaces `path` only once the block
    completes; on error the partial file is removed."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            yield f
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
