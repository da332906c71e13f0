"""Clean twin: the three sanctioned write idioms."""

import json
import os
import tempfile


def publish(path, payload):
    # tmp-file + os.replace: readers only ever see whole files
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def acquire_lock(path):
    # O_EXCL create: exactly one winner, fd-based (never a raw open())
    return os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)


def append_event(path, line):
    # append-only fsync'd log: replay skips torn trailing lines
    with open(path, "a") as f:
        f.write(line + "\n")
        f.flush()
        os.fsync(f.fileno())
