"""Build the native ingest shared library from ``_ingest.cpp``:

    python -m coolpuppy_tpu.native.build

The package also builds it on first import (see ``__init__.py``). The
library is a build output, listed in ``.gitignore``."""

import fcntl
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "_ingest.cpp")
OUT = os.path.join(HERE, "_ingest.so")
LOCK = os.path.join(HERE, ".build.lock")


def up_to_date():
    return os.path.exists(OUT) and (
        os.path.getmtime(OUT) >= os.path.getmtime(SRC)
    )


def build(verbose=True):
    """Compile into a temporary file and move it into place, so a
    concurrent reader never loads a half-written library."""
    tmp = f"{OUT}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", SRC, "-o", tmp]
    if verbose:
        print(" ".join(cmd), file=sys.stderr)
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(tmp, OUT)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return OUT


def ensure_built():
    """Build the library unless an up-to-date one exists; one process
    builds while others wait on the lock. Returns True when it exists."""
    if up_to_date():
        return True
    with open(LOCK, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not up_to_date():
            build(verbose=False)
    return True


if __name__ == "__main__":
    build()
    print(f"built {OUT}", file=sys.stderr)
