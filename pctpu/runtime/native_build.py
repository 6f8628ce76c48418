"""Builds the repository's C++ sources on first use, keyed on their content.

Each output's file name carries a hash of its source and compiler command,
so a binary left over from an older source, or copied in from another
checkout with a newer timestamp, is never picked up: a changed source gets
a new name and is rebuilt.  Outputs go to ``<checkout>/build/native/``
(listed in ``.gitignore``).
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD_DIR = os.path.join(_REPO, "build", "native")


def native_source(name: str) -> str:
    """Path of ``native/<name>`` in this checkout."""
    return os.path.join(_REPO, "native", name)


def build(src: str, flags: list[str], libs: list[str] = (),
          shared: bool = True) -> str:
    """Path of ``src`` compiled by g++ with ``flags`` (as a shared library
    when ``shared``, else an executable) and linked with ``libs``, building
    it if no output for this exact source and command exists yet.  Raises
    ``subprocess.CalledProcessError`` (with g++'s stderr) on a failed
    build."""
    kind = ["-shared", "-fPIC"] if shared else []
    cmd = ["g++", *flags, *kind]
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + "\0".join(cmd + list(libs)).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    out = os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}"
                       + (".so" if shared else ""))
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build to a temporary name and rename: concurrent processes must
        # never load a half-written file (rename is atomic on POSIX)
        tmp = f"{out}.build.{os.getpid()}"
        subprocess.run([*cmd, "-o", tmp, src, *libs], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    return out
