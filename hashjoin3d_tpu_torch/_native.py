"""Build a shared library from the repository's own sources at first use.

Libraries land in ``hashjoin3d_tpu_torch/_build/`` (listed in .gitignore)
under a name derived from the compiler command and the sources' contents, so
an edited source rebuilds and concurrent builds (test workers) never load a
half-written file: each compiles to a private temporary name and renames it
into place.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def build_library(cmd: list[str], sources: list[Path], stem: str) -> Path:
    """Compile ``sources`` with ``cmd`` (compiler and flags, without ``-o``)
    into ``_build/lib<stem>-<hash>.so`` unless it exists; return its path.
    A failed compile raises with the compiler's output."""
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    r = subprocess.run([*cmd, "-o", str(tmp), *map(str, sources)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {out.name} failed: {' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out
