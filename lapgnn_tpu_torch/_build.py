"""Build a shared library from one source file of the repository at first use.

Kernels (``nvcc``) and the native host solver (``g++``) compile into
``build/`` at the repository root, which ``.gitignore`` lists.  The file name
carries a hash of the source and the command, so an edited source rebuilds
and a stale library is never loaded.  Several processes may build at once
(pytest workers): each writes a PID-unique temporary file and renames it into
place, so no process ever loads a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, List, Optional, Sequence

__all__ = ["BUILD_DIR", "BuildError", "SharedLibrary"]

BUILD_DIR = Path(__file__).resolve().parent.parent / "build"


class BuildError(RuntimeError):
    pass


class SharedLibrary:
    """One source file -> one ``.so``, built and loaded once per process.

    ``command`` is called at build time (not at import) and returns the
    compiler invocation without the output and source arguments, so a
    missing compiler only matters to a caller that needs the library.
    ``bind`` sets ``argtypes``/``restype`` on the loaded library; ``deps``
    are the headers the source includes, hashed with it.  ``load``
    may be called from several threads at once; the compiler runs outside
    the GIL, so libraries loaded from separate threads build in parallel.
    """

    def __init__(
        self,
        source: Path,
        subdir: str,
        command: Callable[[], List[str]],
        bind: Callable[[ctypes.CDLL], None],
        deps: Sequence[Path] = (),
    ):
        self.source = Path(source)
        self.deps = [Path(d) for d in deps]
        self.subdir = subdir
        self._command = command
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.path: Optional[Path] = None

    def _build(self) -> Path:
        """Compile unless the library exists; return its path.  The
        compiler's output (for ``nvcc -Xptxas -v``: registers, shared memory
        and spills of each kernel) is kept beside the library as ``.log``."""
        cmd = self._command()
        key = b"".join(p.read_bytes() for p in [self.source, *self.deps]) + "\0".join(cmd).encode()
        tag = hashlib.sha256(key).hexdigest()[:16]
        out = BUILD_DIR / self.subdir / f"lib{self.source.stem}_{tag}.so"
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
        res = subprocess.run(
            cmd + ["-o", str(tmp), str(self.source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if res.returncode != 0:
            raise BuildError(
                f"building {self.source.name} failed (exit {res.returncode}):\n{res.stdout}"
            )
        out.with_suffix(".log").write_text(res.stdout)
        tmp.replace(out)
        return out

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            with self._lock:
                if self._lib is None:
                    path = self._build()
                    lib = ctypes.CDLL(str(path))
                    self._bind(lib)
                    self.path = path
                    self._lib = lib
        return self._lib
