"""Build the CUDA sources under `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface, at first use, into the repository's
`build/kernels/` directory (git-ignored), cached by a hash of the source
and the flags.  Nothing here includes PyTorch's headers, so a build takes
seconds.  `build_all` starts one `nvcc` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, then the toolkit's usual
    place, then the one on PATH."""
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    return found


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: keyed by source and flags."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]


def _start(name: str) -> tuple[Path, subprocess.Popen | None, Path]:
    """Start compiling `name` unless its library is cached.  The compiler
    writes to a temporary name that is renamed into place when it
    succeeds, so a cut build never leaves a library behind."""
    out = library_path(name)
    if out.exists():
        return out, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    with open(out.with_suffix(".log"), "w") as f:
        proc = subprocess.Popen(
            nvcc_command(find_nvcc(), CSRC / f"{name}.cu", tmp),
            stdout=f, stderr=subprocess.STDOUT)
    return out, proc, tmp


def _finish(name: str, out: Path, proc: subprocess.Popen | None,
            tmp: Path) -> Path:
    if proc is None:
        return out
    rc = proc.wait()
    log = out.with_suffix(".log")
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (rc {rc}):\n"
                           f"{log.read_text()[-4000:]}")
    os.replace(tmp, out)
    return out


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Build every named source (default: all of `csrc/*.cu`) in parallel;
    returns {name: library path}.  The compiler's report (`-Xptxas -v`:
    registers, shared memory, spills) is in the `.log` beside each."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _loaded[name] = lib
        return lib
