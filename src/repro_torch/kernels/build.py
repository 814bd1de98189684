"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles alone with
``nvcc`` for ``sm_90a`` into a shared library (no PyTorch headers, so a
build takes seconds); the sources share device helpers through
``csrc/*.cuh``.  Libraries go to ``build/repro_torch/`` at the root of
the checkout, named by a hash of the source, the headers and the flags,
so a stale library is never loaded.  ``build_all`` starts one ``nvcc`` per
source, all at once; a source of ``PARTS`` compiles as several parts at
once (``-DBUILD_PART=<i>``, each an object) linked into its one library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# sources compiled in parts, each with -DBUILD_PART=<i>, one part a dtype:
# the longest compiles of the build on an H100's host, 33-43 s of nvcc
# whole (tools/build_times.py)
PARTS = {"decode_attention": 2, "paged_decode_attention": 2,
         "ssm_scan_bwd": 2}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers of ``csrc`` and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    flags = " ".join(NVCC_FLAGS) + f" parts={PARTS.get(name, 1)}"
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source (each of its parts) into temporary
    files; None if the library for this exact source is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    src = str(CSRC / f"{name}.cu")
    n = PARTS.get(name, 1)
    if n == 1:
        objs, cmds = [], [[nvcc(), *NVCC_FLAGS, "-o", str(tmp), src]]
    else:
        objs = [out.with_suffix(f".{os.getpid()}.{i}.o") for i in range(n)]
        flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[nvcc(), *flags, "-c", f"-DBUILD_PART={i}", "-o", str(o), src]
                for i, o in enumerate(objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    return procs, objs, tmp, out


def _finish(name: str, started) -> str:
    procs, objs, tmp, out = started
    logs = []
    try:
        for proc in procs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu "
                                   f"(exit {proc.returncode}):\n{log}")
        if objs:                    # the parts into the one library
            link = subprocess.run(
                [nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"linking {name}'s parts failed:\n"
                                   f"{link.stdout}{link.stderr}")
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)            # atomic: a concurrent loader sees all
    return "".join(logs)


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all of ``csrc``) in parallel.
    Returns each source's compiler log ('' when it was already built)."""
    names = sources() if names is None else names
    started = {n: _start(n) for n in names}
    logs = {}
    try:
        for n, s in started.items():
            logs[n] = "" if s is None else _finish(n, s)
    finally:
        for s in started.values():  # never leave a compiler running
            for proc in s[0] if s is not None else []:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
