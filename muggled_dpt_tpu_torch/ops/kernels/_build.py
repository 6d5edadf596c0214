"""Build and load the package's CUDA kernels, and count their launches.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and the objects are linked into
one shared library with a plain C interface, which is loaded with ctypes. The
build happens at first use, never at import, into ``muggled_dpt_tpu_torch/build/``
(listed in .gitignore); the library's file name carries a hash of the sources
and flags, so an edited source is rebuilt. ``nvcc`` is found through
``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda/bin/nvcc``.

A wrapper module reaches its C entry through ``kernel_entry``, declaring the
entry's signature at the call, and counts each launch under its route with
``count``; ``launch_counts()`` reports every route of ``ROUTES``."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

NEG_INF = -1e30

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build_library(verbose: bool = False, logs: dict | None = None) -> Path:
    """Compile csrc/ into build/libmdpt_kernels-<hash>.so unless that file
    exists already; return its path. Raises with nvcc's output on failure.
    ``verbose``: ptxas reports each kernel's resources (-Xptxas=-v) and the
    output is printed; ``logs``: filled with each compiled source's output,
    by file name (left empty when the library existed)."""
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    lib_path = BUILD_DIR / f"libmdpt_kernels-{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), f"{digest.hexdigest()[:16]}.{os.getpid()}"
    jobs = []
    for src in (s for s in sources if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}-{tag}.o"
        cmd = [nvcc, *(["-Xptxas=-v"] if verbose else []), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        for _, cmd, proc in jobs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
            if verbose:
                print(out, flush=True)
            if logs is not None:
                logs[Path(cmd[-1]).name] = out
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for obj, _, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent loader never sees a partial file
    finally:
        for obj, _, proc in jobs:
            if proc.returncode is None:  # another source failed first: stop this one
                proc.kill()
                proc.communicate()
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return lib_path


def ptxas_report(source: str) -> str:
    """nvcc's output for one csrc/ source compiled alone with -Xptxas=-v
    (each kernel's registers, spills and shared memory, and any warning),
    into a scratch object under build/ that is removed again."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = BUILD_DIR / f"report-{os.getpid()}.o"
    cmd = [find_nvcc(), "-Xptxas=-v", *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / source)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    finally:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    return proc.stdout


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    return ctypes.CDLL(str(build_library()))


@functools.cache
def kernel_entry(name: str, *argtypes):
    """The library's C function ``name`` with ``argtypes`` declared (64-bit
    pointers stay whole) and an int result, the CUDA error it returns. Each
    module that calls an entry declares its signature at the call."""
    fn = kernel_library()[name]
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


# every kernel route of the package, in the order launch_counts() reports them
ROUTES = ("fused", "fused_biased", "bnhd", "window", "window_sm90", "fused_f16", "fused_biased_f16", "bnhd_f16",
          "window_f16", "window_sm90_f16", "fused_mlp", "fused_mlp_sm90", "head_tail", "head_tail_sm90", "int8_qk",
          "int8_qk_sm90", "int8_qk_fused", "int8_qk_fused_sm90", "xl", "staged", "variant", "upsample_ac",
          "upsample_ac_nchw", "cosine_qk", "postnorm_residual", "swiglu_gate")
_launches = dict.fromkeys(ROUTES, 0)


def count(route: str) -> None:
    """Count one launch of ``route``, a name in ``ROUTES`` (KeyError otherwise)."""
    _launches[route] += 1


def reset_launch_counts() -> None:
    """Zero the launch count of every kernel route of the package."""
    _launches.update(dict.fromkeys(ROUTES, 0))


def launch_counts() -> dict[str, int]:
    """The launch count of every kernel route of the package, by the names
    of ``ROUTES`` in their order, zeros included."""
    return dict(_launches)
