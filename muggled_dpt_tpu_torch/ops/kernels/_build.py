"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and the objects are linked into
one shared library with a plain C interface, which is loaded with ctypes. The
build happens at first use, never at import, into ``muggled_dpt_tpu_torch/build/``
(listed in .gitignore); the library's file name carries a hash of the sources
and flags, so an edited source is rebuilt. ``nvcc`` is found through
``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda/bin/nvcc``."""

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
    """The built kernel library, loaded once per process, with every entry
    point's argtypes declared (64-bit pointers stay whole)."""
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.mdpt_flash_attention
    # the int64 argument array (its slots in csrc/flash_attention.cu), qk_scale_log2, stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_flash_attention_sm90_info
    # 0 (unbiased) or 1 (a bias of q's type), 0 (bf16) or 1 (f16), then five int32 out values
    # (csrc/flash_attention_sm90.cu): registers, spill bytes, static and dynamic shared bytes, threads
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_window_attention
    # the int64 argument array (its slots in csrc/window_attention.cu; the call writes SLOT_ROUTE), stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_window_attention_sm90_info
    # 0 (no mask) or 1 (mask), 0 (bf16) or 1 (f16), then five int32 out values (csrc/window_attention_sm90.cu), as the
    # flash kernel's
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_fused_mlp
    # the int64 argument array (its slots in csrc/fused_mlp.cu; the call writes SLOT_ROUTE), LayerNorm eps, stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_fused_mlp_sm90_info
    # 0 (the LayerNorm pass), 1 (fc1) or 2 (fc2), then nine int32 out values (csrc/fused_mlp_sm90.cu): the five of the
    # flash kernel's, the tile's rows and columns, the TMA stages, 1 for the ping-pong schedule
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_head_tail
    # the int64 argument array (its slots in csrc/head_tail.cu; the call writes SLOT_ROUTE), stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_upsample_bilinear_ac
    # the int64 argument array (its slots in csrc/upsample_bilinear_ac.cu), stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_cosine_qk
    # the int64 argument array (its slots in csrc/cosine_qk.cu), stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_flash_attention_int8
    # the int64 argument array (its slots in csrc/flash_attention_int8.cu; the call writes SLOT_ROUTE), q's factor, #6's
    # scale, stream
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_flash_attention_int8_sm90_info
    # eight int32 out values (csrc/flash_attention_int8_sm90.cu): the five of the flash kernel's, the q rows per CTA, the
    # K/V stages, the consumers' registers after setmaxnreg
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_flash_xl_sm90_info
    # qp, pipelined, ablate, then seven int32 out values (csrc/flash_xl_sm90.cu): the five of the flash kernel's, the key
    # tile and the consumers' registers after setmaxnreg
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_flash_staged_sm90_info
    # 0 or 1 (the scale's sign), then seven int32 out values (csrc/flash_staged_sm90.cu), as #10's
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_flash_variant_sm90_info
    # mode (csrc/flash_variant_sm90.cu's FvMode), then seven int32 out values, as #10's
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.mdpt_head_tail_sm90_info
    # output rows per unit (8 or 6), then seven int32 out values (csrc/head_tail_sm90.cu): the five of the flash kernel's,
    # the rows again, the TMA ring's stages
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("mdpt_flash_attention_xl", "mdpt_flash_attention_staged", "mdpt_flash_variant"):
        fn = getattr(lib, name)
        # the int64 argument array (its slots in csrc/flash_variants.cuh), qk_scale, stream
        fn.argtypes = [ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
