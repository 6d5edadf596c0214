"""The build harness of the design-variant tools (``flash_sm90_variants.py``,
``window_sm90_variants.py``, ``sweep_sm90_variants.py`` and
``shootout_head_variants.py``). A variant is a committed source of
``csrc/`` with one design decision changed by text edits and a C entry over
raw pointers appended; each is built by nvcc with ``-Xptxas=-v`` into a
library of its own under the gitignored ``build/``, with ``csrc/`` on the
include path, all builds started together, and ptxas's report is read per
kernel. Each tool declares only its variants, its C entry and its cases."""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import time

from ..ops.kernels._build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, find_nvcc


def edited(text: str, replacements, where: str) -> str:
    """``text`` with each (old, new) of ``replacements`` applied in order to
    every occurrence; raises if ``where`` (the source) no longer holds an
    old text."""
    for old, new in replacements:
        if old not in text:
            raise RuntimeError(f"{where} no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def with_header(source: str, header: str) -> str:
    """csrc/``source`` with its include of csrc/``header`` replaced by the
    header's text, so that edits may reach into the header."""
    return (CSRC_DIR / source).read_text().replace(f'#include "{header}"', (CSRC_DIR / header).read_text(), 1)


def ptxas_summary(log: str, label=lambda mangled: mangled[:60]) -> list[str]:
    """Per kernel: registers, spill bytes, and each C75xx warning, from nvcc
    -Xptxas=-v output; ``label`` names a kernel from its mangled name."""
    lines, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            current = label(entry.group(1))
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and current:
            lines.append(f"{current}: spill stores {spill.group(1)} B, loads {spill.group(2)} B")
        used = re.search(r"Used (\d+) registers", line)
        if used and current:
            lines.append(f"{current}: {used.group(1)} registers")
        warn = re.search(r"\((C75\d\d)\)\s*(.*?)\s+in the function\s+'(\w+)'", line)
        if warn:
            lines.append(f"{label(warn.group(3))}: ptxas {warn.group(1)}: {warn.group(2)}")
    return lines


def build(sources: dict, subdir: str, argtypes: dict, out_dir=None, prefix: str = "variant", label=None) -> dict:
    """Each {name: source text} compiled at once into ``build/<subdir>/``,
    one nvcc each. Prints each build's seconds and ``ptxas_summary`` (with
    ``label``); with ``out_dir``, writes each build's whole output to
    ``<out_dir>/<prefix>_<n>.txt``. Returns {name: library}, whose C entry
    ``run`` takes ``argtypes[name]`` and returns an int."""
    work = BUILD_DIR / subdir
    work.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, text) in enumerate(sources.items()):
        src, lib = work / f"{prefix}{i}.cu", work / f"{prefix}{i}.so"
        src.write_text(text)
        cmd = [find_nvcc(), "-Xptxas=-v", *NVCC_FLAGS, "-I", str(CSRC_DIR), "-shared", "-o", str(lib), str(src)]
        jobs[name] = (i, lib, time.perf_counter(), subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, lib, t0, proc) in jobs.items():
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        if out_dir:
            with open(os.path.join(out_dir, f"{prefix}_{i}.txt"), "w") as f:
                f.write(f"{name}\n{log}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log[-4000:]}")
        print(f"variant {name!r}: built in {seconds:.1f} s", flush=True)
        for line in ptxas_summary(log, *(() if label is None else (label,))):
            print(f"  {line}", flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        libs[name].run.argtypes = argtypes[name]
        libs[name].run.restype = ctypes.c_int
    return libs


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=60).stdout.strip()
