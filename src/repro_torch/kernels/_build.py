"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` compiles into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``build/`` at the root of the checkout, named by a hash of
its source and the compiler flags: a changed source rebuilds, an unchanged
one loads at once. nvcc's report (registers, spills and shared memory of
each instantiation, from ``-Xptxas -v``) is kept beside the library as
``.log``, so it can be read after a cached build too. A failed build raises
with nvcc's output. Nothing is built when a module is imported, only at a
kernel's first launch or when a caller asks for :func:`build`.
:func:`ptxas_report` reads that report per kernel instantiation, and
:func:`sass_hmma` counts the tensor-core instructions of each kernel in a
built library (chip_smoke.py and the card tests read both).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention", "ssd_scan",
           "ssd_scan_bwd")
# The head_dims each attention kernel instantiates (its entry's ``switch
# (d)``); the wrappers check against these. Serving runs the forward flash
# and the decode kernel at Zamba2-7B's 224 too; the backward, which only
# training runs, and the sharded decode's partials are built for the rest.
ATTENTION_HEAD_DIMS = {
    "flash_attention": (32, 64, 128, 224),
    "decode_attention": (32, 64, 128, 224),
    "decode_attention_partials": (32, 64, 128),
    "flash_attention_bwd": (32, 64, 128),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def report_path(name: str) -> Path:
    """Where nvcc's report on the library of ``csrc/<name>.cu`` is kept."""
    return library_path(name).with_suffix(".log")


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, one nvcc each, all
    started together. Returns nvcc's report for every named source, built
    now or before (register, spill and shared-memory use, from ``-Xptxas
    -v``); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in running.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            report_path(name).write_text(logs[name])
            os.replace(tmp, out)
        else:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: report_path(name).read_text() if report_path(name).exists() else ""
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load its library."""
    path = library_path(name)
    if not path.exists():
        build((name,))
    return ctypes.CDLL(str(path))


def _demangle(names: List[str]) -> List[str]:
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not names or not os.path.exists(tool):
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    if len(out) != len(names):
        return names
    # drop the namespace, the casts of template arguments and the parameter list
    out = [re.sub(r"\(anonymous namespace\)::|<unnamed>::|\((?:int|bool|long)\)", "", o)
           for o in out]
    return [o.split("(")[0].removeprefix("void ") for o in out]


def ptxas_report(log: str) -> List[dict]:
    """Registers, spill bytes and static shared memory of each kernel
    instantiation, from nvcc's ``-Xptxas -v`` report."""
    rows, fn = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = {"fn": ln.split("'")[1]}
            rows.append(fn)
        elif fn is not None and "spill stores" in ln:
            words = ln.replace(",", "").split()
            fn["spill_bytes"] = int(words[words.index("spill") - 2]) + int(words[-4])
        elif fn is not None and "Used " in ln:
            words = ln.replace(",", "").split()
            fn["registers"] = int(words[words.index("registers") - 1])
            fn["smem_static"] = int(words[words.index("smem") - 2]) if "smem" in words else 0
    for row, name in zip(rows, _demangle([r["fn"] for r in rows]), strict=True):
        row["fn"] = name
    return rows


def sass_hmma(library: Path) -> Optional[Dict[str, int]]:
    """HMMA (tensor-core) instructions in each kernel of a built library's
    SASS, or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True,
                          timeout=120).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    return dict(zip(_demangle(list(counts)), counts.values(), strict=True))
