"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface under ``<repo>/build/kernels/``
(git-ignored) and loaded with ``ctypes``.  The build runs at first use,
never at import: the CPU tests import every module on a machine with no
``nvcc``.  All sources compile in parallel, one ``nvcc`` each; a source
is rebuilt when it or a shared ``csrc/*.cuh`` header is newer than its
library.

``LAUNCHES`` counts the launches of each kernel wrapper (a plain count:
a run can show that its main path went through the kernels).

    from repro_torch.kernels import build
    seconds, logs = build.build_all(verbose=True)   # -Xptxas -v output
    lib = build.library("batched_search")           # ctypes.CDLL
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}

LAUNCHES: Dict[str, int] = {
    "crude_topk": 0, "refine_topk": 0,
    "ivf_crude_topk": 0, "ivf_refine_topk": 0,
    "crude_topk_pred": 0, "select_topk": 0, "rerank_topk": 0,
    "kmeans_assign": 0, "icm_encode": 0,
    "adc": 0, "two_step": 0, "flash_attention": 0,
    "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
}

# ctypes signatures of each library's C entry points: every pointer and
# the stream travel as c_void_p (a bare Python int would be cut to 32
# bits), every size as c_int / c_long (a 64-bit stride as c_longlong)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_LL = ctypes.c_longlong
_COMMON = {   # search_common.cuh, compiled into every library
    "icq_error_string": ([_I], ctypes.c_char_p),
}
SIGNATURES = {
    "batched_search": {
        **_COMMON,
        "icq_crude_topk": ([_P] * 8 + [_I] * 10 + [_P], _I),
        "icq_refine_topk": ([_P] * 6 + [_I] * 9 + [_P], _I),
        "icq_crude_plan": ([_I] * 9 + [_P], _I),
        "icq_refine_plan": ([_I] * 7 + [_P], _I),
        "icq_select_topk": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "icq_select_plan": ([_I] * 3 + [_P], _I),
        "icq_merge_lists": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "icq_merge_block": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "icq_merge_block_fits": ([_I] * 3, _I),
    },
    "ivf_search": {
        **_COMMON,
        "icq_ivf_crude_topk": ([_P] * 8 + [_I] * 10 + [_P], _I),
        "icq_ivf_crude_plan": ([_I] * 8 + [_P], _I),
        "icq_ivf_refine_topk": ([_P] * 6 + [_I] * 9 + [_P], _I),
        "icq_ivf_refine_plan": ([_I] * 7 + [_P], _I),
    },
    "kmeans": {
        **_COMMON,
        "icq_kmeans_assign": ([_P] * 9 + [_L, _I, _I, _I, _P], _I),
        "icq_kmeans_plan": ([_L, _I, _I, _I, _P], _I),
    },
    "icm_encode": {
        **_COMMON,
        "icq_icm_plan": ([_L] + [_I] * 4 + [_P], _I),
        "icq_icm_encode": ([_P] * 8 + [_L] + [_I] * 5 + [_P], _I),
    },
    "adc": {
        **_COMMON,
        "icq_adc_max_lut_bytes": ([], _L),
        "icq_adc": ([_P, _I, _P, _P, _L, _I, _I, _P], _I),
        "icq_two_step": ([_P, _I] + [_P] * 5 + [_L, _I, _I, _P], _I),
    },
    "flash_attention": {
        **_COMMON,
        "icq_flash_attention": ([_P] * 5 + [_I] * 8 + [_F] + [_I] * 4
                                + [_P] + [_LL] * 4 + [_P], _I),
        "icq_flash_attention_attributes": ([_I] * 4 + [_P, _P], _I),
        "icq_flash_general_instance": ([_I] * 5, _I),
    },
    "flash_attention_bwd": {
        **_COMMON,
        "icq_flash_attention_bwd": ([_I] + [_P] * 10 + [_I] * 8 + [_F]
                                    + [_I] * 4 + [_P] + [_LL] * 4 + [_P],
                                    _I),
        "icq_flash_attention_bwd_attributes": ([_I] * 5 + [_P, _P], _I),
    },
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin); the CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def build_all(verbose: bool = False) -> Tuple[float, Dict[str, str]]:
    """Compile every ``csrc/*.cu`` source, all ``nvcc`` processes started
    together.  Returns (wall seconds, {name: compiler output}); with
    ``verbose`` the output holds ``-Xptxas -v`` (registers, shared
    memory, spills per kernel).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(_lib_path(src.stem)), str(src)]
        procs[src.stem] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs, failed = {}, []
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return time.perf_counter() - t0, logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if it is
    missing or older than its source."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    newest = max(p.stat().st_mtime
                 for p in (CSRC / f"{name}.cu", *CSRC.glob("*.cuh")))
    if not path.exists() or path.stat().st_mtime < newest:
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _LIBS[name] = lib
    return lib
