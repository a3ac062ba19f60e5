"""Build and bind the port's CUDA kernels.

The sources under ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` at first use, one ``nvcc`` process per source started together,
and linked into one shared library under ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``). The library has a plain C interface
bound through ``ctypes``; every C entry point returns ``cudaGetLastError()``
and :func:`check` raises when it is not 0. Nothing is built when a module is
imported, so the CPU test suite imports every module without ``nvcc``.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one right
after its launch and nowhere else, so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("interp.cu", "rmsnorm.cu", "flashattn.cu", "softmax.cu",
           "dspace.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {
    "library_eval": 0, "rmsnorm_lib": 0, "flash_attn_lib": 0,
    "softmax_lib": 0, "interp_eval": 0, "envelopes_parity": 0,
    "envelopes_parity_batched": 0, "envelopes_parity_fleet": 0,
    "dd_max_rows": 0, "library_walk": 0, "rom_eval": 0, "softmax_tab": 0,
    "rmsnorm_tab": 0, "flash_attn_tab": 0, "act_lib": 0}

# Set by ``launch.xprof.profile_step`` while it traces a step on fake
# tensors: the served kernels' wrappers hand it their plain version, the
# tensors they read and the products they compute, and it counts one op.
TRACER = None


def tracer_for(x):
    """The profiler tracing ``x`` (:data:`TRACER`), only where ``x`` is a
    fake tensor: a real tensor always takes its kernel (CUDA) or its
    plain version (CPU), whatever the profiler does elsewhere."""
    if TRACER is None:
        return None
    from torch._subclasses.fake_tensor import is_fake

    return TRACER if is_fake(x) else None


# the served kernels' launches by the ROM each read, (kernel, ROM address):
# which slot library a per-layer numerics plan sent each launch to
LAUNCHES_BY_ROM: dict[tuple[str, int], int] = {}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    "repro_library_eval": (_P, _P, _I, _P, _P, _I, _I, _P, _L, _I, _P),
    "repro_library_walk": (_P, _P, _I, _P, _P, _P, _I, _I, _I, _P, _L, _I,
                           _P),
    "repro_rom_eval": (_P, _P, _P, _P, _P, _L, _I, _P),
    "repro_act_lib": (_P, _P, _L, _L, _L, _I, _P, _P, _P, _P, _I, _I, _I,
                      _P),
    "repro_rmsnorm_lib": (_P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P,
                          _I, _P),
    "repro_flash_attn_lib": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _I, _I, _F, _I, _I, _P),
    "repro_softmax_lib": (_P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _I,
                          _P),
    "repro_softmax_tab": (_P, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P, _I,
                          _P),
    "repro_rmsnorm_tab": (_P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _I,
                          _P),
    "repro_flash_attn_tab": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _F, _I, _I, _P),
    "repro_interp_eval": (_P, _P, _P, _P, _L, _I, _P),
    "repro_envelopes_parity": (_P, _P, _L, _I, _P, _P, _P, _P, _I, _P),
    "repro_dd_max_rows": (_P, _P, _L, _I, _P, _I, _P),
    "repro_dd_max_rows2": (_P, _P, _L, _I, _P, _P, _I, _P),
    "repro_envelope_quotient": (_P, _P, _L, _P, _I, _P),
}

_lib: ctypes.CDLL | None = None
BUILD_LOG: dict = {}  # path, seconds and compiler output of this process's build


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    LAUNCHES_BY_ROM.clear()


def launched(name: str, rom) -> None:
    """Count one launch of ``name`` that read the ROM tensor ``rom``: in
    ``LAUNCHES`` and, by the ROM's address, in ``LAUNCHES_BY_ROM``."""
    LAUNCHES[name] += 1
    key = (name, rom.data_ptr())
    LAUNCHES_BY_ROM[key] = LAUNCHES_BY_ROM.get(key, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the kernels (if this source set is not built yet) and return
    the shared library's path."""
    so = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    if so.exists():
        BUILD_LOG.update(path=str(so), seconds=0.0, output="(cached)")
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = pathlib.Path(tmp) / (src + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                for _s, _o, other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
        tmp_so = pathlib.Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_so),
             *(str(o) for _s, o, _p in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, so)
    BUILD_LOG.update(path=str(so), seconds=time.perf_counter() - t0,
                     output="\n".join(logs))
    return so


def load() -> ctypes.CDLL:
    """The bound kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(args)
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(name: str, rc: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        msg = load().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def int_array(values, ctype=ctypes.c_int32):
    return (ctype * len(values))(*values)
