"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources compile with nvcc, one process per source started together,
and link into one shared library with a plain C interface, loaded with
ctypes: no PyTorch headers, so the build takes seconds. The library lands
in `mavmap_tpu_torch/_build/`, named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused. Nothing here
runs at import time; `library()` builds on first use.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("match.cu", "ba_accum.cu", "pose_lm.cu")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
# Flags of one source only. The pose LM rounds every product and sum on
# its own, as the plain version's elementwise kernels do: no contraction
# into fused multiply-adds (csrc/pose_lm.cu).
SOURCE_FLAGS = {"pose_lm.cu": ("-fmad=false",)}

_lib = None
build_seconds = None  # wall time of the last build in this process (None: reused)


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + " ".join(SOURCE_FLAGS.get(name, ())).encode() + f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels if no library for the current sources exists;
    returns the library path."""
    global build_seconds
    path = os.path.join(BUILD_DIR, f"libmavmap_kernels_{_digest()}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [f"{tmp}.{name}.o" for name in SOURCES]
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-c",
                                   os.path.join(CSRC, name), "-o", obj],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for name, obj in zip(SOURCES, objs)]
        errors = []
        for name, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {name} failed ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file
    build_seconds = time.perf_counter() - t0
    return path


def library():
    """The loaded kernel library (built on first call) with argtypes set."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.mavmap_match.argtypes = [P, P, P, P, P, P, ctypes.c_float, I, I, I, I, I, I, I,
                                 P, P, P, P, P, P, P, P, P]
    lib.mavmap_seg_accum_full.argtypes = [P, P, P, I, P, I, I, I, P, P, P]
    lib.mavmap_seg_accum_sorted.argtypes = [P, P, I, I, P, P]
    lib.mavmap_seg_accum_one_pass.argtypes = [P, P, P, P, I, I, I, I, P, P]
    lib.mavmap_pose_lm.argtypes = [P, P, P, P, P, P, I, I, I, ctypes.c_float, I, P, P, P, P]
    for fn in (lib.mavmap_match, lib.mavmap_seg_accum_full, lib.mavmap_seg_accum_sorted,
               lib.mavmap_seg_accum_one_pass, lib.mavmap_pose_lm):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err, name):
    """Raise if a C entry reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(device):
    import torch

    return torch.cuda.current_stream(device).cuda_stream


# Launches of each kernel by its wrapper (a count of kernel calls, never of
# plain-version calls). chip_smoke.py zeroes them before driving the main
# path and reads them after, to show the path went through the kernels.
# "match" counts every K1 launch; "match_batched" the ones with a slot axis,
# and slots["match_batched"] the slots those launches ran.
# "seg_accum_full" counts every K2 launch, "seg_accum_full_one_pass" the
# ones that took the one-pass path (a plan's one_pass). "pose_lm" counts
# K4's launches: one per registration step's pose refinement.
launches = {"match": 0, "match_batched": 0, "seg_accum_full": 0,
            "seg_accum_full_one_pass": 0, "seg_accum_sorted": 0, "pose_lm": 0}
slots = {"match_batched": 0}


def reset_launches():
    for counts in (launches, slots):
        for k in counts:
            counts[k] = 0


def require(t, name, dtype, ndim, device):
    """Validate a kernel argument: device, dtype, rank, contiguity."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
