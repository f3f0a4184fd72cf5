"""Native (C++) track store, built with g++ and loaded with ctypes.

Port of mavmap_tpu/native/__init__.py. `load_mapstore_lib()` compiles
mapstore.cc on first use (g++ -O2, a plain C interface) into
`mavmap_tpu_torch/_build/native/`, named by a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused;
nothing is built at import time. Unlike the JAX package, which falls back
to the Python store when the build fails, a failed build raises with
g++'s output: the Python store is chosen explicitly
(SequentialMapper(store_backend="python")).
"""

import ctypes
import hashlib
import os
import subprocess
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "mapstore.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
GXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_LIB = None
build_seconds = None  # wall time of the last build in this process (None: reused)


def build():
    """Compile mapstore.cc unless a library of the current source exists;
    returns the library's path. Raises RuntimeError with g++'s output when
    the compile fails."""
    global build_seconds
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"libmapstore_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, SOURCE, "-o", tmp], capture_output=True,
                              text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the native track store builds with g++ "
                           "(store_backend='python' selects the Python store)") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ mapstore.cc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    build_seconds = time.perf_counter() - t0
    return path


def load_mapstore_lib():
    """The loaded native map-store library (built on first call) with
    argtypes and restypes set."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build())
    c, p, u8, i32 = ctypes.c_int64, ctypes.c_void_p, ctypes.c_uint8, ctypes.c_int32
    pc, pu8, pi32 = ctypes.POINTER(c), ctypes.POINTER(u8), ctypes.POINTER(i32)
    for name, res, args in (
            ("ms_create", p, []),
            ("ms_destroy", None, [p]),
            ("ms_add_image", c, [p, i32, c]),
            ("ms_num_points2D", c, [p]),
            ("ms_num_points3D", c, [p]),
            ("ms_capacity_points3D", c, [p]),
            ("ms_add_correspondence", c, [p, c, c]),
            ("ms_set_tri", None, [p, c, u8]),
            ("ms_get_tri", u8, [p, c]),
            ("ms_get_valid", u8, [p, c]),
            ("ms_track_len", i32, [p, c]),
            ("ms_point3D_of", c, [p, c]),
            ("ms_delete_point3D", None, [p, c]),
            ("ms_get_track", None, [p, c, pc]),
            ("ms_export_p2d_point3D", None, [p, pc]),
            ("ms_export_p3d_flags", None, [p, pu8, pu8, pi32]),
            ("ms_add_correspondences", c, [p, pc, pc, c, pc]),
            ("ms_load_tracks", c, [p, c, c, pc, pc, pc, pu8])):
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _LIB = lib
    return lib
