"""Build & load the native parsing library via ctypes (no pip needed).

The library is built only from the committed `fastparse.cpp`, into
`_build/fastparse-<key>.so`, where the key hashes the source, the
compiler command and the machine architecture.  A library built from
other sources, with other flags or for another architecture therefore
sits under another name and is never loaded; the flags name no host CPU
(no -march=native), so a build is valid on any host of its architecture.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).parent
_SRC = _HERE / "fastparse.cpp"
BUILD_DIR = _HERE / "_build"
CXX_CMD = ("g++", "-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_CMD).encode())
    h.update(platform.machine().encode())
    return BUILD_DIR / f"fastparse-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    if so.exists():
        return True
    BUILD_DIR.mkdir(exist_ok=True)
    # build under a temporary name, then rename: concurrent processes
    # never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([*CXX_CMD, "-o", tmp, str(_SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library():
    """The loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not _build(so):
            return None
        lib = ctypes.CDLL(str(so))
        i64 = ctypes.c_int64
        p8 = ctypes.POINTER(ctypes.c_uint8)
        p32 = ctypes.POINTER(ctypes.c_int32)
        p64 = ctypes.POINTER(ctypes.c_int64)
        lib.parse_fasta.restype = i64
        lib.parse_fasta.argtypes = [p8, i64, p8, i64, p32, i64, p64, p64]
        lib.parse_fastq.restype = i64
        lib.parse_fastq.argtypes = [p8, i64, ctypes.c_int32, p8, i64, p32,
                                    i64, p64, p64]
        lib.extract_canonical.restype = i64
        lib.extract_canonical.argtypes = [p8, p32, i64, ctypes.c_int32, p64,
                                          i64]
        lib.pack_batch.restype = None
        lib.pack_batch.argtypes = [p8, p64, i64, ctypes.c_int32, p8, i64]
        pu32 = ctypes.POINTER(ctypes.c_uint32)
        lib.build_stream_cols.restype = None
        lib.build_stream_cols.argtypes = [p8, i64, p32, i64, ctypes.c_int32,
                                          pu32, pu32, i64]
        pu64 = ctypes.POINTER(ctypes.c_uint64)
        pu16 = ctypes.POINTER(ctypes.c_uint16)
        lib.count_kmers_baseline.restype = i64
        lib.count_kmers_baseline.argtypes = [p8, p32, i64, ctypes.c_int32,
                                             pu64, pu16, ctypes.c_int32, p64]
        lib.build_stream3_cols.restype = None
        lib.build_stream3_cols.argtypes = [p8, i64, p32, i64,
                                           ctypes.c_int32, pu32, pu32,
                                           pu32, pu32, i64]
        lib.build_neighbor_index.restype = ctypes.c_int32
        lib.build_neighbor_index.argtypes = [p64, i64, ctypes.c_int32,
                                             ctypes.c_int32, p32, p32]
        pi8 = ctypes.POINTER(ctypes.c_int8)
        lib.colored_bfs.restype = i64
        lib.colored_bfs.argtypes = [p32, pi8, i64, ctypes.c_int32,
                                    ctypes.c_int32, i64, p32, i64, p64,
                                    p32, i64]
        lib.pivot_bfs_depth1.restype = i64
        lib.pivot_bfs_depth1.argtypes = [p32, p32, p64, p8, i64, p64, i64,
                                         p32, i64, p64, p64, p64, i64]
        lib.contig_walk_baseline.restype = i64
        lib.contig_walk_baseline.argtypes = [pu64, p32, i64, ctypes.c_int32,
                                             ctypes.c_int32, ctypes.c_int32,
                                             p64, p64]
        lib.bfs_components_baseline.restype = i64
        lib.bfs_components_baseline.argtypes = [pu64, p32, i64,
                                                ctypes.c_int32,
                                                ctypes.c_int32, p64]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None
