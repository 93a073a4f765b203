"""ctypes bindings for the native C++ JSONL reader (``bb_ingest.cpp``).

``bb_ingest.cpp`` is this package's own copy of the JAX package's reader.
It is built on demand with ``g++ -O2 -std=c++17 -shared -fPIC`` into
``build/torch_native/`` (never beside the source), under a name made from
the hash of the source and the flags, so an edited source is rebuilt.  The
library is written to a temporary file and moved into place, so processes
that build at once (test workers) never load a half-written file.
:func:`load_library` raises ``ImportError`` when the library cannot be
built; ``data/ingest.ingest_jsonl`` then takes the Python reader under
``backend="auto"`` and raises under ``"native"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bb_ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()


class _BBResult(ctypes.Structure):
    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("n_users", ctypes.c_int64),
        ("n_items", ctypes.c_int64),
        ("bad_lines", ctypes.c_int64),
        ("uidx", ctypes.POINTER(ctypes.c_int32)),
        ("iidx", ctypes.POINTER(ctypes.c_int32)),
        ("rating", ctypes.POINTER(ctypes.c_float)),
        ("timestamp", ctypes.POINTER(ctypes.c_int64)),
        ("helpful", ctypes.POINTER(ctypes.c_float)),
        ("verified", ctypes.POINTER(ctypes.c_float)),
        ("split", ctypes.POINTER(ctypes.c_int8)),
        ("positive", ctypes.POINTER(ctypes.c_uint8)),
        ("tok_count", ctypes.POINTER(ctypes.c_int32)),
        ("uniq_tok_count", ctypes.POINTER(ctypes.c_int32)),
        ("user_id_blob", ctypes.POINTER(ctypes.c_char)),
        ("user_id_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("item_id_blob", ctypes.POINTER(ctypes.c_char)),
        ("item_id_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("label_total", ctypes.POINTER(ctypes.c_int64)),
        ("label_helpful", ctypes.POINTER(ctypes.c_int64)),
        ("user_unique_tokens", ctypes.POINTER(ctypes.c_int64)),
    ]


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join([CXX, *CXX_FLAGS]).encode()).hexdigest()
    return BUILD_DIR / f"libbb_ingest_{digest[:16]}.so"


def build() -> Path:
    """Compile the source unless this source's library already exists;
    raises ``ImportError`` with the compiler's output when it cannot."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise ImportError(f"native ingest library unavailable: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise ImportError(f"native ingest library unavailable: {CXX} failed "
                          f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library():
    """The built library with its entry points typed (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.bb_ingest.restype = ctypes.POINTER(_BBResult)
            lib.bb_ingest.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, ctypes.c_int]
            lib.bb_free.restype = None
            lib.bb_free.argtypes = [ctypes.POINTER(_BBResult)]
            lib.bb_split_bucket.restype = ctypes.c_int
            lib.bb_split_bucket.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                            ctypes.c_double, ctypes.c_double]
            _lib = lib
    return _lib


def _copy(ptr, n, dtype):
    if n == 0:
        return np.zeros(0, dtype)
    return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)


def _decode_blob(blob, offsets, n):
    if n == 0:
        return []
    offs = np.ctypeslib.as_array(offsets, shape=(n + 1,))
    raw = ctypes.string_at(blob, int(offs[-1]))
    return [raw[offs[i]:offs[i + 1]].decode("utf-8", errors="replace")
            for i in range(n)]


def split_bucket_native(uid: str, iid: str, train_p: float = 0.8,
                        val_p: float = 0.1) -> int:
    lib = load_library()
    return int(lib.bb_split_bucket(uid.encode(), iid.encode(), train_p, val_p))


def ingest_jsonl_native(path, cfg, with_text_stats: bool = True,
                        collect_token_hashes: bool = False):
    """Native counterpart of ``data.ingest.ingest_jsonl``: the same
    ``InteractionTable``, with ``extra["backend"] = "native"`` and the count
    of skipped lines in ``extra["bad_lines"]``."""
    lib = load_library()
    from ..ingest import InteractionTable

    res = lib.bb_ingest(
        str(path).encode(), cfg.user_key.encode(), cfg.item_key.encode(),
        cfg.rating_key.encode(), float(cfg.pos_rating_threshold),
        float(cfg.train_p), float(cfg.val_p),
        1 if with_text_stats else 0, 1 if collect_token_hashes else 0)
    if not res:
        raise FileNotFoundError(path)
    r = res.contents
    try:
        N, U, I = int(r.n_records), int(r.n_users), int(r.n_items)
        user_ids = _decode_blob(r.user_id_blob, r.user_id_offsets, U)
        item_ids = _decode_blob(r.item_id_blob, r.item_id_offsets, I)
        extra = {
            "label_total": dict(zip(user_ids,
                                    _copy(r.label_total, U, np.int64))),
            "label_helpful": dict(zip(user_ids,
                                      _copy(r.label_helpful, U, np.int64))),
            "bad_lines": int(r.bad_lines),
            "backend": "native",
        }
        if collect_token_hashes:
            extra["user_unique_tokens"] = _copy(r.user_unique_tokens, U,
                                                np.int64)
        return InteractionTable(
            user_ids=user_ids, item_ids=item_ids,
            user2idx={u: k for k, u in enumerate(user_ids)},
            item2idx={i: k for k, i in enumerate(item_ids)},
            uidx=_copy(r.uidx, N, np.int32),
            iidx=_copy(r.iidx, N, np.int32),
            rating=_copy(r.rating, N, np.float32),
            timestamp=_copy(r.timestamp, N, np.int64),
            helpful_vote=_copy(r.helpful, N, np.float32),
            verified=_copy(r.verified, N, np.float32),
            split=_copy(r.split, N, np.int8),
            positive=_copy(r.positive, N, np.uint8).astype(bool),
            tok_count=_copy(r.tok_count, N, np.int32),
            uniq_tok_count=_copy(r.uniq_tok_count, N, np.int32),
            extra=extra,
        )
    finally:
        lib.bb_free(res)
