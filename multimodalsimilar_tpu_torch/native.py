"""ctypes bridge to the native host-side encoders (native/fastpack.cpp).

The port's own copy of ``multimodalsimilar_tpu/native.py``: the char
encoder and the fastText word/bigram encoder. The shared library is built lazily on first use with g++ from the
repository's ``native/fastpack.cpp`` into the port's git-ignored
``build/`` directory, never into ``native/libfastpack.so``, so the two
packages never race on one file. When the toolchain or the build is
unavailable, ``TextTokenizer.from_vocab`` and
``FastTextVocab.encode_batch`` fall back to their pure-Python encoders:
this is host tokenization, not a device path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "fastpack.cpp")
_LIB = os.path.join(_PKG, "build", "libfastpack.so")
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall"]   # native/Makefile CXXFLAGS
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # build to a temp path and rename: a concurrent process must never
    # dlopen a half-written .so
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.build.{os.getpid()}"
    try:
        subprocess.run(["g++", *_FLAGS, "-shared", "-o", tmp, _SRC],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.CalledProcessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            # a stale or corrupt .so: rebuild once and retry
            if not _build():
                return None
            try:
                lib = ctypes.CDLL(_LIB)
            except OSError:
                return None
        lib.ft_vocab_create.restype = ctypes.c_void_p
        lib.ft_vocab_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64]
        lib.ft_vocab_free.restype = None
        lib.ft_vocab_free.argtypes = [ctypes.c_void_p]
        lib.ft_encode_batch.restype = None
        lib.ft_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
        lib.char_vocab_create.restype = ctypes.c_void_p
        lib.char_vocab_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
        lib.char_vocab_free.restype = None
        lib.char_vocab_free.argtypes = [ctypes.c_void_p]
        lib.char_encode_batch.restype = None
        lib.char_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def _c_strings(strings: Sequence[str]):
    arr = (ctypes.c_char_p * len(strings))()
    encoded = [s.encode("utf-8") for s in strings]
    arr[:] = encoded
    return arr, encoded  # keep `encoded` alive


class NativeFtEncoder:
    """Native fastText word/bigram packer (FastTextVocab.encode_batch)."""

    def __init__(self, words: dict, bucket: int, nwords: int):
        self.lib = load()
        if self.lib is None:
            raise RuntimeError("native fastpack unavailable")
        keys = list(words)
        ids = np.asarray([words[k] for k in keys], np.int32)
        arr, keep = _c_strings(keys)
        self._handle = self.lib.ft_vocab_create(
            arr, ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(keys), bucket, nwords)

    def encode_batch(self, lines: Sequence[str], max_tokens: int,
                     word_ngrams: int = 2):
        n = len(lines)
        ids = np.zeros((n, max_tokens), np.int32)
        mask = np.zeros((n, max_tokens), np.float32)
        arr, keep = _c_strings(list(lines))
        self.lib.ft_encode_batch(
            self._handle, arr, n, max_tokens, word_ngrams,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return ids, mask

    def __del__(self):
        if getattr(self, "_handle", None) and self.lib is not None:
            self.lib.ft_vocab_free(self._handle)


class NativeCharEncoder:
    """Native char-level BERT packer (TextTokenizer.from_vocab backend)."""

    def __init__(self, tokens: Sequence[str], pad: int, unk: int,
                 cls_id: int, sep: int):
        self.lib = load()
        if self.lib is None:
            raise RuntimeError("native fastpack unavailable")
        arr, keep = _c_strings(list(tokens))
        self._handle = self.lib.char_vocab_create(arr, len(tokens), pad,
                                                  unk, cls_id, sep)

    def encode_batch(self, lines: Sequence[str], max_length: int):
        if max_length < 3:
            # [CLS] + >=1 char + [SEP] minimum; the C packer writes CLS/SEP
            # unconditionally (a 0-length buffer would be a heap overrun)
            raise ValueError(f"max_length must be >= 3, got {max_length}")
        n = len(lines)
        ids = np.zeros((n, max_length), np.int32)
        mask = np.zeros((n, max_length), np.int32)
        types = np.zeros((n, max_length), np.int32)
        # strip ALL Unicode whitespace like the Python path and
        # build_char_vocab: the C splitter only knows ASCII space classes
        arr, keep = _c_strings(["".join(line.split()) for line in lines])
        self.lib.char_encode_batch(
            self._handle, arr, n, max_length,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return {"input_ids": ids, "attention_mask": mask,
                "token_type_ids": types}

    def __del__(self):
        if getattr(self, "_handle", None) and self.lib is not None:
            self.lib.char_vocab_free(self._handle)


def available() -> bool:
    return load() is not None
