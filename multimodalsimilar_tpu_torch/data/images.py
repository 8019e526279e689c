"""Image decode / resize / normalize / augment on the host.

Replaces the reference's albumentations recipes (getAugmentation,
daodian_infer.py:107-129 and cv_classifier_train_daodian.py:66-88):

  train: Resize -> HFlip(0.5) -> VFlip(0.5) -> Rotate(±120°, 0.75) ->
         RandomBrightness(0.09..0.6, 0.5) -> Normalize(imagenet)
  eval:  Resize -> Normalize(imagenet)

Output is NHWC: the port's embedders permute to NCHW on the device, after
normalizing there. Decoding reads BGR via cv2 and converts to RGB exactly
like cv_dataset.py:34-35.

Copied from ``multimodalsimilar_tpu/data/images.py`` (which imports no JAX;
``cv2`` is imported only inside the functions, so the module imports where
OpenCV is absent). Keeping the accelerator fed is a host problem (a single
host core decodes tens of images per second at 512px), so three host
optimizations live here:

* **reduced-scale JPEG decode** — when the target size allows it, decode at
  1/2 / 1/4 / 1/8 scale straight from the DCT domain
  (cv2.IMREAD_REDUCED_COLOR_*), chosen from a header-only dimension probe.
  This replaces part of the bilinear resize with an exact DCT low-pass (a
  resize-algorithm change, not a semantics change; pass min_size=None for
  bit-exact full decodes).
* **DecodedCache** — disk-backed uint8 resized-image store so multi-epoch
  training (the reference trains 100 epochs, cv_classifier_train_daodian.py:50)
  decodes each image once; augmentation stays per-epoch downstream.
* **uint8 emission** (normalize_host=False) — ship [B,H,W,3] uint8 to the
  device (4x smaller transfers) and normalize there
  (models.vision.device_normalize, the same f32 math).
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def image_dims(path: str, jpeg_only: bool = False) -> Optional[tuple]:
    """(height, width) from the file header alone (JPEG SOF / PNG IHDR);
    None when the format is unknown or the header is malformed.
    ``jpeg_only=True`` also returns None for PNGs (the reduced-decode
    caller needs JPEG dims specifically, in one header read)."""
    try:
        with open(path, "rb") as f:
            head = f.read(32)
            if head[:8] == b"\x89PNG\r\n\x1a\n":         # PNG: IHDR is fixed
                if jpeg_only:
                    return None
                w, h = struct.unpack(">II", head[16:24])
                return (h, w)
            if head[:2] == b"\xff\xd8":                   # JPEG: scan for SOF
                f.seek(2)
                while True:
                    marker = f.read(2)
                    if len(marker) < 2 or marker[0] != 0xFF:
                        return None
                    code = marker[1]
                    while code == 0xFF:                   # legal fill bytes
                        nxt = f.read(1)
                        if not nxt:
                            return None
                        code = nxt[0]
                    if code in (0xD8, 0x01) or 0xD0 <= code <= 0xD7:
                        continue                          # no length field
                    ln = struct.unpack(">H", f.read(2))[0]
                    # SOF0-15 minus DHT(C4)/JPG(C8)/DAC(CC)
                    if 0xC0 <= code <= 0xCF and code not in (0xC4, 0xC8,
                                                             0xCC):
                        body = f.read(5)
                        h, w = struct.unpack(">HH", body[1:5])
                        return (h, w)
                    f.seek(ln - 2, os.SEEK_CUR)
    except Exception:
        return None
    return None


def decode_image(path: str, min_size: Optional[int] = None
                 ) -> Optional[np.ndarray]:
    """Read an image file to RGB uint8 HWC; None on any failure (the
    reference's per-row try/except skip semantics, cv_dataset.py:33-41).

    With ``min_size``, JPEGs big enough are decoded at reduced scale (the
    largest 1/2^k whose short side still covers min_size) — 2-4x faster on
    large product photos headed for a small model input.
    """
    try:
        import cv2
        flags = cv2.IMREAD_COLOR
        if min_size:
            # JPEG only: IMREAD_REDUCED_* is an exact DCT low-pass for
            # JPEGs but a full-decode-plus-resize for PNGs — chaining that
            # with our own resize would double-resample PNG pixels
            dims = image_dims(path, jpeg_only=True)
            if dims:
                short = min(dims)
                for factor, flag in ((8, cv2.IMREAD_REDUCED_COLOR_8),
                                     (4, cv2.IMREAD_REDUCED_COLOR_4),
                                     (2, cv2.IMREAD_REDUCED_COLOR_2)):
                    if short // factor >= min_size:
                        flags = flag
                        break
        img = cv2.imread(path, flags)
        if img is None:
            return None
        if (min_size and flags != cv2.IMREAD_COLOR
                and min(img.shape[:2]) < min_size):
            img = cv2.imread(path)                       # probe lied; redo
            if img is None:
                return None
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except Exception:
        return None


def decode_image_bytes(data: bytes) -> Optional[np.ndarray]:
    """Decode encoded image bytes (JPEG/PNG/...) to RGB uint8 HWC; None on
    any failure — the bytes-level analogue of ``decode_image`` for payloads
    that arrive over the wire instead of from disk (the online serving
    daemon's base64 image requests, pipelines/serving.py)."""
    try:
        import cv2
        buf = np.frombuffer(data, np.uint8)
        img = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        if img is None:
            return None
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except Exception:
        return None


def resize(img: np.ndarray, size: int) -> np.ndarray:
    import cv2
    if img.shape[0] == size and img.shape[1] == size:
        return img
    return cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 HWC -> float32 HWC, imagenet mean/std (albumentations
    Normalize semantics: x/255 then (x-mean)/std)."""
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def augment_resized(img: np.ndarray, rng: np.random.Generator
                    ) -> np.ndarray:
    """The uint8 augmentation chain on an already-resized image:
    HFlip/VFlip/Rotate/RandomBrightness (reference recipe order)."""
    import cv2
    size = img.shape[0]
    if rng.uniform() < 0.5:
        img = img[:, ::-1]
    if rng.uniform() < 0.5:
        img = img[::-1, :]
    if rng.uniform() < 0.75:
        angle = rng.uniform(-120, 120)
        mat = cv2.getRotationMatrix2D((size / 2, size / 2), angle, 1.0)
        img = cv2.warpAffine(np.ascontiguousarray(img), mat, (size, size),
                             borderMode=cv2.BORDER_REFLECT_101)
    if rng.uniform() < 0.5:
        # albumentations RandomBrightness(limit=(0.09, 0.6)) in the
        # reference's ToTensorV2-era version (>=0.4) is
        # RandomBrightnessContrast(brightness_limit=...) with the default
        # brightness_by_max=True: ADDITIVE img + beta*255, not a scale
        # (the multiplicative reading only held for <=0.3 releases)
        beta = rng.uniform(0.09, 0.6)
        img = np.clip(img.astype(np.float32) + beta * 255.0, 0, 255
                      ).astype(np.uint8)
    return np.ascontiguousarray(img)


def augment_train(img: np.ndarray, rng: np.random.Generator,
                  size: int) -> np.ndarray:
    """Train-time augmentation, mirroring the reference's recipe."""
    return normalize(augment_resized(resize(img, size), rng))


class DecodedCache:
    """Disk-backed store of resized uint8 images, one fixed-size record per
    key (the decode-once equivalent of the reference's per-SKU emb.txt cache
    idea, daodian_infer.py:259-285, applied one stage earlier).

    Construct via ``DecodedCache.open`` — it returns one shared instance per
    directory within the process (the CLI builds train + eval sources over
    the same cache), so all puts serialize on one lock. Appends additionally
    hold an fcntl flock on data.bin and re-align to a record boundary first,
    so a crash mid-write (torn record) or a second writer process cannot
    shift later slots; keys.txt lines are only trusted when
    newline-terminated (a torn final line is re-decoded, never mis-mapped).
    The record size is pinned in meta.json — reusing a directory with a
    different image size raises instead of silently corrupting.
    """

    _instances: dict = {}
    _instances_lock = threading.Lock()

    @classmethod
    def open(cls, directory: str, size: int) -> "DecodedCache":
        key = (os.path.realpath(directory), size)
        with cls._instances_lock:
            inst = cls._instances.get(key)
            if inst is None:
                inst = cls._instances[key] = cls(directory, size)
            return inst

    def __init__(self, directory: str, size: int):
        os.makedirs(directory, exist_ok=True)
        self.size = size
        self.record = size * size * 3
        meta_path = os.path.join(directory, "meta.json")
        meta = None
        if os.path.exists(meta_path):
            try:
                meta = json.load(open(meta_path))
            except (json.JSONDecodeError, OSError):
                meta = None      # torn meta from a crash: rewrite below
        if meta is not None:
            if meta["size"] != size:
                raise ValueError(
                    f"DecodedCache at {directory} holds {meta['size']}px "
                    f"images, requested {size}px — use a separate directory")
        else:
            data_bin = os.path.join(directory, "data.bin")
            if os.path.exists(data_bin) and os.path.getsize(data_bin) > 0:
                # torn meta but EXISTING data: we cannot know its record
                # size — re-stamping with the caller's size could pread
                # misaligned garbage into training. Fail with instructions.
                raise ValueError(
                    f"DecodedCache at {directory}: meta.json is unreadable "
                    f"but data.bin is non-empty — delete the directory to "
                    f"rebuild")
            # atomic like the rest of the class's crash discipline: a kill
            # mid-json.dump must not brick the directory
            tmp = f"{meta_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"size": size, "format": "rgb-uint8"}, f)
            os.replace(tmp, meta_path)
        self._keys_path = os.path.join(directory, "keys.txt")
        self._data_path = os.path.join(directory, "data.bin")
        # keys.txt lines are "key\tslot": the slot is the record-aligned
        # data.bin offset claimed under the flock at append time.
        self._index = {}
        self._keys_offset = 0     # how far into keys.txt we have indexed
        self._lock = threading.Lock()
        if os.path.exists(self._keys_path):
            with open(self._keys_path, "rb") as f:
                raw = f.read()
            if raw and not raw.endswith(b"\n"):
                # torn final line from a crash: terminate it with an invalid
                # slot so it parses as garbage (and future appends don't
                # concatenate onto it), never as a wrong mapping
                with open(self._keys_path, "ab") as f:
                    f.write(b"\t#\n")
                raw += b"\t#\n"
            self._ingest_keys(raw)
        self._read_fd = os.open(self._data_path,
                                os.O_RDONLY | os.O_CREAT, 0o644)

    def _ingest_keys(self, raw: bytes) -> None:
        for line in raw.decode("utf-8", "replace").splitlines():
            key, _, slot = line.rpartition("\t")
            if key and slot.isdigit():
                self._index[key] = int(slot)
        self._keys_offset += len(raw)

    def _refresh_index(self) -> None:
        """Incrementally ingest keys appended by OTHER processes sharing
        this directory (multi-host training, parallel CLI jobs) — the
        index only knew this process's own writes, so shared caches
        silently degraded to decode-once-per-process."""
        try:
            end = os.path.getsize(self._keys_path)
        except OSError:
            return
        if end <= self._keys_offset:
            return
        with open(self._keys_path, "rb") as f:
            f.seek(self._keys_offset)
            raw = f.read()
        if raw and not raw.endswith(b"\n"):
            raw = raw[: raw.rfind(b"\n") + 1]   # skip a mid-append tail
        self._ingest_keys(raw)

    def __len__(self):
        return len(self._index)

    def get(self, key: str) -> Optional[np.ndarray]:
        slot = self._index.get(key)
        if slot is None:
            with self._lock:
                self._refresh_index()        # another process may have it
            slot = self._index.get(key)
            if slot is None:
                return None
        buf = os.pread(self._read_fd, self.record, slot * self.record)
        if len(buf) != self.record:
            return None                      # torn write from a crash
        return np.frombuffer(buf, np.uint8).reshape(self.size, self.size, 3)

    def put(self, key: str, img: np.ndarray) -> None:
        import fcntl
        if img.shape != (self.size, self.size, 3) or img.dtype != np.uint8:
            raise ValueError(f"expected {self.size}px rgb-uint8, "
                             f"got {img.shape} {img.dtype}")
        if "\t" in key or "\n" in key:
            raise ValueError(f"cache key may not contain tab/newline: {key!r}")
        payload = np.ascontiguousarray(img).tobytes()
        with self._lock:
            if key not in self._index:
                self._refresh_index()        # avoid cross-process dupes
            if key in self._index:
                return
            fd = os.open(self._data_path, os.O_WRONLY | os.O_CREAT, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                end = os.fstat(fd).st_size
                slot = end // self.record    # re-align past any torn tail
                off, done = slot * self.record, 0
                while done < len(payload):   # pwrite may be partial
                    done += os.pwrite(fd, payload[done:], off + done)
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
                os.close(fd)
            with open(self._keys_path, "a") as k:
                k.write(f"{key}\t{slot}\n")
            self._index[key] = slot

    def close(self):
        # deregister first: instances are process-wide singletons per
        # (dir, size), so a closed instance must never be handed to the
        # next DecodedCache.open (its dead fd would poison every user)
        with self._instances_lock:
            for k, v in list(self._instances.items()):
                if v is self:
                    del self._instances[k]
        os.close(self._read_fd)


def load_eval(path: str, size: int, cache: Optional[DecodedCache] = None,
              normalize_host: bool = True) -> Optional[np.ndarray]:
    img = _decode_resized(path, size, cache)
    if img is None:
        return None
    return normalize(img) if normalize_host else img


def load_train(path: str, size: int, rng: np.random.Generator,
               cache: Optional[DecodedCache] = None,
               normalize_host: bool = True) -> Optional[np.ndarray]:
    img = _decode_resized(path, size, cache)
    if img is None:
        return None
    img = augment_resized(img, rng)
    return normalize(img) if normalize_host else img


def _decode_resized(path: str, size: int, cache: Optional[DecodedCache]
                    ) -> Optional[np.ndarray]:
    if cache is not None:
        img = cache.get(path)
        if img is not None:
            return img
    img = decode_image(path, min_size=size)
    if img is None:
        return None
    img = resize(img, size)
    if cache is not None:
        cache.put(path, img)
    return img
