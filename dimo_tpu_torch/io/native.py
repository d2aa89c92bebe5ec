"""ctypes bindings for the native runtime library (`native/dimo_native.cpp`).

Counterpart of `dimo_tpu/io/native.py`: the C++ binary float32 PLY codec
and the asynchronous double-buffered batch packer. The library is the
repository's `native/libdimo_native.so` (built by
`scripts/build_native.sh`). When that file is missing or does not load,
`available()` is False and the callers take their numpy routes
(`io/ply.py`, the trainer's numpy gather), as the reference does.

The packer's out slots are tensors: page-locked (`pin_memory=True`) when
the batches go to a card, so `.to(device, non_blocking=True)` copies
them asynchronously. A slot must not be refilled while such a copy still
reads it: the caller hands the copy's CUDA event to `hold`, and `submit`
waits for the event of the slot it is about to fill.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from dimo_tpu_torch.utils import diagnostics

_LIB = None
_PATH = None
_TRIED = False
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REPO_LIB = os.path.join(_REPO, "native", "libdimo_native.so")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ply_write_f32.restype = ctypes.c_int
    lib.ply_write_f32.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_int64]
    lib.ply_read_f32_header.restype = ctypes.c_int64
    lib.ply_read_f32_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.ply_read_f32_data.restype = ctypes.c_int
    lib.ply_read_f32_data.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int]
    lib.packer_create.restype = ctypes.c_void_p
    lib.packer_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_int64]
    lib.packer_submit.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_void_p,
                                  ctypes.c_void_p]
    lib.packer_wait.argtypes = [ctypes.c_void_p]
    lib.packer_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _find_lib():
    """The repository's library, bound, or None where it does not load."""
    global _LIB, _PATH, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        _LIB, _PATH = _bind(ctypes.CDLL(REPO_LIB)), REPO_LIB
    except OSError:
        pass
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def library_path() -> str | None:
    """The file the library was loaded from, or None."""
    _find_lib()
    return _PATH


# ---------------------------------------------------------------------------
# PLY fast path

def ply_write(path: str, names: list[str], columns: np.ndarray) -> bool:
    """Write binary f32 PLY via C++. Returns False if unavailable/failed."""
    lib = _find_lib()
    if lib is None:
        return False
    data = np.ascontiguousarray(columns, dtype=np.float32)
    names_blob = b"".join(n.encode() + b"\0" for n in names)
    rc = lib.ply_write_f32(path.encode(), names_blob, len(names),
                           data.ctypes.data_as(ctypes.c_void_p),
                           data.shape[0])
    return rc == 0


def ply_read(path: str):
    """Read binary f32 PLY via C++ -> dict[name] = (N,) f32 array, or None."""
    lib = _find_lib()
    if lib is None:
        return None
    n_verts = ctypes.c_int64(0)
    n_props = ctypes.c_int(0)
    names_buf = ctypes.create_string_buffer(16384)
    off = lib.ply_read_f32_header(path.encode(), ctypes.byref(n_verts),
                                  ctypes.byref(n_props), names_buf,
                                  len(names_buf))
    if off < 0:
        return None
    names = names_buf.value.decode().strip("\n").split("\n")
    out = np.empty((n_verts.value, n_props.value), np.float32)
    rc = lib.ply_read_f32_data(path.encode(), off,
                               out.ctypes.data_as(ctypes.c_void_p),
                               n_verts.value, n_props.value)
    if rc != 0:
        return None
    return {name: out[:, i].copy() for i, name in enumerate(names)}


# ---------------------------------------------------------------------------
# async batch packer

class BatchPacker:
    """Double-buffered asynchronous frame gatherer.

    images: (F_total, ...) u8 contiguous; masks: (F_total, ...) u8.
    submit(indices) starts packing on the worker thread; get() blocks for
    the previously submitted batch and returns its slot's (images, masks)
    tensors. Call submit for step k+1 before consuming step k to overlap
    host packing with device compute. A caller that copies a slot
    asynchronously passes the copy's event to `hold`.
    """

    def __init__(self, images: np.ndarray, masks: np.ndarray, batch: int,
                 slots: int = 2, pin_memory: bool = False):
        lib = _find_lib()
        if lib is None:
            raise RuntimeError("native library not available")
        self._lib = lib
        self.images = np.ascontiguousarray(images)
        self.masks = np.ascontiguousarray(masks)
        self.img_bytes = int(np.prod(self.images.shape[1:]))
        self.mask_bytes = int(np.prod(self.masks.shape[1:]))
        # double-buffered out slots: the worker packs batch k+1 into slot
        # (k+1) % slots while slot k % slots is being copied to the device
        self._slots = slots
        self.out_imgs = [torch.empty((batch,) + self.images.shape[1:],
                                     dtype=torch.uint8, pin_memory=pin_memory)
                         for _ in range(slots)]
        self.out_masks = [torch.empty((batch,) + self.masks.shape[1:],
                                      dtype=torch.uint8, pin_memory=pin_memory)
                          for _ in range(slots)]
        self._submits = 0
        self._gets = 0
        self._idx_keepalive = [None] * slots
        self._held = [None] * slots    # per slot: event of a copy reading it
        self._h = lib.packer_create(
            self.images.ctypes.data_as(ctypes.c_void_p),
            self.masks.ctypes.data_as(ctypes.c_void_p),
            self.img_bytes, self.mask_bytes)

    def submit(self, flat_indices: np.ndarray) -> None:
        slot = self._submits % self._slots
        idx = np.ascontiguousarray(flat_indices, dtype=np.int64)
        assert idx.shape[0] == self.out_imgs[slot].shape[0]
        if self._held[slot] is not None:
            # a copy out of this slot may still be in flight
            with diagnostics.host_wait("packer_slot"):
                self._held[slot].synchronize()
            self._held[slot] = None
        self._idx_keepalive[slot] = idx
        self._lib.packer_submit(
            self._h, idx.ctypes.data_as(ctypes.c_void_p), idx.shape[0],
            ctypes.c_void_p(self.out_imgs[slot].data_ptr()),
            ctypes.c_void_p(self.out_masks[slot].data_ptr()))
        self._submits += 1

    def get(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Blocks until all submitted jobs finish; returns the oldest
        un-consumed slot's buffers (the wait: span `packer_wait`)."""
        with diagnostics.span("packer_wait"):
            self._lib.packer_wait(self._h)
        slot = self._gets % self._slots
        self._gets += 1
        return self.out_imgs[slot], self.out_masks[slot]

    def hold(self, event) -> None:
        """Keep the slot of the last `get` from being refilled until
        `event` (a `torch.cuda.Event` recorded after the copies out of it)
        has completed."""
        self._held[(self._gets - 1) % self._slots] = event

    def close(self) -> None:
        if self._h:
            self._lib.packer_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
