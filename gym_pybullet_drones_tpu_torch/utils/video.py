"""Dependency-free video assembly: an MJPEG AVI writer on top of PIL.

The reference records mp4 through PyBullet's ffmpeg state logging in GUI
mode (reference BaseAviary.py:148-156) and PNG frame sequences in DIRECT
mode (:174-192).  Own copy of the JAX package's `utils/video.py`: it needs
no ffmpeg, so the adapter's record path assembles the captured frames into
a Motion-JPEG AVI — a format every player handles — written directly from
Python (RIFF container + per-frame JPEG via PIL).  scripts/png2mp4.sh
remains available for hosts that do have ffmpeg.
"""
from __future__ import annotations

import io
import os
import struct

from gym_pybullet_drones_tpu_torch.utils.utils import require


class MJPEGWriter:
    """Incremental Motion-JPEG AVI writer.

    >>> w = MJPEGWriter("out.avi", fps=24)
    >>> w.add_frame(rgb_uint8_array)   # (H, W, 3) or (H, W, 4)
    >>> w.close()
    """

    def __init__(self, path: str, fps: float = 24.0, quality: int = 85):
        self.path = path
        self.fps = float(fps)
        self.quality = int(quality)
        self._frames: list[bytes] = []
        self._size = None

    def add_frame(self, rgb) -> None:
        Image = require("PIL.Image", "MJPEGWriter")
        import numpy as np
        arr = np.asarray(rgb)
        if arr.ndim != 3 or arr.shape[2] not in (3, 4):
            raise ValueError(f"expected (H, W, 3|4) frame, got {arr.shape}")
        if arr.shape[2] == 4:
            arr = arr[..., :3]
        img = Image.fromarray(arr.astype("uint8"), "RGB")
        if self._size is None:
            self._size = img.size
        elif img.size != self._size:
            img = img.resize(self._size)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", quality=self.quality)
        self._frames.append(buf.getvalue())

    def add_image_file(self, path: str) -> None:
        Image = require("PIL.Image", "MJPEGWriter")
        import numpy as np
        with Image.open(path) as img:
            self.add_frame(np.asarray(img.convert("RGB")))

    def close(self) -> str:
        if not self._frames:
            raise ValueError("no frames added")
        w, h = self._size
        n = len(self._frames)
        us_per_frame = int(round(1_000_000 / self.fps))
        max_bytes = max(len(f) for f in self._frames)

        def chunk(fourcc: bytes, payload: bytes) -> bytes:
            pad = b"\x00" if len(payload) % 2 else b""
            return fourcc + struct.pack("<I", len(payload)) + payload + pad

        def lst(fourcc: bytes, payload: bytes) -> bytes:
            return chunk(b"LIST", fourcc + payload)

        avih = struct.pack(
            "<IIIIIIIIIIIIII",
            us_per_frame, max_bytes * int(self.fps), 0,
            0x10,              # AVIF_HASINDEX
            n, 0, 1, max_bytes, w, h, 0, 0, 0, 0)
        strh = struct.pack(
            "<4s4sIHHIIIIIIIIhhhh",
            b"vids", b"MJPG", 0, 0, 0, 0,
            1, int(round(self.fps)),     # scale / rate
            0, n, max_bytes, 0xFFFFFFFF, 0, 0, 0, int(w), int(h))
        strf = struct.pack(
            "<IiiHH4sIiiII",
            40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
        hdrl = lst(b"hdrl", chunk(b"avih", avih)
                   + lst(b"strl", chunk(b"strh", strh)
                         + chunk(b"strf", strf)))

        movi_chunks, index, offset = [], [], 4
        for f in self._frames:
            c = chunk(b"00dc", f)
            movi_chunks.append(c)
            index.append(struct.pack("<4sIII", b"00dc", 0x10,
                                     offset, len(f)))
            offset += len(c)
        movi = lst(b"movi", b"".join(movi_chunks))
        idx1 = chunk(b"idx1", b"".join(index))

        riff_payload = b"AVI " + hdrl + movi + idx1
        with open(self.path, "wb") as fh:
            fh.write(b"RIFF" + struct.pack("<I", len(riff_payload))
                     + riff_payload)
        return self.path


def assemble_frame_dir(frame_dir: str, out_path: str | None = None,
                       fps: float = 24.0) -> str | None:
    """Assemble frame_<n>.png files from a recording dir into an AVI.

    Returns the written path, or None when the directory holds no frames.
    Counterpart of the reference's mp4 state logging
    (reference BaseAviary.py:523-537) for the adapter's DIRECT-mode record
    path.
    """
    frames = sorted(
        (f for f in os.listdir(frame_dir)
         if f.startswith("frame_") and f.endswith(".png")),
        key=lambda f: int(f[6:-4]))
    if not frames:
        return None
    out = out_path or os.path.join(frame_dir, "video.avi")
    wtr = MJPEGWriter(out, fps=fps)
    for f in frames:
        wtr.add_image_file(os.path.join(frame_dir, f))
    return wtr.close()
