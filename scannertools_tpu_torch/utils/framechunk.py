"""FrameChunk — the layout convention for decoded frame chunks.

Decoded frames travel as the *raw byte stream* of each frame, viewed as
``[T, rows, 128] uint8`` with ``rows = ceil(payload / 128)`` — exactly the
contiguous decode buffer, so the host-side view is free (np.reshape). The
same view is what the device kernels read: a frame's bytes start on a
128-byte boundary, so 16-byte vector loads are always aligned.

Two storage formats (``fmt``):

* ``"rgb"`` — interleaved RGB24 (payload = H*W*3 bytes/frame). The host
  decoder already paid an swscale YUV→RGB conversion.
* ``"i420"`` — planar YUV 4:2:0 straight off the video codec (payload =
  H*W*3/2 bytes/frame): Y plane, then U, then V. Half the host→device bytes
  of RGB24 and no host colorspace math — the conversion runs on the device,
  fused into the consumer (the I420 histogram kernel fuses it into binning).

``flat`` is a numpy array on the host or a torch tensor on a device (CPU or
CUDA). ``device()`` uploads; ``host()`` copies back.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128

# YUV->RGB matrix coefficients: (y_scale, y_off, r_v, g_u, g_v, b_u) for
# R = ys*(Y-yo) + rv*(V-128); G = ys*(Y-yo) - gu*(U-128) - gv*(V-128);
# B = ys*(Y-yo) + bu*(U-128). Keyed by (bt709, full_range). Limited range
# uses the standard 16..235 excursion (what untagged mp4s carry).
_YUV_COEFS = {
    (False, False): (1.1643836, 16.0, 1.5960268, 0.3917623, 0.8129676,
                     2.0172321),
    (False, True): (1.0, 0.0, 1.402, 0.344136, 0.714136, 1.772),
    (True, False): (1.1643836, 16.0, 1.7927411, 0.2132486, 0.5329093,
                    2.1124018),
    (True, True): (1.0, 0.0, 1.5748, 0.1873243, 0.4681243, 1.8556),
}


def yuv420_to_rgb(y, u, v, full_range: bool, bt709: bool, xp=np):
    """Planar YUV (Y: [..., H, W]; U/V: [..., H/2, W/2], float32) -> RGB
    float32 [..., H, W, 3] in 0..255, floored to integers (swscale's
    fixed-point converter truncates). Nearest-neighbour chroma upsample.

    Every operation is a separately rounded float32 operation in the order
    written, for numpy (``xp=np``) and torch (``xp=torch``) alike; the
    I420 histogram kernel repeats that order without FMA contraction, so
    all three agree bit for bit."""
    ys, yo, rv, gu, gv, bu = _YUV_COEFS[(bool(bt709), bool(full_range))]
    yy = (y - yo) * ys
    d = u - 128.0
    e = v - 128.0
    if xp is np:
        d = np.repeat(np.repeat(d, 2, axis=-2), 2, axis=-1)
        e = np.repeat(np.repeat(e, 2, axis=-2), 2, axis=-1)
    else:
        d = d.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        e = e.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    r = yy + rv * e
    g = yy - gu * d - gv * e
    b = yy + bu * d
    rgb = xp.stack([r, g, b], -1)
    return xp.clip(xp.floor(rgb), 0.0, 255.0)


class FrameChunk:
    """flat: [T, rows, 128] uint8 (np.ndarray on the host, torch.Tensor on
    a device)."""

    def __init__(self, flat, h: int, w: int, c: int = 3, fmt: str = "rgb",
                 full_range: bool = False, bt709: bool = False):
        self.flat = flat
        self.h = int(h)
        self.w = int(w)
        self.c = int(c)
        self.fmt = fmt
        self.full_range = bool(full_range)
        self.bt709 = bool(bt709)

    def _like(self, flat) -> "FrameChunk":
        return FrameChunk(flat, self.h, self.w, self.c, self.fmt,
                          self.full_range, self.bt709)

    # -- metadata --
    @property
    def npix(self) -> int:
        return self.h * self.w * self.c

    @property
    def payload(self) -> int:
        """Meaningful bytes per frame in ``flat`` (before lane padding)."""
        if self.fmt == "i420":
            return self.h * self.w * 3 // 2
        return self.h * self.w * self.c

    @property
    def on_host(self) -> bool:
        return isinstance(self.flat, np.ndarray)

    def __repr__(self):
        where = "host" if self.on_host else str(self.flat.device)
        return (f"FrameChunk(T={self.flat.shape[0]}, {self.h}x{self.w}x"
                f"{self.c}, {self.fmt}, {where})")

    # -- construction --
    @staticmethod
    def _from_payload(flat2d, h: int, w: int, c: int, fmt: str,
                      full_range: bool = False,
                      bt709: bool = False) -> "FrameChunk":
        t, p = flat2d.shape
        rem = (-p) % LANES
        if rem:
            flat2d = np.pad(flat2d, ((0, 0), (0, rem)))
        return FrameChunk(flat2d.reshape(t, (p + rem) // LANES, LANES),
                          h, w, c, fmt, full_range, bt709)

    @staticmethod
    def from_hwc(frames: np.ndarray) -> "FrameChunk":
        """Wrap a host [T, H, W, C] uint8 buffer (zero-copy when the byte
        count is lane-aligned; otherwise one host pad copy)."""
        t, h, w, c = frames.shape
        flat = np.ascontiguousarray(frames).reshape(t, h * w * c)
        return FrameChunk._from_payload(flat, h, w, c, "rgb")

    @staticmethod
    def from_i420(planes: np.ndarray, h: int, w: int,
                  full_range: bool = False,
                  bt709: bool = False) -> "FrameChunk":
        """Wrap a host [T, H*W*3//2] uint8 packed-I420 buffer (the native
        decoder's read_frames_i420 output)."""
        t = planes.shape[0]
        flat = np.ascontiguousarray(planes).reshape(t, h * w * 3 // 2)
        return FrameChunk._from_payload(flat, h, w, 3, "i420",
                                        full_range, bt709)

    # -- representations --
    def _planes_f32(self):
        """i420 flat bytes -> (y, u, v) float32 planes."""
        t = self.flat.shape[0]
        h, w = self.h, self.w
        ysz = h * w
        csz = (h // 2) * (w // 2)
        if self.on_host:
            x = self.flat.reshape(t, -1).astype(np.float32)
        else:
            x = self.flat.reshape(t, -1).to(torch.float32)
        y = x[:, :ysz].reshape(t, h, w)
        u = x[:, ysz:ysz + csz].reshape(t, h // 2, w // 2)
        v = x[:, ysz + csz:ysz + 2 * csz].reshape(t, h // 2, w // 2)
        return y, u, v

    def hwc_f32(self):
        """[T, H, W, C] float32, as a numpy array for a host chunk and a
        tensor on the chunk's device otherwise. For i420 chunks this is
        where the YUV->RGB conversion runs."""
        t = self.flat.shape[0]
        if self.fmt == "i420":
            y, u, v = self._planes_f32()
            return yuv420_to_rgb(y, u, v, self.full_range, self.bt709,
                                 xp=np if self.on_host else torch)
        if self.on_host:
            x = self.flat.astype(np.float32)
        else:
            x = self.flat.to(torch.float32)
        return x.reshape(t, -1)[:, : self.npix].reshape(
            t, self.h, self.w, self.c)

    def hwc_u8(self):
        """[T, H, W, C] uint8 (host rgb: a free view)."""
        t = self.flat.shape[0]
        if self.fmt == "i420":
            rgb = self.hwc_f32()
            return rgb.astype(np.uint8) if self.on_host \
                else rgb.to(torch.uint8)
        return self.flat.reshape(t, -1)[:, : self.npix].reshape(
            t, self.h, self.w, self.c)

    def device(self, dev="cuda") -> "FrameChunk":
        """Copy to torch device ``dev`` on the current stream. The CUDA copy
        may still be in flight when this returns: the caller records an
        event after it and waits on that event before the host buffer is
        reused (the executor uploads on a side stream this way). A CPU
        target always copies, so the chunk never aliases a reusable host
        staging buffer."""
        dev = torch.device(dev)
        src = torch.from_numpy(self.flat) if self.on_host else self.flat
        if dev.type == "cuda":
            return self._like(src.to(dev, non_blocking=True))
        return self._like(src.to(dev, copy=True))

    def host(self) -> "FrameChunk":
        if self.on_host:
            return self
        return self._like(self.flat.cpu().numpy())

    # -- row ops used by the executor --
    def slice_rows(self, start: int, length: int) -> "FrameChunk":
        return self._like(self.flat[start : start + length])

    def __len__(self) -> int:
        return self.flat.shape[0]


def as_hwc_f32(frames) -> torch.Tensor:
    """Device ops' helper: a FrameChunk or a plain NHWC array -> a float32
    [T, H, W, C] tensor (on the chunk's device; i420 converted in the
    written order by ``hwc_f32``)."""
    if isinstance(frames, FrameChunk):
        frames = frames.hwc_f32()
    return torch.as_tensor(frames).to(torch.float32).contiguous()
