"""Clip-level transforms on uint8 numpy video (T, H, W, C).

Counterpart of ``youku_mplug_tpu/data/transforms.py``, op for op and
draw for draw: the per-frame augment ops on cv2 (``AUG_OPS``: PIL's
enhance tables as lookup tables, ``warpAffine`` geometry with a grey
fill), ``TemporalConsistentRandAugment`` (ops drawn once a clip and
applied to every frame), ``RandomResizedCrop``, ``RandomHorizontalFlip``,
``Resize``, ``CenterCrop``, ``RandomErasing``, ``Compose``,
``clip_to_tensor`` and ``normalize``, and the two pipelines the runners
use, ``train_transform`` and ``test_transform``.  Every transform takes
an explicit ``numpy.random.Generator``, so a sample's augmentation
depends on its own generator only.  The pipelines stop at uint8: the
clip goes to the device as it is and is normalized there
(``ops/preprocess.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import cv2
import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_FILL = (128, 128, 128)
_MAX_LEVEL = 10
_TRANSLATE_CONST = 10

_INTERP = {
    "bilinear": cv2.INTER_LINEAR,
    "bicubic": cv2.INTER_CUBIC,
    "nearest": cv2.INTER_NEAREST,
}


# ---------------------------------------------------------------------------
# per-frame augment ops (uint8 HWC in/out)
# ---------------------------------------------------------------------------


def _identity(img):
    return img


def _lut(img, table):
    """Apply a 256-entry uint8 lookup table via cv2.LUT (SIMD; ~7x the
    throughput of numpy fancy indexing on 224px frames)."""
    return cv2.LUT(img, table)


def _lut_brightness(img, factor):
    table = np.clip(np.arange(256, dtype=np.float32) * factor, 0,
                    255).astype(np.uint8)
    return _lut(img, table)


def _lut_contrast(img, factor):
    # luminance-weighted mean, PIL ImageEnhance.Contrast semantics (note the
    # reference applies BGR-order weights to RGB frames; we keep the same
    # arithmetic for behavioral parity).  cv2.mean == np.mean per channel
    # (double accumulation) but SIMD-vectorized.
    ch = cv2.mean(img)[:3]
    mean = float(ch[0] * 0.114 + ch[1] * 0.587 + ch[2] * 0.299)
    table = np.clip((np.arange(256, dtype=np.float32) - mean) * factor
                    + mean, 0, 255).astype(np.uint8)
    return _lut(img, table)


def _sharpness(img, factor):
    kernel = np.ones((3, 3), np.float32)
    kernel[1, 1] = 5
    kernel /= 13
    smooth = cv2.filter2D(img, -1, kernel)
    if factor == 0.0:
        return smooth
    # interior = smooth + factor * (img - smooth), border kept from img
    # (PIL SMOOTH-filter blend semantics).  addWeighted saturates and
    # rounds-to-nearest like PIL; then restore the 1px border.
    out = cv2.addWeighted(img, factor, smooth, 1.0 - factor, 0.0)
    out[0], out[-1] = img[0], img[-1]
    out[:, 0], out[:, -1] = img[:, 0], img[:, -1]
    return out


def _warp(img, m):
    h, w = img.shape[:2]
    return cv2.warpAffine(img, m, (w, h), borderValue=_FILL,
                          flags=cv2.INTER_LINEAR).astype(np.uint8)


def _shear_x(img, factor):
    return _warp(img, np.float32([[1, factor, 0], [0, 1, 0]]))


def _shear_y(img, factor):
    return _warp(img, np.float32([[1, 0, 0], [factor, 1, 0]]))


def _shift(img, dx, dy):
    """Integer-offset translate as slice copy + gray fill — exact match
    of warpAffine-with-integral-translation at ~6x less cost."""
    h, w = img.shape[:2]
    out = np.empty_like(img)
    out.fill(_FILL[0])  # gray fill; memset (all channels share the value)
    sy0, sy1 = max(0, -dy), min(h, h - dy)
    sx0, sx1 = max(0, -dx), min(w, w - dx)
    if sy1 > sy0 and sx1 > sx0:
        out[sy0 + dy:sy1 + dy, sx0 + dx:sx1 + dx] = img[sy0:sy1, sx0:sx1]
    return out


def _translate_x(img, offset):
    if float(offset) == int(offset):
        return _shift(img, -int(offset), 0)
    return _warp(img, np.float32([[1, 0, -offset], [0, 1, 0]]))


def _translate_y(img, offset):
    if float(offset) == int(offset):
        return _shift(img, 0, -int(offset))
    return _warp(img, np.float32([[1, 0, 0], [0, 1, -offset]]))


def _rotate(img, degree):
    h, w = img.shape[:2]
    m = cv2.getRotationMatrix2D((w / 2, h / 2), degree, 1)
    return _warp(img, m)


def _equalize(img):
    chans = [cv2.cvtColor(
        cv2.equalizeHist(img[..., c]), cv2.COLOR_GRAY2RGB)[..., 0]
        for c in range(img.shape[-1])]
    return np.stack(chans, axis=-1)


def _auto_contrast(img):
    """Per-channel min/max rescale (PIL ImageOps.autocontrast,
    reference rand_augment.py:147-149)."""
    ramp = np.arange(256, dtype=np.float32)
    ident = ramp.astype(np.uint8)
    tables = []
    for c in range(img.shape[-1]):
        ch = img[..., c]
        lo, hi = int(ch.min()), int(ch.max())
        if hi <= lo:
            tables.append(ident)
        else:
            scale = 255.0 / (hi - lo)
            tables.append(np.clip((ramp - lo) * scale, 0,
                                  255).astype(np.uint8))
    # one multi-channel LUT call (cv2 applies table c to channel c)
    return _lut(img, np.stack(tables, axis=-1).reshape(1, 256, -1))


def _invert(img):
    return cv2.bitwise_not(img)  # exactly 255 - img, SIMD


def _posterize(img, bits_to_keep):
    if bits_to_keep >= 8:
        return img
    table = (np.arange(256, dtype=np.uint8)
             & np.uint8(256 - (1 << (8 - int(bits_to_keep)))))
    return _lut(img, table)


def _solarize(img, thresh):
    table = np.arange(256, dtype=np.int32)
    table = np.where(table < thresh, table, 255 - table).astype(np.uint8)
    return _lut(img, table)


def _solarize_add(img, add, thresh=128):
    table = np.arange(256, dtype=np.int32)
    table = np.where(table < thresh,
                     np.clip(table + int(add), 0, 255), table)
    return _lut(img, table.astype(np.uint8))


def _color(img, factor):
    """PIL ImageEnhance.Color: blend with the grayscale image."""
    gray = cv2.cvtColor(cv2.cvtColor(img, cv2.COLOR_RGB2GRAY),
                        cv2.COLOR_GRAY2RGB)
    # gray + factor * (img - gray), saturating round like PIL blend
    return cv2.addWeighted(img, factor, gray, 1.0 - factor, 0.0)


def _translate_x_rel(img, pct):
    return _translate_x(img, pct * img.shape[1])


def _translate_y_rel(img, pct):
    return _translate_y(img, pct * img.shape[0])


def _enhance_arg(level):
    return ((level / _MAX_LEVEL) * 1.8 + 0.1,)


def _shear_arg(level):
    return ((level / _MAX_LEVEL) * 0.3,)


def _translate_arg(level):
    return ((level / _MAX_LEVEL) * float(_TRANSLATE_CONST),)


def _rotate_arg(level):
    return ((level / _MAX_LEVEL) * 30.0,)


def _translate_rel_arg(level):
    return ((level / _MAX_LEVEL) * 0.45,)


def _posterize_arg(level):
    return (int((level / _MAX_LEVEL) * 4),)


def _solarize_arg(level):
    return (int((level / _MAX_LEVEL) * 256),)


def _solarize_add_arg(level):
    return (int((level / _MAX_LEVEL) * 110),)


AUG_OPS = {
    "Identity": (_identity, lambda level: ()),
    "Equalize": (_equalize, lambda level: ()),
    "AutoContrast": (_auto_contrast, lambda level: ()),
    "Invert": (_invert, lambda level: ()),
    "Brightness": (_lut_brightness, _enhance_arg),
    "Contrast": (_lut_contrast, _enhance_arg),
    "Color": (_color, _enhance_arg),
    "Sharpness": (_sharpness, _enhance_arg),
    "ShearX": (_shear_x, _shear_arg),
    "ShearY": (_shear_y, _shear_arg),
    "TranslateX": (_translate_x, _translate_arg),
    "TranslateY": (_translate_y, _translate_arg),
    "TranslateXRel": (_translate_x_rel, _translate_rel_arg),
    "TranslateYRel": (_translate_y_rel, _translate_rel_arg),
    "Rotate": (_rotate, _rotate_arg),
    "Posterize": (_posterize, _posterize_arg),
    "Solarize": (_solarize, _solarize_arg),
    "SolarizeAdd": (_solarize_add, _solarize_add_arg),
}

# the reference's default op list (rand_augment.py:398-415)
RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
    "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
    "Sharpness", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]


class TemporalConsistentRandAugment:
    """Sample N ops once per clip, apply the SAME ops/args to every frame
    (reference randaugment_video.py:323-362)."""

    def __init__(self, n: int = 2, m: int = 5,
                 augs: Optional[Sequence[str]] = None):
        self.n = n
        self.m = m
        self.augs = list(augs) if augs else list(AUG_OPS)

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        names = rng.choice(self.augs, self.n, replace=False)
        ops = [(AUG_OPS[name][0], AUG_OPS[name][1](self.m))
               for name in names]
        out = np.empty_like(clip)
        for k, frame in enumerate(clip):
            for fn, args in ops:
                frame = fn(frame, *args)
            out[k] = frame
        return out


class RandomResizedCrop:
    """Clip-level area crop + resize, torchvision sampling semantics
    (scale log-ratio, 10 attempts, center fallback)."""

    def __init__(self, size: int, scale: Tuple[float, float] = (0.5, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                 interpolation: str = "bicubic"):
        self.size = (size, size) if isinstance(size, int) else size
        self.scale = scale
        self.ratio = ratio
        self.interp = _INTERP[interpolation]

    def _sample_box(self, h, w, rng):
        area = h * w
        log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
        for _ in range(10):
            target = area * rng.uniform(*self.scale)
            aspect = float(np.exp(rng.uniform(*log_ratio)))
            cw = int(round(np.sqrt(target * aspect)))
            ch = int(round(np.sqrt(target / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                i = int(rng.integers(0, h - ch + 1))
                j = int(rng.integers(0, w - cw + 1))
                return i, j, ch, cw
        # center fallback
        in_ratio = w / h
        if in_ratio < self.ratio[0]:
            cw, ch = w, int(round(w / self.ratio[0]))
        elif in_ratio > self.ratio[1]:
            ch, cw = h, int(round(h * self.ratio[1]))
        else:
            cw, ch = w, h
        return (h - ch) // 2, (w - cw) // 2, ch, cw

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        t, h, w, c = clip.shape
        i, j, ch, cw = self._sample_box(h, w, rng)
        crop = clip[:, i:i + ch, j:j + cw]
        out = np.empty((t, self.size[0], self.size[1], c), clip.dtype)
        for k, f in enumerate(crop):
            cv2.resize(f, (self.size[1], self.size[0]), dst=out[k],
                       interpolation=self.interp)
        return out


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, clip, rng=None):
        rng = rng or np.random.default_rng()
        if rng.random() < self.p:
            out = np.empty_like(clip)
            for i in range(clip.shape[0]):
                cv2.flip(clip[i], 1, dst=out[i])  # ~30x a strided np copy
            return out
        return clip


class Resize:
    def __init__(self, size, interpolation: str = "bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.interp = _INTERP[interpolation]

    def __call__(self, clip, rng=None):
        return np.stack([
            cv2.resize(f, (self.size[1], self.size[0]),
                       interpolation=self.interp) for f in clip])


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, clip, rng=None):
        t, h, w, c = clip.shape
        ch, cw = self.size
        i, j = (h - ch) // 2, (w - cw) // 2
        return clip[:, i:i + ch, j:j + cw]


def clip_to_tensor(clip: np.ndarray) -> np.ndarray:
    """(T, H, W, C) uint8 -> (C, T, H, W) float32 in [0, 1] (reference
    ClipToTensor, volume_transforms.py:16-39)."""
    return clip.transpose(3, 0, 1, 2).astype(np.float32) / 255.0


def normalize(clip_cthw: np.ndarray, mean=CLIP_MEAN, std=CLIP_STD
              ) -> np.ndarray:
    mean = np.asarray(mean, np.float32).reshape(-1, 1, 1, 1)
    std = np.asarray(std, np.float32).reshape(-1, 1, 1, 1)
    return (clip_cthw - mean) / std


class RandomErasing:
    """Random Erasing (Zhong et al. 2017) for normalized clips — the
    capability of the reference's timm-derived variant
    (dataset/video_utils/random_erasing.py:27-172): with probability p,
    pick up to ``max_count`` boxes by area/aspect and overwrite them with
    zeros ('const'), a per-box normal color ('rand'), or per-pixel noise
    ('pixel').  ``cube=True`` erases the SAME box in every frame (the
    reference's temporal-cube default).

    Applies to clips shaped (T, H, W, C) float (post-normalization, like
    the reference) — place it after clip_to_tensor/normalize, or call
    on (C, T, H, W) via ``chw=True``.
    """

    def __init__(self, probability=0.25, min_area=0.02, max_area=1 / 3,
                 min_aspect=0.3, max_aspect=None, mode="pixel",
                 min_count=1, max_count=None, cube=True):
        import math

        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect = (math.log(min_aspect), math.log(max_aspect))
        self.min_count = min_count
        self.max_count = max_count or min_count
        mode = (mode or "const").lower()
        assert mode in ("const", "rand", "pixel")
        self.mode = mode
        self.cube = cube

    def _fill(self, rng, shape, dtype):
        h, w, c = shape
        if self.mode == "pixel":
            return rng.normal(size=(h, w, c)).astype(dtype)
        if self.mode == "rand":
            return np.broadcast_to(
                rng.normal(size=(1, 1, c)).astype(dtype), (h, w, c))
        return np.zeros((h, w, c), dtype)

    def _boxes(self, rng, img_h, img_w):
        import math

        area = img_h * img_w
        count = (self.min_count if self.min_count == self.max_count
                 else int(rng.integers(self.min_count, self.max_count + 1)))
        out = []
        for _ in range(count):
            for _ in range(10):
                target = rng.uniform(self.min_area, self.max_area) * \
                    area / count
                aspect = math.exp(rng.uniform(*self.log_aspect))
                h = int(round(math.sqrt(target * aspect)))
                w = int(round(math.sqrt(target / aspect)))
                if 0 < h < img_h and 0 < w < img_w:
                    top = int(rng.integers(0, img_h - h + 1))
                    left = int(rng.integers(0, img_w - w + 1))
                    out.append((top, left, h, w))
                    break
        return out

    def __call__(self, clip: np.ndarray, rng=None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        clip = np.ascontiguousarray(clip)
        t, img_h, img_w, c = clip.shape
        if self.cube:
            # one probability roll + one box set for the whole clip
            if rng.random() > self.probability:
                return clip
            for top, left, h, w in self._boxes(rng, img_h, img_w):
                clip[:, top:top + h, left:left + w, :] = \
                    self._fill(rng, (h, w, c), clip.dtype)
        else:
            # reference non-cube path rolls per frame (:169-172)
            for i in range(t):
                if rng.random() > self.probability:
                    continue
                for top, left, h, w in self._boxes(rng, img_h, img_w):
                    clip[i, top:top + h, left:left + w, :] = \
                        self._fill(rng, (h, w, c), clip.dtype)
        return clip


class Compose:
    """Sequential clip transforms sharing one rng."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, clip, rng=None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            clip = t(clip, rng=rng)
        return clip


def train_transform(image_res: int, scale=(0.5, 1.0)) -> Compose:
    """The pretrain and finetune pipeline: an area crop resized to
    ``image_res`` (bicubic), a horizontal flip, and two of nine augment
    ops at magnitude 5; uint8 out."""
    return Compose([
        RandomResizedCrop(image_res, scale=scale, interpolation="bicubic"),
        RandomHorizontalFlip(),
        TemporalConsistentRandAugment(n=2, m=5, augs=[
            "Identity", "Contrast", "Brightness", "Sharpness", "ShearX",
            "ShearY", "TranslateX", "TranslateY", "Rotate"]),
    ])


def test_transform(image_res: int) -> Compose:
    return Compose([Resize((image_res, image_res))])
