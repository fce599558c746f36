"""Counterpart of ``youku_mplug_tpu/data/vg_transforms.py``, a copy of
the JAX package's module (numpy and cv2 only), so the port imports
nothing of that package.

Box-aware visual-grounding transforms (host-side, numpy/cv2).

Rebuilds the reference's grounding augmentation pipeline
(reference: dataset/vg_transforms.py:17-288 and the composition in
dataset/grounding_dataset.py:345-384) without torch/PIL:

- images are uint8 [H, W, C]; boxes travel in **xyxy pixel** coords and
  come out as normalized cxcywh on the padded square (the DETR-style
  target the reference emits from NormalizeAndPad);
- horizontal flip swaps the box AND the words "left"/"right" in the
  query (vg_transforms.py:150-167);
- RandomSelect skips the crop branch whenever the query contains a
  direction word (left/right/top/bottom/middle) — spatial language must
  stay truthful (vg_transforms.py:318-330);
- RandomSizeCrop retries until the box center survives the crop, then
  clamps the box to the crop (intent of vg_transforms.py:189-226; the
  reference's guard compares x against the row offset — a transposed
  check we do not reproduce);
- the reference pads the *normalized* tensor with zeros, which equals
  padding raw pixels with the CLIP mean color; we pad uint8 with that
  color so the fused device-side normalize (ops/preprocess.py) lands on
  the same values.

All randomness flows through an explicit ``numpy.random.Generator``.
"""

from __future__ import annotations

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_PAD_COLOR = tuple(int(round(m * 255)) for m in CLIP_MEAN)
_DIR_WORDS = ("left", "right", "top", "bottom", "middle")


def _cv2():
    import cv2

    return cv2


def resize_long_side(img, box, size):
    """Scale so max(h, w) == size (vg_transforms.py:31-40)."""
    h, w = img.shape[:2]
    ratio = float(size) / float(max(h, w))
    new_w, new_h = round(w * ratio), round(h * ratio)
    img = _cv2().resize(img, (new_w, new_h),
                        interpolation=_cv2().INTER_LINEAR)
    return img, box * ratio


def resize_short_side(img, box, size):
    """Scale so min(h, w) == size (vg_transforms.py:42-50)."""
    h, w = img.shape[:2]
    ratio = float(size) / float(min(h, w))
    new_w, new_h = round(w * ratio), round(h * ratio)
    img = _cv2().resize(img, (new_w, new_h),
                        interpolation=_cv2().INTER_LINEAR)
    return img, box * ratio


def hflip(img, box, text):
    """Mirror image + box; swap left<->right words in the query
    (vg_transforms.py:150-167)."""
    img = img[:, ::-1].copy()
    w = img.shape[1]
    x0, y0, x1, y1 = box
    box = np.asarray([w - x1, y0, w - x0, y1], np.float32)
    text = (text.replace("right", "*&^special^&*")
            .replace("left", "right")
            .replace("*&^special^&*", "left"))
    return img, box, text


def crop(img, box, top, left, ch, cw):
    """Crop region + clamp the box into it (vg_transforms.py:17-28)."""
    img = img[top:top + ch, left:left + cw]
    box = box - np.asarray([left, top, left, top], np.float32)
    box = np.minimum(box.reshape(2, 2),
                     np.asarray([cw, ch], np.float32))
    return img, np.clip(box, 0, None).reshape(-1)


def random_size_crop(img, box, min_size, max_size, rng, max_try=20):
    """Random crop that keeps the box center inside (intent of
    vg_transforms.py:189-226)."""
    h, w = img.shape[:2]
    cx = (box[0] + box[2]) / 2
    cy = (box[1] + box[3]) / 2
    for _ in range(max_try):
        cw = int(rng.integers(min_size, min(w, max_size) + 1))
        ch = int(rng.integers(min_size, min(h, max_size) + 1))
        top = int(rng.integers(0, h - ch + 1))
        left = int(rng.integers(0, w - cw + 1))
        if left < cx < left + cw and top < cy < top + ch:
            return crop(img, box, top, left, ch, cw)
    return img, box


def color_jitter(img, rng, brightness=0.4, contrast=0.4, saturation=0.4):
    """Torchvision-factor jitter (vg_transforms.py:70-133)."""
    out = img.astype(np.float32)
    for kind in rng.permutation(3):
        f = float(rng.uniform(1 - brightness, 1 + brightness)) \
            if kind == 0 else None
        if kind == 0:
            out = out * f
        elif kind == 1:
            f = float(rng.uniform(1 - contrast, 1 + contrast))
            mean = out.mean()
            out = (out - mean) * f + mean
        else:
            f = float(rng.uniform(1 - saturation, 1 + saturation))
            gray = out @ np.asarray([0.299, 0.587, 0.114], np.float32)
            out = (out - gray[..., None]) * f + gray[..., None]
    return np.clip(out, 0, 255).astype(np.uint8)


def gaussian_blur(img, rng, sigma=(0.1, 2.0), p=0.5):
    if rng.random() >= p:
        return img
    s = float(rng.uniform(*sigma))
    return _cv2().GaussianBlur(img, (0, 0), s)


def normalize_and_pad(img, box, size, rng=None, aug_translate=False):
    """Pad to a size x size square (mean-color pad == the reference's
    zero-pad in normalized space), return (img, pad_mask, cxcywh/size)
    (vg_transforms.py:238-288)."""
    h, w = img.shape[:2]
    dh, dw = size - h, size - w
    if aug_translate and rng is not None:
        top = int(rng.integers(0, dh + 1))
        left = int(rng.integers(0, dw + 1))
    else:
        top = round(dh / 2.0 - 0.1)
        left = round(dw / 2.0 - 0.1)
    out = np.empty((size, size, 3), np.uint8)
    out[:] = np.asarray(_PAD_COLOR, np.uint8)
    out[top:top + h, left:left + w] = img
    mask = np.ones((size, size), np.int32)
    mask[top:top + h, left:left + w] = 0
    x0, y0, x1, y1 = box + np.asarray([left, top, left, top], np.float32)
    cxcywh = np.asarray([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                        np.float32) / size
    return out, mask, cxcywh


def vg_train_transform(image_res: int, aug_scale: bool = True,
                       aug_crop: bool = True, aug_blur: bool = False,
                       aug_translate: bool = False):
    """Training pipeline (grounding_dataset.py make_transforms:345-377).

    Returns fn(img uint8 [H,W,C], box xyxy float [4], text, rng) ->
    (img uint8 [S,S,3], mask [S,S], box cxcywh/S [4], text).
    """
    if aug_scale:
        rate = image_res // 20
        scales = [image_res - rate * i for i in range(7)]
    else:
        scales = [image_res]
    crop_prob = 0.5 if aug_crop else 0.0

    def fn(img, box, text, rng):
        box = np.asarray(box, np.float32)
        use_crop = (crop_prob > 0 and rng.random() < crop_prob
                    and not any(wd in text for wd in _DIR_WORDS))
        if use_crop:
            img, box = resize_short_side(
                img, box, int(rng.choice([400, 500, 600])))
            img, box = random_size_crop(img, box, 384, 600, rng)
            img, box = resize_long_side(img, box,
                                        int(rng.choice(scales)))
        else:
            img, box = resize_long_side(img, box,
                                        int(rng.choice(scales)))
        img = color_jitter(img, rng)
        if aug_blur:
            img = gaussian_blur(img, rng)
        if rng.random() < 0.5:
            img, box, text = hflip(img, box, text)
        img, mask, cxcywh = normalize_and_pad(
            img, box, image_res, rng=rng, aug_translate=aug_translate)
        return img, mask, cxcywh, text

    return fn


def vg_test_transform(image_res: int):
    """Eval pipeline: deterministic long-side resize + center pad."""

    def fn(img, box, text, rng=None):
        box = np.asarray(box, np.float32)
        img, box = resize_long_side(img, box, image_res)
        img, mask, cxcywh = normalize_and_pad(img, box, image_res)
        return img, mask, cxcywh, text

    return fn
