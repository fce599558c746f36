"""Counterpart of ``youku_mplug_tpu/data/pretrain_transforms.py``, on the
port's copy of the clip transforms (``data/transforms.py``).

Two-resolution MIM pretrain transform.

Re-implements the reference's COCA/image-pretrain augmentation
(reference: dataset/pretrain_transforms.py:155 ``DataAugmentationForPretrain``
— rand-aug -> hflip -> one shared random-resized-crop box resized to TWO
target resolutions; dataset/masking_generator.py ``MaskingGenerator`` —
blockwise patch masking with exact mask-count maintenance) on the repo's
clip conventions: uint8 (T, H, W, C) numpy in, explicit
``numpy.random.Generator`` for worker determinism, float conversion left
to the device-side fused normalize (ops/preprocess.py).

The first stream ("patches") feeds the ViT encoder; the second
("visual_tokens") feeds the MIM target branch (pixel/teacher targets for
``MPLUGCOCA``'s masked-image-modeling loss, models/gpt2_multimodal.py).
Both streams come from the SAME crop box so targets stay aligned with
the masked patch grid.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import cv2
import numpy as np

from youku_mplug_tpu_torch.data.transforms import (
    _INTERP,
    RandomHorizontalFlip,
    RandomResizedCrop,
    TemporalConsistentRandAugment,
)

# the reference's MIM rand-aug op list (pretrain_transforms.py:168-169)
MIM_AUG_OPS = [
    "Identity", "AutoContrast", "Equalize", "Brightness", "Sharpness",
    "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
]


class BlockwiseMaskingGenerator:
    """Blockwise patch masking (reference masking_generator.py:6-83).

    Draws rectangular blocks by area/log-aspect until ``num_masking_patches``
    are covered, then trims/pads by random single patches so the count is
    EXACT — the fixed-count contract downstream MIM losses rely on.
    """

    def __init__(self, input_size, num_masking_patches: int,
                 min_num_patches: int = 4,
                 max_num_patches: Optional[int] = None,
                 min_aspect: float = 0.3,
                 max_aspect: Optional[float] = None):
        if not isinstance(input_size, (tuple, list)):
            input_size = (input_size, input_size)
        self.height, self.width = int(input_size[0]), int(input_size[1])
        self.num_masking_patches = int(num_masking_patches)
        self.min_num_patches = min_num_patches
        self.max_num_patches = (self.num_masking_patches
                                if max_num_patches is None
                                else int(max_num_patches))
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect = (math.log(min_aspect), math.log(max_aspect))

    def _block(self, mask: np.ndarray, max_mask_patches: int,
               rng: np.random.Generator) -> int:
        delta = 0
        # python random.uniform(a, b) tolerates b < a (samples between the
        # two either way); numpy Generator.uniform does not — sort bounds.
        lo, hi = sorted((float(self.min_num_patches),
                         float(max_mask_patches)))
        for _ in range(10):
            target = rng.uniform(lo, hi)
            aspect = math.exp(rng.uniform(*self.log_aspect))
            h = int(round(math.sqrt(target * aspect)))
            w = int(round(math.sqrt(target / aspect)))
            if w < self.width and h < self.height:
                top = int(rng.integers(0, self.height - h + 1))
                left = int(rng.integers(0, self.width - w + 1))
                region = mask[top:top + h, left:left + w]
                fresh = h * w - int(region.sum())
                if 0 < fresh <= max_mask_patches:
                    delta = fresh
                    region[:] = 1
                if delta > 0:
                    break
        return delta

    def __call__(self, rng: Optional[np.random.Generator] = None
                 ) -> np.ndarray:
        """-> (height, width) int32 mask with exactly
        ``num_masking_patches`` ones."""
        rng = rng or np.random.default_rng()
        mask = np.zeros((self.height, self.width), np.int32)
        count = 0
        while count < self.num_masking_patches:
            cap = min(self.num_masking_patches - count,
                      self.max_num_patches)
            delta = self._block(mask, cap, rng)
            if delta == 0:
                break
            count += delta
        # exact-count maintenance (reference :69-82)
        if count > self.num_masking_patches:
            ys, xs = mask.nonzero()
            drop = rng.choice(len(ys), count - self.num_masking_patches,
                              replace=False)
            mask[ys[drop], xs[drop]] = 0
        elif count < self.num_masking_patches:
            ys, xs = (mask == 0).nonzero()
            add = rng.choice(len(ys), self.num_masking_patches - count,
                             replace=False)
            mask[ys[add], xs[add]] = 1
        return mask


class TwoResolutionRandomResizedCrop(RandomResizedCrop):
    """One sampled crop box resized to two target resolutions (reference
    pretrain_transforms.py:39-133). Returns (first, second) clips."""

    def __init__(self, size: int, second_size: Optional[int] = None,
                 scale: Tuple[float, float] = (0.2, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3),
                 interpolation: str = "bicubic",
                 second_interpolation: str = "bicubic"):
        super().__init__(size, scale=scale, ratio=ratio,
                         interpolation=interpolation)
        second_size = second_size if second_size is not None else size
        self.second_size = ((second_size, second_size)
                            if isinstance(second_size, int)
                            else tuple(second_size))
        self.second_interp = _INTERP[second_interpolation]

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        t, h, w, c = clip.shape
        i, j, ch, cw = self._sample_box(h, w, rng)
        crop = clip[:, i:i + ch, j:j + cw]
        first = np.empty((t, self.size[0], self.size[1], c), clip.dtype)
        second = np.empty((t, self.second_size[0], self.second_size[1], c),
                          clip.dtype)
        for k, f in enumerate(crop):
            cv2.resize(f, (self.size[1], self.size[0]), dst=first[k],
                       interpolation=self.interp)
            cv2.resize(f, (self.second_size[1], self.second_size[0]),
                       dst=second[k], interpolation=self.second_interp)
        return first, second


class MIMPretrainTransform:
    """The full MIM pretrain augmentation (reference
    DataAugmentationForPretrain, pretrain_transforms.py:155-200):
    rand-aug (2 ops @ magnitude 7) -> hflip(0.5) -> two-resolution
    shared-box crop -> blockwise patch mask.

    Returns dict(patches, visual_tokens, mask): uint8 clips (normalize on
    device) + (window, window) int32 mask. For still images pass a
    one-frame clip; rand-aug ops are temporally consistent for clips.
    """

    def __init__(self, input_size: int = 224,
                 second_size: Optional[int] = None,
                 window_size: int = 14, num_mask_patches: int = 75,
                 max_mask_patches_per_block: Optional[int] = None,
                 min_mask_patches_per_block: int = 4,
                 rand_aug: bool = True, scale: Tuple[float, float] = (0.2, 1.0)):
        self.rand_aug = (TemporalConsistentRandAugment(
            n=2, m=7, augs=MIM_AUG_OPS) if rand_aug else None)
        self.hflip = RandomHorizontalFlip(0.5)
        self.crop = TwoResolutionRandomResizedCrop(
            input_size, second_size=second_size, scale=scale)
        self.mask_gen = BlockwiseMaskingGenerator(
            window_size, num_mask_patches,
            min_num_patches=min_mask_patches_per_block,
            max_num_patches=max_mask_patches_per_block)

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> dict:
        rng = rng or np.random.default_rng()
        if self.rand_aug is not None:
            clip = self.rand_aug(clip, rng=rng)
        clip = self.hflip(clip, rng=rng)
        patches, visual_tokens = self.crop(clip, rng=rng)
        return {"patches": patches, "visual_tokens": visual_tokens,
                "mask": self.mask_gen(rng)}
