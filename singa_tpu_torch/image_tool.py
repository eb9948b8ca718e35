"""Image augmentation toolkit.

Counterpart of ``singa_tpu/image_tool.py``, a copy of its own: free
functions (``load_img``, ``crop``, ``crop_and_resize``, ``resize``,
``color_cast``, ``enhance``, ``flip``, ...) and the chainable
:class:`ImageTool`, whose ops either sample one random case
(``inplace=True``, training) or enumerate cases (``num_case=n``,
test-time augmentation). PIL and numpy do the work; every random choice
comes from the stdlib ``random`` module in the JAX module's order, so
``random.seed(s)`` gives the same augmentation in both packages.
"""

from __future__ import annotations

import random

import numpy as np
from PIL import Image, ImageEnhance


def load_img(path, grayscale=False):
    img = Image.open(path)
    return img.convert("L" if grayscale else "RGB")


def crop(img, patch, position):
    """Crop a (pw, ph) patch at one of five positions
    (left_top/left_bottom/right_top/right_bottom/center)."""
    w, h = img.size
    pw, ph = patch
    if pw > w or ph > h:
        raise ValueError(f"patch {patch} larger than image {img.size}")
    boxes = {
        "left_top": (0, 0),
        "left_bottom": (0, h - ph),
        "right_top": (w - pw, 0),
        "right_bottom": (w - pw, h - ph),
        "center": ((w - pw) // 2, (h - ph) // 2),
    }
    if position not in boxes:
        raise ValueError(f"unknown crop position {position}")
    left, top = boxes[position]
    return img.crop((left, top, left + pw, top + ph))


def crop_and_resize(img, patch, position):
    """Crop a full-height (or full-width) strip whose aspect matches the
    patch, at left/center/right (or top/middle/bottom), then resize."""
    w, h = img.size
    pw, ph = patch
    if position in ("left", "center", "right"):
        strip = min(w, int(h * pw / ph)) if ph else w
        offs = {"left": 0, "center": (w - strip) // 2,
                "right": w - strip}[position]
        box = (offs, 0, offs + strip, h)
    elif position in ("top", "middle", "bottom"):
        strip = min(h, int(w * ph / pw)) if pw else h
        offs = {"top": 0, "middle": (h - strip) // 2,
                "bottom": h - strip}[position]
        box = (0, offs, w, offs + strip)
    else:
        raise ValueError(f"unknown crop_and_resize position {position}")
    return img.crop(box).resize(patch)


def resize(img, small_size):
    """Resize so the shorter side equals small_size, keeping aspect."""
    w, h = img.size
    if w < h:
        return img.resize((small_size, int(h * small_size / w)))
    return img.resize((int(w * small_size / h), small_size))


def scale(img, small_size):
    return resize(img, small_size)


def resize_by_hw(img, size):
    """size = (height, width)."""
    return img.resize((size[1], size[0]))


def color_cast(img, offset=20):
    """Add a random offset in [-offset, offset] to a random channel."""
    arr = np.asarray(img, np.int32).copy()
    if arr.ndim == 2:
        arr = arr[:, :, None]
    ch = random.randint(0, arr.shape[2] - 1)
    delta = random.randint(-offset, offset)
    arr[:, :, ch] = np.clip(arr[:, :, ch] + delta, 0, 255)
    return Image.fromarray(arr.squeeze().astype(np.uint8))


def enhance(img, scale=0.2):  # noqa: A002
    """Random brightness/contrast/color/sharpness jitter of +-scale."""
    for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                ImageEnhance.Color, ImageEnhance.Sharpness):
        factor = 1.0 + random.uniform(-scale, scale)
        img = enh(img).enhance(factor)
    return img


def flip(img):
    return img.transpose(Image.FLIP_LEFT_RIGHT)


def flip_down(img):
    return img.transpose(Image.FLIP_TOP_BOTTOM)


def get_list_sample(lst, sample_size):
    return random.sample(list(lst), sample_size)


class ImageTool:
    """Chainable augmentation pipeline (reference image_tool.ImageTool:214).

    Each op transforms every held image; ``inplace=True`` keeps the chain
    going with one random case per image, ``inplace=False`` returns the
    augmented list without touching the chain. ``num_case>1`` enumerates
    multiple augmentation cases per image (test-time augmentation).
    """

    def __init__(self):
        self.imgs = []

    def load(self, path, grayscale=False):
        self.imgs = [load_img(path, grayscale)]
        return self

    def set(self, imgs):  # noqa: A003
        self.imgs = list(imgs)
        return self

    def append(self, img):
        self.imgs.append(img)
        return self

    def get(self):
        return self.imgs

    def _apply(self, cases, num_case, inplace):
        """cases: list of (callable, case_id); sample num_case per image."""
        out = []
        for img in self.imgs:
            chosen = get_list_sample(cases, min(num_case, len(cases)))
            out.extend(fn(img) for fn in chosen)
        if inplace:
            self.imgs = out
            return self
        return out

    # ---- resize family ---------------------------------------------------
    def resize_by_range(self, rng, inplace=True):
        size = random.randint(rng[0], rng[1] - 1) if rng[1] > rng[0] \
            else rng[0]
        return self.resize_by_list([size], 1, inplace)

    def resize_by_list(self, size_list, num_case=1, inplace=True):
        return self._apply([lambda im, s=s: resize(im, s)
                            for s in size_list], num_case, inplace)

    scale_by_range = resize_by_range
    scale_by_list = resize_by_list

    def resize_by_hw_range(self, rng, inplace=True):
        h = random.randint(rng[0][0], rng[0][1])
        w = random.randint(rng[1][0], rng[1][1])
        return self.resize_by_hw_list([(h, w)], 1, inplace)

    def resize_by_hw_list(self, size_list, num_case=1, inplace=True):
        return self._apply([lambda im, s=s: resize_by_hw(im, s)
                            for s in size_list], num_case, inplace)

    # ---- rotate ----------------------------------------------------------
    def rotate_by_range(self, rng, inplace=True):
        angle = random.uniform(rng[0], rng[1])
        return self.rotate_by_list([angle], 1, inplace)

    def rotate_by_list(self, angle_list, num_case=1, inplace=True):
        return self._apply([lambda im, a=a: im.rotate(a)
                            for a in angle_list], num_case, inplace)

    # ---- crops -----------------------------------------------------------
    def crop5(self, patch, num_case=1, inplace=True):
        """Corners + center crop (reference crop5:377)."""
        positions = ["left_top", "left_bottom", "right_top",
                     "right_bottom", "center"]
        return self._apply([lambda im, p=p: crop(im, patch, p)
                            for p in positions], num_case, inplace)

    @staticmethod
    def _strip_crop(im, patch, idx):
        """idx 0/1/2 -> orientation-appropriate strip position, decided
        per image like the reference (crop3 image_tool.py:426-437)."""
        w, h = im.size
        positions = ["left", "center", "right"] if w >= h \
            else ["top", "middle", "bottom"]
        return crop_and_resize(im, patch, positions[idx])

    def crop3(self, patch, num_case=1, inplace=True):
        """Strip crops + resize (reference crop3:407)."""
        return self._apply(
            [lambda im, i=i: self._strip_crop(im, patch, i)
             for i in range(3)], num_case, inplace)

    def crop8(self, patch, num_case=1, inplace=True):
        """crop5 + crop3 cases (reference crop8:449)."""
        five = ["left_top", "left_bottom", "right_top", "right_bottom",
                "center"]
        cases = [lambda im, p=p: crop(im, patch, p) for p in five] + \
            [lambda im, i=i: self._strip_crop(im, patch, i)
             for i in range(3)]
        return self._apply(cases, num_case, inplace)

    def random_crop(self, patch, inplace=True):
        def fn(im):
            w, h = im.size
            left = random.randint(0, w - patch[0])
            top = random.randint(0, h - patch[1])
            return im.crop((left, top, left + patch[0], top + patch[1]))
        return self._apply([fn], 1, inplace)

    def random_crop_resize(self, patch, inplace=True):
        """Random-area crop then resize to patch (reference :504)."""
        def fn(im):
            w, h = im.size
            area_frac = random.uniform(0.08, 1.0)
            cw = max(1, int(w * np.sqrt(area_frac)))
            ch = max(1, int(h * np.sqrt(area_frac)))
            left = random.randint(0, w - cw)
            top = random.randint(0, h - ch)
            return im.crop((left, top, left + cw, top + ch)).resize(patch)
        return self._apply([fn], 1, inplace)

    # ---- photometric -----------------------------------------------------
    def flip(self, num_case=1, inplace=True):
        cases = [lambda im: im, flip]
        return self._apply(cases, num_case, inplace)

    def flip_down(self, num_case=1, inplace=True):
        cases = [lambda im: im, flip_down]
        return self._apply(cases, num_case, inplace)

    def color_cast(self, offset=20, inplace=True):
        return self._apply([lambda im: color_cast(im, offset)], 1, inplace)

    def enhance(self, scale=0.2, inplace=True):  # noqa: A002
        return self._apply([lambda im: enhance(im, scale)], 1, inplace)

    def num_augmentation(self):
        return len(self.imgs)
