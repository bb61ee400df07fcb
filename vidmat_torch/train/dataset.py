"""Directory-format video-matting dataset (counterpart of
vidmat/train/dataset.py), the layout public matting datasets ship in:

    fgr_root/clip_000/00000.png ...   RGB foreground frames
    pha_root/clip_000/00000.png ...   grayscale alpha, matching names
    bgr_root/*.png                    still background images (optional)

A flat directory of frames (no clip subdirectories) is one clip. Batches
are composed on the fly, ``frame = fgr * pha + bg * (1 - pha)``, and
yielded in the contract of ``train/loop.py``: ``(clips (T, N, H, W, 3),
gt_alpha (T, N, H, W, 1), gt_fgr (T, N, H, W, 3))`` float32 in [0, 1].

Augmentation: one crop and flip shared by a clip's T frames, a slow pan
of the background across the clip (a sliding crop window), and solid
random colors when no ``bgr_root`` is given. All host numpy and cv2 work
(cv2 reads and resizes the images, and says so through ``require_cv2``
where it is missing); equal seeds give the JAX package's batches.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np

from vidmat_torch.io.reader import read_image, require_cv2

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def _list_frames(d: str) -> List[str]:
    return sorted(
        os.path.join(d, f) for f in os.listdir(d)
        if f.lower().endswith(_IMG_EXTS))


def _list_clips(root: str) -> List[List[str]]:
    """Clip subdirectories (sorted), or the root itself as one clip."""
    if not os.path.isdir(root):
        raise FileNotFoundError(root)
    subdirs = sorted(
        os.path.join(root, d) for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d)))
    if subdirs:
        clips = [_list_frames(d) for d in subdirs]
        clips = [c for c in clips if c]
        if not clips:
            raise ValueError(f"no frames under any clip dir in {root}")
        return clips
    frames = _list_frames(root)
    if not frames:
        raise ValueError(f"no image frames in {root}")
    return [frames]


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    cv2 = require_cv2("resizing the dataset's frames")
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA
                      if img.shape[0] >= h else cv2.INTER_LINEAR)


def _load_rgb(path: str) -> np.ndarray:
    img = read_image(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img[..., :3].astype(np.float32) / 255.0


def _load_alpha(path: str) -> np.ndarray:
    img = read_image(path)
    if img.ndim == 3:
        # RGBA alpha plane if present, else luminance of an RGB-saved matte
        img = img[..., 3] if img.shape[-1] == 4 else img[..., :3].mean(-1)
    return img.astype(np.float32)[..., None] / 255.0


class ClipDirDataset:
    """Endless sampler over a directory-format matting dataset.

    fgr_root/pha_root: clip layout above; frame lists must align per clip
        (same count, sorted names pair up).
    bgr_root: directory of background stills, a single image path, or
        None (solid random colors).
    size: output (H, W) crop, or one int for square.
    clip_len/batch: T and N of the yielded batches.
    motion_aug: slide the background crop across the clip (pan).
    scale_jitter: random pre-crop resize in [1.0, 1.0 + scale_jitter]
        of the minimal covering scale.
    """

    def __init__(self, fgr_root: str, pha_root: str,
                 bgr_root: Optional[str] = None,
                 clip_len: int = 4, batch: int = 2,
                 size: Union[int, Tuple[int, int]] = 256,
                 seed: int = 0, motion_aug: bool = True,
                 flip: bool = True, scale_jitter: float = 0.25,
                 max_pan: int = 16):
        self.fgr_clips = _list_clips(fgr_root)
        self.pha_clips = _list_clips(pha_root)
        if len(self.fgr_clips) != len(self.pha_clips):
            raise ValueError(
                f"fgr has {len(self.fgr_clips)} clips, pha has "
                f"{len(self.pha_clips)} — the roots must mirror each other")
        for i, (f, p) in enumerate(zip(self.fgr_clips, self.pha_clips)):
            if len(f) != len(p):
                raise ValueError(
                    f"clip {i}: {len(f)} fgr frames vs {len(p)} pha frames")
        if bgr_root is None:
            self.bg_paths: Optional[List[str]] = None
        elif os.path.isdir(bgr_root):
            self.bg_paths = _list_frames(bgr_root)
            if not self.bg_paths:
                raise ValueError(f"no background images in {bgr_root}")
        else:
            self.bg_paths = [bgr_root]
        self.t = clip_len
        self.n = batch
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.motion_aug = motion_aug
        self.flip = flip
        self.scale_jitter = scale_jitter
        self.max_pan = max_pan
        self.rng = np.random.RandomState(seed)

    # -- sampling pieces ----------------------------------------------------

    def _sample_fg(self, rng) -> Tuple[np.ndarray, np.ndarray]:
        """(fgr (T,H,W,3), pha (T,H,W,1)) with one crop/flip shared over T."""
        h, w = self.size
        ci = rng.randint(len(self.fgr_clips))
        fpaths, ppaths = self.fgr_clips[ci], self.pha_clips[ci]
        start = rng.randint(max(1, len(fpaths)))
        # modular indexing loops short clips instead of rejecting them
        idx = [(start + k) % len(fpaths) for k in range(self.t)]

        first = _load_rgb(fpaths[idx[0]])
        ih, iw = first.shape[:2]
        # minimal covering scale, jittered up, then one shared crop
        base = max(h / ih, w / iw)
        scale = base * (1.0 + rng.rand() * self.scale_jitter)
        rh, rw = max(h, int(round(ih * scale))), max(w, int(round(iw * scale)))
        y0 = rng.randint(rh - h + 1)
        x0 = rng.randint(rw - w + 1)
        do_flip = self.flip and rng.rand() < 0.5

        fgr = np.empty((self.t, h, w, 3), np.float32)
        pha = np.empty((self.t, h, w, 1), np.float32)
        for k, fi in enumerate(idx):
            fr = first if k == 0 else _load_rgb(fpaths[fi])
            al = _load_alpha(ppaths[fi])
            if al.shape[:2] != fr.shape[:2]:
                raise ValueError(
                    f"{ppaths[fi]}: alpha {al.shape[:2]} does not match "
                    f"fgr {fr.shape[:2]}")
            fr = _resize(fr, rh, rw)
            al = _resize(al[..., 0], rh, rw)[..., None]
            fr = fr[y0:y0 + h, x0:x0 + w]
            al = al[y0:y0 + h, x0:x0 + w]
            if do_flip:
                fr, al = fr[:, ::-1], al[:, ::-1]
            fgr[k], pha[k] = fr, np.clip(al, 0.0, 1.0)
        return fgr, pha

    def _sample_bg(self, rng) -> np.ndarray:
        """(T, H, W, 3) background with a slow pan across the clip."""
        h, w = self.size
        if self.bg_paths is None:
            color = rng.rand(3).astype(np.float32)
            return np.broadcast_to(color, (self.t, h, w, 3)).copy()
        img = _load_rgb(self.bg_paths[rng.randint(len(self.bg_paths))])
        pan = self.max_pan if self.motion_aug else 0
        margin = pan * max(1, self.t - 1)
        ih, iw = img.shape[:2]
        scale = max((h + margin) / ih, (w + margin) / iw)
        rh = max(h + margin, int(round(ih * scale)))
        rw = max(w + margin, int(round(iw * scale)))
        img = _resize(img, rh, rw)
        vy = rng.randint(-pan, pan + 1) if pan else 0
        vx = rng.randint(-pan, pan + 1) if pan else 0
        # start so every frame's window stays in bounds
        ylo = max(0, -vy * (self.t - 1))
        yhi = rh - h - max(0, vy * (self.t - 1))
        xlo = max(0, -vx * (self.t - 1))
        xhi = rw - w - max(0, vx * (self.t - 1))
        y0 = rng.randint(ylo, yhi + 1)
        x0 = rng.randint(xlo, xhi + 1)
        out = np.empty((self.t, h, w, 3), np.float32)
        for k in range(self.t):
            y, x = y0 + vy * k, x0 + vx * k
            out[k] = img[y:y + h, x:x + w]
        return out

    # -- iterator contract --------------------------------------------------

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Endless (clips, gt_alpha, gt_fgr) float32 batches."""
        h, w = self.size
        while True:
            clips = np.empty((self.t, self.n, h, w, 3), np.float32)
            alphas = np.empty((self.t, self.n, h, w, 1), np.float32)
            fgrs = np.empty((self.t, self.n, h, w, 3), np.float32)
            for b in range(self.n):
                fgr, pha = self._sample_fg(self.rng)
                bg = self._sample_bg(self.rng)
                clips[:, b] = fgr * pha + bg * (1.0 - pha)
                alphas[:, b] = pha
                fgrs[:, b] = fgr
            yield clips, alphas, fgrs


def with_trimaps(batches) -> Iterator[
        Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Wrap a (clips, alpha, fgr) iterator for the trimap-conditioned model:
    appends the {0, 0.5, 1} trimap derived from gt alpha as channel 4."""
    from vidmat_torch.train.data import alpha_to_trimap

    for clips, alphas, fgrs in batches:
        t, n = clips.shape[:2]
        tri = np.stack([
            np.stack([alpha_to_trimap(alphas[ti, b]) for b in range(n)])
            for ti in range(t)])
        yield np.concatenate([clips, tri], axis=-1), alphas, fgrs

def as_seg_batches(batches, threshold: float = 0.5) -> Iterator[
        Tuple[np.ndarray, np.ndarray]]:
    """Adapt a (clips, alpha, fgr) iterator into the (clips, gt_mask)
    contract of the segmentation co-training step
    (``loop.make_seg_train_step``): the mask is gt alpha binarized at
    ``threshold``. Lets the directory-format dataset double as
    segmentation supervision; a dedicated person-seg dataset (masks, no
    alpha) plugs into the same contract directly."""
    for clips, alphas, _ in batches:
        yield clips, (alphas > threshold).astype(np.float32)
