"""Synthetic training batchers (counterpart of vidmat/train/data.py):
endless iterators of (clips (T, N, H, W, C), gt_alpha (T, N, H, W, 1),
gt_fgr (T, N, H, W, 3)) float32 numpy batches with exact ground truth, or
(clips, gt_mask) for the segmentation co-training step. Host numpy only:
equal seeds give the JAX package's batches byte for byte.
``alpha_to_trimap``, ``trimap_from_mask`` and ``_box_dilate`` are the
serving pipeline's (``pipeline/trimap.py``).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from vidmat_torch.io.fixtures import synthetic_frame
from vidmat_torch.pipeline.trimap import (_box_dilate,  # noqa: F401
                                          alpha_to_trimap, trimap_from_mask)


def synthetic_clip_batches(t: int = 4, n: int = 2, h: int = 64, w: int = 64,
                           seed: int = 0
                           ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]]:
    """Endless iterator of synthetic training batches with exact gt alpha."""
    rng = np.random.RandomState(seed)
    while True:
        clips = np.zeros((t, n, h, w, 3), np.float32)
        alphas = np.zeros((t, n, h, w, 1), np.float32)
        fgrs = np.zeros((t, n, h, w, 3), np.float32)
        for b in range(n):
            s = int(rng.randint(0, 10000))
            t0 = rng.rand()
            for ti in range(t):
                frame, alpha = synthetic_frame(h, w, t0 + ti / 30.0, seed=s)
                clips[ti, b] = frame.astype(np.float32) / 255.0
                alphas[ti, b] = alpha
                # exact foreground: frame where alpha>0 (disk color blend)
                fgrs[ti, b] = clips[ti, b]
        yield clips, alphas, fgrs


def synthetic_hard_clip_batches(t: int = 4, n: int = 2, h: int = 64,
                                w: int = 64, seed: int = 0,
                                octave2: float = 0.0
                                ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]]:
    """Endless iterator of HARD-fixture batches (io/fixtures.
    synthetic_hard_frame): panning multi-octave background, hair-like
    filament strands, a sweeping occluder, sensor noise — the failure
    modes the plain disk fixture cannot expose, with exact analytic
    alpha. Mixed into plain-family training via train_eval.py --hard.

    octave2: fraction of clips that ALSO carry the octave-two realism
    effects (shutter motion blur with exact time-averaged alpha,
    exposure drift, JPEG round-trip — io/fixtures HARD2 lineage), with
    per-clip randomized magnitudes so one checkpoint covers the range."""
    from vidmat_torch.io.fixtures import synthetic_hard_frame

    rng = np.random.RandomState(seed + 11)
    while True:
        clips = np.zeros((t, n, h, w, 3), np.float32)
        alphas = np.zeros((t, n, h, w, 1), np.float32)
        fgrs = np.zeros((t, n, h, w, 3), np.float32)
        for b in range(n):
            s = int(rng.randint(0, 10000))
            t0 = rng.rand()
            kw = {}
            if octave2 > 0.0 and rng.rand() < octave2:
                # 1/30 = the batcher's frame interval in t-units; blur
                # fraction up to a ~250-degree shutter
                kw = dict(shutter_dt=rng.uniform(0.2, 0.7) / 30.0,
                          light_drift=rng.uniform(0.0, 0.2),
                          jpeg=int(rng.choice([0, 60, 75, 90])))
            for ti in range(t):
                frame, alpha = synthetic_hard_frame(h, w, t0 + ti / 30.0,
                                                    seed=s, **kw)
                clips[ti, b] = frame.astype(np.float32) / 255.0
                alphas[ti, b] = alpha
                # frame-as-foreground convention (fgr loss masked by gt
                # alpha, so background/occluder pixels are ignored)
                fgrs[ti, b] = clips[ti, b]
        yield clips, alphas, fgrs


def synthetic_hard_plate_batches(t: int = 4, n: int = 2, h: int = 64,
                                 w: int = 64, seed: int = 0,
                                 plate_jitter: float = 0.03,
                                 octave2: float = 0.5
                                 ) -> Iterator[Tuple[np.ndarray,
                                                     np.ndarray,
                                                     np.ndarray]]:
    """Endless iterator of HARD clean-plate batches (io/fixtures.
    synthetic_hard_plate_frame): camouflaged disk AND camouflaged hair
    filaments over a two-octave background — only plate comparison can
    find the subject — with per-clip randomized camera drift (plate
    misregistration). octave2 fraction adds shutter blur + exposure
    drift. 6-channel clips: [frame | plate], the plate-family input
    convention (mixed into --plate training via train_eval.py --hard)."""
    from vidmat_torch.io.fixtures import synthetic_hard_plate_frame

    rng = np.random.RandomState(seed + 23)
    while True:
        clips = np.zeros((t, n, h, w, 6), np.float32)
        alphas = np.zeros((t, n, h, w, 1), np.float32)
        fgrs = np.zeros((t, n, h, w, 3), np.float32)
        for b in range(n):
            s = int(rng.randint(0, 10000))
            t0 = rng.rand()
            pan = float(rng.uniform(0.0, 0.05))
            kw = dict(pan=pan, plate_jitter=plate_jitter)
            if octave2 > 0.0 and rng.rand() < octave2:
                kw.update(shutter_dt=rng.uniform(0.2, 0.7) / 30.0,
                          light_drift=rng.uniform(0.0, 0.15))
            for ti in range(t):
                frame, alpha, plate = synthetic_hard_plate_frame(
                    h, w, t0 + ti / 30.0, seed=s, **kw)
                clips[ti, b, :, :, :3] = frame.astype(np.float32) / 255.0
                clips[ti, b, :, :, 3:] = plate.astype(np.float32) / 255.0
                alphas[ti, b] = alpha
                fgrs[ti, b] = clips[ti, b, :, :, :3]
        yield clips, alphas, fgrs


def synthetic_ambiguous_clip_batches(t: int = 4, n: int = 2, h: int = 64,
                                     w: int = 64, seed: int = 0
                                     ) -> Iterator[Tuple[np.ndarray,
                                                         np.ndarray,
                                                         np.ndarray]]:
    """Endless iterator of AMBIGUOUS twin-disk batches: two identical
    disks, gt alpha covers a randomly chosen one — pixel evidence alone
    cannot say which (io/fixtures.synthetic_ambiguous_frame)."""
    from vidmat_torch.io.fixtures import synthetic_ambiguous_frame

    rng = np.random.RandomState(seed + 7)
    while True:
        clips = np.zeros((t, n, h, w, 3), np.float32)
        alphas = np.zeros((t, n, h, w, 1), np.float32)
        fgrs = np.zeros((t, n, h, w, 3), np.float32)
        for b in range(n):
            s = int(rng.randint(0, 10000))
            t0 = rng.rand()
            target = int(rng.randint(2))
            for ti in range(t):
                frame, alpha = synthetic_ambiguous_frame(
                    h, w, t0 + ti / 30.0, seed=s, target=target)
                clips[ti, b] = frame.astype(np.float32) / 255.0
                alphas[ti, b] = alpha
                # frame-as-foreground convention; the fgr loss is masked
                # by gt alpha so the twin's pixels are ignored
                fgrs[ti, b] = clips[ti, b]
        yield clips, alphas, fgrs


def synthetic_plate_batches(t: int = 4, n: int = 2, h: int = 64,
                            w: int = 64, seed: int = 0,
                            camouflage: float = 0.5,
                            plate_jitter: float = 0.03,
                            ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]]:
    """Batches for the CLEAN-PLATE conditioned model (BGMv2 lineage):
    clips carry 3 extra input channels with the pre-captured background
    plate (io/fixtures.synthetic_plate_frame) — constant across each
    clip, as a real captured plate is.

    camouflage: fraction of clips whose foreground is filled with
    offset-sampled background texture — content where ONLY the plate
    can find the subject (the measured value of plate conditioning;
    the remainder are plain distinct-colored disks so the model also
    learns ordinary content).
    plate_jitter: imperfect-capture magnitude (brightness gain + noise
    on the plate channels only) so the model tolerates plates that do
    not match pixel-exactly.
    """
    from vidmat_torch.io.fixtures import synthetic_plate_frame

    rng = np.random.RandomState(seed + 3)
    while True:
        clips = np.zeros((t, n, h, w, 6), np.float32)
        alphas = np.zeros((t, n, h, w, 1), np.float32)
        fgrs = np.zeros((t, n, h, w, 3), np.float32)
        for b in range(n):
            s = int(rng.randint(0, 10000))
            t0 = rng.rand()
            camo = bool(rng.rand() < camouflage)
            for ti in range(t):
                frame, alpha, plate = synthetic_plate_frame(
                    h, w, t0 + ti / 30.0, seed=s, camouflage=camo,
                    plate_jitter=plate_jitter)
                clips[ti, b, :, :, :3] = frame.astype(np.float32) / 255.0
                clips[ti, b, :, :, 3:] = plate.astype(np.float32) / 255.0
                alphas[ti, b] = alpha
                # frame-as-foreground convention (fgr loss masked by gt
                # alpha, so background pixels are ignored)
                fgrs[ti, b] = clips[ti, b, :, :, :3]
        yield clips, alphas, fgrs


def synthetic_trimap_batches(t: int = 1, n: int = 2, h: int = 64,
                             w: int = 64, seed: int = 0,
                             keyframe: str = "off",
                             ambiguous: float = 0.0,
                             hard: float = 0.0,
                             octave2: float = 0.0):
    """Batches for the trimap-conditioned model: clips carry a 4th input
    channel with the {0, 0.5, 1} trimap derived from gt alpha.

    keyframe: trimap-PROPAGATION training (recurrent trimap family —
    the user annotates frame 0, the GRU carries the constraint forward):
      - "off":  every frame gets its own trimap (per-frame family);
      - "only": frame 0 gets its trimap, frames 1.. are all-0.5
                (fully unknown — the recurrence must do the work);
      - "mixed": alternate per-frame / keyframe batches so one
                checkpoint serves both input conventions.

    ambiguous: fraction of batches drawn from the twin-disk AMBIGUOUS
    task (synthetic_ambiguous_clip_batches) where only the trimap says
    which twin is the subject — keyframe batches on that task are what
    force the recurrence to actually CARRY the annotation (on
    unambiguous content a trimap-free net can ignore the hint entirely).

    hard: fraction of batches drawn from the HARD fixture
    (synthetic_hard_clip_batches — pan/hair/occluder/noise); the trimap
    channel derives from the hard alpha exactly like the plain one, so
    the conditioned families train on hard content too.
    """
    mode_rng = np.random.RandomState(seed + 1)
    plain = synthetic_clip_batches(t, n, h, w, seed)
    amb = (synthetic_ambiguous_clip_batches(t, n, h, w, seed)
           if ambiguous > 0.0 else None)
    hrd = (synthetic_hard_clip_batches(t, n, h, w, seed, octave2=octave2)
           if hard > 0.0 else None)
    while True:
        r = mode_rng.rand()
        if amb is not None and r < ambiguous:
            src = amb
        elif hrd is not None and r < ambiguous + hard:
            src = hrd
        else:
            src = plain
        clips, alphas, fgrs = next(src)
        key_batch = (keyframe == "only"
                     or (keyframe == "mixed" and mode_rng.rand() < 0.5))
        tri = np.stack([
            np.stack([alpha_to_trimap(alphas[ti, b]) for b in range(n)])
            if (ti == 0 or not key_batch)
            else np.full((n, h, w, 1), 0.5, np.float32)
            for ti in range(t)])
        clips4 = np.concatenate([clips, tri], axis=-1)
        yield clips4, alphas, fgrs

def synthetic_seg_batches(t: int = 4, n: int = 2, h: int = 64, w: int = 64,
                          seed: int = 0, hard: float = 0.0,
                          octave2: float = 0.0
                          ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless iterator of segmentation co-training batches:
    (clips (T,N,H,W,3), gt_mask (T,N,H,W,1) float {0,1}).

    Stand-in for a real person-segmentation dataset (the label modality
    RVM-lineage co-training consumes at scale): the synthetic subject's
    binarized coverage. A real adapter plugs any (frames, binary mask)
    source into the same iterator contract (e.g. ClipDirDataset's pha
    thresholded at 0.5).

    hard: fraction of clips drawn from the HARD fixture (pan / hair /
    occluder / noise; masks binarize the hard alpha — filaments mostly
    vanish under the 0.5 threshold, as a real segmentation label would).
    octave2: of those, the fraction also carrying shutter blur /
    exposure drift / JPEG (io/fixtures octave-two effects).
    """
    from vidmat_torch.io.fixtures import synthetic_hard_frame

    rng = np.random.RandomState(seed)
    while True:
        clips = np.zeros((t, n, h, w, 3), np.float32)
        masks = np.zeros((t, n, h, w, 1), np.float32)
        for b in range(n):
            s = int(rng.randint(0, 10000))
            t0 = rng.rand()
            use_hard = hard > 0.0 and rng.rand() < hard
            kw = {}
            if use_hard and octave2 > 0.0 and rng.rand() < octave2:
                kw = dict(shutter_dt=rng.uniform(0.2, 0.7) / 30.0,
                          light_drift=rng.uniform(0.0, 0.2),
                          jpeg=int(rng.choice([0, 60, 75, 90])))
            for ti in range(t):
                if use_hard:
                    frame, alpha = synthetic_hard_frame(
                        h, w, t0 + ti / 30.0, seed=s, **kw)
                else:
                    frame, alpha = synthetic_frame(h, w, t0 + ti / 30.0,
                                                   seed=s)
                clips[ti, b] = frame.astype(np.float32) / 255.0
                masks[ti, b] = (alpha > 0.5).astype(np.float32)
        yield clips, masks
