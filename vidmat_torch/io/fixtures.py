"""Synthetic video fixtures with closed-form ground-truth alpha
(counterpart of the moving-disk, clean-plate, hard and hard clean-plate
clips, the ambiguous twin-disk clip and the directory-format dataset
writer in vidmat/io/fixtures.py; numpy only, cv2 for the hard clip's JPEG
option and the dataset writer's PNGs alone)."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def synthetic_frame(h: int, w: int, t: float, seed: int = 0,
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One frame of the moving-disk clip: (frame uint8 (H, W, 3), alpha
    float32 (H, W, 1)); a soft-edged disk orbiting the frame center over a
    low-frequency background texture."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.rand(3, 4) * 2 * np.pi
    bg = _texture(xx, yy, h, w, phase)

    cx = w / 2 + 0.25 * w * np.cos(2 * np.pi * t)
    cy = h / 2 + 0.25 * h * np.sin(2 * np.pi * t)
    radius = 0.18 * min(h, w)
    dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    alpha = np.clip((radius - dist) / 2.0 + 0.5, 0.0, 1.0)[..., None]

    fg_color = np.array([0.9, 0.3, 0.2], np.float32) + 0.1 * np.sin(
        np.stack([xx, yy, xx + yy], axis=-1) / 17.0)
    frame = alpha * fg_color + (1.0 - alpha) * bg
    frame_u8 = np.round(np.clip(frame, 0, 1) * 255).astype(np.uint8)
    return frame_u8, alpha.astype(np.float32)


def synthetic_clip(h: int, w: int, num_frames: int, seed: int = 0,
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (frame_uint8, gt_alpha) pairs for a num_frames clip."""
    for i in range(num_frames):
        yield synthetic_frame(h, w, i / max(num_frames, 1), seed)


def synthetic_frames_only(h: int, w: int, num_frames: int, seed: int = 0
                          ) -> Iterator[np.ndarray]:
    for frame, _ in synthetic_clip(h, w, num_frames, seed):
        yield frame


def _texture(xx: np.ndarray, yy: np.ndarray, h: int, w: int,
             phase: np.ndarray) -> np.ndarray:
    return np.stack([
        0.5 + 0.2 * np.sin(2 * np.pi * xx / w * 3 + phase[c, 0])
        * np.cos(2 * np.pi * yy / h * 2 + phase[c, 1])
        + 0.1 * np.sin(2 * np.pi * (xx + yy) / (h + w) * 5 + phase[c, 2])
        for c in range(3)], axis=-1)


def synthetic_plate_frame(h: int, w: int, t: float, seed: int = 0,
                          camouflage: bool = True,
                          plate_jitter: float = 0.0,
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One frame of the clean-plate clip: (frame uint8 (H, W, 3), alpha
    float32 (H, W, 1), plate uint8 (H, W, 3)), the plate being the scene's
    background without the foreground.

    camouflage=True fills the orbiting disk with the same background
    texture sampled at a fixed per-seed offset, so only a comparison with
    the plate can find it. plate_jitter scales and noises the returned
    plate by that magnitude (an imperfect capture); the frame still
    composites over the true background."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.rand(3, 4) * 2 * np.pi
    bg = _texture(xx, yy, h, w, phase)

    cx = w / 2 + 0.25 * w * np.cos(2 * np.pi * t)
    cy = h / 2 + 0.25 * h * np.sin(2 * np.pi * t)
    radius = 0.18 * min(h, w)
    dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    alpha = np.clip((radius - dist) / 2.0 + 0.5, 0.0, 1.0)[..., None]

    if camouflage:
        ox = (0.2 + 0.3 * rng.rand()) * w
        oy = (0.2 + 0.3 * rng.rand()) * h
        fg_fill = _texture(xx + ox, yy + oy, h, w, phase)
    else:
        fg_fill = np.array([0.9, 0.3, 0.2], np.float32) + 0.1 * np.sin(
            np.stack([xx, yy, xx + yy], axis=-1) / 17.0)

    frame = alpha * fg_fill + (1.0 - alpha) * bg
    plate = bg
    if plate_jitter > 0.0:
        jr = np.random.RandomState(seed + 13)
        gain = 1.0 + plate_jitter * (2.0 * jr.rand() - 1.0)
        plate = plate * gain + plate_jitter * jr.randn(h, w, 3).astype(
            np.float32) * 0.5
    frame_u8 = np.round(np.clip(frame, 0, 1) * 255).astype(np.uint8)
    plate_u8 = np.round(np.clip(plate, 0, 1) * 255).astype(np.uint8)
    return frame_u8, alpha.astype(np.float32), plate_u8


def synthetic_plate_clip(h: int, w: int, num_frames: int, seed: int = 0,
                         camouflage: bool = True, plate_jitter: float = 0.0
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]]:
    """Yield (frame_uint8, gt_alpha, plate_uint8) for a clean-plate clip
    (the plate is constant across the clip, as a captured plate is)."""
    for i in range(num_frames):
        yield synthetic_plate_frame(h, w, i / max(num_frames, 1), seed,
                                    camouflage=camouflage,
                                    plate_jitter=plate_jitter)


def synthetic_ambiguous_frame(h: int, w: int, t: float, seed: int = 0,
                              target: int = 0
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """One frame of the AMBIGUOUS twin-disk clip.

    Two visually IDENTICAL soft-edged disks orbit the frame center in
    anti-phase; ground-truth alpha covers only disk ``target`` (0 or 1).
    The rendered frame is bit-identical for either target — no pixel
    evidence says which twin is the subject — so matting the right one
    requires an external hint (a keyframe trimap) carried forward by the
    temporal state. This is the fixture that makes trimap PROPAGATION a
    measurable capability instead of a no-op on unambiguous content.
    """
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.rand(3, 4) * 2 * np.pi
    bg = _texture(xx, yy, h, w, phase)

    radius = 0.15 * min(h, w)
    fg_color = np.array([0.9, 0.3, 0.2], np.float32) + 0.1 * np.sin(
        np.stack([xx, yy, xx + yy], axis=-1) / 17.0)
    alphas = []
    for k in range(2):  # twin k at orbit angle 2*pi*t + k*pi
        ang = 2 * np.pi * t + k * np.pi
        cx = w / 2 + 0.28 * w * np.cos(ang)
        cy = h / 2 + 0.28 * h * np.sin(ang)
        dist = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        alphas.append(np.clip((radius - dist) / 2.0 + 0.5,
                              0.0, 1.0)[..., None])
    # Anti-phase twins on a 0.28-radius orbit never overlap (centers are
    # 0.56*min(h,w) apart vs disk diameter 0.3), so the union composite
    # is exact.
    a_union = np.clip(alphas[0] + alphas[1], 0.0, 1.0)
    frame = a_union * fg_color + (1.0 - a_union) * bg
    frame_u8 = np.round(np.clip(frame, 0, 1) * 255).astype(np.uint8)
    return frame_u8, alphas[target].astype(np.float32)


def synthetic_ambiguous_clip(h: int, w: int, num_frames: int,
                             seed: int = 0, target: int = 0
                             ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (frame_uint8, gt_alpha) for the twin-disk ambiguous clip."""
    for i in range(num_frames):
        yield synthetic_ambiguous_frame(h, w, i / 30.0, seed, target)


def _disk_hair_alpha(xx: np.ndarray, yy: np.ndarray, h: int, w: int,
                     t: float, rng: np.random.RandomState, hair: bool
                     ) -> np.ndarray:
    """The hard clip's subject coverage: a soft orbiting disk and, with
    ``hair``, 12 thin waving filament strands on polar spirals whose
    alpha falls off with the arc distance (a real metric width, tapered
    toward the tip). Takes one draw of ``rng`` (the curl) with hair."""
    cx = w / 2 + 0.22 * w * np.cos(2 * np.pi * t)
    cy = h / 2 + 0.22 * h * np.sin(2 * np.pi * t)
    radius = 0.16 * min(h, w)
    dx, dy = xx - cx, yy - cy
    dist = np.sqrt(dx ** 2 + dy ** 2)
    alpha = np.clip((radius - dist) / 2.0 + 0.5, 0.0, 1.0)

    if hair:
        theta_pix = np.arctan2(dy, dx)
        r_max = 1.9 * radius
        n_strands = 12
        curl = 0.8 * (2.0 * rng.rand() - 1.0)
        base_w = 0.05 * radius
        a_hair = np.zeros((h, w), np.float32)
        for k in range(n_strands):
            ak = (2 * np.pi * k / n_strands
                  + 0.25 * np.sin(2 * np.pi * t + 1.7 * k))
            target = ak + curl * (dist - radius) / radius
            d_ang = np.angle(np.exp(1j * (theta_pix - target))).astype(
                np.float32)
            arc = np.abs(d_ang) * np.maximum(dist, 1e-3)
            taper = np.clip((r_max - dist) / (0.35 * radius), 0.0, 1.0)
            width = base_w * (0.3 + 0.7 * taper)
            prof = np.clip((width - arc) / 1.2 + 0.5, 0.0, 1.0)
            in_band = (dist >= radius * 0.9) & (dist <= r_max)
            a_hair = np.maximum(a_hair,
                                np.where(in_band, prof * taper, 0.0))
        alpha = np.maximum(alpha, a_hair)
    return alpha


def _hard_render(h: int, w: int, t: float, seed: int, pan: bool,
                 hair: bool, occluder: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """One noiseless float render of the hard scene at time t: (frame
    (H, W, 3) float32 before clipping, alpha (H, W))."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.rand(3, 4) * 2 * np.pi
    # A panning camera: a constant per-seed velocity.
    vx, vy = ((rng.rand(2) - 0.5) * np.array([w, h]) * 0.9) if pan \
        else (0.0, 0.0)
    bx, by = xx + vx * t, yy + vy * t
    bg = _texture(bx, by, h, w, phase)
    # A high-frequency octave that pans with the camera.
    hp = rng.rand(3, 2) * 2 * np.pi
    bg = bg + np.stack([
        0.07 * np.sin(2 * np.pi * bx / w * 23 + hp[c, 0])
        * np.cos(2 * np.pi * by / h * 19 + hp[c, 1])
        for c in range(3)], axis=-1)

    alpha = _disk_hair_alpha(xx, yy, h, w, t, rng, hair)

    fg_color = np.array([0.85, 0.45, 0.25], np.float32) + 0.12 * np.sin(
        np.stack([xx / 11.0, yy / 13.0, (xx + yy) / 17.0], axis=-1))
    frame = alpha[..., None] * fg_color + (1.0 - alpha[..., None]) * bg

    if occluder:
        bar_cx = w * (0.5 + 0.38 * np.sin(2 * np.pi * 0.7 * t + 1.0))
        bar_hw = 0.05 * w
        occ = np.clip((bar_hw - np.abs(xx - bar_cx)) / 1.5 + 0.5,
                      0.0, 1.0)
        occ_color = (np.array([0.2, 0.25, 0.3], np.float32)
                     + 0.1 * np.sin(np.stack([yy / 7.0, yy / 5.0,
                                              xx / 9.0], axis=-1)))
        frame = occ[..., None] * occ_color + (1.0 - occ[..., None]) * frame
        alpha = alpha * (1.0 - occ)  # the visible coverage
    return frame, alpha


def _shutter_average(render, t: float, shutter_dt: float, taps: int = 5):
    """Motion blur: the mean of ``taps`` renders (frame and alpha) over
    the shutter interval [t - dt/2, t + dt/2]."""
    offs = ((np.arange(taps) + 0.5) / taps - 0.5) * shutter_dt
    acc_f = acc_a = None
    for off in offs:
        f, a = render(t + off)
        acc_f = f if acc_f is None else acc_f + f
        acc_a = a if acc_a is None else acc_a + a
    return acc_f / taps, acc_a / taps


def _light_drift_gain(t: float, seed: int, magnitude: float) -> np.ndarray:
    """Per-channel exposure drift over the clip: slow sinusoids with a
    per-seed frequency and phase."""
    drng = np.random.RandomState(seed + 29)
    freq = 0.5 + drng.rand(3)
    ph = drng.rand(3) * 2 * np.pi
    return (1.0 + magnitude * np.sin(2 * np.pi * freq * t + ph)
            ).astype(np.float32)


def _jpeg_roundtrip(frame_u8: np.ndarray, quality: int) -> np.ndarray:
    """The frame through a JPEG encode and decode (cv2, imported here:
    only this option needs it)."""
    import cv2

    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(frame_u8,
                                                cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
    if not ok:
        return frame_u8
    return cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def synthetic_hard_frame(h: int, w: int, t: float, seed: int = 0,
                         pan: bool = True, hair: bool = True,
                         occluder: bool = True, noise: float = 0.015,
                         shutter_dt: float = 0.0,
                         light_drift: float = 0.0, jpeg: int = 0,
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One frame of the hard clip (vidmat/io/fixtures.py
    ``synthetic_hard_frame``): the moving disk with a panning textured
    background (``pan``), thin filament strands off its edge (``hair``),
    a textured bar sweeping in front (``occluder``; the ground truth is
    the visible coverage), sensor noise on the frame only (``noise``),
    motion blur over ``shutter_dt``, exposure drift (``light_drift``) and
    a JPEG round trip at quality ``jpeg`` (> 0; needs cv2). Returns
    (frame uint8 (H, W, 3), alpha float32 (H, W, 1))."""
    if shutter_dt > 0.0:
        frame, alpha = _shutter_average(
            lambda tt: _hard_render(h, w, tt, seed, pan, hair, occluder),
            t, shutter_dt)
    else:
        frame, alpha = _hard_render(h, w, t, seed, pan, hair, occluder)

    if light_drift > 0.0:
        frame = frame * _light_drift_gain(t, seed, light_drift)

    if noise > 0.0:
        nrng = np.random.RandomState(
            (seed * 9973 + int(t * 1e4) % 7919) % (2 ** 32 - 1))
        frame = frame + noise * nrng.randn(h, w, 3).astype(np.float32)

    frame_u8 = np.round(np.clip(frame, 0, 1) * 255).astype(np.uint8)
    if jpeg:
        frame_u8 = _jpeg_roundtrip(frame_u8, jpeg)
    return frame_u8, alpha[..., None].astype(np.float32)


def synthetic_hard_clip(h: int, w: int, num_frames: int, seed: int = 0,
                        motion_blur: float = 0.0,
                        **kw) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (frame_uint8, gt_alpha) of the hard clip. motion_blur: the
    shutter's open fraction of the frame interval (0.5 = a 180-degree
    shutter); the other options are ``synthetic_hard_frame``'s."""
    dt = 1.0 / max(num_frames, 1)
    for i in range(num_frames):
        yield synthetic_hard_frame(h, w, i * dt, seed,
                                   shutter_dt=motion_blur * dt, **kw)


# The octave-two realism knobs of the quality report's extended hard
# protocol: clip-level kwargs for synthetic_hard_clip (jpeg needs cv2).
HARD2 = dict(motion_blur=0.5, light_drift=0.15, jpeg=75)


def _hard_plate_render(h: int, w: int, t: float, seed: int, pan: float,
                       hair: bool
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One noiseless float render of the HARD clean-plate scene at exact
    time t: (frame (H,W,3), alpha (H,W), plate (H,W,3)).

    The scene is the plate fixture's camouflage task raised to the hard
    suite's realism: multi-octave background, the subject (disk AND hair
    filaments) filled with offset-sampled background texture so pixels
    alone cannot find even the strands — only plate comparison can —
    plus a slow camera drift (``pan`` = fraction of the frame drifted
    per unit t). The plate is the background AS CAPTURED AT t=0, so
    under drift it misregisters by a few pixels over the clip — the
    tripod-bump failure mode a real pre-captured plate suffers."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.rand(3, 4) * 2 * np.pi
    hp = rng.rand(3, 2) * 2 * np.pi
    vx, vy = (rng.rand(2) - 0.5) * 2.0 * pan * np.array([w, h])
    ox = (0.2 + 0.3 * rng.rand()) * w
    oy = (0.2 + 0.3 * rng.rand()) * h

    def octaves(sx, sy):
        base = _texture(sx, sy, h, w, phase)
        return base + np.stack([
            0.07 * np.sin(2 * np.pi * sx / w * 23 + hp[c, 0])
            * np.cos(2 * np.pi * sy / h * 19 + hp[c, 1])
            for c in range(3)], axis=-1)

    bg = octaves(xx + vx * t, yy + vy * t)
    plate = octaves(xx, yy)  # captured before the shot (t=0 camera pose)
    alpha = _disk_hair_alpha(xx, yy, h, w, t, rng, hair)
    # Camouflage fill: the same two-octave texture sampled at a fixed
    # per-seed offset (and riding the camera like the background does) —
    # locally indistinguishable from background in every statistic.
    fill = octaves(xx + ox + vx * t, yy + oy + vy * t)
    frame = alpha[..., None] * fill + (1.0 - alpha[..., None]) * bg
    return frame, alpha, plate


# The canonical EXTENDED hard-plate protocol: clip-level kwargs for
# synthetic_hard_plate_clip.
HARD_PLATE = dict(motion_blur=0.5, light_drift=0.12, pan=0.03,
                  plate_jitter=0.03)


def synthetic_hard_plate_frame(h: int, w: int, t: float, seed: int = 0,
                               pan: float = 0.03, hair: bool = True,
                               noise: float = 0.012,
                               plate_jitter: float = 0.03,
                               shutter_dt: float = 0.0,
                               light_drift: float = 0.0,
                               ) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """One frame of the HARD clean-plate suite.

    Composition of the plate fixture's camouflage premise with the hard
    suite's realism octaves: camouflaged disk AND camouflaged hair
    filaments (only the plate can reveal either), two-octave texture, a
    slow camera drift that misregisters the t=0-captured plate, shutter
    motion blur (exact time-averaged alpha), exposure drift on the frame
    (the plate keeps capture-time lighting — exactly the mismatch a real
    plate suffers), independent sensor noise on frame and plate, and the
    existing ``plate_jitter`` imperfect-capture model. No occluder: an
    object absent from the plate is by definition foreground to plate
    conditioning, so its ground-truth status would be ill-posed.

    Returns (frame_uint8 (H,W,3), alpha_f32 (H,W,1), plate_uint8 (H,W,3)).
    """
    if shutter_dt > 0.0:
        def render(tt):
            f, a, _ = _hard_plate_render(h, w, tt, seed, pan, hair)
            return f, a

        frame, alpha = _shutter_average(render, t, shutter_dt)
        _, _, plate = _hard_plate_render(h, w, t, seed, pan, hair)
    else:
        frame, alpha, plate = _hard_plate_render(h, w, t, seed, pan, hair)

    if light_drift > 0.0:
        frame = frame * _light_drift_gain(t, seed, light_drift)
    if noise > 0.0:
        nrng = np.random.RandomState(
            (seed * 9973 + int(t * 1e4) % 7919) % (2 ** 32 - 1))
        frame = frame + noise * nrng.randn(h, w, 3).astype(np.float32)
        prng = np.random.RandomState(seed + 17)  # plate noise: one
        plate = plate + noise * prng.randn(h, w, 3).astype(np.float32)
        #       capture => one static noise field, not per-frame
    if plate_jitter > 0.0:
        jr = np.random.RandomState(seed + 13)
        gain = 1.0 + plate_jitter * (2.0 * jr.rand() - 1.0)
        plate = plate * gain + plate_jitter * jr.randn(h, w, 3).astype(
            np.float32) * 0.5
    frame_u8 = np.round(np.clip(frame, 0, 1) * 255).astype(np.uint8)
    plate_u8 = np.round(np.clip(plate, 0, 1) * 255).astype(np.uint8)
    return frame_u8, alpha[..., None].astype(np.float32), plate_u8


def synthetic_hard_plate_clip(h: int, w: int, num_frames: int,
                              seed: int = 0, motion_blur: float = 0.0,
                              **kw) -> Iterator[Tuple[np.ndarray,
                                                      np.ndarray,
                                                      np.ndarray]]:
    """Yield (frame_uint8, gt_alpha, plate_uint8) for the hard
    clean-plate suite; the plate is constant across the clip (one
    capture). Pass ``**HARD_PLATE`` for the canonical protocol."""
    dt = 1.0 / max(num_frames, 1)
    for i in range(num_frames):
        yield synthetic_hard_plate_frame(h, w, i * dt, seed,
                                         shutter_dt=motion_blur * dt,
                                         **kw)


def write_synthetic_matting_dataset(root: str, num_clips: int = 2,
                                    frames: int = 6, h: int = 96,
                                    w: int = 96, seed: int = 0,
                                    backgrounds: int = 2) -> dict:
    """Write a directory-format matting dataset (fgr/pha clip dirs + bgr
    stills) from the synthetic fixture — the on-disk layout
    ``train.dataset.ClipDirDataset`` reads. Foreground frames store the
    PURE foreground (disk color over black), alpha the exact soft matte.

    Returns {'fgr': ..., 'pha': ..., 'bgr': ...} root paths.
    """
    import os

    from vidmat_torch.io.reader import require_cv2

    cv2 = require_cv2("writing the synthetic matting dataset")

    paths = {k: f"{root}/{k}" for k in ("fgr", "pha", "bgr")}
    for ci in range(num_clips):
        fd = f"{paths['fgr']}/clip_{ci:03d}"
        pd = f"{paths['pha']}/clip_{ci:03d}"
        os.makedirs(fd, exist_ok=True)
        os.makedirs(pd, exist_ok=True)
        for fi, (frame, alpha) in enumerate(
                synthetic_clip(h, w, frames, seed=seed + ci)):
            # the frame itself is the foreground layer (same convention as
            # synthetic_clip_batches: "frame where alpha>0"); the loader's
            # composite fgr*pha + bg*(1-pha) then yields a valid
            # (input, alpha, fgr) training triple
            cv2.imwrite(f"{fd}/{fi:05d}.png",
                        cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            cv2.imwrite(f"{pd}/{fi:05d}.png",
                        np.round(alpha[..., 0] * 255).astype(np.uint8))
    os.makedirs(paths["bgr"], exist_ok=True)
    rng = np.random.RandomState(seed + 777)
    for bi in range(backgrounds):
        noise = rng.rand(h * 2, w * 2, 3).astype(np.float32)
        bg = cv2.GaussianBlur(noise, (0, 0), sigmaX=9)
        bg = (bg - bg.min()) / max(1e-6, bg.max() - bg.min())
        cv2.imwrite(f"{paths['bgr']}/bg_{bi:03d}.png",
                    cv2.cvtColor(np.round(bg * 255).astype(np.uint8),
                                 cv2.COLOR_RGB2BGR))
    return paths
