"""Standard matting evaluation metrics (counterpart of
vidmat/eval/metrics.py; alphamatting.com / video-matting benchmark
conventions):

- **MAD**  mean absolute difference, reported x1e3
- **MSE**  mean squared error, reported x1e3
- **SAD**  sum of absolute differences, reported /1e3
- **Grad** gradient error: squared difference of Gaussian-derivative
  gradient magnitudes (sigma=1.4), summed, /1e3
- **Conn** connectivity error (Rhemann et al.): per-threshold largest
  connected component sweep, /1e3
- **dtSSD** temporal coherence: RMS difference of the frame-to-frame
  alpha deltas, x1e2
- **fgr MSE** foreground color error inside the matte (alpha>0), x1e3

MAD, MSE, SAD, Grad, dtSSD and fgr MSE are elementwise ops and small
separable convolutions: they run as torch ops in float32 on the
evaluator's device (full float32 on the card: no TF32), one frame at a
time. Conn is a data-dependent connected-component sweep and runs on the
host with scipy, as in the JAX package; it is opt-in for video.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from vidmat_torch._device import device_constant, full_fp32, resolve_device

ALL_METRICS = ("mad", "mse", "sad", "grad", "conn", "dtssd")


# ---------------------------------------------------------------------------
# Device-side per-frame metrics (alpha in [0,1], shape (H, W))
# ---------------------------------------------------------------------------


def _gauss_1d(sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps (radius = ceil(3*sigma))."""
    r = int(np.ceil(3.0 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _dgauss_1d(sigma: float) -> np.ndarray:
    """Unnormalized first-derivative-of-Gaussian taps; see
    :func:`_grad_filters` for the benchmark's unit-L2 2-D normalization."""
    r = int(np.ceil(3.0 * sigma))
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (-x * g / (sigma ** 2)).astype(np.float32)


def _grad_filters(sigma: float) -> tuple[np.ndarray, np.ndarray]:
    """Separable (smooth, derivative) taps scaled so the 2-D filter
    outer(gauss, dgauss) has unit L2 norm: the gaussgradient convention
    the matting benchmarks use."""
    g = _gauss_1d(sigma)
    dg = _dgauss_1d(sigma)
    scale = 1.0 / np.sqrt(np.sum(g.astype(np.float64) ** 2)
                          * np.sum(dg.astype(np.float64) ** 2))
    return g, (dg * scale).astype(np.float32)


@device_constant
def _grad_taps(sigma: float, device: torch.device):
    """:func:`_grad_filters`' taps as float32 tensors on ``device``."""
    return tuple(torch.from_numpy(t).to(device)
                 for t in _grad_filters(sigma))


def _sep_conv(img: torch.Tensor, kx: torch.Tensor,
              ky: torch.Tensor) -> torch.Tensor:
    """Separable 2-D cross-correlation with SAME (zero) padding on an
    (H, W) map: along x with ``kx``, then along y with ``ky``."""
    x = img[None, None]
    x = F.conv2d(x, kx.view(1, 1, 1, -1), padding=(0, len(kx) // 2))
    x = F.conv2d(x, ky.view(1, 1, -1, 1), padding=(len(ky) // 2, 0))
    return x[0, 0]


def _grad_amplitude(a: torch.Tensor, sigma: float) -> torch.Tensor:
    g, dg = _grad_taps(sigma, a.device)
    gx = _sep_conv(a, dg, g)   # d/dx smoothed along y
    gy = _sep_conv(a, g, dg)   # d/dy smoothed along x
    return torch.sqrt(gx * gx + gy * gy + 1e-12)


def _frame_metrics(pred: torch.Tensor, true: torch.Tensor,
                   sigma: float = 1.4) -> Dict[str, torch.Tensor]:
    """All device-side per-frame metrics of one frame pair.

    Returns unscaled accumulables (0-d tensors); scaling to literature
    units happens in :func:`scale_metric` so streaming accumulation stays
    a plain sum/mean."""
    pred = pred.float()
    true = true.float()
    diff = pred - true
    with full_fp32():
        ga = _grad_amplitude(pred, sigma) - _grad_amplitude(true, sigma)
    return {
        "mad": torch.mean(torch.abs(diff)),
        "mse": torch.mean(diff * diff),
        "sad": torch.sum(torch.abs(diff)),
        "grad": torch.sum(ga * ga),
    }


def _frame_metrics_region(pred: torch.Tensor, true: torch.Tensor,
                          region: torch.Tensor,
                          sigma: float = 1.4) -> Dict[str, torch.Tensor]:
    """Region-restricted variant of :func:`_frame_metrics`: the trimap
    unknown-band protocol of the matting benchmarks (alphamatting.com /
    DIM): means and sums run over ``region`` pixels only. Gradient
    amplitudes are still computed on the FULL frame (the filters smooth
    across the region boundary, per the standard protocol); only the
    error sum is restricted."""
    pred = pred.float()
    true = true.float()
    m = region.float()
    n = torch.clamp(torch.sum(m), min=1.0)
    diff = pred - true
    with full_fp32():
        ga = _grad_amplitude(pred, sigma) - _grad_amplitude(true, sigma)
    return {
        "mad": torch.sum(torch.abs(diff) * m) / n,
        "mse": torch.sum(diff * diff * m) / n,
        "sad": torch.sum(torch.abs(diff) * m),
        "grad": torch.sum(ga * ga * m),
    }


def _frame_dtssd(pred_t: torch.Tensor, pred_tm1: torch.Tensor,
                 true_t: torch.Tensor, true_tm1: torch.Tensor,
                 region: Optional[torch.Tensor] = None) -> torch.Tensor:
    d = (pred_t.float() - pred_tm1.float()) - (true_t.float()
                                               - true_tm1.float())
    if region is None:
        return torch.sqrt(torch.mean(d * d))
    m = region.float()
    return torch.sqrt(torch.sum(d * d * m) / torch.clamp(torch.sum(m),
                                                         min=1.0))


def _frame_fgr_mse(pred_fgr: torch.Tensor, true_fgr: torch.Tensor,
                   true_alpha: torch.Tensor) -> torch.Tensor:
    """Foreground MSE inside the matte (alpha>0), the RVM-style fgr
    metric."""
    mask = (true_alpha > 0).float()[..., None]
    d = (pred_fgr.float() - true_fgr.float()) * mask
    denom = torch.clamp(torch.sum(mask) * pred_fgr.shape[-1], min=1.0)
    return torch.sum(d * d) / denom


# ---------------------------------------------------------------------------
# Host-side connectivity (data-dependent; scipy.ndimage)
# ---------------------------------------------------------------------------


def connectivity_error(pred: np.ndarray, true: np.ndarray,
                       step: float = 0.1, theta: float = 0.15,
                       region: Optional[np.ndarray] = None) -> float:
    """Connectivity error (Rhemann et al. 2009), /1e3.

    For each threshold level the source region Omega is the largest
    connected component of {pred>=t} & {true>=t}; each pixel's l_map is
    the highest level at which it was still connected; the error sums the
    difference of the soft connectedness maps. Connected components are
    data-dependent host work, as in the JAX package."""
    from scipy import ndimage

    pred = np.asarray(pred, np.float32)
    true = np.asarray(true, np.float32)
    thresh_steps = np.arange(0.0, 1.0 + step, step)
    l_map = np.full(pred.shape, -1.0, np.float32)
    for i in range(1, len(thresh_steps)):
        t = thresh_steps[i]
        inter = (true >= t) & (pred >= t)
        if inter.any():
            labels, _ = ndimage.label(inter)
            sizes = np.bincount(labels.ravel())
            sizes[0] = 0
            omega = labels == sizes.argmax()
        else:
            omega = np.zeros_like(inter)
        flag = (l_map == -1.0) & (~omega)
        l_map[flag] = thresh_steps[i - 1]
    l_map[l_map == -1.0] = 1.0

    true_d = true - l_map
    pred_d = pred - l_map
    true_phi = 1.0 - true_d * (true_d >= theta)
    pred_phi = 1.0 - pred_d * (pred_d >= theta)
    err = np.abs(true_phi - pred_phi)
    if region is not None:
        # Region-restricted sum (the connectedness maps stay global;
        # only the error accumulation is restricted, as the benchmark
        # protocol has it).
        err = err * np.asarray(region, np.float32)
    return float(np.sum(err) / 1000.0)


# ---------------------------------------------------------------------------
# Scaling to literature units
# ---------------------------------------------------------------------------

_SCALES = {"mad": 1e3, "mse": 1e3, "sad": 1e-3, "grad": 1e-3,
           "dtssd": 1e2, "fgr_mse": 1e3, "conn": 1.0}


def scale_metric(name: str, value: float) -> float:
    return float(value) * _SCALES.get(name, 1.0)


def trimap_unknown_region(trimap: np.ndarray,
                          lo: float = 0.25, hi: float = 0.75) -> np.ndarray:
    """Boolean unknown-band mask from a trimap frame: the region the
    trimap-restricted benchmark protocol scores over. Takes float [0,1]
    or integer trimaps ((H, W) or (H, W, 1)); the byte convention of
    vidmat_torch.pipeline.trimap (<=0.25 bg, >=0.75 fg, between =
    unknown)."""
    t = np.asarray(trimap)
    if t.ndim == 3 and t.shape[-1] == 1:
        t = t[..., 0]
    if t.ndim != 2:
        raise ValueError(f"trimap must be (H, W) or (H, W, 1), got {t.shape}")
    if np.issubdtype(t.dtype, np.integer):
        t = t.astype(np.float32) / float(np.iinfo(t.dtype).max)
    return (t > lo) & (t < hi)


# ---------------------------------------------------------------------------
# Streaming evaluator
# ---------------------------------------------------------------------------


class VideoEval:
    """Streaming per-frame matting evaluator.

    Feed (pred_alpha, true_alpha) frame pairs (float arrays in [0,1] or
    uint8 in [0,255], (H, W) or (H, W, 1)) via :meth:`update`; read
    per-frame rows from :attr:`frames` and literature-scaled aggregates
    from :meth:`summary`. The device metrics run per frame on ``device``
    ("cuda", the default, raises without a CUDA device; or "cpu");
    ``conn`` (host connected components) only when requested. The
    signature is the JAX package's, plus ``device``.
    """

    def __init__(self, metrics: Sequence[str] = ("mad", "mse", "sad",
                                                 "grad", "dtssd"),
                 sigma: float = 1.4,
                 device: Union[str, torch.device] = "cuda"):
        unknown = set(metrics) - set(ALL_METRICS) - {"fgr_mse"}
        if unknown:
            raise ValueError(f"unknown metrics: {sorted(unknown)}; "
                             f"available: {ALL_METRICS + ('fgr_mse',)}")
        self.metrics = tuple(metrics)
        self.sigma = float(sigma)
        self.device = resolve_device(device)
        self.frames: List[Dict[str, float]] = []
        self._prev: Optional[tuple] = None

    def reset_temporal(self) -> None:
        """Break the dtSSD frame chain (call between clips / scene cuts so
        the transition across the boundary is not scored)."""
        self._prev = None

    @staticmethod
    def _canon(a: np.ndarray) -> np.ndarray:
        a = np.asarray(a)
        if a.ndim == 3 and a.shape[-1] == 1:
            a = a[..., 0]
        if a.ndim != 2:
            raise ValueError(f"alpha frame must be (H, W) or (H, W, 1), "
                             f"got {a.shape}")
        if np.issubdtype(a.dtype, np.integer):
            # uint8 mattes scale by 255; 16-bit PNG ground truth
            # (read_image keeps uint16) by 65535, etc.
            a = a.astype(np.float32) / float(np.iinfo(a.dtype).max)
        return np.asarray(a, np.float32)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def update(self, pred: np.ndarray, true: np.ndarray,
               pred_fgr: Optional[np.ndarray] = None,
               true_fgr: Optional[np.ndarray] = None,
               region: Optional[np.ndarray] = None) -> Dict[str, float]:
        """Score one frame pair. ``region`` (optional bool/0-1 mask, same
        H x W) restricts the alpha metrics to those pixels: pass the
        trimap unknown band (:func:`trimap_unknown_region`) for the
        standard trimap-restricted benchmark protocol. dtSSD pairs each
        transition with the CURRENT frame's region; fgr_mse keeps its own
        alpha>0 support."""
        pred = self._canon(pred)
        true = self._canon(true)
        if pred.shape != true.shape:
            raise ValueError(f"pred {pred.shape} vs true {true.shape}")
        if region is not None:
            region = np.asarray(region)
            if region.ndim == 3 and region.shape[-1] == 1:
                region = region[..., 0]
            if region.shape != pred.shape:
                raise ValueError(f"region {region.shape} vs pred "
                                 f"{pred.shape}")
            region = region.astype(np.float32)
        p_t, t_t = self._dev(pred), self._dev(true)
        r_t = None if region is None else self._dev(region)
        dev = (_frame_metrics(p_t, t_t, sigma=self.sigma)
               if r_t is None else
               _frame_metrics_region(p_t, t_t, r_t, sigma=self.sigma))
        names = [k for k in ("mad", "mse", "sad", "grad")
                 if k in self.metrics]
        vals = [dev[k] for k in names]
        if "dtssd" in self.metrics and self._prev is not None:
            names.append("dtssd")
            vals.append(_frame_dtssd(p_t, self._prev[0], t_t,
                                     self._prev[1], r_t))
        if "fgr_mse" in self.metrics and pred_fgr is not None \
                and true_fgr is not None:
            pf, tf = np.asarray(pred_fgr), np.asarray(true_fgr)
            names.append("fgr_mse")
            vals.append(_frame_fgr_mse(
                self._dev(pf.astype(np.float32)) / (
                    255.0 if pf.dtype == np.uint8 else 1.0),
                self._dev(tf.astype(np.float32)) / (
                    255.0 if tf.dtype == np.uint8 else 1.0),
                t_t))
        # One device-to-host copy per frame.
        got = dict(zip(names, torch.stack(vals).tolist())) if vals else {}
        row: Dict[str, float] = {k: got[k] for k in ("mad", "mse", "sad",
                                                      "grad") if k in got}
        if "conn" in self.metrics:
            row["conn"] = connectivity_error(pred, true, region=region)
        for k in ("dtssd", "fgr_mse"):
            if k in got:
                row[k] = got[k]
        if "dtssd" in self.metrics:
            self._prev = (p_t, t_t)
        self.frames.append(row)
        return row

    def summary(self) -> Dict[str, float]:
        """Literature-scaled aggregates: mean over frames (dtssd over the
        T-1 frame transitions)."""
        out: Dict[str, float] = {"frames": len(self.frames)}
        for name in self.metrics + (("fgr_mse",) if any(
                "fgr_mse" in r for r in self.frames) else ()):
            vals = [r[name] for r in self.frames if name in r]
            if vals:
                out[name] = scale_metric(name, float(np.mean(vals)))
        return out


def evaluate_sequences(pred_frames: Iterable[np.ndarray],
                       true_frames: Iterable[np.ndarray],
                       metrics: Sequence[str] = ("mad", "mse", "sad",
                                                 "grad", "dtssd"),
                       device: Union[str, torch.device] = "cuda",
                       ) -> Dict[str, float]:
    """Evaluate two aligned alpha-frame iterables on ``device``; returns
    the scaled summary. Raises if the sequences have different lengths."""
    ev = VideoEval(metrics=metrics, device=device)
    it_p: Iterator = iter(pred_frames)
    it_t: Iterator = iter(true_frames)
    sentinel = object()
    while True:
        p = next(it_p, sentinel)
        t = next(it_t, sentinel)
        if p is sentinel and t is sentinel:
            break
        if p is sentinel or t is sentinel:
            raise ValueError("pred/true sequences have different lengths "
                             f"(diverged at frame {len(ev.frames)})")
        ev.update(p, t)
    return ev.summary()
