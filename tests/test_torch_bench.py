"""``bench_torch.py`` on the CPU (``--quick --device cpu``): each mode
prints one JSON line with ``bench.py``'s keys (the 4K and multistream
modes too); without a card it raises unless given ``--device cpu``."""

import json

import pytest
import torch

import bench_torch

RING_KEYS = {"metric", "value", "unit", "vs_baseline", "p50_ms", "fps_min",
             "fps_max", "device", "resolution", "downsample_ratio", "dtype",
             "conv_impl", "preset", "p50_ms_per_frame"}
E2E_KEYS = {"metric", "value", "unit", "vs_baseline", "p50_ms",
            "h2d_ms_per_frame", "device", "resolution", "frames"}


@pytest.mark.parametrize("mode", ["1080p", "e2e"])
def test_bench_prints_one_record(mode, capsys):
    assert bench_torch.main(["--mode", mode, "--quick", "--device",
                             "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert (RING_KEYS if mode == "1080p" else E2E_KEYS) <= set(rec), rec
    assert rec["device"] == "cpu" and rec["value"] > 0
    assert rec["resolution"] == "512x256"
    if mode == "1080p":
        assert rec["preset"].startswith("video_1080p")
        assert rec["conv_impl"] == "planar" and rec["dtype"] == "bfloat16"
        assert rec["chunk"] == 4 and rec["dispatch"] == "eager chunk body"
        assert rec["downsample_ratio"] == 0.25
    else:
        assert rec["frames"] == 24


@pytest.mark.parametrize("mode", ["4k", "4k_tiled", "multistream"])
def test_unported_modes_raise(mode, capsys):
    """The modes that once raised naming their item print their record:
    video_4k at pool 8, tiled or not (A.8), and the multistream preset's
    8 streams a round (A.12)."""
    argv = ["--mode", mode, "--device", "cpu"]
    assert bench_torch.main(argv + ["--quick"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert RING_KEYS <= set(rec), rec
    assert rec["unit"] == "fps/gpu" and rec["value"] > 0
    if mode == "multistream":
        assert rec["preset"].startswith("multistream")
        assert rec["batch"] == 8 and rec["chunk"] == 1
        assert rec["resolution"] == "512x256 x8 streams"
        assert rec["downsample_ratio"] == 0.25
        assert rec["dispatch"] == "per-frame body on 8 streams"
        return
    assert rec["preset"].startswith("video_4k") and rec["value"] > 0
    assert rec["downsample_ratio"] == 0.125 and rec["chunk"] == 1
    assert rec["dispatch"] == "per-frame body"
    assert ("tile_size=None" in rec["preset"]) == (mode == "4k")
    assert rec.get("tile_size") == (128 if mode == "4k_tiled" else None)


def test_bench_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main(["--quick"])
    assert bench_torch.main(["--mode", "smoke"]) == 2
