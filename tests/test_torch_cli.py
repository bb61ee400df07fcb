"""The port's command line (``python -m vidmat_torch.cli``) on the CPU.

- Parsers: every subcommand's actions against the JAX package's
  (``vidmat/cli.py``'s ``_add_*`` helpers), action by action: option
  strings, destination, default, choices, type, nargs, required, const,
  metavar and action kind equal; the port adds only ``--device``. Help
  texts are equal too, except where the JAX text names a JAX mechanism
  the port does not have (``HELP_DIFFERS``: orbax checkpoints,
  jax.profiler, the Pallas interpreter, the TPU mesh of ``--pp``, the
  JAX export command).
- Subcommands: each driven with numpy-backed fakes in place of the
  port's video and image readers and writers (the card's machine has no
  cv2; the fakes keep every frame in memory), its outputs equal byte for
  byte to the API called directly on the same frames; ``train`` writes
  the variables ``train_on_clips`` gives, which ``video --checkpoint``
  serves; ``multistream --pp`` serves streams of unequal length on CPU
  positions and, with too few cards, exits naming the cards it needs.
"""

import argparse
import json
import os

import numpy as np
import pytest

from vidmat_torch import cli
from vidmat_torch.io import reader as io_reader
from vidmat_torch.io import writer as io_writer
from vidmat_torch.io.fixtures import synthetic_clip, synthetic_frame
from vidmat_torch.pipeline import trimap as trimap_mod

SUBCOMMANDS = ["video", "image", "bench", "multistream", "export",
               "bundle-video", "train", "live", "evaluate"]
#: (subcommand, dest) whose help names a JAX mechanism the port lacks
HELP_DIFFERS = {("video", "checkpoint"), ("video", "profile"),
                ("multistream", "preset"), ("multistream", "pp"),
                ("multistream", "pallas_interpret"),
                ("export", "checkpoint"), ("bundle-video", "bundle")}
FIELDS = ("option_strings", "dest", "default", "choices", "type", "nargs",
          "required", "const", "metavar")
H, W = 64, 128


def _subparsers(mod):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd")
    for name in SUBCOMMANDS:
        getattr(mod, "_add_" + name.replace("-", "_"))(sub)
    return sub.choices


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_parser_matches_jax(name):
    from vidmat import cli as jcli

    want = {a.dest: a for a in _subparsers(jcli)[name]._actions}
    got = {a.dest: a for a in _subparsers(cli)[name]._actions}
    assert set(got) - set(want) == {"device"}
    assert not set(want) - set(got)
    assert got["device"].default == "cuda"
    assert got["device"].choices == ["cuda", "cpu"]
    for dest, a in want.items():
        b = got[dest]
        for field in FIELDS:
            assert getattr(b, field) == getattr(a, field), (dest, field)
        assert type(b) is type(a), dest
        if (name, dest) not in HELP_DIFFERS:
            assert b.help == a.help, dest


class _Store(dict):
    """path -> frames (a video) or one array (an image)."""


@pytest.fixture
def store(monkeypatch):
    files = _Store()

    class FakeReader:
        def __init__(self, path):
            if path not in files:
                raise FileNotFoundError(path)
            self.frames = files[path]
            self.fps = 30.0
            self.height, self.width = self.frames[0].shape[:2]

        def close(self):
            pass

        def __iter__(self):
            return iter(np.array(f) for f in self.frames)

    class FakeWriter:
        def __init__(self, path, fps=30.0, queue_size=16):
            self.path = path
            files[path] = []

        def write(self, frame):
            files[self.path].append(np.array(frame))

        def close(self):
            pass

    def read_image(path):
        return np.array(files[path])

    def write_image(path, image):
        files[path] = np.array(image)

    monkeypatch.setattr(io_reader, "VideoReader", FakeReader)
    monkeypatch.setattr(io_reader, "image_sequence", lambda path: None)
    monkeypatch.setattr(io_reader, "read_image", read_image)
    monkeypatch.setattr(trimap_mod, "read_image", read_image)
    monkeypatch.setattr(io_writer, "VideoWriter", FakeWriter)
    monkeypatch.setattr(io_writer, "write_image", write_image)
    return files


def _clip(n=5, seed=3):
    return [f for f, _ in synthetic_clip(H, W, n, seed=seed)]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert int(np.sum(g != w)) == 0


def test_video_equals_convert_video(store, tmp_path, monkeypatch, capsys):
    import vidmat_torch

    monkeypatch.chdir(tmp_path)
    store["in.mp4"] = _clip()
    assert cli.main(["video", "in.mp4", "--output-alpha", "a.mp4",
                     "--output-composition", "c.mp4", "--preset",
                     "video_1080p", "--profile", "1",
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])[
        "frames"] == 5
    assert os.path.isfile(tmp_path / "vidmat_trace" / "trace.json")
    alphas, comps = [], []
    mcfg, pcfg = vidmat_torch.preset_video_1080p()
    vidmat_torch.convert_video(_clip(), output_alpha=alphas.append,
                               output_composition=comps.append,
                               model_cfg=mcfg, pipe_cfg=pcfg, device="cpu")
    _equal(store["a.mp4"], alphas)
    _equal(store["c.mp4"], comps)


def test_checkpoint_reads_npz_and_refuses_orbax(store, tmp_path, capsys):
    from vidmat_torch import ModelConfig
    from vidmat_torch.models.weights import default_checkpoint_path

    store["in.mp4"] = _clip(2)
    npz = default_checkpoint_path(ModelConfig())
    assert cli.main(["video", "in.mp4", "--output-alpha", "a.mp4",
                     "--checkpoint", npz, "--device", "cpu"]) == 0
    first = store["a.mp4"]
    assert cli.main(["video", "in.mp4", "--output-alpha", "a.mp4",
                     "--device", "cpu"]) == 0
    _equal(first, store["a.mp4"])  # the shipped npz is the default
    with pytest.raises(ValueError, match="orbax"):
        cli.main(["video", "in.mp4", "--checkpoint", str(tmp_path),
                  "--device", "cpu"])


def test_checkpoint_directory_names_the_converter(store, tmp_path):
    """An orbax directory given to ``--checkpoint`` raises naming the
    converter at the repo root and its command."""
    store["in.mp4"] = _clip(2)
    with pytest.raises(ValueError) as e:
        cli.main(["video", "in.mp4", "--checkpoint", str(tmp_path),
                  "--device", "cpu"])
    msg = str(e.value)
    assert "orbax checkpoint of the JAX package" in msg
    assert "python jax_checkpoint_to_npz.py CKPT_DIR OUT.npz" in msg
    assert os.path.isfile(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "jax_checkpoint_to_npz.py"))


def test_image_equals_matte_image(store):
    import vidmat_torch

    img, _ = synthetic_frame(60, 84, 0.3)
    store["in.png"] = img
    assert cli.main(["image", "in.png", "--output-alpha", "a.png",
                     "--output-foreground", "f.png", "--device", "cpu"]) == 0
    alpha, fgr = vidmat_torch.matte_image(img, device="cpu")
    _equal([store["a.png"], store["f.png"]], [alpha, fgr])


def test_bench_runs_bench_torch(capsys):
    assert cli.main(["bench", "--quick", "--device", "cpu"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["unit"] == "fps/gpu" and record["value"] > 0


def test_multistream_equals_multistream_matting(store, tmp_path):
    import vidmat_torch

    store["s0.mp4"], store["s1.mp4"] = _clip(4, 3), _clip(3, 5)
    out = str(tmp_path / "ms")
    assert cli.main(["multistream", "s0.mp4", "s1.mp4", "--output-dir", out,
                     "--height", str(H), "--width", str(W),
                     "--pallas-interpret", "--device", "cpu"]) == 0
    ms = vidmat_torch.MultiStreamMatting(2, H, W, downsample_ratio=0.25,
                                         device="cpu")
    want = {0: [], 1: []}
    ms.serve([_clip(4, 3), _clip(3, 5)],
             on_output=lambda i, n, a, o: want[i].append(np.array(a)))
    for i in range(2):
        _equal(store[os.path.join(out, f"alpha_{i:02d}.mp4")], want[i])


def test_export_and_bundle_video_equal_the_api(store, tmp_path, capsys):
    import dataclasses

    from vidmat_torch import preset_video_1080p
    from vidmat_torch.deploy import ServingBundle, export_bundle

    path = str(tmp_path / "cli_bundle")
    assert cli.main(["export", path, "--height", str(H), "--width", str(W),
                     "--preset", "video_1080p", "--chunk", "2",
                     "--device", "cpu"]) == 0
    manifest = json.loads(capsys.readouterr().out)
    assert manifest["chunk"] == 2 and manifest["platforms"] == ["cpu"]
    store["in.mp4"] = _clip()
    assert cli.main(["bundle-video", path, "in.mp4", "--output-alpha",
                     "a.mp4", "--device", "cpu"]) == 0
    mcfg, pcfg = preset_video_1080p()
    direct = export_bundle(str(tmp_path / "api_bundle"), H, W,
                           model_cfg=mcfg,
                           pipe_cfg=dataclasses.replace(pcfg, chunk_size=2),
                           device="cpu")
    alphas = []
    ServingBundle(direct, device="cpu").convert(_clip(),
                                                output_alpha=alphas.append)
    _equal(store["a.mp4"], alphas)


def test_live_equals_realtime_matting(store, monkeypatch, capsys):
    """Lockstep on both sides (frame t+1 is read only after frame t was
    written), so none is dropped however loaded the host is."""
    import threading

    import vidmat_torch

    written = threading.Event()
    Reader, Writer = io_reader.VideoReader, io_writer.VideoWriter

    class LockstepReader(Reader):
        def __iter__(self):
            for f in super().__iter__():
                yield f
                assert written.wait(60.0)
                written.clear()

    class SignallingWriter(Writer):
        def write(self, frame):
            super().write(frame)
            written.set()

    monkeypatch.setattr(io_reader, "VideoReader", LockstepReader)
    monkeypatch.setattr(io_writer, "VideoWriter", SignallingWriter)
    store["in.mp4"] = _clip(4)
    assert cli.main(["live", "in.mp4", "--output-alpha", "a.mp4",
                     "--pace-fps", "100", "--downsample-ratio", "0.5",
                     "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["dropped"] == 0 and stats["processed"] == 4, stats
    rt = vidmat_torch.RealtimeMatting(H, W, downsample_ratio=0.5,
                                      device="cpu")
    want = []

    def src():
        for f in _clip(4):
            yield f
            assert written.wait(60.0)
            written.clear()

    def on_frame(a8, comp):
        want.append(np.array(a8))
        written.set()

    s = rt.run(src(), pace_fps=100.0, on_frame=on_frame)
    assert s["dropped"] == 0
    _equal(store["a.mp4"], want)


def test_evaluate_equals_video_eval(store, tmp_path, capsys):
    from vidmat_torch.eval import VideoEval, scale_metric

    clip = list(synthetic_clip(H, W, 4, seed=2))
    pred = [np.round(a[..., 0] * 250).astype(np.uint8) for _, a in clip]
    true = [np.round(a[..., 0] * 255).astype(np.uint8) for _, a in clip]
    store["p.mp4"] = [np.repeat(p[..., None], 3, -1) for p in pred]
    store["t.mp4"] = [np.repeat(t[..., None], 3, -1) for t in true]
    report_path = str(tmp_path / "report.json")
    assert cli.main(["evaluate", "p.mp4", "t.mp4", "--metrics",
                     "mad,mse,grad,conn,dtssd", "--per-frame", "--output",
                     report_path, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    ev = VideoEval(metrics=("mad", "mse", "grad", "conn", "dtssd"),
                   device="cpu")
    for p, t in zip(pred, true):
        ev.update(p, t)
    want = ev.summary()
    want["per_frame"] = [{k: scale_metric(k, v) for k, v in row.items()}
                         for row in ev.frames]
    assert got == json.loads(json.dumps(want))
    with open(report_path) as f:
        assert json.load(f) == got


def test_train_writes_a_checkpoint_video_reads(store, tmp_path, capsys):
    """``train`` (ported with A.15) on synthetic clips writes the port's
    .npz: the variables of train_on_clips called directly with the same
    data, and ``video --checkpoint`` serves them as convert_video does."""
    import vidmat_torch
    from vidmat_torch import ModelConfig
    from vidmat_torch.models.weights import flatten_variables, load_npz
    from vidmat_torch.train.data import synthetic_clip_batches
    from vidmat_torch.train.loop import train_on_clips

    out = str(tmp_path / "ckpt")
    assert cli.main(["train", "--steps", "2", "--size", "32", "--clip-len",
                     "2", "--batch", "1", "--out", out,
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"saved checkpoint to {out}.npz")
    got = load_npz(out + ".npz")
    state = train_on_clips(ModelConfig(), synthetic_clip_batches(
        t=2, n=1, h=32, w=32), num_steps=2, lr=1e-4, device="cpu",
        callback=lambda i, m: None)
    want = flatten_variables(state.variables)
    assert set(flatten_variables(got)) == set(want)
    for k, v in flatten_variables(got).items():
        np.testing.assert_array_equal(v, want[k])
    store["in.mp4"] = _clip(3)
    assert cli.main(["video", "in.mp4", "--output-alpha", "a.mp4",
                     "--checkpoint", out + ".npz", "--device", "cpu"]) == 0
    alphas = []
    vidmat_torch.convert_video(_clip(3), output_alpha=alphas.append,
                               variables=got, device="cpu")
    _equal(store["a.mp4"], alphas)


def test_unported_subcommands_exit_naming_their_items(store):
    """multistream --pp with too few cards (none here) exits with the JAX
    package's message, naming the cards it needs, before it reads a
    frame (it exited naming A.12 before --pp was ported)."""
    store["a.mp4"] = _clip(2)
    with pytest.raises(SystemExit, match=r"--pp needs 2 devices per stream "
                                         r"\(2 for 1 streams\); 0 visible"):
        cli.main(["multistream", "a.mp4", "--output-dir", "x", "--pp"])


def test_multistream_pp_on_cpu_positions(store, tmp_path, capsys):
    """--pp --device cpu over streams of 4 and 6 frames: 2 x 2 CPU
    positions, each stream's frames written up to its own length, equal
    to PipelinedMatting on that stream alone."""
    from vidmat_torch.parallel.mesh import make_mesh
    from vidmat_torch.parallel.pp import PipelinedMatting

    clips = {"s0.mp4": _clip(4, 3), "s1.mp4": _clip(6, 5)}
    store.update(clips)
    out = str(tmp_path / "pp")
    assert cli.main(["multistream", "s0.mp4", "s1.mp4", "--output-dir", out,
                     "--height", str(H), "--width", str(W), "--pp",
                     "--device", "cpu"]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record == {"streams": 2, "mesh": {"stream": 2, "pp": 2},
                      "frames": [4, 6]}
    pp = PipelinedMatting(H, W, make_mesh(("pp",), devices=["cpu"] * 2),
                          downsample_ratio=0.25)
    for i, name in enumerate(clips):
        got = store[os.path.join(out, f"alpha_{i:02d}.mp4")]
        assert len(got) == len(clips[name])
        _equal(got, [a for a, _ in pp.convert(clips[name])])
