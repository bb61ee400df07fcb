"""The check's control and faults come out as not correct: the reference
in float8 e4m3 in the program's place, and the timed path broken
underneath (a state that never advances, half of the batch left out,
an answer altered where it is produced: the one made for the call
before), each driven through the rest of a run at a small size on the
CPU. The faults break the planar net's program (``PlanarNetwork`` and
its serving body), so they run over the cells whose configuration names
the planar net (``"net": "net"``); the control over every cell with
test sizes."""

import pytest
import torch

from portbench import harness
from portbench.control import control
from portbench.tests.small import CONTROL, SMALL, run_small, small_cell

#: the cells with test sizes whose configuration is the planar net's
PLANAR = [n for n in sorted(SMALL)
          if harness.find_cell(n).config["net"] == "net"]


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("seed", [2**31 + 1, 2**33 + 5, 12345])
def test_fp8_control_is_not_correct(name, seed):
    torch.set_num_threads(4)
    res = control(small_cell(name, sizes=CONTROL), seed, 40, "cpu")
    assert not res["correct"], res["checks"]


def state_never_advances(monkeypatch):
    """Each stage-step hands on the hidden map it was given (the first
    step's own where it was given none), in ``decode`` and in the chunk
    body's ``decode_frames`` alike, which both step through
    ``decode_stage``."""
    from vidmat_torch.models.planar import PlanarNetwork

    decode_stage = PlanarNetwork.decode_stage

    def frozen(self, j, enc, xs, h_prev, *a, **kw):
        xs, h = decode_stage(self, j, enc, xs, h_prev, *a, **kw)
        return xs, (h_prev if h_prev is not None else h)

    monkeypatch.setattr(PlanarNetwork, "decode_stage", frozen)


def half_the_batch(monkeypatch):
    from vidmat_torch.models.planar import PlanarNetwork, PlanarEncoding

    encode = PlanarNetwork.encode

    def half(self, frame, *a, **kw):
        n = frame.shape[0]
        enc = encode(self, frame[:max(1, n // 2)], *a, **kw)
        reps = -(-n // max(1, n // 2))
        return PlanarEncoding(*(None if t is None else
                                t.repeat(reps, *(1,) * (t.dim() - 1))[:n]
                                for t in enc))

    monkeypatch.setattr(PlanarNetwork, "encode", half)


def answer_stale(monkeypatch):
    """Each call of the output kernel hands back the answer it made for
    the call before (a stale buffer)."""
    from vidmat_torch.pipeline import stepfactory

    def stale(fn):
        last = []

        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            prev = last.pop() if last else out
            last.append(out.clone())
            return prev if prev.shape == out.shape else out
        return wrapper

    monkeypatch.setattr(stepfactory, "fused_refine_composite",
                        stale(stepfactory.fused_refine_composite))


FAULTS = {"state_never_advances": state_never_advances,
          "half_the_batch": half_the_batch,
          "answer_stale": answer_stale}


def batch(name):
    """Frames a batch of the net's stateless half at the small size: a
    chunk where the chunk body runs (the guided tail at a pool), else a
    round's streams."""
    cell = small_cell(name)
    pipe = cell.config["pipeline"]
    if cell.traffic["driver"] == "convert" and pipe["refine"]["mode"] == \
            "guided":
        return pipe["chunk_size"]
    return cell.traffic.get("streams", 1)


@pytest.mark.parametrize("name", PLANAR)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(name, fault, monkeypatch):
    if fault == "half_the_batch" and batch(name) < 2:
        pytest.skip("this cell's batches hold one frame: no half to leave "
                    "out")
    FAULTS[fault](monkeypatch)
    r = run_small(name, seconds=1.0)
    assert not r["correct"], r["checks"]
