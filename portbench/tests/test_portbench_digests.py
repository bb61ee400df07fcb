"""The seeded variables and the yardstick's counts, held to values recorded
at the commit before the architecture's parts moved behind the
configuration's names (the head's calibration into the reference module,
the FLOP count into the net's layer module), at the small size on the CPU.

The draw, scaled by kind, is held byte for byte: a sha256 of every leaf
before the head's calibration. It is elementwise arithmetic on torch's
CPU generator, recorded with torch 2.13.0+cpu and numpy 2.0.2 on an x86
Xeon whose torch CPU capability reads AVX512; a host or build whose
vector paths for ``randn`` or ``exp`` round differently reads other
digests with no change to the code. The calibrated head is held to a
tolerance: its gains come from float32 convolution sums whose rounding
follows the CPU's kernels and threads (1e-7 apart between 1 and 8
threads), far under what a change of target, channel or head output
moves. The counts are exact integers at the cell's own size."""

import hashlib

import numpy as np
import pytest

from portbench import harness, weights
from portbench.drivers.common import inputs
from portbench.layers import net, tail
from portbench.tests.small import small_cell

#: sha256 over each leaf's path, dtype, shape and bytes, paths sorted, of
#: the variables as drawn and scaled, before the head's calibration
DRAWN = {
    ("video_1080p.convert_alpha", 2**31 + 17):
        "e46765f46be60914f2b90f7a1f30cb1dac0f1efa644f006c2c09551edf2afd31",
    ("video_1080p.convert_alpha", 2**33 + 5):
        "bfade93620bc46d3e986d7f8684afd088c47377134aea249536e7738304881ea",
    ("video_1080p.convert_alpha", 12345):
        "e6f3b86fbc86507f2878ef89f71d1b8ee298ee91c7b9ae0bb5157332c3c21c1b",
    ("video_1080p.multistream_8", 2**31 + 17):
        "e46765f46be60914f2b90f7a1f30cb1dac0f1efa644f006c2c09551edf2afd31",
    ("video_1080p.multistream_8", 2**33 + 5):
        "bfade93620bc46d3e986d7f8684afd088c47377134aea249536e7738304881ea",
    ("video_1080p.multistream_8", 12345):
        "e6f3b86fbc86507f2878ef89f71d1b8ee298ee91c7b9ae0bb5157332c3c21c1b",
}

#: the calibrated head's bias and each output channel's gain (its kernel
#: over the drawn one)
HEAD = {
    ("video_1080p.convert_alpha", 2**31 + 17): (
        # bias
        -0.189379707, 0.307735085, 0.109165721, 0.197796777, 0.963460147,
        -0.11542917, 0.14670448, 0.0289214719, -0.119534589, -0.247789055,
        -0.265672982, 0.103832901, 0.273522675, 0.112271689, 0.30441168,
        -0.26494953,
        # gain
        0.673603116, 0.193252681, 0.534259491, 0.389491774, 0.87672278,
        0.748824819, 0.659835022, 0.84060242, 0.842229041, 0.344781922,
        0.53743948, 0.768993774, 1.67290797, 0.441092506, 0.384064361,
        0.391330793),
    ("video_1080p.convert_alpha", 2**33 + 5): (
        # bias
        0.2388127, 0.199653253, 0.146657482, -0.20270665, 0.232635543,
        -0.0324271657, -0.100288548, -0.179741204, -0.229670927, 0.158431843,
        0.0761185363, 0.261740386, -0.37654373, 0.285680413, -0.289468646,
        -0.247478306,
        # gain
        0.970251931, 0.139197431, 0.219954927, 0.336697068, 0.482456212,
        0.293183602, 0.227066948, 0.228015248, 0.754120572, 0.182437033,
        0.313818801, 0.14003704, 0.479845768, 0.189193947, 0.14199793,
        0.208731396),
    ("video_1080p.convert_alpha", 12345): (
        # bias
        1.07593095, 0.0383602306, -0.300346673, 0.29117164, 0.324519843,
        0.175112188, -0.293062299, 0.108088657, 0.499783844, 0.273637325,
        -0.352391303, 0.182490692, 1.4597404, 0.0673633441, -0.117138654,
        -0.0698216036,
        # gain
        1.00575438, 0.311155139, 0.228428818, 0.41965557, 1.70778807,
        0.503932436, 0.409343836, 0.364291116, 0.720026661, 0.305890751,
        0.317735498, 0.217394638, 0.558704584, 0.287791185, 0.541533818,
        0.485322135),
    ("video_1080p.multistream_8", 2**31 + 17): (
        # bias
        -0.209158614, 0.317713261, 0.109871678, 0.148129553, 0.975350559,
        -0.125461936, 0.117339797, 0.0339088105, -0.116266489, -0.23455137,
        -0.22586976, 0.0547009893, 0.352391452, 0.112861529, 0.269444734,
        -0.24955602,
        # gain
        0.714631423, 0.206208001, 0.534942469, 0.3737633, 0.871249861,
        0.741603813, 0.606371295, 0.820866932, 0.871255562, 0.358387584,
        0.506682946, 0.669262022, 1.50217691, 0.407978224, 0.37684088,
        0.406940678),
    ("video_1080p.multistream_8", 2**33 + 5): (
        # bias
        0.257781208, 0.202995285, 0.14077197, -0.18973434, 0.232811987,
        -0.0347238071, -0.090429917, -0.194195926, -0.212989345, 0.164225161,
        0.0597188435, 0.244798988, -0.342474312, 0.276696503, -0.279210001,
        -0.235161528,
        # gain
        0.925601408, 0.142625077, 0.203088265, 0.338741564, 0.522972396,
        0.326603071, 0.214079137, 0.242620675, 0.779475666, 0.184799982,
        0.343316139, 0.133084498, 0.461914879, 0.190801696, 0.143037744,
        0.207540897),
    ("video_1080p.multistream_8", 12345): (
        # bias
        1.03005075, 0.0428059734, -0.273938417, 0.252435207, 0.302975178,
        0.186678886, -0.304040462, 0.113191791, 0.494838297, 0.238435552,
        -0.34735474, 0.183478922, 1.43362153, 0.0691633224, -0.0998779759,
        -0.0643594489,
        # gain
        0.917396147, 0.29189242, 0.211558803, 0.378472572, 1.59802247,
        0.570504916, 0.431910728, 0.355990264, 0.688174473, 0.278345145,
        0.32648673, 0.219952419, 0.551920051, 0.276314166, 0.494802415,
        0.50813102),
}

#: the head's rounding room: 50 times what 1 and 8 threads differ by
HEAD_TOL = 1e-5

#: the net's operations a frame, each cell
FLOPS = {"video_1080p.convert_alpha": 1171868672,
         "video_1080p.multistream_8": 1171868672}

#: (units, bytes, operations) of a dispatch's work, each cell and layer
WORK = {
    ("video_1080p.convert_alpha", "net"): (21, 31223104, 4687441920),
    ("video_1080p.convert_alpha", "tail"): (3, 130560000, 1186007040),
    ("video_1080p.multistream_8", "net"): (9, 60329584, 9374883840),
    ("video_1080p.multistream_8", "tail"): (3, 261120000, 2372014080),
}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], path)
        else:
            yield path, np.ascontiguousarray(tree[k])


def digest(variables: dict) -> str:
    h = hashlib.sha256()
    for path, a in _leaves(variables):
        for part in (path, str(a.dtype), str(a.shape)):
            h.update(part.encode())
        h.update(a.tobytes())
    return h.hexdigest()


def drawn_and_calibrated(name: str, seed: int, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(weights, "calibrate", lambda *a, **k: None)
        _, drawn = inputs(small_cell(name), seed, "cpu")
    _, variables = inputs(small_cell(name), seed, "cpu")
    return drawn, variables


@pytest.mark.parametrize("name,seed", sorted(DRAWN))
def test_seeded_variables_are_the_recorded_ones(name, seed, monkeypatch):
    """The draw byte for byte; the calibration touches the head alone."""
    drawn, variables = drawn_and_calibrated(name, seed, monkeypatch)
    assert digest(drawn) == DRAWN[name, seed]
    for path, a in _leaves(variables):
        if not path.startswith("params/head/"):
            assert np.array_equal(a, dict(_leaves(drawn))[path]), path


@pytest.mark.parametrize("name,seed", sorted(HEAD))
def test_calibrated_head_is_the_recorded_one(name, seed, monkeypatch):
    drawn, variables = drawn_and_calibrated(name, seed, monkeypatch)
    k0, k1 = (v["params"]["head"]["kernel"].astype(np.float64)
              for v in (drawn, variables))
    k0, k1 = (k.reshape(-1, k.shape[-1]) for k in (k0, k1))
    gain = (k0 * k1).sum(0) / (k0 * k0).sum(0)
    n = gain.shape[0]
    bias, want_gain = np.array(HEAD[name, seed][:n]), HEAD[name, seed][n:]
    np.testing.assert_allclose(variables["params"]["head"]["bias"], bias,
                               rtol=HEAD_TOL, atol=HEAD_TOL)
    np.testing.assert_allclose(gain, want_gain, rtol=HEAD_TOL)
    np.testing.assert_allclose(k1, k0 * gain, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_counts_are_the_recorded_ones(name):
    cell = harness.find_cell(name)
    assert net.flops_per_frame(cell.config, cell.traffic) == FLOPS[name]
    for layer in (net, tail):
        work = layer.work(cell.config, cell.traffic)
        key = (name, layer.__name__.rsplit(".", 1)[1])
        assert (len(work), sum(w.bytes for w in work),
                sum(w.ops for w in work)) == WORK[key]
