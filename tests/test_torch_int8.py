"""The int8-stored planar conv probe: the port's ``int8_conv_plain``
against the TPU probe kernel's math on the CPU, and the port's probe
tool.

The probe kernel (tools/bench_int8_planes.py ``int8_kernel``) dequantizes
int8 planes to bf16, runs the planar 3x3 tap conv (bf16 weights, f32
sums), ReLU, the interior mask, and requantizes with ``jnp.round``. Here
the same math goes through the JAX package's ``planar_conv`` in
interpret mode (out_dtype float32, scale 1, bias 0) on the dequantized
planes, requantized with ``jnp.round``; the tool itself is neither
imported nor edited. Bar: max 1 int8 unit (the two sum the same exact
products in another order, so a value on a rounding tie may go the other
way); in practice they agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidmat_torch.ops.int8_planar import Q, int8_conv, int8_conv_plain


def _jax_int8_layer(xq, taps):
    """xq (N, H, W, 16) int8, taps (9, 16, 16) bf16 [t, c_out, c_in] ->
    (N, H, W, 16) int8 by the probe kernel's math."""
    from vidmat.ops.pallas.planar import (conv3x3_taps, from_planar,
                                          interior_mask, planar_conv,
                                          to_planar)

    n, h, w, c = xq.shape
    outs = []
    for i in range(n):
        xb = jnp.asarray(xq[i:i + 1]).astype(jnp.bfloat16) * jnp.bfloat16(
            1.0 / Q)
        acc = planar_conv([to_planar(xb)], [taps], conv3x3_taps(w),
                          jnp.ones((c, 1)), jnp.zeros((c, 1)),
                          interior_mask(h, w), act="relu",
                          out_dtype=jnp.float32, interpret=True)
        outs.append(np.asarray(jnp.clip(jnp.round(from_planar(acc, h, w)
                                                  * Q), -127, 127
                                        ).astype(jnp.int8))[0])
    return np.stack(outs)


@pytest.mark.parametrize("shape", [(2, 20, 36), (1, 13, 37), (1, 24, 240)])
def test_int8_conv_plain_matches_probe_math(shape):
    n, h, w = shape
    rng = np.random.RandomState(0)
    taps = (rng.randn(9, 16, 16) * 0.2).astype(np.float32)
    x0 = rng.randn(n, h, w, 16).astype(np.float32) * 0.5
    xq = np.clip(np.round(x0 * Q), -127, 127).astype(np.int8)
    want = _jax_int8_layer(xq, jnp.asarray(taps).astype(jnp.bfloat16))
    # (t, c_out, c_in) with t = 3 * dy + dx -> (c_out, c_in, dy, dx)
    w_port = torch.from_numpy(np.ascontiguousarray(
        taps.reshape(3, 3, 16, 16).transpose(2, 3, 0, 1))).to(torch.bfloat16)
    got = int8_conv_plain(torch.from_numpy(
        np.ascontiguousarray(xq.transpose(0, 3, 1, 2))), w_port)
    assert got.dtype == torch.int8 and got.shape == (n, 16, h, w)
    d = np.abs(got.numpy().transpose(0, 2, 3, 1).astype(int)
               - want.astype(int))
    assert d.max() <= 1, (d.max(), (d > 0).mean())
    assert (want > 0).mean() > 0.3  # the ReLU leaves real work


def test_int8_conv_dequantizes_and_rounds_as_the_probe():
    """Half to even at the requantization, and the bf16 dequantization
    factor: a 1x1-like weight picks single inputs."""
    w = torch.zeros((16, 16, 3, 3), dtype=torch.bfloat16)
    w[0, 0, 1, 1] = 1.0
    w[1, 0, 1, 1] = 0.5
    x = torch.zeros((1, 16, 1, 4), dtype=torch.int8)
    x[0, 0, 0] = torch.tensor([1, 3, -5, 127], dtype=torch.int8)
    out = int8_conv_plain(x, w)
    assert out[0, 0, 0].tolist() == [1, 3, 0, 127]
    # 0.5 * x: 0.5 -> 0, 1.5 -> 2 (half to even)
    assert out[0, 1, 0].tolist() == [0, 2, 0, 64]


def test_int8_conv_wrapper_takes_the_plain_version_on_cpu():
    g = torch.Generator().manual_seed(1)
    x = torch.randint(-127, 128, (1, 16, 9, 11), generator=g,
                      dtype=torch.int8)
    w = (torch.randn((16, 16, 3, 3), generator=g) * 0.2).to(torch.bfloat16)
    before = int8_conv.launches
    assert torch.equal(int8_conv(x, w), int8_conv_plain(x, w))
    assert int8_conv.launches == before


def test_int8_conv_packed_route_matches_unpacked_on_cpu():
    """The packed weights the kernel reads (pack_conv_weight's layout) give
    the layer the (16, 16, 3, 3) weights give: on the CPU the wrapper
    unpacks them, and weights of another layer change the result."""
    from vidmat_torch.ops.int8_planar import unpack_conv_weight
    from vidmat_torch.ops.planar import pack_conv_weight

    g = torch.Generator().manual_seed(2)
    x = torch.randint(-127, 128, (2, 16, 11, 32), generator=g,
                      dtype=torch.int8)
    w = (torch.randn((16, 16, 3, 3), generator=g) * 0.2).to(torch.bfloat16)
    packed = pack_conv_weight(w)
    assert torch.equal(unpack_conv_weight(packed), w)
    want = int8_conv(x, w)
    assert torch.equal(int8_conv(x, w, packed=packed), want)
    other = pack_conv_weight(w.flip(-1).contiguous())
    assert not torch.equal(int8_conv(x, w, packed=other), want)


@pytest.mark.parametrize("bad", ["shape", "dtype", "offset"])
def test_int8_conv_refuses_packed_weights_it_cannot_read(bad):
    from vidmat_torch.ops.planar import pack_conv_weight

    w = torch.zeros((16, 16, 3, 3), dtype=torch.bfloat16)
    packed = pack_conv_weight(w)
    packed = {"shape": packed[:, :144].contiguous(),
              "dtype": packed.float(),
              "offset": torch.zeros(packed.numel() + 1,
                                    dtype=torch.bfloat16)[1:].view(
                                        packed.shape)}[bad]
    x = torch.zeros((1, 16, 4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="pack_conv_weight"):
        int8_conv(x, w, packed=packed)


def test_probe_layers_and_weights():
    """The probe's two layers on the CPU (the tool itself needs the
    card), its weights laid out as the JAX probe's tap stack."""
    from vidmat_torch.tools import bench_int8_planes as bench

    w = bench._layer_weights()
    taps = np.random.RandomState(0).randn(9, 16, 16).astype(np.float32)
    np.testing.assert_array_equal(
        w.float().numpy()[:, :, 1, 2],
        torch.from_numpy(taps[5] * 0.2).to(torch.bfloat16).float().numpy())
    built = bench.variants(batch=1, device="cpu")
    assert sorted(built) == ["bf16-planes", "int8-planes"]
    for step, x in built.values():
        y = step(x)
        assert y.shape == (1, 16, bench.H, bench.W) and y.dtype == x.dtype


def test_probe_needs_the_card(monkeypatch):
    from vidmat_torch.tools import bench_int8_planes as bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(repeats=1)
