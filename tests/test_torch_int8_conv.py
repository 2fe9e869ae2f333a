"""The port's int8 convolution (``ops/int8_conv.py``) and its quantized conv
(``train/quantize.py``) against the JAX package on the CPU.

- The plain int8 conv against JAX's int8 ``conv_general_dilated`` with
  int32 accumulation (``train/quantize.py:175-178``) at the geometries of
  ``tests/test_quantize.py:TwoConv`` (3x3 pad 1 stride 2, 1x1) and the
  stems (K = 27): the accumulators are integers, so exactly equal.
- The card path's im2col and padding (run here through the CPU's
  ``torch._int_mm``) equal the plain version exactly at the padded cases
  (K = 27, K = 9 * C with C not a multiple of 8, at most 16 rows, C_out =
  4 and 18).
- One conv module quantized end to end (float in, the same ``amax``)
  against JAX ``quantized_apply``: rtol 0, atol 1e-6 (the same int32
  accumulators times the same f32 scales; an FMA in XLA's epilogue may
  round the last bit of values of order 1).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from restrictive_hierarchical_semantic_segmentation_tpu.train import (
    quantize as jq,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.ops import (
    int8_conv,
)
from restrictive_hierarchical_semantic_segmentation_tpu_torch.train import (
    quantize as pq,
)

# (batch, H, W, C_in, kernel, C_out, stride, padding)
GEOMETRIES = {
    "3x3_s2_p1": (2, 9, 9, 3, 3, 8, 2, 1),      # TwoConv.c1
    "1x1": (2, 5, 5, 8, 1, 4, 1, 0),            # TwoConv.c2
    "stem_s2": (1, 16, 16, 3, 3, 64, 2, 1),     # the W48 stem, K = 27
    "stem_s1": (2, 12, 12, 3, 3, 64, 1, 1),     # the UNet's first conv
    "3x3_c7": (1, 11, 13, 7, 3, 16, 1, 1),      # K = 63 (concat_prev_probs)
}


def _ints(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(
        np.int8)


def _jax_acc(xq, kq, stride, pad):
    dn = jax.lax.conv_dimension_numbers(xq.shape, kq.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(kq), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=dn,
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_plain_int8_conv_equals_jax_exactly(name):
    b, h, w, c, k, o, s, p = GEOMETRIES[name]
    xq, kq = _ints((b, h, w, c), 1), _ints((k, k, c, o), 2)
    want = _jax_acc(xq, kq, s, p)
    got = int8_conv.int8_conv2d(torch.from_numpy(xq), torch.from_numpy(kq),
                                (s, s), (p, p))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [
    (2, 9, 9, 3, 3, 8, 2, 1),     # K = 27
    (1, 11, 13, 7, 3, 16, 1, 1),  # K = 63
    (1, 3, 3, 4, 3, 8, 2, 1),     # 4 rows: padded to 17
    (3, 6, 6, 16, 1, 24, 1, 0),   # 1x1 at stride 1: the input as it is
    (2, 8, 8, 16, 1, 8, 2, 0),    # 1x1 at stride 2
])
def test_card_path_layout_equals_plain(shape, monkeypatch):
    """The card path's im2col, K and row padding and weight layout, with
    the CPU's torch._int_mm in place of cuBLASLt's."""
    b, h, w, c, k, o, s, p = shape
    xq = torch.from_numpy(_ints((b, h, w, c), 3))
    kq = torch.from_numpy(_ints((k, k, c, o), 4))
    seen = []
    real = torch._int_mm

    def int_mm(a, m):  # the operands the card would get, both K-major
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0
        assert m.shape[1] % 8 == 0 and a.is_contiguous()
        assert m.t().is_contiguous()
        seen.append(a.shape)
        return real(a, m)

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    monkeypatch.setattr(int8_conv, "CALLS", 0)
    got = int8_conv._card(xq, kq, (s, s), (p, p))
    assert len(seen) == 1 and int8_conv.CALLS == 1
    assert torch.equal(got, int8_conv._int8_conv_ref(xq, kq, (s, s), (p, p)))


@pytest.mark.parametrize("shape", [
    (1, 7, 9, 18, 3, 4, 1, 1),    # C_out = 4: 4 zero output channels
    (2, 9, 9, 36, 3, 18, 2, 1),   # C_out = 18 (HRNet-W18): 6 of them
])
def test_card_path_pads_c_out_to_a_multiple_of_8(shape, monkeypatch):
    """C_out that is no multiple of 8: the card path hands torch._int_mm a
    weight padded with zero output channels and slices their columns off,
    bit-equal to the plain version (the CPU's torch._int_mm in place of
    cuBLASLt's)."""
    b, h, w, c, k, o, s, p = shape
    xq = torch.from_numpy(_ints((b, h, w, c), 5))
    kq = torch.from_numpy(_ints((k, k, c, o), 6))
    seen = []
    real = torch._int_mm

    def int_mm(a, m):
        assert a.shape[1] % 8 == 0 and m.shape[1] % 8 == 0
        seen.append(tuple(m.shape))
        return real(a, m)

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    monkeypatch.setattr(int8_conv, "CALLS", 0)
    got = int8_conv._card(xq, kq, (s, s), (p, p))
    assert seen == [(k * k * c + (-k * k * c) % 8, o + (-o) % 8)]
    assert int8_conv.CALLS == 1 and got.shape[-1] == o
    assert torch.equal(got, int8_conv._int8_conv_ref(xq, kq, (s, s), (p, p)))


def test_int8_conv_rejects_what_it_does_not_take():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        int8_conv.int8_conv2d(x.float(), torch.zeros((1, 1, 8, 8),
                                                     dtype=torch.int8))
    with pytest.raises(ValueError, match="same C"):
        int8_conv.int8_conv2d(x, torch.zeros((1, 1, 4, 8), dtype=torch.int8))


class _JaxOne(fnn.Module):
    out: int
    k: int
    stride: int
    pad: int
    bias: bool

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.Conv(self.out, (self.k, self.k), (self.stride,) * 2,
                        padding=self.pad, use_bias=self.bias, name="c")(x)


class _PortOne(nn.Module):
    def __init__(self, c, out, k, stride, pad, bias):
        super().__init__()
        self.c = nn.Conv2d(c, out, k, stride, pad, bias=bias)

    def forward(self, x):  # NHWC in and out, as the segmenter's
        return self.c(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("name,bias", [("3x3_s2_p1", True), ("1x1", False),
                                       ("stem_s1", True), ("3x3_c7", True)])
def test_quantized_conv_equals_jax(name, bias):
    b, h, w, c, k, o, s, p = GEOMETRIES[name]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    kernel = (rng.standard_normal((k, k, c, o)) / np.sqrt(k * k * c)).astype(
        np.float32)
    params = {"c": {"kernel": kernel}}
    if bias:
        params["c"]["bias"] = rng.normal(0, 0.1, o).astype(np.float32)
    jm = _JaxOne(o, k, s, p, bias)
    scales = jq.calibrate(jm.apply, {"params": params}, [x])
    want = np.asarray(jq.quantized_apply(jm.apply, scales,
                                         skip=lambda _: False)(
        {"params": params}, x))

    pm = _PortOne(c, o, k, s, p, bias)
    with torch.no_grad():
        pm.c.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        if bias:
            pm.c.bias.copy_(torch.from_numpy(params["c"]["bias"]))
    assert pq.calibrate(pm, [x]) == pytest.approx(scales, rel=1e-6)
    with torch.inference_mode():
        got = pq.quantized_apply(pm, scales, skip=lambda _: False)(
            torch.from_numpy(x)).numpy()
        plain = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # outside the wrapper the conv is the float conv again
    assert "forward" not in vars(pm.c)
    assert np.abs(got - plain).max() > 0
