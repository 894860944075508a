"""The point <-> range transforms of the port against the JAX package:
the pixel and bilinear tables (equal), `point_to_range` (f32 within
1e-6 of the image scale, gradient within 1e-6), `range_to_point`
(forward bit-equal, gradient within 1e-5), K7's plain version at 4
corners against its 8-corner conventions, and RPVNet's `build_rpv_context`
on a stacked canvas of two scans (every table equal).

Measured: every table equal; point_to_range and its gradient equal to
JAX's on these inputs (the tolerances leave room for the order of a
sum); range_to_point bit-equal, signed zeros included; its gradient, a
mean-centred cumsum over 4P + HW rows in another order than XLA's,
within 1.1e-6 of the gradient's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.models.fusion.rpvnet import build_rpv_context as j_build_rpv_context
from taseg_tpu.ops import point_range as jpr
from taseg_tpu_torch.models.fusion.rpvnet import FUSION_SCALES, build_rpv_context
from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.ops import point_range as tpr
from taseg_tpu_torch.ops import voxelize as tvx


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).numpy()
        return x.view(np.uint16 if x.dtype == np.int16 else np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _tables_equal(t, j, what):
    for f in ("perm", "starts", "counts"):
        np.testing.assert_array_equal(
            getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f"{what} {f}"
        )


def _pixels(seed, p=600, h=8, w=32):
    """Integer pixel coordinates, some outside the image and some rows
    invalid; float ones with exact edges, clamped values and fractions."""
    rng = np.random.default_rng(seed)
    px = rng.integers(-2, w + 2, p).astype(np.int32)
    py = rng.integers(-1, h + 1, p).astype(np.int32)
    valid = rng.random(p) > 0.1
    pxf = rng.uniform(-1.0, w + 0.5, p).astype(np.float32)
    pyf = rng.uniform(-0.5, h + 0.5, p).astype(np.float32)
    pxf[:4] = [0.0, w - 1, w - 1.000001, 3.0]
    pyf[:4] = [0.0, h - 1, 2.5, h - 1.000001]
    return px, py, valid, pxf, pyf, h, w


def test_point_to_range_tables_equal_jax():
    px, py, valid, _, _, h, w = _pixels(0)
    jids, jt = jpr.point_to_range_tables(jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid), h, w)
    tids, tt = tpr.point_to_range_tables(
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(valid), h, w
    )
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    _tables_equal(tt, jt, "pixel tables")
    assert (tids < 0).any() and (tids >= 0).any()


def test_point_to_range_and_its_gradient_match_jax():
    px, py, valid, _, _, h, w = _pixels(1)
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(len(px), 16)).astype(np.float32)
    gimg = rng.normal(size=(h, w, 16)).astype(np.float32)
    jids, jt = jpr.point_to_range_tables(jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid), h, w)
    f = lambda x: jpr.point_to_range(x, jids, jt, h, w)
    want, vjp = jax.vjp(f, jnp.asarray(feats))
    (jgrad,) = vjp(jnp.asarray(gimg))

    tids, tt = tpr.point_to_range_tables(
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(valid), h, w
    )
    x = torch.from_numpy(feats).requires_grad_()
    got = tpr.point_to_range(x, tids, tt, h, w)
    assert got.shape == (h, w, 16) and got.dtype == torch.float32
    (tgrad,) = torch.autograd.grad(got, x, torch.from_numpy(gimg))
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= 1e-6 * scale
    assert np.abs(tgrad.numpy() - np.asarray(jgrad)).max() <= 1e-6 * np.abs(gimg).max()
    empty = np.ones((h, w), bool)
    empty[py[valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)],
          px[valid & (px >= 0) & (px < w) & (py >= 0) & (py < h)]] = False
    # pixels without points: 0 up to the mean-centred cumsum's rounding
    assert empty.any() and np.abs(got.detach().numpy()[empty]).max() <= 1e-6 * scale


def test_range_sample_table_equal_jax():
    _, _, valid, pxf, pyf, h, w = _pixels(3)
    jt = jpr.range_sample_table(jnp.asarray(pxf), jnp.asarray(pyf), jnp.asarray(valid), h, w)
    tt = tpr.range_sample_table(
        torch.from_numpy(pxf), torch.from_numpy(pyf), torch.from_numpy(valid), h, w
    )
    assert tt.idx.shape == (4, len(pxf)) and tt.idx.dtype == torch.int32
    np.testing.assert_array_equal(tt.idx.numpy(), np.asarray(jt.idx))
    np.testing.assert_array_equal(_bits(tt.weights), _bits(jt.weights))
    _tables_equal(tt.pairs, jt.pairs, "corner pairs")
    bare = tpr.range_sample_table(
        torch.from_numpy(pxf), torch.from_numpy(pyf), torch.from_numpy(valid), h, w, with_pairs=False
    )
    assert bare.pairs is None and torch.equal(bare.idx, tt.idx)


def _sample_inputs(seed, c=12):
    _, _, valid, pxf, pyf, h, w = _pixels(seed)
    rng = np.random.default_rng(seed + 10)
    img = rng.normal(size=(h, w, c)).astype(np.float32)
    img[0, 0, :3] = -0.0  # signed zeros at an exact corner
    return valid, pxf, pyf, h, w, img


def test_range_to_point_bit_equal_jax_and_gradient():
    valid, pxf, pyf, h, w, img = _sample_inputs(4)
    jt = jpr.range_sample_table(jnp.asarray(pxf), jnp.asarray(pyf), jnp.asarray(valid), h, w)
    want, vjp = jax.vjp(lambda im: jpr.range_to_point(im, jt), jnp.asarray(img))
    g = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)
    (jgrad,) = vjp(jnp.asarray(g))

    tt = tpr.range_sample_table(
        torch.from_numpy(pxf), torch.from_numpy(pyf), torch.from_numpy(valid), h, w
    )
    _build.reset_launches()
    x = torch.from_numpy(img).requires_grad_()
    got = tpr.range_to_point(x, tt)
    np.testing.assert_array_equal(_bits(got.detach()), _bits(want))
    (tgrad,) = torch.autograd.grad(got, x, torch.from_numpy(g))
    assert tgrad.shape == img.shape
    # the backward's mean-centred cumsum runs over the 4P + HW pair rows
    # in another order than XLA's (measured 1.1e-6)
    assert np.abs(tgrad.numpy() - np.asarray(jgrad)).max() <= 1e-5 * np.abs(np.asarray(jgrad)).max()
    assert not any(_build.LAUNCHES.values())  # CPU tensors: the plain versions
    assert (_bits(got.detach()[~torch.from_numpy(valid)]) == 0).all()  # invalid: +0 rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bilinear_plain_keeps_the_trilinear_conventions(dtype):
    """K7's plain version at 4 corners multiplies and adds in the feature
    dtype in corner order, as at 8: ((c0 + c1) + c2) + c3 with each
    product rounded; absent corners add +0 products.  An 8-corner table
    with the same 4 corners and 4 absent ones gives the same values (bits
    differ only where the 4-corner sum is -0: -0 + +0 is +0).  (3, P)
    and mismatched weight tables are refused."""
    valid, pxf, pyf, h, w, img = _sample_inputs(6)
    t4 = tpr.range_sample_table(
        torch.from_numpy(pxf), torch.from_numpy(pyf), torch.from_numpy(valid), h, w
    )
    rows = torch.from_numpy(img).reshape(-1, img.shape[-1]).to(dtype)
    got = tvx.devoxelize_trilinear(rows, t4)
    assert got.dtype == dtype
    want = None
    for k in range(4):
        idx = t4.idx[k].long()
        gk = torch.where((idx >= 0)[:, None], rows[idx.clamp(min=0)], torch.zeros((), dtype=dtype))
        ck = (gk * t4.weights[k][:, None].to(dtype)).to(dtype)
        want = ck if want is None else (want + ck).to(dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    pad = torch.full_like(t4.idx, -1)
    t8 = tvx.DevoxTable(
        idx=torch.cat([t4.idx, pad]), weights=torch.cat([t4.weights, torch.zeros_like(t4.weights)])
    )
    got8 = tvx.devoxelize_trilinear(rows, t8)
    assert torch.equal(got8, got)
    differ = _bits(got8) != _bits(got)
    assert (got[torch.from_numpy(differ)] == 0).all()
    assert ((_bits(got) == (0x8000 if dtype == torch.bfloat16 else 0x80000000)) == differ).all()
    bad = tvx.DevoxTable(idx=t4.idx[:3].contiguous(), weights=t4.weights[:3].contiguous())
    with pytest.raises(ValueError, match=r"\(8, P\) or \(4, P\)"):
        tvx.devoxelize_trilinear(rows, bad)
    with pytest.raises(ValueError):
        tvx.devoxelize_trilinear(rows, tvx.DevoxTable(idx=t4.idx, weights=t8.weights))


def test_build_rpv_context_batch2_equal_jax():
    """Two scans stacked on a (2 * 16, 64) canvas: the pixel ids, their
    tables and the bilinear tables at scales 1, 4 and 16 equal JAX's;
    every corner of a point stays inside its own scan's band where the
    band has more than one row."""
    h, w, p = 16, 64, 900
    rng = np.random.default_rng(7)
    scan = rng.integers(0, 2, p)
    pxf = rng.uniform(0, w - 1.001, p).astype(np.float32)
    pyf = (rng.uniform(0, h - 1.001, p) + scan * h).astype(np.float32)
    pyf[:3] = [h - 1.001, h, 2 * h - 1.001]  # band edges
    scan[:3] = [0, 1, 1]
    valid = np.arange(p) < p - 50
    j = jax.jit(lambda a, b, v: j_build_rpv_context(a, b, v, h, w, batch=2))(
        jnp.asarray(pxf), jnp.asarray(pyf), jnp.asarray(valid)
    )
    t = build_rpv_context(
        torch.from_numpy(pxf), torch.from_numpy(pyf), torch.from_numpy(valid), h, w, batch=2
    )
    assert (t.h, t.w, t.b) == (h, w, 2)
    for s in FUSION_SCALES:
        (ti, tt), (ji, jt) = t.scatter[s], j.scatter[s]
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=f"scale {s}")
        _tables_equal(tt, jt, f"scatter scale {s}")
        ts, js = t.sample[s], j.sample[s]
        np.testing.assert_array_equal(ts.idx.numpy(), np.asarray(js.idx), err_msg=f"scale {s}")
        np.testing.assert_array_equal(_bits(ts.weights), _bits(js.weights), err_msg=f"scale {s}")
        _tables_equal(ts.pairs, js.pairs, f"sample scale {s}")
        hs, ws = h // s, w // s
        rows = ts.idx[:, torch.from_numpy(valid)] // ws
        out = (rows // hs) != torch.from_numpy(scan[valid])[None]
        if hs > 1:
            assert not out.any(), f"scale {s}"
        else:
            # one row per scan (scale 16 of a 16-row image): the clamp to
            # hs - 1.000001 < 0 puts y just below the band, so a corner
            # in the row above takes a weight of about 1e-6 (as in JAX)
            assert ts.weights[:, torch.from_numpy(valid)][out].max() <= 2e-6
