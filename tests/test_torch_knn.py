"""K9's plain version (`ops/knn.knn_postprocess` on CPU tensors) against
the JAX package's `knn_postprocess` (`models/range2d/postproc.py:19`):
labels array-equal on random scans (ranges with empty pixels, points
near and far from their pixel's range, the window reaching past every
edge) and on a beam-ordered one, on JAX's all-ties case (every
candidate at distance 0, tests/test_range.py:130-145), on the class-0 vote (only class 0 within
the cutoff: label 1, as JAX gives it); the plain version with the
cutoff off, at k = 3 and a 3 x 3 window, and at another sigma; a batch
of images in one call equals the images one by one; the wrapper refuses
wrong dtypes and shapes, and a window, k or cutoff other than K9's.  The
plain `border_mask` and `crf_refine` against JAX's.  JAX's function is
jitted once per shape.  ~10 s in one process, 15 s in the 6-worker
tier-1 run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.models.range2d import postproc as jpost
from taseg_tpu_torch.models.range2d import postproc as tpost
from taseg_tpu_torch.ops.knn import knn_postprocess, knn_postprocess_plain

H, W, P, C = 8, 24, 500, 20


@functools.lru_cache(maxsize=None)
def _jax_knn(**kw):
    return jax.jit(functools.partial(jpost.knn_postprocess, num_classes=C, **kw))


def _scan(seed, empty=0.3, noise=0.5):
    rng = np.random.default_rng(seed)
    r = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    r[rng.random((H, W)) < empty] = 0.0
    lab = rng.integers(0, C, (H, W)).astype(np.int32)
    px = rng.integers(0, W, P).astype(np.int32)
    py = rng.integers(0, H, P).astype(np.int32)
    u = (r[py, px] + rng.normal(0, noise, P)).astype(np.float32)
    return r, u, lab, px, py


def _both(r, u, lab, px, py, fn=knn_postprocess, **kw):
    want = np.asarray(_jax_knn(**kw)(*(jnp.asarray(a) for a in (r, u, lab, px, py))))
    got = fn(*(torch.from_numpy(a) for a in (r, u, lab, px, py)), num_classes=C, **kw)
    assert got.dtype == torch.int32 and got.shape == (P,)
    return got.numpy(), want


@pytest.mark.parametrize("seed", range(4))
def test_random_scans_equal_jax(seed):
    got, want = _both(*_scan(seed, noise=[0.05, 0.5, 2.0, 0.3][seed]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{"cutoff": 0.0}, {"k": 3, "kernel_size": 3}, {"sigma": 2.0, "cutoff": 0.5}])
def test_options_equal_jax(kw):
    got, want = _both(*_scan(7), fn=knn_postprocess_plain, **kw)
    np.testing.assert_array_equal(got, want)


def test_all_ties_equal_jax():
    """Every candidate at distance 0 (a flat image, points on it): the k
    kept are the lowest window indices, the vote is theirs."""
    r, _, lab, px, py = _scan(3)
    r = np.ones_like(r)
    u = np.ones(P, np.float32)
    got, want = _both(r, u, lab, px, py)
    np.testing.assert_array_equal(got, want)


def test_class_zero_votes_give_label_one():
    """Only class 0 within the cutoff: JAX counts them in has_vote and
    the counts [-1, 0, ...] vote label 1; the port gives the same."""
    r, u, _, px, py = _scan(5)
    lab = np.zeros((H, W), np.int32)
    got, want = _both(np.ones_like(r), np.ones(P, np.float32), lab, px, py)
    np.testing.assert_array_equal(got, want)
    assert (got == 1).all()


def test_no_vote_keeps_the_pixel_label():
    r, u, lab, px, py = _scan(6)
    u = u + 100.0  # no candidate within the cutoff
    got, want = _both(r, u, lab, px, py)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, lab[py, px])


def test_batch_equals_images_one_by_one():
    scans = [_scan(s) for s in (10, 11, 12)]
    r = torch.from_numpy(np.stack([s[0] for s in scans]))
    lab = torch.from_numpy(np.stack([s[2] for s in scans]))
    u, px, py = (torch.from_numpy(np.concatenate([s[i] for s in scans])) for i in (1, 3, 4))
    img = torch.repeat_interleave(torch.arange(3, dtype=torch.int32), P)
    got = knn_postprocess(r, u, lab, px, py, img, num_classes=C).numpy()
    want = np.concatenate([_both(*s)[1] for s in scans])
    np.testing.assert_array_equal(got, want)


def test_beam_ordered_scan_equals_jax():
    """Points in beam order (sorted by row, then column: how real scans
    arrive), on a 32 x 96 image with several points a pixel and empty
    pixels: labels array-equal to JAX's.  Measured ~0.8 s, most of it JAX compiling."""
    rng = np.random.default_rng(21)
    h, w, p = 32, 96, 6000
    r = rng.uniform(0.5, 40.0, (h, w)).astype(np.float32)
    r[rng.random((h, w)) < 0.2] = 0.0
    lab = rng.integers(0, C, (h, w)).astype(np.int32)
    px = rng.integers(0, w, p).astype(np.int32)
    py = rng.integers(0, h, p).astype(np.int32)
    o = np.lexsort((px, py))
    px, py = px[o], py[o]
    u = (r[py, px] + rng.normal(0, 0.4, p)).astype(np.float32)
    want = np.asarray(jax.jit(functools.partial(jpost.knn_postprocess, num_classes=C))(
        *(jnp.asarray(a) for a in (r, u, lab, px, py))))
    got = knn_postprocess(*(torch.from_numpy(a) for a in (r, u, lab, px, py)), num_classes=C)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != lab[py, px]).any()  # the clean-up relabels some points


def _k9_emulation(r, u, lab, px, py, k=5, ks=5, cutoff=1.0):
    """K9's per-thread algorithm (`csrc/knn_postproc.cu`) in numpy, f32:
    the window in dy-major order, the k best by the strict-< insertion
    with the shift behind it, the vote over the kept labels."""
    from taseg_tpu_torch.ops.knn import inv_gauss

    wgt = inv_gauss(ks, 1.0)
    h, w = r.shape
    out = np.empty(len(u), np.int32)
    for i in range(len(u)):
        best = [(np.float32(np.inf), 0)] * k
        for o in range(ks * ks):
            y, x = py[i] + o // ks - ks // 2, px[i] + o % ks - ks // 2
            rr, ll = (r[y, x], lab[y, x]) if 0 <= y < h and 0 <= x < w else (np.float32(1e9), 0)
            d = np.float32(abs(np.float32(rr - u[i])))
            cand, shift = (np.float32(d * wgt[o]) + d, ll), False
            for j in range(k):
                if shift or cand[0] < best[j][0]:
                    best[j], cand, shift = cand, best[j], True
        ok = [d <= cutoff and 0 <= l < C for d, l in best]
        voted, count = 1, 0
        for (d, l), o in zip(best, ok):
            n = sum(o2 and l2 == l for (_, l2), o2 in zip(best, ok))
            if o and l != 0 and (n > count or (n == count and l < voted)):
                voted, count = l, n
        out[i] = voted if any(ok) else lab[py[i], px[i]]
    return out


@pytest.mark.parametrize("case", ["random", "ties", "class0"])
def test_kernel_algorithm_equals_jax(case):
    """The kernel's loop, emulated in numpy, gives JAX's labels (the
    kernel itself runs on the card: tests/test_torch_cuda.py and
    chip_smoke.py hold it against the plain version)."""
    r, u, lab, px, py = _scan(8)
    if case != "random":
        r, u = np.ones_like(r), np.ones(P, np.float32)
    if case == "class0":
        lab = np.zeros_like(lab)
    _, want = _both(r, u, lab, px, py)
    np.testing.assert_array_equal(_k9_emulation(r, u, lab, px, py), want)


def test_wrapper_refuses_bad_arguments():
    r, u, lab, px, py = (torch.from_numpy(a) for a in _scan(0))
    with pytest.raises(TypeError):
        knn_postprocess(r.double(), u, lab, px, py, num_classes=C)
    with pytest.raises(TypeError):
        knn_postprocess(r, u, lab.long(), px, py, num_classes=C)
    with pytest.raises(ValueError):
        knn_postprocess(r, u, lab, px[:-1], py, num_classes=C)
    with pytest.raises(TypeError):  # K9's window and k are fixed
        knn_postprocess(r, u, lab, px, py, num_classes=C, kernel_size=3)
    with pytest.raises(TypeError):
        knn_postprocess(r, u, lab, px, py, num_classes=C, k=3)
    with pytest.raises(ValueError):
        knn_postprocess(r, u, lab, px, py, num_classes=C, cutoff=0.0)
    with pytest.raises(ValueError):
        knn_postprocess(r[None].expand(2, H, W).contiguous(), u, lab[None].expand(2, H, W).contiguous(),
                        px, py, num_classes=C)


@pytest.mark.parametrize("kw", [{}, {"kern_conn": 8, "border_size": 2}, {"background_class": None}])
def test_border_mask_equals_jax(kw):
    lab = np.random.default_rng(1).integers(0, 4, (H, W)).astype(np.int32)
    want = np.asarray(jpost.border_mask(jnp.asarray(lab), **kw))
    np.testing.assert_array_equal(tpost.border_mask(torch.from_numpy(lab), **kw).numpy(), want)


def test_crf_refine_matches_jax():
    """Softmax scores, xyz and mask through 3 iterations: within 1e-6."""
    rng = np.random.default_rng(2)
    prob = rng.dirichlet(np.ones(C), (H, W)).astype(np.float32)
    xyz = rng.normal(size=(H, W, 3)).astype(np.float32)
    m = (rng.random((H, W)) < 0.8).astype(np.float32)
    want = np.asarray(jpost.crf_refine(jnp.asarray(prob), jnp.asarray(xyz), jnp.asarray(m)))
    got = tpost.crf_refine(torch.from_numpy(prob), torch.from_numpy(xyz), torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
