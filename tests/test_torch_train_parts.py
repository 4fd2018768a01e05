"""Port parity of the training slice's parts on the CPU: train-mode masked
BatchNorm, the masked MLP, the arch-string CNN, the discriminators, the
losses, the crops, the box transforms, the sampling helpers and jaccard,
each against the JAX package's function on the same numpy inputs.

JAX variables go through ``state_dict_from_jax`` into the port's modules
(strict).  Bars: 2e-5 abs for reformulations of the same sums (norms,
losses, crops, running statistics), 1e-4 abs/rel for convolution outputs,
whose sums run in another order.
"""

import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sg2im_tpu import losses as jL
from sg2im_tpu.models import discriminators as jD
from sg2im_tpu.nn import layers as jlayers
from sg2im_tpu.ops import boxes as jboxes
from sg2im_tpu.ops import crop as jcrop
from sg2im_tpu.ops import sampling as jsampling
from sg2im_tpu.utils import metrics as jmetrics
from sg2im_tpu_torch import losses as tL
from sg2im_tpu_torch.ckpt import state_dict_from_jax
from sg2im_tpu_torch.models import discriminators as tD
from sg2im_tpu_torch.nn import layers as tlayers
from sg2im_tpu_torch.ops import boxes as tboxes
from sg2im_tpu_torch.ops import crop as tcrop
from sg2im_tpu_torch.ops import sampling as tsampling
from sg2im_tpu_torch.utils import metrics as tmetrics

EXACT = 2e-5
CONV = 1e-4
VOCAB = {"object_idx_to_name": ["__image__", "cat", "dog", "sky", "tree"]}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)
                                                 .transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    sd = {k.lstrip("."): v for k, v in state_dict_from_jax(variables).items()}
    module.load_state_dict(sd, strict=True)
    return module


def _perturb(variables, seed):
    """Running statistics and affine parameters away from (0, 1)."""
    rng = np.random.RandomState(seed)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else
                (v + 0.1 * rng.randn(*v.shape)).astype(np.float32)
                if k in ("mean", "scale", "bias") else
                (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
                if k == "var" else np.asarray(v)
                for k, v in node.items()}

    return walk(_np(variables))


def _stats(sd):
    return {k: v for k, v in sd.items() if k.endswith(("running_mean",
                                                        "running_var"))}


def _assert_stats(module, jax_stats):
    want = _stats(state_dict_from_jax({"batch_stats": jax_stats}))
    got = _stats(module.state_dict())
    assert {k.lstrip(".") for k in want} == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k.lstrip(".")].numpy(), v.numpy(),
                                   atol=EXACT)


# ---------------------------------------------------------------------------
# Train-mode BatchNorm and the MLP.
# ---------------------------------------------------------------------------

# name: (JAX input shape, mask shape or None, phases)
BN_CASES = {"rows (N, T, C) masked": ((3, 7, 6), (3, 7), 1),
            "rows unmasked": ((10, 6), None, 1),
            "images masked": ((5, 4, 3, 6), (5,), 1),
            "images unmasked": ((4, 4, 3, 6), None, 1),
            "packed phases 4 masked": ((3, 2, 3, 4 * 6), (3,), 4),
            "packed phases 4": ((2, 2, 2, 4 * 6), None, 4),
            "all masked out": ((2, 3, 6), (2, 3), 1)}


@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_train_batchnorm_matches_jax(name):
    """Outputs and running statistics after a train-mode call, the sample
    mask keeping padded rows out; phases=4 folds the packed phases into
    the reduction as the packed CRN stages do."""
    shape, mask_shape, phases = BN_CASES[name]
    C = 6
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    mask = None
    if mask_shape is not None:
        mask = (rng.rand(*mask_shape) < 0.6).astype(np.float32)
        mask.reshape(-1)[0] = 1.0
        if name == "all masked out":
            mask[:] = 0.0
    jbn = jlayers.BatchNorm(C)
    variables = _perturb(jbn.init(jax.random.PRNGKey(0),
                                  jnp.zeros((2, C))), seed=1)
    jx = jnp.asarray(x)
    if phases > 1:
        jx = jx.reshape(shape[:-1] + (phases, C))
    jm = None if mask is None else jnp.asarray(mask)
    want, upd = jbn.apply(variables, jx, train=True, mask=jm,
                          mutable=["batch_stats"])
    want = np.asarray(want).reshape(shape)

    bn = _load(tlayers.BatchNorm(C), variables).train()
    tm = None if mask is None else torch.from_numpy(mask)
    if len(shape) == 4:
        got = nhwc(bn(nchw(x), phases=phases, mask=tm))
    else:
        got = bn(torch.from_numpy(x), mask=tm).detach().numpy()
    np.testing.assert_allclose(got, want, atol=EXACT)
    _assert_stats(bn, upd["batch_stats"])


def test_batchnorm_eval_after_train_uses_moved_statistics():
    bn = tlayers.BatchNorm(4).train()
    x = torch.randn(8, 4) * 3 + 1
    bn(x)
    assert not torch.equal(bn.running_mean, torch.zeros(4))
    bn.eval()
    want = (x - bn.running_mean) / torch.sqrt(bn.running_var + 1e-5)
    torch.testing.assert_close(bn(x), want, atol=EXACT, rtol=0)


def test_masked_mlp_train_matches_jax():
    """The GCN / head MLP with BatchNorm in train mode over padded rows."""
    dims = (8, 16, 5)
    rng = np.random.RandomState(2)
    x = rng.randn(3, 6, 8).astype(np.float32)
    mask = (rng.rand(3, 6) < 0.7).astype(np.float32)
    jm = jlayers.MLP(dims, batch_norm="batch")
    variables = _perturb(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8))),
                         seed=3)
    want, upd = jm.apply(variables, jnp.asarray(x), train=True,
                         mask=jnp.asarray(mask), mutable=["batch_stats"])
    tm = _load(tlayers.MLP(dims, batch_norm="batch"), variables).train()
    got = tm(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=EXACT)
    _assert_stats(tm, upd["batch_stats"])


def test_global_avg_pool_matches_jax():
    x = np.random.RandomState(4).randn(2, 5, 3, 7).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.global_avg_pool(nchw(x)).numpy(),
        np.asarray(jlayers.global_avg_pool(jnp.asarray(x))), atol=EXACT)


# ---------------------------------------------------------------------------
# parse_arch, ArchCNN and the discriminators.
# ---------------------------------------------------------------------------

# name: (arch, normalization, padding, pooling, input (H, W, C)): the archs
# of the JAX suite's training and discriminator tests at small widths, and
# one with a fully connected head.
ARCHS = {
    "C3-8-2 batch": ("C3-8-2", "batch", "same", "avg", (16, 16, 3)),
    "C4-16-2,C4-32-2 valid batch": ("C4-16-2,C4-32-2", "batch", "valid",
                                    "avg", (32, 32, 3)),
    "C3-8-2,C3-8-1 instance": ("C3-8-2,C3-8-1", "instance", "same", "avg",
                               (16, 16, 3)),
    "C3-16-1,R,C3-32-2 batch": ("C3-16-1,R,C3-32-2", "batch", "same", "avg",
                                (8, 8, 3)),
    "fc head": ("C3-8-2,C3-8-2,FC-32-10,FC-10-4", "batch", "same", "avg",
                (8, 8, 3)),
}
# parse_arch alone also takes the rest of the grammar.
PARSE_ARCHS = {
    **ARCHS,
    "residual pool upsample": ("I4,C3-8-1,R,P2,U2,C3-6-1", "batch", "same",
                               "max", None),
    "residual valid no norm": ("I4,C3-8-1,R,P2,C3-6-1", "none", "valid",
                               "avg", None),
    "residual first instance": ("I4,R,C3-6-1", "instance", "same", "avg",
                                None),
}


@pytest.mark.parametrize("name", sorted(PARSE_ARCHS))
def test_parse_arch_matches_jax(name):
    arch, norm, pad, pool, _ = PARSE_ARCHS[name]
    jspecs, jc = jlayers.parse_arch(arch, norm, "leakyrelu-0.2", pad, pool)
    tspecs, tc = tlayers.parse_arch(arch, norm, "leakyrelu-0.2", pad, pool)
    assert tc == jc
    assert [tuple(s) for s in tspecs] == [
        (s.kind, s.torch_idx, s.in_ch, s.out_ch, s.kernel, s.stride, s.pad,
         s.factor, s.norm_kind) for s in jspecs]


def test_parse_arch_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="Invalid layer"):
        tlayers.parse_arch("C3-8-1,X7")
    with pytest.raises(ValueError, match="same"):
        tlayers.parse_arch("C4-8-1", padding="same")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_arch_cnn_train_matches_jax(name):
    """Outputs and batch statistics of a train-mode call with a sample
    mask, and the eval-mode output after it."""
    arch, norm, pad, pool, (H, W, C) = ARCHS[name]
    rng = np.random.RandomState(5)
    x = rng.randn(4, H, W, C).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    kw = dict(normalization=norm, activation="leakyrelu-0.2", padding=pad,
              pooling=pool)
    jm = jlayers.ArchCNN(arch=arch, **kw)
    # ArchCNN's ``init`` field (the kernel init) shadows Module.init.
    variables = _perturb(jax.jit(functools.partial(flax.linen.Module.init,
                                                   jm))(
        jax.random.PRNGKey(2), jnp.asarray(x[:2])), seed=6)

    @jax.jit
    def run(v, x, m):
        want, upd = jm.apply(v, x, train=True, sample_mask=m,
                             mutable=["batch_stats"])
        return want, upd, jm.apply({**v, **upd}, x, train=False)

    want, upd, want_eval = run(variables, jnp.asarray(x), jnp.asarray(mask))
    tm = _load(tlayers.ArchCNN(arch, **kw), variables).train()
    for got, w in ((tm(nchw(x), torch.from_numpy(mask)), want),
                   (tm.eval()(nchw(x)), want_eval)):
        got = got.detach()
        got = nhwc(got) if got.ndim == 4 else got.numpy()
        np.testing.assert_allclose(got, np.asarray(w), atol=CONV, rtol=CONV)
        if norm == "batch" and tm.training:
            _assert_stats(tm, upd["batch_stats"])


def _boxes(rng, N, O):
    lo = rng.uniform(0, 0.5, (N, O, 2)).astype(np.float32)
    sz = rng.uniform(0.2, 0.5, (N, O, 2)).astype(np.float32)
    return np.concatenate([lo, lo + sz], -1)


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_discriminators_train_match_jax(norm):
    """PatchDiscriminator and AcCropDiscriminator (with its AcDiscriminator)
    on the training configuration's settings at a small width: scores,
    logits and batch statistics after a train-mode call over padded
    object slots; the JAX variables load under upstream's names."""
    rng = np.random.RandomState(7)
    imgs = rng.randn(2, 32, 32, 3).astype(np.float32)
    boxes = _boxes(rng, 2, 5)
    obj_mask = np.array([[1, 1, 1, 0, 1], [1, 1, 0, 0, 0]], np.float32)
    arch = "C4-8-2,C4-16-2,C4-16-2"
    kw = dict(normalization=norm, activation="leakyrelu-0.2",
              padding="valid")
    mutable = ["batch_stats"] if norm == "batch" else False

    jp = jD.PatchDiscriminator(arch=arch, **kw)
    pv = _perturb(jax.jit(functools.partial(jp.init, train=True))(
        jax.random.PRNGKey(3), jnp.asarray(imgs)), seed=8)
    out = jax.jit(functools.partial(jp.apply, train=True, mutable=mutable))(
        pv, jnp.asarray(imgs))
    want, upd = out if mutable else (out, None)
    tp = _load(tD.PatchDiscriminator(arch, **kw), pv).train()
    np.testing.assert_allclose(nhwc(tp(nchw(imgs))), np.asarray(want),
                               atol=CONV, rtol=CONV)
    if upd is not None:
        _assert_stats(tp, upd["batch_stats"])

    ja = jD.AcCropDiscriminator(vocab=VOCAB, arch=arch, object_size=32, **kw)
    av = _perturb(jax.jit(functools.partial(ja.init, train=True))(
        jax.random.PRNGKey(4), jnp.asarray(imgs), jnp.asarray(boxes)), seed=9)
    out = jax.jit(functools.partial(ja.apply, train=True, mutable=mutable))(
        av, jnp.asarray(imgs), jnp.asarray(boxes),
        obj_mask=jnp.asarray(obj_mask))
    (wscores, wlogits), upd = out if mutable else (out, None)
    ta = _load(tD.AcCropDiscriminator(VOCAB, arch, object_size=32, **kw),
               av).train()
    scores, logits = ta(nchw(imgs), torch.from_numpy(boxes),
                        torch.from_numpy(obj_mask))
    assert scores.shape == (2, 5, 1) and logits.shape == (2, 5, 5)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(wscores),
                               atol=CONV, rtol=CONV)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(wlogits),
                               atol=CONV, rtol=CONV)
    if upd is not None:
        _assert_stats(ta, upd["batch_stats"])


def test_discriminator_init_is_seeded():
    """Seeded init from an explicit torch.Generator: the same seed gives
    the same weights."""
    sds = []
    for _ in range(2):
        d = tD.AcCropDiscriminator(VOCAB, "C4-8-2,C4-16-2", object_size=16,
                                   padding="valid")
        tlayers.init_weights(d, torch.Generator().manual_seed(11))
        sds.append(d.state_dict())
    assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])


# ---------------------------------------------------------------------------
# Losses.
# ---------------------------------------------------------------------------

def _loss_inputs(seed=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, 5, 1).astype(np.float32) * 3,
            rng.randn(3, 5, 1).astype(np.float32) * 3,
            (rng.rand(3, 5) < 0.6).astype(np.float32))


@pytest.mark.parametrize("gan_type", ["gan", "wgan", "lsgan"])
@pytest.mark.parametrize("masked", [True, False])
def test_gan_losses_match_jax(gan_type, masked):
    real, fake, mask = _loss_inputs()
    jg, jd = jL.get_gan_losses(gan_type)
    tg, td = tL.get_gan_losses(gan_type)
    jm = jnp.asarray(mask) if masked else None
    tm = torch.from_numpy(mask) if masked else None
    np.testing.assert_allclose(
        float(tg(torch.from_numpy(fake), tm)),
        float(jg(jnp.asarray(fake), jm)), atol=EXACT, rtol=EXACT)
    np.testing.assert_allclose(
        float(td(torch.from_numpy(real), torch.from_numpy(fake), tm)),
        float(jd(jnp.asarray(real), jnp.asarray(fake), jm)), atol=EXACT,
        rtol=EXACT)
    with pytest.raises(ValueError, match="GAN type"):
        tL.get_gan_losses("hinge")


def test_regression_losses_and_masked_mean_match_jax():
    rng = np.random.RandomState(9)
    pred = rng.randn(3, 5, 4).astype(np.float32)
    tgt = rng.randn(3, 5, 4).astype(np.float32)
    mask = (rng.rand(3, 5) < 0.5).astype(np.float32)
    nan_pred = pred.copy()
    nan_pred[mask == 0] = np.nan  # masked-out NaN must not poison the mean
    for jfn, tfn, args in [
            (jL.l1_loss, tL.l1_loss, (pred, tgt)),
            (jL.mse_loss, tL.mse_loss, (pred, tgt)),
            (jL.mse_loss, tL.mse_loss, (pred, tgt, mask)),
            (jL.mse_loss, tL.mse_loss, (nan_pred, tgt, mask)),
            (jL.masked_mean, tL.masked_mean, (pred, mask[:, :, None])),
            (jL.bce_with_logits, tL.bce_with_logits, (pred, tgt > 0))]:
        want = np.asarray(jfn(*(jnp.asarray(a, jnp.float32) for a in args)))
        got = tfn(*(torch.from_numpy(np.asarray(a, np.float32))
                    for a in args))
        np.testing.assert_allclose(got.numpy(), want, atol=EXACT, rtol=EXACT)
        assert np.isfinite(want).all()
    assert float(tL.masked_mean(torch.ones(2, 3), torch.zeros(2))) == 0.0


def test_cross_entropy_matches_jax():
    """Masked rows may hold out-of-range labels; a real row's out-of-range
    label gives NaN, as the JAX gather does."""
    rng = np.random.RandomState(10)
    logits = rng.randn(3, 6, 7).astype(np.float32) * 2
    labels = rng.randint(0, 7, (3, 6)).astype(np.int32)
    mask = (rng.rand(3, 6) < 0.6).astype(np.float32)
    mask[0, 0] = 0.0
    labels[0, 0] = -1
    for m in (mask, None):
        lab = labels if m is not None else np.abs(labels)
        want = float(jL.cross_entropy(jnp.asarray(logits), jnp.asarray(lab),
                                      None if m is None else jnp.asarray(m)))
        got = float(tL.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(lab),
                                     None if m is None else
                                     torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, atol=EXACT, rtol=EXACT)
    bad = labels.copy()
    bad[1, 1], mask[1, 1] = 9, 1.0
    assert np.isnan(float(tL.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(bad),
        torch.from_numpy(mask))))
    assert np.isnan(float(jL.cross_entropy(
        jnp.asarray(logits), jnp.asarray(bad), jnp.asarray(mask))))


def test_bce_matches_jax_and_is_finite_at_sigmoid_saturation():
    """The mask BCE clamps its probabilities to [1e-7, 1 - 1e-7]: at
    f32 sigmoid saturation the gradient stays finite (as
    tests/test_train.py:451 holds for the JAX loss), and loss and gradient
    match JAX's."""
    rng = np.random.RandomState(0)
    scores = (rng.randn(4, 6, 8, 8) * 2.0).astype(np.float32)
    scores[0], scores[1] = 20.0, -20.0
    targets = (rng.rand(4, 6, 8, 8) > 0.5).astype(np.float32)
    mask = (rng.rand(4, 6) > 0.3).astype(np.float32)

    def jloss(s):
        return jL.binary_cross_entropy(jax.nn.sigmoid(s), jnp.asarray(targets),
                                       jnp.asarray(mask))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(scores))
    s = torch.from_numpy(scores).requires_grad_()
    got = tL.binary_cross_entropy(torch.sigmoid(s), torch.from_numpy(targets),
                                  torch.from_numpy(mask))
    got.backward()
    assert torch.isfinite(s.grad).all()
    np.testing.assert_allclose(float(got), float(want), atol=EXACT,
                               rtol=EXACT)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_g), atol=1e-7,
                               rtol=1e-4)


def test_gradient_penalty_matches_jax():
    """WGAN-GP with the JAX draw of eps handed to the port."""
    rng = np.random.RandomState(11)
    real = rng.randn(3, 4, 4, 2).astype(np.float32)
    fake = rng.randn(3, 4, 4, 2).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = float(jL.gradient_penalty(
        key, jnp.asarray(real), jnp.asarray(fake),
        lambda x: jnp.tanh(x) * x, gamma=2.0))
    eps = np.asarray(jax.random.normal(key, (3, 1, 1, 1)))
    got = float(tL.gradient_penalty(
        nchw(real), nchw(fake), lambda x: torch.tanh(x) * x, gamma=2.0,
        eps=torch.from_numpy(eps.copy())))
    np.testing.assert_allclose(got, want, atol=EXACT, rtol=EXACT)


# ---------------------------------------------------------------------------
# Crops, boxes, sampling, jaccard.
# ---------------------------------------------------------------------------

def test_crop_bbox_forms_match_jax():
    rng = np.random.RandomState(12)
    feats = rng.randn(3, 12, 10, 4).astype(np.float32)
    bbox = _boxes(rng, 1, 3)[0]
    bbox[2] = [-0.2, 0.1, 0.6, 1.3]  # reaches outside the image
    for backend in ("separable", "border"):
        want = jcrop.crop_bbox(jnp.asarray(feats), jnp.asarray(bbox), 6, 5,
                               backend=backend)
        got = tcrop.crop_bbox(nchw(feats), torch.from_numpy(bbox), 6, 5,
                              backend=backend)
        np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=EXACT)
    idx = np.array([2, 0, 2, 1, 1], np.int32)
    boxes5 = _boxes(rng, 1, 5)[0]
    want = jcrop.crop_bbox_batch(jnp.asarray(feats), jnp.asarray(boxes5),
                                 jnp.asarray(idx), 7)
    got = tcrop.crop_bbox_batch(nchw(feats), torch.from_numpy(boxes5),
                                torch.from_numpy(idx), 7)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=EXACT)
    with pytest.raises(ValueError, match="backend"):
        tcrop.crop_bbox(nchw(feats), torch.from_numpy(bbox), 6,
                        backend="jj")


def test_crop_bbox_padded_and_uncrop_match_jax():
    rng = np.random.RandomState(13)
    imgs = rng.randn(2, 16, 12, 3).astype(np.float32)
    boxes = _boxes(rng, 2, 4)
    boxes[1, 3] = 0.0  # a padded slot's degenerate box
    want = jcrop.crop_bbox_padded(jnp.asarray(imgs), jnp.asarray(boxes), 8)
    got = tcrop.crop_bbox_padded(nchw(imgs), torch.from_numpy(boxes), 8)
    assert got.shape == (2, 4, 3, 8, 8)
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(),
                               np.asarray(want), atol=EXACT)
    crops = rng.randn(3, 5, 6, 2).astype(np.float32)
    bbox = _boxes(rng, 1, 3)[0]
    want = jcrop.uncrop_bbox(jnp.asarray(crops), jnp.asarray(bbox), 9, 11,
                             fill_value=-1.0)
    got = tcrop.uncrop_bbox(nchw(crops), torch.from_numpy(bbox), 9, 11,
                            fill_value=-1.0)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=EXACT)


def test_crop_gradient_matches_jax():
    """The object discriminator's crops carry the image gradient to G."""
    rng = np.random.RandomState(14)
    imgs = rng.randn(2, 12, 12, 3).astype(np.float32)
    boxes = _boxes(rng, 2, 3)
    g = rng.randn(2, 3, 6, 6, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jcrop.crop_bbox_padded(x, jnp.asarray(boxes),
                                                      6), jnp.asarray(imgs))
    (want,) = vjp(jnp.asarray(g))
    x = nchw(imgs).requires_grad_()
    tcrop.crop_bbox_padded(x, torch.from_numpy(boxes), 6).backward(
        torch.from_numpy(g.transpose(0, 1, 4, 2, 3).copy()))
    np.testing.assert_allclose(nhwc(x.grad), np.asarray(want), atol=EXACT)


def test_box_transforms_match_jax():
    rng = np.random.RandomState(15)
    anchors = np.concatenate([rng.rand(4, 2), rng.rand(4, 2) + 0.2],
                             -1).astype(np.float32)
    trans = (rng.randn(4, 4) * 0.3).astype(np.float32)
    boxes = np.concatenate([rng.rand(4, 2), rng.rand(4, 2) + 0.1],
                           -1).astype(np.float32)
    for name, args in [("apply_box_transform", (anchors, trans)),
                       ("invert_box_transform", (anchors, boxes)),
                       ("centers_to_extents", (boxes,)),
                       ("extents_to_centers", (boxes,))]:
        want = getattr(jboxes, name)(*map(jnp.asarray, args))
        got = getattr(tboxes, name)(*(torch.from_numpy(a) for a in args))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=EXACT,
                                   rtol=EXACT)
    ext = tboxes.centers_to_extents(torch.from_numpy(boxes))
    torch.testing.assert_close(tboxes.extents_to_centers(ext),
                               torch.from_numpy(boxes))


def test_sampling_helpers_match_jax():
    rng = np.random.RandomState(16)
    start = rng.randn(3, 2).astype(np.float32)
    end = rng.randn(3, 2).astype(np.float32)
    np.testing.assert_allclose(
        tsampling.tensor_linspace(torch.from_numpy(start),
                                  torch.from_numpy(end), 7).numpy(),
        np.asarray(jsampling.tensor_linspace(jnp.asarray(start),
                                             jnp.asarray(end), 7)),
        atol=EXACT)
    img = rng.randn(2, 6, 5, 3).astype(np.float32)
    X = rng.uniform(-0.2, 1.2, (2, 4, 3)).astype(np.float32)
    Y = rng.uniform(-0.2, 1.2, (2, 4, 3)).astype(np.float32)
    want = jsampling.bilinear_sample_border(*map(jnp.asarray, (img, X, Y)))
    got = tsampling.bilinear_sample_border(nchw(img), torch.from_numpy(X),
                                           torch.from_numpy(Y))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=EXACT)


def test_jaccard_matches_jax():
    rng = np.random.RandomState(17)
    pred = _boxes(rng, 2, 5)
    gt = _boxes(rng, 2, 5)
    pred[1, 4] = gt[1, 4] = 0.0  # a padded row: no union, counts 0
    mask = np.array([[1, 1, 0, 1, 1], [1, 1, 1, 1, 0]], np.float32)
    for m in (mask, None):
        want = float(jmetrics.jaccard(jnp.asarray(pred), jnp.asarray(gt),
                                      None if m is None else jnp.asarray(m)))
        got = float(tmetrics.jaccard(torch.from_numpy(pred),
                                     torch.from_numpy(gt),
                                     None if m is None else
                                     torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, atol=EXACT, rtol=EXACT)
        assert np.isfinite(got)
