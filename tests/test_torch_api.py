"""The last names of the JAX package's public API in the port, against the
JAX functions on seeded numpy inputs, on the CPU: ``data.batching``
(``pad_graphs``, ``flat_to_padded``, ``padded_to_flat``, ``GraphBatch``'s
``num_images`` and ``replace``), ``encode_scene_graphs`` with ``O_max`` /
``T_max``, ``ops.sampling``'s ``normalized_to_pixel`` and ``grid_sample``,
``utils.metrics.grad_global_norm`` and ``utils.flags.float_tuple``.

Also the subpackage namespaces: each JAX subpackage's ``__all__`` (nn,
ops, utils, data, models) against the port's, the top level's lazy names,
``nn.layers.parse_mlp``'s specs, and the port's ``MLP`` with each of the
JAX one's arguments (activation, dropout in eval mode, final_nonlinearity,
batch_norm) on weights carried across by the JAX package's
``convert_variables_to_torch_state``.

Bars: the batching and encoding exactly (round trips included), the flag
type exactly, ``grid_sample`` within 1e-5 (out-of-bounds and non-finite
taps included), ``grad_global_norm`` within 1e-6 relative, the MLPs within
2e-5.
"""

import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sg2im_tpu.data as jax_data
from sg2im_tpu.data import batching as jax_batching
from sg2im_tpu.ops import sampling as jax_sampling
from sg2im_tpu.utils import flags as jax_flags
from sg2im_tpu.utils import metrics as jax_metrics
from sg2im_tpu_torch import data
from sg2im_tpu_torch.data import batching
from sg2im_tpu_torch.ops import sampling
from sg2im_tpu_torch.utils import flags, metrics

FIELDS = ("objs", "triples", "obj_mask", "triple_mask", "boxes", "masks",
          "images")


def _graphs(seed, n=5, max_o=6, max_t=7, M=4, missing_mask=False):
    """Per-image (objs, triples with local indices, boxes, masks) lists."""
    rng = np.random.RandomState(seed)
    objs, triples, boxes, masks = [], [], [], []
    for i in range(n):
        o = rng.randint(1, max_o + 1)
        t = rng.randint(0, max_t + 1)
        objs.append(rng.randint(1, 50, o).astype(np.int32))
        triples.append(np.stack([rng.randint(0, o, t), rng.randint(0, 9, t),
                                 rng.randint(0, o, t)], 1).astype(np.int32))
        boxes.append(rng.rand(o, 4).astype(np.float32))
        masks.append(None if missing_mask and i == 1
                     else rng.rand(o, M, M).astype(np.float32))
    return objs, triples, boxes, masks


def _same_batch(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            assert np.array_equal(x, y), name


@pytest.mark.parametrize("kw", [
    {}, {"align": 8}, {"O_max": 8, "T_max": 9},
    {"boxes": True}, {"boxes": True, "masks": True},
    {"boxes": True, "masks": True, "missing_mask": True, "align": 4},
    {"images": True},
], ids=["default", "align8", "pad_targets", "boxes", "boxes_masks",
        "a_missing_mask", "images"])
def test_pad_graphs_matches_jax(kw):
    kw = dict(kw)
    objs, triples, boxes, masks = _graphs(
        3, missing_mask=kw.pop("missing_mask", False))
    args = dict(boxes_list=boxes if kw.pop("boxes", False) else None,
                masks_list=masks if kw.pop("masks", False) else None)
    if kw.pop("images", False):
        args["images"] = np.random.RandomState(4).rand(
            5, 8, 8, 3).astype(np.float32)
    got = batching.pad_graphs(objs, triples, **args, **kw)
    want = jax_batching.pad_graphs(objs, triples, **args, **kw)
    _same_batch(got, want)
    assert got.num_images == want.num_images == 5


def test_pad_graphs_rejects_graphs_beyond_the_targets():
    objs, triples, _, _ = _graphs(5)
    for mod in (batching, jax_batching):
        with pytest.raises(ValueError, match="exceed pad targets"):
            mod.pad_graphs(objs, triples, O_max=2, T_max=64)


def _flat(seed, shuffle):
    """Flat ragged arrays with global indices; ``shuffle`` permutes the
    objects so that obj_to_img is not sorted."""
    objs, triples, boxes, masks = _graphs(seed)
    o2i = np.concatenate([np.full(len(o), n) for n, o in enumerate(objs)])
    offsets = np.cumsum([0] + [len(o) for o in objs])
    flat_t = np.concatenate([t + [offsets[n], 0, offsets[n]]
                             for n, t in enumerate(triples)])
    flat = [np.concatenate(objs), flat_t, o2i, np.concatenate(boxes),
            np.concatenate(masks)]
    if shuffle:
        perm = np.random.RandomState(seed).permutation(len(o2i))
        inv = np.argsort(perm)
        flat = [flat[0][perm], flat[1].copy(), o2i[perm], flat[3][perm],
                flat[4][perm]]
        flat[1][:, 0] = inv[flat[1][:, 0]]
        flat[1][:, 2] = inv[flat[1][:, 2]]
    return flat


@pytest.mark.parametrize("shuffle", [False, True], ids=["sorted",
                                                        "unsorted"])
@pytest.mark.parametrize("extras", [False, True], ids=["graphs",
                                                       "boxes_masks"])
def test_flat_padded_round_trips_match_jax(shuffle, extras):
    objs, triples, o2i, boxes, masks = _flat(6, shuffle)
    kw = dict(boxes=boxes, masks=masks) if extras else {}
    got = batching.flat_to_padded(objs, triples, o2i, align=4, **kw)
    want = jax_batching.flat_to_padded(objs, triples, o2i, align=4, **kw)
    _same_batch(got, want)
    back, jback = batching.padded_to_flat(got), jax_batching.padded_to_flat(
        want)
    assert len(back) == len(jback) == (5 if extras else 3)
    for a, b in zip(back, jback):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # padded -> flat -> padded is the identity.
    again = batching.flat_to_padded(*back[:3], num_imgs=got.num_images,
                                    O_max=got.objs.shape[1],
                                    T_max=got.triples.shape[1],
                                    **(dict(boxes=back[3], masks=back[4])
                                       if extras else {}))
    _same_batch(again, got)
    if not shuffle:
        # Sorted routing: flat -> padded -> flat is the identity too.
        for a, b in zip(back, (objs, triples, o2i, boxes, masks)):
            assert np.array_equal(a, b)


def test_flat_to_padded_with_empty_images_and_no_triples():
    objs = np.array([3, 4], np.int32)
    triples = np.zeros((0, 3), np.int32)
    o2i = np.array([0, 2])
    for kw in ({}, {"num_imgs": 4}):
        got = batching.flat_to_padded(objs, triples, o2i, **kw)
        want = jax_batching.flat_to_padded(objs, triples, o2i, **kw)
        _same_batch(got, want)


def test_graph_batch_num_images_replace_and_pad_rows():
    objs, triples, boxes, masks = _graphs(8, n=3)
    b = batching.pad_graphs(objs, triples, boxes_list=boxes)
    jb = jax_batching.pad_graphs(objs, triples, boxes_list=boxes)
    assert b.num_images == jb.num_images == 3
    imgs = np.ones((3, 4, 4, 3), np.float32)
    _same_batch(b.replace(images=imgs), jb.replace(images=imgs))
    assert b.images is None  # replace returns a new batch
    padded = b.pad_rows(5)
    assert padded.num_images == 5 and padded.masks is None
    for name in ("objs", "triples", "obj_mask", "triple_mask", "boxes"):
        a = getattr(padded, name)
        assert np.array_equal(a[:3], getattr(b, name))
        assert not a[3:].any()
    assert data.GraphBatch is batching.GraphBatch


def test_data_exports_every_name_of_the_jax_package():
    missing = [n for n in jax_data.__all__ if not hasattr(data, n)]
    assert not missing
    for name in ("GraphBatch", "pad_graphs", "flat_to_padded",
                 "padded_to_flat", "encode_scene_graphs"):
        assert name in jax_data.__all__ and callable(getattr(data, name))


@pytest.mark.parametrize("shape", [(6, 5, 3), (3, 6, 5, 3)],
                         ids=["image", "batch"])
@pytest.mark.parametrize("rescale", [True, False])
def test_imagenet_deprocess_matches_jax(shape, rescale):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    got = data.imagenet_deprocess(x, rescale_image=rescale)
    want = jax_data.imagenet_deprocess(x, rescale_image=rescale)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(data.imagenet_preprocess(x),
                          jax_data.imagenet_preprocess(x))
    if len(shape) == 4:
        assert np.array_equal(
            data.imagenet_deprocess_batch(x, rescale=rescale),
            jax_data.imagenet_deprocess_batch(x, rescale=rescale))


VOCAB = {
    "object_name_to_idx": {"__image__": 0, "cat": 1, "dog": 2, "tree": 3},
    "pred_name_to_idx": {"__in_image__": 0, "left of": 1, "above": 2},
}
GRAPHS = [
    {"objects": ["cat", "dog"], "relationships": [[0, "left of", 1]]},
    {"objects": ["tree", "cat", "dog"],
     "relationships": [[0, "above", 1], [2, "left of", 0]]},
    {"objects": ["dog"], "relationships": []},
]


@pytest.mark.parametrize("kw", [
    {}, {"align": 8}, {"O_max": 8, "T_max": 12},
    {"O_max": 4, "T_max": 5}, {"O_max": 16, "align": 8},
], ids=["default", "align8", "pad_targets", "tight", "O_max_align"])
def test_encode_scene_graphs_matches_jax(kw):
    _same_batch(data.encode_scene_graphs(GRAPHS, VOCAB, **kw),
                jax_data.encode_scene_graphs(GRAPHS, VOCAB, **kw))
    # One dict, as one graph.
    _same_batch(data.encode_scene_graphs(GRAPHS[1], VOCAB, **kw),
                jax_data.encode_scene_graphs(GRAPHS[1], VOCAB, **kw))


@pytest.mark.parametrize("graph, match", [
    ({"objects": ["cow"], "relationships": []}, "not in vocab"),
    ({"objects": ["cat"], "relationships": [[0, "under", 0]]},
     "not in vocab"),
    ({"objects": ["cat"], "relationships": [[0, "above", 3]]},
     "out of range"),
], ids=["object", "predicate", "endpoint"])
def test_encode_scene_graphs_errors_match_jax(graph, match):
    for mod in (data, jax_data):
        with pytest.raises(ValueError, match=match):
            mod.encode_scene_graphs([graph], VOCAB)
    with pytest.raises(ValueError, match="exceed pad targets"):
        data.encode_scene_graphs(GRAPHS, VOCAB, O_max=3)


@pytest.mark.parametrize("size", [1, 2, 17])
def test_normalized_to_pixel_matches_jax(size):
    c = np.linspace(-1.5, 1.5, 13).astype(np.float32)
    got = sampling.normalized_to_pixel(torch.from_numpy(c), size).numpy()
    want = np.asarray(jax_sampling.normalized_to_pixel(jnp.asarray(c), size))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("N, H, W, C, Hg, Wg", [
    (2, 8, 8, 3, 5, 7), (1, 5, 13, 4, 9, 3), (3, 16, 4, 1, 6, 6),
    (2, 1, 6, 2, 4, 4),
], ids=["square", "wide", "tall", "one_row"])
def test_grid_sample_matches_jax(N, H, W, C, Hg, Wg):
    rng = np.random.RandomState(H * 100 + W)
    img = rng.randn(N, H, W, C).astype(np.float32)
    # Beyond [-1, 1] on both sides: taps outside the image add 0.
    grid = rng.uniform(-1.4, 1.4, (N, Hg, Wg, 2)).astype(np.float32)
    grid[0, 0, 0] = [-1.0, 1.0]        # the corners, exactly
    grid[0, 0, 1] = [1.0, -1.0]
    grid[-1, -1, -1, 0] = np.nan       # a degenerate box's coordinates
    grid[-1, 0, -1, 1] = np.inf
    grid[0, -1, 0] = [-np.inf, 0.3]
    got = sampling.grid_sample(torch.from_numpy(img), torch.from_numpy(grid))
    want = np.asarray(jax_sampling.grid_sample(jnp.asarray(img),
                                               jnp.asarray(grid)))
    assert got.shape == (N, Hg, Wg, C)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not got[-1, -1, -1].any() and not got[0, -1, 0].any()


@pytest.mark.parametrize("as_dict", [False, True], ids=["list", "dict"])
def test_grad_global_norm_matches_jax(as_dict):
    rng = np.random.RandomState(11)
    shapes = [(3, 4), (7,), (2, 3, 5, 5), ()]
    arrs = [np.asarray(rng.randn(*s) * 10.0 ** i, np.float32)
            for i, s in enumerate(shapes)]
    tensors = [torch.from_numpy(a) for a in arrs]
    want = float(jax_metrics.grad_global_norm(
        {f"p{i}": jnp.asarray(a) for i, a in enumerate(arrs)}))
    grads = ({f"p{i}": t for i, t in enumerate(tensors)} if as_dict
             else iter(tensors))
    got = metrics.grad_global_norm(grads)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-6 * want
    # bf16 gradients are summed in float32, as in the JAX function.
    half = [t.to(torch.bfloat16) for t in tensors]
    want16 = float(jax_metrics.grad_global_norm(
        [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in half]))
    assert abs(float(metrics.grad_global_norm(half)) - want16) <= (
        1e-6 * want16)


@pytest.mark.parametrize("text", ["1.5", "0.1,2,-3e-2", "inf,-0.0", "7"])
def test_float_tuple_matches_jax(text):
    got = flags.float_tuple(text)
    assert got == jax_flags.float_tuple(text)
    assert all(type(v) is float for v in got)
    p = argparse.ArgumentParser()
    p.add_argument("--x", type=flags.float_tuple)
    assert p.parse_args(["--x", text]).x == got


def test_float_tuple_rejects_what_the_jax_one_rejects():
    for mod in (flags, jax_flags):
        with pytest.raises(ValueError):
            mod.float_tuple("1,two")


def test_graph_batch_fields_match_jax():
    assert [f.name for f in dataclasses.fields(batching.GraphBatch)] == [
        f.name for f in dataclasses.fields(jax_batching.GraphBatch)]


@pytest.mark.parametrize("sub", ["nn", "ops", "utils", "data", "models"])
def test_subpackage_all_matches_jax(sub):
    import importlib

    jax_mod = importlib.import_module(f"sg2im_tpu.{sub}")
    port = importlib.import_module(f"sg2im_tpu_torch.{sub}")
    assert sorted(port.__all__) == sorted(jax_mod.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_top_level_lazy_names_match_jax():
    import sg2im_tpu
    import sg2im_tpu_torch
    from sg2im_tpu_torch.train.config import TrainConfig
    from sg2im_tpu_torch.train.trainer import Trainer

    for name in ("InferenceEngine", "Sg2ImGenerator", "Trainer",
                 "TrainConfig"):
        assert getattr(sg2im_tpu, name).__name__ == name
        assert getattr(sg2im_tpu_torch, name).__name__ == name
    assert sg2im_tpu_torch.Trainer is Trainer
    assert sg2im_tpu_torch.TrainConfig is TrainConfig
    with pytest.raises(AttributeError):
        sg2im_tpu_torch.NoSuchName


MLP_CASES = [
    ((6, 8, 5), {}),
    ((6, 8, 5), {"activation": "leakyrelu"}),
    ((6, 8, 7, 5), {"dropout": 0.3}),
    ((6, 8, 5), {"final_nonlinearity": False}),
    ((6, 8, 5), {"batch_norm": "batch", "dropout": 0.5,
                 "final_nonlinearity": False}),
    ((6, 8, 5), {"activation": "tanh", "batch_norm": "batch"}),
    ((6, 5), {"activation": "leakyrelu", "final_nonlinearity": False}),
]
MLP_IDS = ["default", "leakyrelu", "dropout", "no_final", "bn_dropout",
           "unknown_activation", "one_layer"]


@pytest.mark.parametrize("dims, kw", MLP_CASES, ids=MLP_IDS)
def test_parse_mlp_matches_jax(dims, kw):
    from sg2im_tpu.nn import layers as jlayers
    from sg2im_tpu_torch.nn import layers

    got = layers.parse_mlp(dims, **kw)
    want = jlayers.parse_mlp(dims, **kw)
    assert [tuple(s) for s in got] == [
        (s.kind, s.torch_idx, s.din, s.dout) for s in want]


@pytest.mark.parametrize("dims, kw", MLP_CASES, ids=MLP_IDS)
def test_mlp_arguments_match_jax(dims, kw):
    import jax

    from sg2im_tpu.ckpt.torch_convert import convert_variables_to_torch_state
    from sg2im_tpu.nn import layers as jlayers
    from sg2im_tpu_torch.nn import layers

    x = np.random.RandomState(5).randn(3, 4, dims[0]).astype(np.float32)
    jm = jlayers.MLP(dims, **kw)
    variables = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    rng = np.random.RandomState(6)

    def stats(path, v):  # running statistics away from (0, 1)
        name = path[-1].key
        if name == "mean":
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return np.asarray(v)

    variables = jax.tree_util.tree_map_with_path(stats, variables)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    m = layers.MLP(dims, **kw)
    m.load_state_dict(convert_variables_to_torch_state(variables),
                      strict=True)
    m.eval()
    assert [type(layer).__name__ for layer in m] == [
        {"linear": "Linear", "bn": "BatchNorm", "dropout": "Dropout",
         "act": ("LeakyReLU" if kw.get("activation") == "leakyrelu"
                 else "ReLU")}[s.kind] for s in layers.parse_mlp(dims, **kw)]
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
