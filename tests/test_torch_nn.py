"""Port parity: sg2im_tpu_torch.nn against sg2im_tpu.nn on the CPU.

Each JAX module is built from a seed, its variables are mapped with
``state_dict_from_jax`` and loaded into the port with strict=True, and both
run on the same numpy inputs.  Bars: 2e-5 abs for exact reformulations
(norms, MLPs, pooling), 1e-4 abs/rel for convolution outputs, whose sums
run in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sg2im_tpu.nn import crn as jcrn
from sg2im_tpu.nn import graph as jgraph
from sg2im_tpu.nn import layers as jlayers
from sg2im_tpu_torch.ckpt import state_dict_from_jax
from sg2im_tpu_torch.nn import crn as tcrn
from sg2im_tpu_torch.nn import graph as tgraph
from sg2im_tpu_torch.nn import layers as tlayers

EXACT = 2e-5
CONV = 1e-4


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if hasattr(v, "items") else np.array(v)
            for k, v in tree.items()}


def perturb_norms(variables, seed=0):
    """Non-trivial BatchNorm state: running stats and affine parameters
    away from their (0, 1) initial values."""
    rng = np.random.RandomState(seed)
    tree = _numpy_tree(variables)

    def walk(node, in_bn):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, in_bn or k == "bn")
            elif k == "mean":
                node[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k == "var":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif in_bn and k == "scale":
                node[k] = (1 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif in_bn and k == "bias":
                node[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)

    walk(tree, False)
    return tree


def load(module, variables):
    module.load_state_dict(state_dict_from_jax(variables), strict=True)
    return module.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape", [(6, 5), (2, 4, 3, 5)])
def test_batchnorm_eval_matches_jax(shape):
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    jbn = jlayers.BatchNorm(5)
    variables = perturb_norms(jbn.init(jax.random.PRNGKey(0),
                                       jnp.asarray(x)))
    want = np.asarray(jbn.apply(variables, jnp.asarray(x), train=False))
    bn = tlayers.BatchNorm(5)
    # The JAX tree is rooted at the wrapper: prefix the port's module name.
    state = state_dict_from_jax(variables)
    bn.load_state_dict({k.split(".", 1)[1]: v for k, v in state.items()},
                       strict=True)
    bn.eval()
    if len(shape) == 4:  # channels last in JAX, dim 1 in the port
        got = nhwc(bn(nchw(x)))
    else:
        got = bn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=EXACT)


def test_batchnorm_drops_num_batches_tracked_and_refuses_training():
    """A loaded num_batches_tracked is dropped; train mode takes batch
    statistics and moves the running ones as the JAX BatchNorm does."""
    bn = tlayers.BatchNorm(3)
    state = dict(bn.state_dict(), num_batches_tracked=torch.tensor(7))
    bn.load_state_dict(state, strict=True)
    x = np.random.RandomState(2).randn(5, 3).astype(np.float32) * 2 + 1
    jbn = jlayers.BatchNorm(3)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, upd = jbn.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    got = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=EXACT)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["mean"]),
                               atol=EXACT)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["bn"]["var"]),
                               atol=EXACT)


def test_instance_norm_matches_jax():
    x = np.random.RandomState(1).randn(2, 6, 5, 3).astype(np.float32)
    want = np.asarray(jlayers.instance_norm_2d(jnp.asarray(x)))
    np.testing.assert_allclose(nhwc(tlayers.instance_norm_2d(nchw(x))),
                               want, atol=EXACT)


def test_activation_quirks():
    # Every CNN/CRN name becomes a leaky ReLU, 'relu' included.
    assert tlayers.parse_activation("relu") == ("leakyrelu", 0.01)
    assert tlayers.parse_activation("leakyrelu-0.2") == ("leakyrelu", 0.2)
    assert tlayers.parse_activation("relu") == jlayers.parse_activation(
        "relu")


@pytest.mark.parametrize("batch_norm", ["none", "batch"])
def test_mlp_matches_jax(batch_norm):
    x = np.random.RandomState(2).randn(3, 4, 6).astype(np.float32)
    jm = jlayers.MLP((6, 8, 5), batch_norm=batch_norm)
    variables = perturb_norms(jm.init(jax.random.PRNGKey(1),
                                      jnp.asarray(x)))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    m = load(tlayers.MLP((6, 8, 5), batch_norm=batch_norm), variables)
    got = m(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=EXACT)
    # The final-ReLU quirk: a true ReLU ends the heads, so outputs are >= 0
    # and some are exactly 0.
    assert (got >= 0).all() and (got == 0).any()


@pytest.mark.parametrize("pooling", ["sum", "avg"])
def test_pool_messages_matches_jax(pooling):
    rng = np.random.RandomState(3)
    N, T, O, H = 2, 7, 5, 4
    s_idx = rng.randint(0, O, (N, T)).astype(np.int32)
    o_idx = rng.randint(0, O, (N, T)).astype(np.int32)
    s_msgs = rng.randn(N, T, H).astype(np.float32)
    o_msgs = rng.randn(N, T, H).astype(np.float32)
    tmask = (rng.rand(N, T) < 0.7).astype(np.float32)
    want = np.asarray(jgraph.pool_messages(
        *map(jnp.asarray, (s_idx, o_idx, s_msgs, o_msgs, tmask)), O,
        pooling))
    got = tgraph.pool_messages(
        *map(torch.from_numpy, (s_idx, o_idx, s_msgs, o_msgs, tmask)), O,
        pooling)
    np.testing.assert_allclose(got.numpy(), want, atol=EXACT)


def test_graph_triple_conv_net_matches_jax():
    rng = np.random.RandomState(4)
    N, O, T, D = 2, 5, 6, 8
    obj = rng.randn(N, O, D).astype(np.float32)
    pred = rng.randn(N, T, D).astype(np.float32)
    edges = rng.randint(0, O, (N, T, 2)).astype(np.int32)
    tmask = (rng.rand(N, T) < 0.8).astype(np.float32)
    jnet = jgraph.GraphTripleConvNet(input_dim=D, num_layers=2,
                                     hidden_dim=12)
    args = tuple(map(jnp.asarray, (obj, pred, edges, tmask)))
    variables = jax.jit(jnet.init)(jax.random.PRNGKey(2), *args)
    want = jax.jit(jnet.apply)(variables, *args)
    net = load(tgraph.GraphTripleConvNet(D, num_layers=2, hidden_dim=12),
               variables)
    with torch.no_grad():
        got = net(torch.from_numpy(obj), torch.from_numpy(pred),
                  torch.from_numpy(edges).long(), torch.from_numpy(tmask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=EXACT)


def test_upsample_and_pool_match_jax():
    x = np.random.RandomState(5).randn(2, 4, 6, 3).astype(np.float32)
    np.testing.assert_array_equal(
        nhwc(tlayers.upsample_nearest(nchw(x), 2)),
        np.asarray(jlayers.upsample_nearest(jnp.asarray(x), 2)))
    np.testing.assert_allclose(
        nhwc(tlayers.avg_pool_2d(nchw(x), 2)),
        np.asarray(jlayers.avg_pool_2d(jnp.asarray(x), 2)), atol=EXACT)


@pytest.fixture(scope="module", params=["batch", "instance"])
def crn_case(request):
    """A 3-stage CRN from a seed, and a 16x16 layout."""
    dims = (6, 16, 8, 4)
    layout = np.random.RandomState(6).randn(2, 16, 16, 6).astype(np.float32)
    jnet = jcrn.RefinementNetwork(dims=dims, normalization=request.param,
                                  activation="leakyrelu-0.2")
    variables = perturb_norms(jax.jit(jnet.init)(jax.random.PRNGKey(3),
                                                 jnp.asarray(layout)))
    return dims, request.param, layout, variables


NOISE_DIM = 2  # 'split_noise': the layout's last 2 channels come apart
# conv0_mode of both networks; 'split_noise' is 'split' with the noise
# apart.  'packed' at packed_min_res 8: the 8x8 and 16x16 stages and the
# head run packed, the 4x4 stage legacy.
NET_MODES = {"legacy": {}, "split": {}, "phase": {},
             "packed": {"packed_min_res": 8}, "split_noise": {}}


@pytest.mark.parametrize("mode", sorted(NET_MODES))
def test_refinement_network_matches_jax(crn_case, mode):
    dims, norm, layout, variables = crn_case
    conv0_mode = "split" if mode == "split_noise" else mode
    kw = dict(normalization=norm, activation="leakyrelu-0.2",
              conv0_mode=conv0_mode, **NET_MODES[mode])
    jnet = jcrn.RefinementNetwork(dims=dims, **kw)
    net = load(tcrn.RefinementNetwork(dims, **kw), variables)
    if mode == "split_noise":
        parts = (layout[..., :-NOISE_DIM], layout[..., -NOISE_DIM:])
        want = jax.jit(lambda v, x, n: jnet.apply(v, x, noise=n))(
            variables, *map(jnp.asarray, parts))
        with torch.no_grad():
            got = net(nchw(parts[0]), noise=nchw(parts[1]))
    else:
        want = jax.jit(jnet.apply)(variables, jnp.asarray(layout))
        with torch.no_grad():
            got = net(nchw(layout))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=CONV,
                               rtol=CONV)


# -- the packed domain and the phase / noise forms of conv0 -------------------

def _scaled_bar(want):
    """The JAX suite's bar for exact reformulations (tests/
    test_model_parity.py): 2e-5 of max(|out|, 1)."""
    return EXACT * max(float(np.abs(want).max()), 1.0)


def _variables(module, *args, seed, **kwargs):
    """Variables of a JAX module for ``args``, drawn with numpy from a seed
    (shapes from ``jax.eval_shape``: no initializer is compiled).  Conv
    kernels are N(0, 2 / fan_in), everything else N(0, 0.1^2); BatchNorm
    state goes through :func:`perturb_norms`."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                            **kwargs)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key == "kernel":
            std = (2.0 / np.prod(leaf.shape[:-1])) ** 0.5
        else:
            std = 0.1
        return (std * rng.randn(*leaf.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return perturb_norms(tree, seed)


def _load_flat(module, variables, prefix=""):
    """A single JAX module's variables (no module path) into a port
    module whose parameters sit under ``prefix``."""
    state = {prefix + k.lstrip("."): v
             for k, v in state_dict_from_jax(variables).items()}
    module.load_state_dict(state, strict=True)
    return module.eval()


PACKED_CONVS = [(4, 3, 5, 7), (2, 16, 8, 3), (3, 2, 1, 4)]  # R, Rw, cin, co


@pytest.mark.parametrize("R,Rw,cin,co", PACKED_CONVS)
def test_packed_conv3x3_matches_jax(R, Rw, cin, co):
    x = np.random.RandomState(R).randn(2, R, Rw, 4 * cin).astype(np.float32)
    jm = jcrn.PackedConv3x3(cin, co)
    variables = _variables(jm, jnp.asarray(x), seed=R)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    conv = _load_flat(tcrn.QuantConv3x3(cin, co), variables)
    with torch.no_grad():
        got = nhwc(conv.packed(nchw(x)))
    np.testing.assert_allclose(got, want, atol=_scaled_bar(want), rtol=0)


@pytest.mark.parametrize("R,Rw,cin,co", PACKED_CONVS)
def test_packed_upsample_conv_matches_jax(R, Rw, cin, co):
    rng = np.random.RandomState(R + 10)
    cl = cin + 2
    lp = rng.randn(2, R, Rw, 4 * cl).astype(np.float32)
    feats = rng.randn(2, R, Rw, cin).astype(np.float32)
    jm = jcrn.PackedUpsampleConv(cl, cin, co)
    args = (jnp.asarray(lp), jnp.asarray(feats))
    variables = _variables(jm, *args, seed=R)
    want = np.asarray(jax.jit(jm.apply)(variables, *args))
    conv = _load_flat(tcrn.FusedUpsampleConv(cl, cin, co), variables)
    with torch.no_grad():
        got = nhwc(conv.packed(nchw(lp), nchw(feats), torch.float32))
    np.testing.assert_allclose(got, want, atol=_scaled_bar(want), rtol=0)


def test_packed_instance_norm_matches_jax():
    x = (3 * np.random.RandomState(7).randn(2, 5, 3, 4 * 6) + 1).astype(
        np.float32)
    want = np.asarray(jcrn.packed_instance_norm(jnp.asarray(x), 6))
    got = nhwc(tcrn.packed_instance_norm(nchw(x), 6))
    np.testing.assert_allclose(got, want, atol=_scaled_bar(want), rtol=0)


@pytest.mark.parametrize("cin,co", [(6, 3), (5, 4)])
def test_packed_conv1x1_matches_jax(cin, co):
    x = np.random.RandomState(cin).randn(2, 3, 5, 4 * cin).astype(np.float32)
    jm = jcrn.PackedConv1x1(cin, co)
    variables = _variables(jm, jnp.asarray(x), seed=cin)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    conv = _load_flat(torch.nn.Conv2d(cin, co, 1), variables)
    with torch.no_grad():
        got = nhwc(tcrn.packed_conv1x1(conv, nchw(x)))
    assert got.shape == (2, 6, 10, co)
    np.testing.assert_allclose(got, want, atol=_scaled_bar(want), rtol=0)


@pytest.mark.parametrize("normalization", ["batch", "instance", "none"])
def test_packed_refinement_module_matches_jax(normalization):
    """RefinementModule.packed against PackedRefinementModule, BatchNorm
    statistics away from (0, 1): each channel's statistics serve its four
    phases."""
    rng = np.random.RandomState(8)
    lp = rng.randn(2, 4, 4, 4 * 5).astype(np.float32)
    feats = rng.randn(2, 4, 4, 3).astype(np.float32)
    jm = jcrn.PackedRefinementModule(5, 3, 6, normalization=normalization,
                                     activation="leakyrelu-0.2")
    args = (jnp.asarray(lp), jnp.asarray(feats))
    variables = _variables(jm, *args, seed=8)
    want = np.asarray(jax.jit(jm.apply)(variables, *args))
    stage = _load_flat(tcrn.RefinementModule(5, 3, 6, normalization,
                                             "leakyrelu-0.2"),
                       variables, prefix="net.")
    with torch.no_grad():
        got = nhwc(stage.packed(nchw(lp), nchw(feats)))
    np.testing.assert_allclose(got, want, atol=_scaled_bar(want), rtol=0)


CONV0_CASES = [(4, 5, 3, 7), (8, 40, 24, 16), (3, 2, 1, 4)]  # R, cl, cf, co


@pytest.mark.parametrize("R,cl,cf,co", CONV0_CASES)
def test_fused_upsample_conv_phase_matches_jax(R, cl, cf, co):
    rng = np.random.RandomState(R)
    layout = rng.randn(2, 2 * R, 2 * R, cl).astype(np.float32)
    feats = rng.randn(2, R, R, cf).astype(np.float32)
    jm = jcrn.FusedUpsampleConv(cl, cf, co, mode="phase")
    args = (jnp.asarray(layout), jnp.asarray(feats))
    variables = _variables(jm, *args, seed=R)
    want = np.asarray(jax.jit(jm.apply)(variables, *args))
    conv = _load_flat(tcrn.FusedUpsampleConv(cl, cf, co, mode="phase"),
                      variables)
    with torch.no_grad():
        got = nhwc(conv(nchw(layout), nchw(feats), torch.float32))
    np.testing.assert_allclose(got, want, atol=_scaled_bar(want), rtol=0)


@pytest.mark.parametrize("R,cl,cf,co", CONV0_CASES)
def test_fused_upsample_conv_separate_noise_matches_jax(R, cl, cf, co):
    """Split conv0 with the layout block's trailing noise channels apart,
    at half and at equal resolution (the first stage's concat)."""
    rng = np.random.RandomState(R + 20)
    cn = 2
    layout = rng.randn(2, 2 * R, 2 * R, cl).astype(np.float32)
    noise = rng.randn(2, 2 * R, 2 * R, cn).astype(np.float32)
    jm = jcrn.FusedUpsampleConv(cl + cn, cf, co, mode="split", noise_dim=cn)
    conv = tcrn.FusedUpsampleConv(cl + cn, cf, co, mode="split")
    for i, side in enumerate((R, 2 * R)):
        feats = rng.randn(2, side, side, cf).astype(np.float32)
        args = tuple(map(jnp.asarray, (layout, feats)))
        if i == 0:
            variables = _variables(jm, *args, seed=R,
                                   noise=jnp.asarray(noise))
            _load_flat(conv, variables)
        want = np.asarray(jax.jit(jm.apply)(variables, *args,
                                   noise=jnp.asarray(noise)))
        with torch.no_grad():
            got = nhwc(conv(nchw(layout), nchw(feats), torch.float32,
                            noise=nchw(noise)))
        np.testing.assert_allclose(got, want, atol=_scaled_bar(want),
                                   rtol=0)


def test_crn_mode_checks():
    with pytest.raises(ValueError, match="unknown CRN mode"):
        tcrn.RefinementNetwork((6, 8, 4), conv0_mode="split_noise")
    for mode in ("packed", "phase"):
        with pytest.raises(ValueError, match="int8"):
            tcrn.RefinementNetwork((6, 8, 4), conv0_mode=mode, quant="int8")
    net = tcrn.RefinementNetwork((6, 8, 4), conv0_mode="legacy").eval()
    with pytest.raises(ValueError, match="'split'"):
        net(torch.zeros(1, 4, 8, 8), noise=torch.zeros(1, 2, 8, 8))
