"""The JAX package's parameter init: for the same key, a model's weights are
those that flax's ``Module.init({'params': key}, ...)`` gives the JAX
package's model.

Counterparts: the initializers of ``sg2im_tpu/nn/layers.py:37-55``
(``torch_linear_kernel_init``, ``torch_linear_bias_init``,
``kaiming_normal_init``), ``nn.initializers.normal(1.0)`` of the
embeddings (``sg2im_tpu/models/sg2im.py:159, 165``), the ones and zeros of
``_BNCore`` (``layers.py:112-117``), and flax's key per parameter
(``flax/core/scope.py``: ``Scope.make_rng`` and ``_fold_in_static``).  No
flax or JAX is imported: the streams are ``ops.prng``'s.

What ``Module.init`` does, leaf by leaf:

* the key of a parameter is ``fold_in(key, u32)``, ``u32`` the SHA-1 of
  its module path and of its 1-based order among the ``self.param`` calls
  of its own module (``ops.prng.fold_in_static``).  Every parameter
  counts, BatchNorm's ones and zeros too: a Dense or Conv draws its kernel
  with 1 and its bias with 2, ``_BNCore`` its scale with 1 and its bias
  with 2, an Embed its embedding with 1;
* a kernel is ``variance_scaling`` in its JAX layout (Dense (in, out),
  Conv HWIO; ``fan_in`` the product of all but the last dimension):
  upstream's nn.Linear default, ``uniform(key, shape, -1, 1) * sqrt(3
  var)`` with ``var = float32((1 / 3) / fan_in)``, or kaiming's
  ``normal(key, shape) * sqrt(var)`` with ``var = float32(2 / fan_in)``
  where the port's module says ``kernel_init = 'kaiming_normal'`` (the
  GCN's MLPs and the CRN's convs, as in the JAX modules); the factors are
  float32 (``3 * var`` and the square root rounded in float32, x64 off)
  and the product is rounded on its own, since flax's init is eager;
* a bias is ``uniform(key, (out,), -b, b)``, ``b = 1 / sqrt(fan_in)`` of
  its kernel's ``fan_in`` (every JAX module passes that fan_in to
  ``torch_linear_bias_init``), the bounds rounded to float32;
* an embedding is ``normal(key, shape) * 1.0``; BatchNorm's scale and
  running variance are ones, its bias and running mean zeros.

Each leaf is drawn in its JAX shape, whose row-major order threefry's
counters follow, and only then moved into the port's layout by
``ckpt.state_dict_from_jax``; ``ckpt.jax_leaves`` lists the leaves, so no
path is written twice.  The JAX model's parameter paths and shapes are
the same in every ``crn_mode`` (and int8 tier), and so are the weights.

On the card every drawn leaf is one launch of the threefry kernel
(``ops.prng_kernel``: ``threefry_uniform`` or ``threefry_normal`` with its
scale); on the CPU the same wrappers compute the plain versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sg2im_tpu_torch.ckpt import jax_leaves, state_dict_from_jax
from sg2im_tpu_torch.ops import prng
from sg2im_tpu_torch.ops.prng_kernel import threefry_normal, threefry_uniform

MODELS = ("g", "d_obj", "d_img")
# A leaf's place among its module's self.param calls (1-based counters).
_PARAM_ORDER = {"kernel": 0, "scale": 0, "embedding": 0, "bias": 1}


class Leaf(NamedTuple):
    """One variable of the JAX model as the init draws it.  ``draw``:
    'uniform' (on ``bounds``, times ``scale``), 'normal' (times
    ``scale``), 'ones' or 'zeros'; ``counter``: its 1-based order among
    its module's parameters (0 for batch statistics)."""
    name: str
    collection: str
    path: tuple
    shape: tuple
    draw: str
    scale: float = 1.0
    bounds: tuple = (0.0, 1.0)
    counter: int = 0


def _f32(x) -> float:
    return float(np.float32(x))


def init_plan(module: torch.nn.Module, model: str,
              prefix: str = "") -> list[Leaf]:
    """The leaves of ``module`` (the port's generator, 'g', or a
    discriminator, 'd_obj' / 'd_img') in the JAX model, each with its
    initializer.  ``prefix``: ``module`` is the submodule of that model
    under this dotted name (e.g. one CRN stage), and draws as it does
    there."""
    if model not in MODELS:
        raise ValueError(f"model must be one of {MODELS}, got {model!r}")
    named = {prefix + k: v for k, v in module.state_dict().items()}
    leaves = list(jax_leaves(named, model))
    fans = {}  # a kernel's module -> fan_in of its JAX shape
    shapes = {}
    for name, _, path, axes in leaves:
        shape = tuple(named[name].shape)
        if axes is not None:
            shape = tuple(shape[a] for a in axes)
            fans[name.rsplit(".", 1)[0]] = int(np.prod(shape[:-1]))
        shapes[name] = shape
    scopes: dict[tuple, list[str]] = {}
    for name, collection, path, _ in leaves:
        if collection == "params":
            scopes.setdefault(tuple(path[:-1]), []).append(path[-1])
    plan = []
    for name, collection, path, axes in leaves:
        shape, leaf = shapes[name], path[-1]
        owner = name.rsplit(".", 1)[0]
        if collection == "batch_stats":
            plan.append(Leaf(name, collection, tuple(path), shape,
                             "zeros" if leaf == "mean" else "ones"))
            continue
        scope = tuple(path[:-1])
        order = sorted(scopes[scope], key=_PARAM_ORDER.__getitem__)
        counter = order.index(leaf) + 1
        common = (name, collection, tuple(path), shape)
        if scope[-1:] == ("bn",):
            plan.append(Leaf(*common, "ones" if leaf == "scale" else "zeros",
                             counter=counter))
        elif leaf == "embedding":
            plan.append(Leaf(*common, "normal", 1.0, counter=counter))
        elif leaf == "kernel":
            kind = getattr(module.get_submodule(owner[len(prefix):]),
                           "kernel_init", "torch_linear")
            fan_in = fans[owner]
            if kind == "kaiming_normal":
                var = np.float32(2.0 / fan_in)
                plan.append(Leaf(*common, "normal", _f32(np.sqrt(var)),
                                 counter=counter))
            elif kind == "torch_linear":
                var = np.float32((1.0 / 3.0) / fan_in)
                plan.append(Leaf(*common, "uniform",
                                 _f32(np.sqrt(np.float32(3) * var)),
                                 (-1.0, 1.0), counter))
            else:
                raise ValueError(f"{owner}: unknown kernel_init {kind!r}")
        else:  # a Dense or Conv bias: torch_linear_bias_init(fan_in)
            b = 1.0 / (fans[owner] ** 0.5)
            plan.append(Leaf(*common, "uniform", 1.0, (-b, b), counter))
    return plan


def init_draws(module: torch.nn.Module, model: str) -> dict[str, int]:
    """The threefry launches :func:`init_state_dict` makes on the card for
    ``module``: one a drawn leaf, {'threefry_uniform': n,
    'threefry_normal': m}."""
    plan = init_plan(module, model)
    return {f"threefry_{d}": sum(leaf.draw == d for leaf in plan)
            for d in ("uniform", "normal")}


def init_state_dict(module: torch.nn.Module, model: str, key, device=None,
                    prefix: str = "") -> dict[str, torch.Tensor]:
    """The state dict of ``module`` that flax's ``init`` gives the JAX
    model of kind ``model`` for ``{'params': key}``, drawn on ``device``
    (default the CPU): float32 tensors under the port's names.  ``key``: a
    (2,) uint32 tensor (on any device; read once) or two ints.
    ``prefix``: see :func:`init_plan`."""
    device = torch.device(device or "cpu")
    root = prng.key_words(key)
    tree: dict = {}
    for leaf in init_plan(module, model, prefix):
        n = int(np.prod(leaf.shape, dtype=np.int64))
        if leaf.draw in ("ones", "zeros"):
            value = (torch.ones if leaf.draw == "ones" else torch.zeros)(
                leaf.shape, dtype=torch.float32, device=device)
        else:
            k = prng.fold_in_words(root, prng.static_fold_data(
                leaf.path[:-1] + (leaf.counter,)))
            # A flat draw is the JAX shape's row-major order: for the
            # normal, a channels_last (1, n, 1, 1) draw, the walk's flat
            # case.
            if leaf.draw == "uniform":
                value = threefry_uniform(k, n, *leaf.bounds, leaf.scale,
                                         device=device)
            else:
                value = threefry_normal(k, (1, n, 1, 1), device=device,
                                        memory_format=torch.channels_last,
                                        scale=leaf.scale)
            value = value.view(leaf.shape)
        node = tree.setdefault(leaf.collection, {})
        for p in leaf.path[:-1]:
            node = node.setdefault(p, {})
        node[leaf.path[-1]] = value
    state = state_dict_from_jax(tree)
    return {k[len(prefix):]: v for k, v in state.items()}


def reset_parameters(module: torch.nn.Module, model: str, key,
                     prefix: str = "") -> None:
    """Load :func:`init_state_dict` into ``module``, drawn where its
    parameters lie."""
    device = next(module.parameters()).device
    state = init_state_dict(module, model, key, device, prefix)
    with torch.no_grad():
        module.load_state_dict(state, strict=True)
