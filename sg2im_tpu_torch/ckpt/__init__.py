"""Weights into the port: reference ``.pt`` checkpoints and JAX variables.

The port's modules keep upstream's parameter names, so a reference
checkpoint's ``model_state`` loads with ``load_state_dict(strict=True)`` as
it is.  ``state_dict_from_jax`` maps the JAX package's flax variable trees
(numpy or JAX arrays) onto the same names, the inverse of the JAX
package's own converter (``sg2im_tpu/ckpt/torch_convert.py``), for the
generator and both discriminators, and ``variables_to_jax`` maps them back;
``train_state_from_jax`` carries a whole JAX ``TrainState`` across
(optimizer moments included), live or as the JAX store's ``state.msgpack``
restores it, and ``jax_tree_from_train_state`` is its inverse, the tree
that file holds; ``calibration_from_jax`` carries the int8 tier's
activation scales across.  ``load_reference_bundle`` reads a warm start
(the generator and both discriminators), ``export_reference_checkpoint``
writes the generator back in the reference layout; ``store`` saves and
resumes train states in the port's format and in the JAX store's.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# Upstream model kwargs that later versions dropped (upstream
# scripts/strip_old_args.py); the model ignores them.
DEPRECATED_MODEL_KWARGS = ("vec_noise_dim", "gconv_mode", "box_anchor",
                           "decouple_obj_predictions")

_FLAX_PART = re.compile(
    r"(layer|gconvs_|refinement_modules_|output_conv_|cnn_)(\d+)")


def _torch_prefix(path) -> str:
    """flax module path -> upstream dotted module name."""
    parts = []
    prev_layer = False
    for p in path:
        if p == "bn":  # the JAX BatchNorm wrapper's own level
            continue
        m = _FLAX_PART.fullmatch(p)
        if m is not None and m[1] == "layer" and prev_layer:
            # A residual block's own layer: cnn.{i}.net.{j} upstream.
            parts += ["net", m[2]]
        elif m is None:
            parts.append(p)
        elif m[1] == "layer":
            parts.append(m[2])
        elif m[1] == "cnn_":  # AcDiscriminator's Sequential(cnn, pool, fc)
            parts += ["cnn", m[2]]
        elif m[1] == "gconvs_":
            parts += ["gconvs", m[2]]
        elif m[1] == "refinement_modules_":
            parts += ["refinement_modules", m[2], "net"]
        else:
            parts += ["output_conv", m[2]]
        prev_layer = m is not None and m[1] == "layer"
    return ".".join(parts)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_jax(variables) -> dict[str, torch.Tensor]:
    """JAX variables {'params', 'batch_stats'} of the generator or of a
    discriminator -> the port's state dict (float32 CPU tensors).  Dense
    kernels (in, out) become Linear weights (out, in); conv kernels HWIO
    become OIHW."""
    state = {}
    for path, arr in _leaves(variables.get("params", {})):
        arr = np.asarray(arr, np.float32)
        base, leaf = _torch_prefix(path[:-1]), path[-1]
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf not in ("embedding", "scale", "bias"):
            raise ValueError(f"unknown parameter leaf {leaf!r} at {path}")
        name = "bias" if leaf == "bias" else "weight"
        state[f"{base}.{name}"] = torch.from_numpy(np.array(arr))
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _leaves(variables.get("batch_stats", {})):
        if path[-1] not in stat_names:
            raise ValueError(f"unknown statistics leaf {path[-1]!r} at {path}")
        state[f"{_torch_prefix(path[:-1])}.{stat_names[path[-1]]}"] = \
            torch.from_numpy(np.array(arr, np.float32))
    return state


def _field(node, name: str):
    """A field of a JAX TrainState or optax state, live (attributes and
    tuples) or as msgpack restores it (maps keyed by field name, tuples
    keyed '0', '1', ...)."""
    if isinstance(node, dict):
        return node[name]
    return node[int(name)] if name.isdigit() else getattr(node, name)


def _adam_from_jax(opt_state, device):
    """optax (ScaleByAdamState, EmptyState) -> the port's AdamState, the
    moments in the port's parameter layout."""
    from sg2im_tpu_torch.train.state import AdamState

    adam = _field(opt_state, "0")

    def moments(tree):
        return {k: v.to(device) for k, v in
                state_dict_from_jax({"params": tree}).items()}

    return AdamState(
        count=torch.tensor(int(np.asarray(_field(adam, "count"))),
                           dtype=torch.int32, device=device),
        mu=moments(_field(adam, "mu")), nu=moments(_field(adam, "nu")))


def train_state_from_jax(state, device="cpu"):
    """A JAX ``TrainState`` -> the port's ``TrainState`` on ``device``: the
    step, the threefry key, the three models' parameters and BatchNorm
    statistics and each optimizer's count and moments.  ``state`` is the
    JAX package's object (leaves numpy or JAX arrays) or the map the JAX
    store's ``state.msgpack`` holds (``ckpt.msgpack.msgpack_restore``), nil
    for a discriminator that is off.

    The key crosses unchanged: the port splits and draws as the JAX
    package does (``ops.prng``), so a run resumed here continues the JAX
    run's noise stream."""
    from sg2im_tpu_torch.train.state import TrainState

    device = torch.device(device)
    key = np.asarray(_field(state, "rng"))
    if key.shape != (2,):
        raise ValueError(f"a JAX PRNG key has shape (2,), not {key.shape}")

    def sd(variables):
        return {k: v.to(device) for k, v in
                state_dict_from_jax(variables).items()}

    fields = {"step": torch.tensor(int(np.asarray(_field(state, "step"))),
                                   dtype=torch.int32, device=device),
              "rng": torch.from_numpy(key.astype(np.uint32)).to(device),
              "g": sd(_field(state, "g_vars")),
              "g_opt": _adam_from_jax(_field(state, "g_opt"), device)}
    for name in ("d_obj", "d_img"):
        if _field(state, name + "_vars") is not None:
            fields[name] = sd(_field(state, name + "_vars"))
            fields[name + "_opt"] = _adam_from_jax(
                _field(state, name + "_opt"), device)
    return TrainState(**fields)


# The JAX package's module paths for upstream's names: a copy of the path
# mappers of sg2im_tpu/ckpt/torch_convert.py (:99, :129, :140), which the
# port does not import.  Each takes a name's parts without its leaf and
# gives the flax path, or None for a name the JAX models do not hold.

def _generator_path(parts):
    head = parts[0]
    if head in ("obj_embeddings", "pred_embeddings"):
        return [head]
    if head == "gconv":
        if len(parts) == 1:  # nn.Linear (gconv_num_layers == 0)
            return ["gconv"]
        return ["gconv", parts[1], f"layer{parts[2]}"]
    if head == "gconv_net":  # gconv_net.gconvs.{k}.net{1,2}.{i}
        _, _, k, net, i = parts
        return ["gconv_net", f"gconvs_{k}", net, f"layer{i}"]
    if head in ("box_net", "rel_aux_net", "mask_net"):
        return [head, f"layer{parts[1]}"]
    if head == "refinement_net":
        if parts[1] == "refinement_modules":  # ...{k}.net.{i}
            _, _, k, _, i = parts
            return ["refinement_net", f"refinement_modules_{k}", f"layer{i}"]
        if parts[1] == "output_conv":
            return ["refinement_net", f"output_conv_{parts[2]}"]
    raise ValueError(f"unmapped generator name: {'.'.join(parts)}")


def _patch_d_path(parts):
    if parts[0] == "classifier":  # upstream's unused head
        return None
    if parts[0] == "cnn":
        if len(parts) >= 4 and parts[2] == "net":  # a residual block
            return ["cnn", f"layer{parts[1]}", f"layer{parts[3]}"]
        return ["cnn", f"layer{parts[1]}"]
    raise ValueError(f"unmapped PatchDiscriminator name: {'.'.join(parts)}")


def _ac_d_path(parts):
    rest = parts[1:]  # discriminator.{cnn.0.{i} | cnn.2 | *_classifier}
    if parts[0] == "discriminator" and rest[0] == "cnn":
        if rest[1] == "0":
            if len(rest) >= 5 and rest[3] == "net":  # a residual block
                return ["discriminator", "cnn_0", f"layer{rest[2]}",
                        f"layer{rest[4]}"]
            return ["discriminator", "cnn_0", f"layer{rest[2]}"]
        if rest[1] == "2":
            return ["discriminator", "cnn_2"]
    if parts[0] == "discriminator" and rest[0] in ("real_classifier",
                                                   "obj_classifier"):
        return ["discriminator", rest[0]]
    raise ValueError(f"unmapped AcCropDiscriminator name: {'.'.join(parts)}")


_JAX_PATHS = {"g": _generator_path, "d_obj": _ac_d_path,
              "d_img": _patch_d_path}


def _put(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def variables_to_jax(state_dict, model: str, context=None) -> dict:
    """Upstream-named tensors -> flax ``{'params', 'batch_stats'}`` of
    float32 numpy arrays (``state_dict_from_jax``'s inverse; the JAX
    package's ``convert_state_dict``): Linear weights (out, in) become
    kernels (in, out), conv weights OIHW become HWIO, a BatchNorm's weight
    and bias go under its ``bn/scale`` and ``bn/bias`` and its running
    statistics into ``batch_stats``.  ``model``: 'g', 'd_obj' or 'd_img';
    ``context`` (default ``state_dict``), the model's whole state dict,
    tells a BatchNorm's weight by its running mean where ``state_dict``
    holds parameters alone (Adam's moments)."""
    path_of = _JAX_PATHS[model]
    context = state_dict if context is None else context
    params: dict = {}
    stats: dict = {}
    for key, t in state_dict.items():
        *parts, leaf = key.split(".")
        path = path_of(parts)
        if path is None or leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu().numpy().astype(np.float32, copy=False)
        if len(path) == 1 and path[0] in ("obj_embeddings",
                                          "pred_embeddings"):
            _put(params, path + ["embedding"], arr)
        elif leaf in ("running_mean", "running_var"):
            _put(stats, path + ["bn", leaf[len("running_"):]], arr)
        elif f"{'.'.join(parts)}.running_mean" in context:
            _put(params, path + ["bn", "scale" if leaf == "weight"
                                 else "bias"], arr)
        elif leaf == "weight":
            _put(params, path + ["kernel"], np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T))
        elif leaf == "bias":
            _put(params, path + ["bias"], arr)
        else:
            raise ValueError(f"unknown leaf {leaf!r} of {key}")
    return {"params": params, "batch_stats": stats} if stats \
        else {"params": params}


def jax_tree_from_train_state(state) -> dict:
    """The port's ``TrainState`` -> the JAX package's ``TrainState`` as the
    JAX store's ``state.msgpack`` holds it (:func:`train_state_from_jax`'s
    inverse), numpy arrays on the host: ``step``, ``rng``, each model's
    ``*_vars`` and its optax state ``{'0': {count, mu, nu}, '1': {}}``, nil
    for a discriminator that is off.  The keys are those of the JAX
    ``Trainer.init_state`` for the same config, as ``flax.serialization.
    from_bytes`` wants.  ``rng`` is the state's threefry key as it is."""
    tree = {"step": np.asarray(int(state.step), np.int32),
            "rng": state.rng.detach().cpu().numpy().astype(np.uint32)}
    for name in ("g", "d_obj", "d_img"):
        sd, opt = getattr(state, name), getattr(state, name + "_opt")
        vars_name = "g_vars" if name == "g" else name + "_vars"
        if sd is None:
            tree[vars_name] = tree[name + "_opt"] = None
            continue
        tree[vars_name] = variables_to_jax(sd, name)
        tree[name + "_opt"] = {"0": {
            "count": np.asarray(int(opt.count), np.int32),
            "mu": variables_to_jax(opt.mu, name, sd)["params"],
            "nu": variables_to_jax(opt.nu, name, sd)["params"]},
            "1": {}}
    return tree


def calibration_from_jax(quant_collection) -> dict[str, float]:
    """The JAX engine's int8 scales (``variables['quant']``, a nested dict
    of float32 scalars) -> the port's {tag: float}, tags joined with '/'
    as in the calibration files; install with
    ``InferenceEngine.set_calibration``."""
    return {"/".join(path): float(np.float32(np.asarray(v)))
            for path, v in _leaves(quant_collection)}


def clean_model_kwargs(model_kwargs) -> tuple[dict, dict | None]:
    """Drop deprecated kwargs, split out the vocab, make sizes tuples."""
    kw = dict(model_kwargs)
    for k in DEPRECATED_MODEL_KWARGS:
        kw.pop(k, None)
    vocab = kw.pop("vocab", None)
    for k in ("image_size", "refinement_dims"):
        if k in kw:
            kw[k] = tuple(kw[k])
    return kw, vocab


def _strip_module(state: dict) -> dict:
    """Remove DataParallel's ``module.`` prefixes."""
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def load_reference_checkpoint(path) -> tuple[dict, dict, dict]:
    """Load a reference-layout ``.pt`` (full or stripped) on the CPU.

    Returns (vocab, model_kwargs, state_dict), with DataParallel
    ``module.`` prefixes removed from the state dict.  Only tensors and
    plain containers are unpickled (``weights_only=True``).
    """
    bundle = load_reference_bundle(path)
    return bundle["vocab"], bundle["model_kwargs"], bundle["generator"]


def load_reference_bundle(path) -> dict:
    """Everything a warm start takes from a reference-layout ``.pt`` (the
    counterpart of the JAX package's ``convert_checkpoint``): a dict of
    ``model_kwargs`` (vocab removed), ``vocab``, ``generator`` (the state
    dict), ``d_obj`` / ``d_img`` (the discriminators' state dicts, or None
    when the file has none) with ``d_obj_kwargs`` / ``d_img_kwargs``, and
    the training ``args``.  The port's modules keep upstream's names, so
    each state dict loads as it is."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    kwargs, vocab = clean_model_kwargs(ckpt["model_kwargs"])
    if vocab is None:
        vocab = ckpt.get("vocab")
    if vocab is None:
        raise ValueError(f"{path}: no vocab in model_kwargs or checkpoint")
    out = {"model_kwargs": kwargs, "vocab": vocab,
           "generator": _strip_module(ckpt["model_state"]),
           "args": ckpt.get("args")}
    for name in ("d_obj", "d_img"):
        sd = ckpt.get(name + "_state")
        out[name] = _strip_module(sd) if sd else None
        dk = dict(ckpt.get(name + "_kwargs") or {}) if sd else None
        if dk is not None:
            dk.pop("vocab", None)
        out[name + "_kwargs"] = dk
    return out


def export_reference_checkpoint(path, generator_state: dict, model_kwargs,
                                vocab, args=None):
    """Write the generator as a reference-layout ``.pt`` (``model_state``,
    ``model_kwargs`` with the vocab, ``args``), which upstream's
    ``Sg2ImModel(**model_kwargs).load_state_dict(model_state)`` and the
    JAX package's ``convert_checkpoint`` read (the JAX package's
    ``export_torch_checkpoint``).  The port-only kwargs ``compute_dtype``
    and ``crn_mode`` are left out."""
    kw = dict(model_kwargs, vocab=vocab)
    kw.pop("compute_dtype", None)
    kw.pop("crn_mode", None)
    torch.save({"model_state": {k: v.detach().to("cpu", copy=True)
                                for k, v in generator_state.items()},
                "model_kwargs": kw, "args": dict(args or {})}, path)
    return path
