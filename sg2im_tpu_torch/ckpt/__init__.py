"""Weights into the port: reference ``.pt`` checkpoints and JAX variables.

The port's modules keep upstream's parameter names, so a reference
checkpoint's ``model_state`` loads with ``load_state_dict(strict=True)`` as
it is.  ``state_dict_from_jax`` maps the JAX package's flax variable trees
(numpy or JAX arrays) onto the same names, the inverse of the JAX
package's own converter (``sg2im_tpu/ckpt/torch_convert.py``), for the
generator and both discriminators; ``train_state_from_jax`` carries a whole
JAX ``TrainState`` across, optimizer moments included;
``calibration_from_jax`` carries the int8 tier's activation scales across.
``store`` saves and resumes the port's own train state.
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


def _adam_from_jax(opt_state, device):
    """optax (ScaleByAdamState, EmptyState) -> the port's AdamState, the
    moments in the port's parameter layout."""
    from sg2im_tpu_torch.train.state import AdamState

    adam = opt_state[0]

    def moments(tree):
        return {k: v.to(device) for k, v in
                state_dict_from_jax({"params": tree}).items()}

    return AdamState(
        count=torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                           device=device),
        mu=moments(adam.mu), nu=moments(adam.nu))


def train_state_from_jax(state, device="cpu", noise_seed: int = 0):
    """A JAX ``TrainState`` (the JAX package's; leaves numpy or JAX arrays)
    -> the port's ``TrainState`` on ``device``: the step, the three
    models' parameters and BatchNorm statistics and each optimizer's
    count and moments.  JAX's PRNG key has no counterpart: the layout-noise
    generator starts from ``noise_seed`` (a step fed its noise explicitly
    never reads it)."""
    from sg2im_tpu_torch.train.state import TrainState

    device = torch.device(device)

    def sd(variables):
        return {k: v.to(device) for k, v in
                state_dict_from_jax(variables).items()}

    fields = {"step": torch.tensor(int(np.asarray(state.step)),
                                   dtype=torch.int32, device=device),
              "noise_rng": torch.Generator(device=device).manual_seed(
                  noise_seed).get_state(),
              "g": sd(state.g_vars), "g_opt": _adam_from_jax(state.g_opt,
                                                             device)}
    for name in ("d_obj", "d_img"):
        if getattr(state, name + "_vars") is not None:
            fields[name] = sd(getattr(state, name + "_vars"))
            fields[name + "_opt"] = _adam_from_jax(
                getattr(state, name + "_opt"), device)
    return TrainState(**fields)


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


def load_reference_checkpoint(path) -> tuple[dict, dict, dict]:
    """Load a reference-layout ``.pt`` (full or stripped) on the CPU.

    Returns (vocab, model_kwargs, state_dict), with DataParallel
    ``module.`` prefixes removed from the state dict.  Only tensors and
    plain containers are unpickled (``weights_only=True``).
    """
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    kwargs, vocab = clean_model_kwargs(ckpt["model_kwargs"])
    if vocab is None:
        vocab = ckpt.get("vocab")
    if vocab is None:
        raise ValueError(f"{path}: no vocab in model_kwargs or checkpoint")
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in ckpt["model_state"].items()}
    return vocab, kwargs, state
