"""Weights into the port: reference ``.pt`` checkpoints and JAX variables.

The port's modules keep upstream's parameter names, so a reference
checkpoint's ``model_state`` loads with ``load_state_dict(strict=True)`` as
it is.  ``state_dict_from_jax`` maps the JAX package's flax variable trees
(numpy or JAX arrays) onto the same names, the inverse of the JAX
package's own converter (``sg2im_tpu/ckpt/torch_convert.py``), for the
generator and both discriminators; ``train_state_from_jax`` carries a whole
JAX ``TrainState`` across, optimizer moments included;
``calibration_from_jax`` carries the int8 tier's activation scales across.
``load_reference_bundle`` reads a warm start (the generator and both
discriminators), ``export_reference_checkpoint`` writes the generator back
in the reference layout; ``store`` saves and resumes the port's own train
state.
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
