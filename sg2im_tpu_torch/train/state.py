"""Train state: every learnable tensor of the GAN triple (G, D_obj, D_img)
and of its three optimizers (counterpart of ``sg2im_tpu/train/state.py``).

The modules of a :class:`~sg2im_tpu_torch.train.trainer.Trainer` are
templates: a step runs them with ``torch.func.functional_call`` on the
tensors held here, so a state is data that can be saved, loaded, copied or
carried across from the JAX package (``ckpt.train_state_from_jax``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count (int32, 0-dim) and the
    first and second moments, keyed by parameter name."""

    count: torch.Tensor
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """``step`` (int32, 0-dim, on the device) counts iterations, skipped
    ones included (upstream's ``t``); ``rng`` is the JAX package's
    threefry key (uint32 (2,), on the device), which every step splits
    into its successor and the key of its layout noise (``ops.prng``);
    ``g``, ``d_obj``, ``d_img`` are the modules' state dicts (parameters
    and BatchNorm buffers)."""

    step: torch.Tensor
    rng: torch.Tensor
    g: dict[str, torch.Tensor]
    g_opt: AdamState
    d_obj: dict[str, torch.Tensor] | None = None
    d_obj_opt: AdamState | None = None
    d_img: dict[str, torch.Tensor] | None = None
    d_img_opt: AdamState | None = None

    def replace(self, **fields) -> "TrainState":
        return dataclasses.replace(self, **fields)


def tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """Every tensor of ``state`` under a flat dotted name (``g.<param>``,
    ``g_opt.mu.<param>``, ...), the layout a checkpoint stores."""
    out = {"step": state.step, "rng": state.rng}
    for model in ("g", "d_obj", "d_img"):
        sd, opt = getattr(state, model), getattr(state, model + "_opt")
        if sd is None:
            continue
        out.update({f"{model}.{k}": v for k, v in sd.items()})
        out[f"{model}_opt.count"] = opt.count
        out.update({f"{model}_opt.mu.{k}": v for k, v in opt.mu.items()})
        out.update({f"{model}_opt.nu.{k}": v for k, v in opt.nu.items()})
    return out


def from_tensors(flat: dict[str, torch.Tensor]) -> TrainState:
    """Inverse of :func:`tensors`."""
    fields: dict = {"step": flat["step"], "rng": flat["rng"]}
    for model in ("g", "d_obj", "d_img"):
        pre = model + "."
        sd = {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}
        if not sd:
            continue
        opt = model + "_opt."
        fields[model] = sd
        fields[model + "_opt"] = AdamState(
            count=flat[opt + "count"],
            mu={k[len(opt) + 3:]: v for k, v in flat.items()
                if k.startswith(opt + "mu.")},
            nu={k[len(opt) + 3:]: v for k, v in flat.items()
                if k.startswith(opt + "nu.")})
    return TrainState(**fields)

