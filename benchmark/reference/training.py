"""sg2im's GAN training step in plain PyTorch, float32: the two
discriminators, the losses and Adam (``scripts/train.py``,
``sg2im/discriminators.py``, ``sg2im/losses.py``, ``sg2im/bilinear.py``).

One step: the generator in train mode composes the layout from the
ground-truth boxes and masks; its loss is the L1 pixel loss, the box MSE
and, through both discriminators (their weights held fixed), the
auxiliary-classifier loss and the two GAN generator losses; Adam on the
generator.  Then each discriminator scores the step's fakes and the real
images, and takes its own Adam step.  Every BatchNorm runs in train mode,
so running statistics never reach an output within a step.  Random
numbers are jax.random's: each step splits the key into the next key and
the key of its layout noise.  The discriminators' CNNs are upstream
``build_cnn`` arch strings of 'C<k>-<c>-<s>' layers with 'valid' padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import generator as gen
from benchmark.reference import threefry


def _arch(arch: str, c_in: int = 3):
    """[(kernel, in, out, stride)] of an arch string's conv layers."""
    layers = []
    for s in arch.split(","):
        k, c, *stride = (int(v) for v in s[1:].split("-"))
        layers.append((k, c_in, c, stride[0] if stride else 1))
        c_in = c
    return layers


def d_obj_spec(cfg) -> list[tuple[str, tuple, str]]:
    """The object discriminator's tensors, upstream's names."""
    out = []
    idx = 0
    layers = _arch(cfg["train"]["d_obj_arch"])
    pre = "discriminator.cnn.0"
    for i, (k, ci, co, _) in enumerate(layers):
        if i:
            out += [(f"{pre}.{idx}.{n}", (ci,), f"bn_{v}") for n, v in (
                ("weight", "weight"), ("bias", "bias"),
                ("running_mean", "mean"), ("running_var", "var"))]
            idx += 2
        out += [(f"{pre}.{idx}.weight", (co, ci, k, k), "weight"),
                (f"{pre}.{idx}.bias", (co,), "bias")]
        idx += 1
    c = layers[-1][2]
    out += [("discriminator.cnn.2.weight", (1024, c), "weight"),
            ("discriminator.cnn.2.bias", (1024,), "bias"),
            ("discriminator.real_classifier.weight", (1, 1024), "weight"),
            ("discriminator.real_classifier.bias", (1,), "bias"),
            ("discriminator.obj_classifier.weight",
             (cfg["num_objects"], 1024), "weight"),
            ("discriminator.obj_classifier.bias", (cfg["num_objects"],),
             "bias")]
    return out


def d_img_spec(cfg) -> list[tuple[str, tuple, str]]:
    """The patch discriminator's tensors, upstream's names."""
    out = []
    idx = 0
    for i, (k, ci, co, _) in enumerate(_arch(cfg["train"]["d_img_arch"])):
        if i:
            out += [(f"cnn.{idx}.{n}", (ci,), f"bn_{v}") for n, v in (
                ("weight", "weight"), ("bias", "bias"),
                ("running_mean", "mean"), ("running_var", "var"))]
            idx += 2
        out += [(f"cnn.{idx}.weight", (co, ci, k, k), "weight"),
                (f"cnn.{idx}.bias", (co,), "bias")]
        idx += 1
    return out


def cnn(W, prefix, arch, x, mask=None):
    """An arch-string CNN in train mode: a conv, then for each further conv
    a BatchNorm (over the rows ``mask`` marks) and a LeakyReLU before it."""
    idx = 0
    for i, (_, _, _, stride) in enumerate(_arch(arch)):
        if i:
            x = gen.batch_norm(x, W, f"{prefix}{idx}", True, mask)
            x = F.leaky_relu(x, gen.LEAKY)
            idx += 2
        x = F.conv2d(x, W[f"{prefix}{idx}.weight"], W[f"{prefix}{idx}.bias"],
                     stride=stride)
        idx += 1
    return x


def crops(imgs, boxes, size):
    """Each box [x0, y0, x1, y1] of each image bilinearly cropped to size x
    size (grid_sample, align_corners=True, zeros outside) -> (N * O, C,
    size, size)."""
    N, O = boxes.shape[:2]
    t = torch.linspace(0.0, 1.0, size, device=imgs.device)
    x0, y0, x1, y1 = (v[..., None] for v in boxes.unbind(-1))
    gx = 2.0 * (x0 + (x1 - x0) * t) - 1.0
    gy = 2.0 * (y0 + (y1 - y0) * t) - 1.0
    grid = torch.stack([gx[:, :, None, :].expand(N, O, size, size),
                        gy[:, :, :, None].expand(N, O, size, size)], dim=-1)
    src = imgs.repeat_interleave(O, dim=0)
    return F.grid_sample(src, grid.reshape(N * O, size, size, 2),
                         mode="bilinear", padding_mode="zeros",
                         align_corners=True)


def d_obj(W, cfg, imgs, boxes, obj_mask):
    """The object discriminator -> (real/fake scores (N, O), object logits
    (N, O, num_objects))."""
    N, O = boxes.shape[:2]
    x = crops(imgs, boxes, cfg["train"]["crop_size"])
    x = cnn(W, "discriminator.cnn.0.", cfg["train"]["d_obj_arch"], x,
            obj_mask.reshape(-1))
    v = F.linear(x.mean(dim=(2, 3)), W["discriminator.cnn.2.weight"],
                 W["discriminator.cnn.2.bias"])
    real = F.linear(v, W["discriminator.real_classifier.weight"],
                    W["discriminator.real_classifier.bias"])
    logits = F.linear(v, W["discriminator.obj_classifier.weight"],
                      W["discriminator.obj_classifier.bias"])
    return real.reshape(N, O), logits.reshape(N, O, -1)


def d_img(W, cfg, imgs):
    return cnn(W, "cnn.", cfg["train"]["d_img_arch"], imgs)


def masked_mean(x, mask=None):
    if mask is None:
        return x.mean()
    m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim)).expand(
        x.shape).to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def bce(scores, target: float, mask=None):
    return masked_mean(F.binary_cross_entropy_with_logits(
        scores, torch.full_like(scores, target), reduction="none"), mask)


def cross_entropy(logits, labels, mask):
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          (labels * (mask > 0)).reshape(-1),
                          reduction="none").reshape(labels.shape)
    return masked_mean(nll, mask)


def g_losses(Wg, Wdo, Wdi, cfg, b, noise, sections=None):
    """The generator's losses on batch ``b`` -> (total, imgs)."""
    t = cfg["train"]
    imgs, boxes, _, _ = gen.forward(
        Wg, cfg, b["objs"], b["triples"], b["obj_mask"], b["triple_mask"],
        noise, train=True, boxes_gt=b["boxes"], masks_gt=b["masks"],
        sections=sections)
    om = b["obj_mask"]
    total = (imgs - b["imgs"]).abs().mean() * t["l1_pixel_loss_weight"]
    total = total + masked_mean((boxes - b["boxes"]) ** 2, om) \
        * t["bbox_pred_loss_weight"]
    scores, logits = d_obj(Wdo, cfg, imgs, b["boxes"], om)
    total = total + cross_entropy(logits, b["objs"], om) * t["ac_loss_weight"]
    w = t["discriminator_loss_weight"]
    total = total + bce(scores, 1.0, om) * w * t["d_obj_weight"]
    total = total + bce(d_img(Wdi, cfg, imgs), 1.0) * w * t["d_img_weight"]
    return total, imgs


def d_obj_loss(W, cfg, fake, b):
    om = b["obj_mask"]
    s_fake, l_fake = d_obj(W, cfg, fake, b["boxes"], om)
    s_real, l_real = d_obj(W, cfg, b["imgs"], b["boxes"], om)
    return (bce(s_real, 1.0, om) + bce(s_fake, 0.0, om)
            + cross_entropy(l_real, b["objs"], om)
            + cross_entropy(l_fake, b["objs"], om))


def d_img_loss(W, cfg, fake, b):
    return (bce(d_img(W, cfg, b["imgs"]), 1.0)
            + bce(d_img(W, cfg, fake), 0.0))


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with bias correction; parameters
    the loss does not reach get a zero gradient."""

    def __init__(self, lr, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t, self.m, self.v = 0, {}, {}

    def step(self, params: dict, grads: dict) -> dict:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = self.m.get(k, torch.zeros_like(p)) * self.b1 \
                + g * (1.0 - self.b1)
            v = self.v.get(k, torch.zeros_like(p)) * self.b2 \
                + g * g * (1.0 - self.b2)
            self.m[k], self.v[k] = m, v
            out[k] = p - self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps)
        return out


def _grads(total, params: dict) -> dict:
    gs = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), gs)}


def is_param(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def train_steps(weights: dict, cfg, batches, key, steps: int):
    """``steps`` GAN steps from ``weights`` ({'g', 'd_obj', 'd_img'}: flat
    dicts) on ``batches`` in order, the layout noise drawn from ``key``.

    Returns {'losses': [(G total, D_obj total, D_img total)] a step,
    'grads': {model: {name: first step's gradient}}, 'params': {model:
    {name: parameters after the last step}}}."""
    lr = cfg["train"]["learning_rate"]
    params = {m: {k: v.detach().clone() for k, v in w.items() if is_param(k)}
              for m, w in weights.items()}
    bufs = {m: {k: v for k, v in w.items() if not is_param(k)}
            for m, w in weights.items()}
    opts = {m: Adam(lr) for m in weights}
    H, W = cfg["model"]["image_size"]
    D = cfg["model"]["layout_noise_dim"]
    out = {"losses": [], "grads": {}}
    for i in range(steps):
        b = batches[i]
        key, noise_key = threefry.split(key)
        noise = threefry.layout_noise(noise_key, b["imgs"].shape[0], D, H, W,
                                      b["imgs"].device)
        leaves = {k: v.requires_grad_(True) for k, v in params["g"].items()}
        total, imgs = g_losses({**leaves, **bufs["g"]},
                               {**params["d_obj"], **bufs["d_obj"]},
                               {**params["d_img"], **bufs["d_img"]},
                               cfg, b, noise)
        step_grads = {"g": _grads(total, leaves)}
        fake = imgs.detach()
        losses = [total.detach()]
        for m, loss_fn in (("d_obj", d_obj_loss), ("d_img", d_img_loss)):
            d_leaves = {k: v.detach().requires_grad_(True)
                        for k, v in params[m].items()}
            d_total = loss_fn({**d_leaves, **bufs[m]}, cfg, fake, b)
            step_grads[m] = _grads(d_total, d_leaves)
            losses.append(d_total.detach())
        for m in params:
            params[m] = {k: v.detach() for k, v in opts[m].step(
                params[m], step_grads[m]).items()}
        out["losses"].append(tuple(float(v) for v in losses))
        if i == 0:
            out["grads"] = step_grads
    out["params"] = params
    return out
