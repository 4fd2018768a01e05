"""The sg2im generator (Johnson et al., CVPR 2018) in plain PyTorch, float32.

Written from the published model (``sg2im/model.py``, ``graph.py``,
``layout.py``, ``crn.py``, ``layers.py`` of google/sg2im), over padded
per-image graph batches: objs (N, O), triples (N, T, 3) whose subject and
object index the image's own object slots, obj_mask (N, O) and
triple_mask (N, T) marking the real slots.  Parameters are a flat dict
under upstream's state-dict names (:func:`spec` lists them), so the same
weights load into any implementation that keeps those names.

Departures from the published code, each one the port's documented behaviour:
a box of zero width or height composes nothing (its warp coordinates are
not finite and are dropped); the layout is ``sum`` pooled over the real
objects; BatchNorm in train mode takes its statistics over the real slots
only (``mask``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

LEAKY = 0.2  # 'leakyrelu-0.2', the configurations' activation


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 matmuls and convolutions as float32 (TF32 off, the
    reference's precision) or, with ``tf32``, rounded to TF32 on the card;
    the process's settings are restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _stages(cfg) -> list[tuple[int, int]]:
    """(input channels, output channels) of each CRN stage."""
    dims = list(cfg["model"]["refinement_dims"])
    return [(1 if i == 0 else dims[i - 1], d) for i, d in enumerate(dims)]


def spec(cfg) -> list[tuple[str, tuple, str]]:
    """Every generator tensor: (name, shape, kind).  kind says how the
    benchmark draws it: 'embed', 'weight' (fan-in scaled), 'bias', 'box'
    and 'box_bias' (the box head's last layer), 'bn_weight', 'bn_bias',
    'bn_mean', 'bn_var'."""
    m = cfg["model"]
    E, G, Hd = m["embedding_dim"], m["gconv_dim"], m["gconv_hidden_dim"]
    out = [("obj_embeddings.weight", (cfg["num_objects"] + 1, E), "embed"),
           ("pred_embeddings.weight", (cfg["num_predicates"], E), "embed")]

    def linear(name, din, dout, kind="weight", bias="bias"):
        out.extend([(f"{name}.weight", (dout, din), kind),
                    (f"{name}.bias", (dout,), bias)])

    def bn(name, c):
        out.extend([(f"{name}.{k}", (c,), f"bn_{v}") for k, v in (
            ("weight", "weight"), ("bias", "bias"),
            ("running_mean", "mean"), ("running_var", "var"))])

    def conv(name, co, ci, k):
        out.extend([(f"{name}.weight", (co, ci, k, k), "weight"),
                    (f"{name}.bias", (co,), "bias")])

    for i in range(m["gconv_num_layers"]):
        name = "gconv" if i == 0 else f"gconv_net.gconvs.{i - 1}"
        din = E if i == 0 else G
        linear(f"{name}.net1.0", 3 * din, Hd)
        linear(f"{name}.net1.2", Hd, 2 * Hd + G)
        linear(f"{name}.net2.0", Hd, Hd)
        linear(f"{name}.net2.2", Hd, G)
    linear("box_net.0", G, Hd)
    linear("box_net.2", Hd, 4, kind="box", bias="box_bias")
    steps = int(math.log2(m["mask_size"]))
    for k in range(steps):
        bn(f"mask_net.{4 * k + 1}", G)
        conv(f"mask_net.{4 * k + 2}", G, G, 3)
    conv(f"mask_net.{4 * steps}", 1, G, 1)
    linear("rel_aux_net.0", 2 * E + 8, Hd)
    linear("rel_aux_net.2", Hd, cfg["num_predicates"])
    layout_dim = G + m["layout_noise_dim"]
    for i, (ci, co) in enumerate(_stages(cfg)):
        name = f"refinement_net.refinement_modules.{i}.net"
        conv(f"{name}.0", co, layout_dim + ci, 3)
        bn(f"{name}.1", co)
        conv(f"{name}.3", co, co, 3)
        bn(f"{name}.4", co)
    c = m["refinement_dims"][-1]
    conv("refinement_net.output_conv.0", c, c, 3)
    conv("refinement_net.output_conv.2", 3, c, 1)
    return out


def batch_norm(x, W, name, train, mask=None, eps=1e-5):
    """BatchNorm2d over NCHW: running statistics in eval mode; in train
    mode the batch's mean and biased variance over the rows whose ``mask``
    (N,) is 1."""
    w, b = W[f"{name}.weight"], W[f"{name}.bias"]
    if not train:
        mean, var = W[f"{name}.running_mean"], W[f"{name}.running_var"]
    else:
        wt = (torch.ones(x.shape[0], device=x.device) if mask is None
              else mask.to(x.dtype))[:, None, None, None]
        n = (wt.sum() * x.shape[2] * x.shape[3]).clamp_min(1.0)
        mean = (x * wt).sum(dim=(0, 2, 3)) / n
        var = (((x - mean[None, :, None, None]) ** 2) * wt).sum(
            dim=(0, 2, 3)) / n
    inv = torch.rsqrt(var + eps)
    return ((x - mean[None, :, None, None]) * (inv * w)[None, :, None, None]
            + b[None, :, None, None])


def _linear(x, W, name):
    return F.linear(x, W[f"{name}.weight"], W[f"{name}.bias"])


def _mlp2(x, W, name):
    """Upstream build_mlp of two Linear layers, each followed by a ReLU."""
    return F.relu(_linear(F.relu(_linear(x, W, f"{name}.0")), W,
                          f"{name}.2"))


def graph_conv(W, name, obj_vecs, pred_vecs, s, o, triple_mask, hidden):
    """One graph convolution: each triple [s, p, o] through net1; the
    subject and object messages averaged onto their objects, through
    net2."""
    N, O, _ = obj_vecs.shape
    rows = torch.arange(N, device=obj_vecs.device)[:, None]
    t = _mlp2(torch.cat([obj_vecs[rows, s], pred_vecs, obj_vecs[rows, o]],
                        dim=-1), W, f"{name}.net1")
    dout = t.shape[-1] - 2 * hidden
    m = triple_mask[..., None]
    new_s, new_p = t[..., :hidden] * m, t[..., hidden:hidden + dout]
    new_o = t[..., hidden + dout:] * m
    flat_s, flat_o = (rows * O + s).reshape(-1), (rows * O + o).reshape(-1)
    pooled = torch.zeros(N * O, hidden, device=t.device)
    pooled = pooled.index_add(0, flat_s, new_s.reshape(-1, hidden))
    pooled = pooled.index_add(0, flat_o, new_o.reshape(-1, hidden))
    counts = torch.zeros(N * O, device=t.device)
    counts = counts.index_add(0, flat_s, triple_mask.reshape(-1))
    counts = counts.index_add(0, flat_o, triple_mask.reshape(-1))
    pooled = pooled / counts.clamp_min(1.0)[:, None]
    return _mlp2(pooled, W, f"{name}.net2").reshape(N, O, -1), new_p


def mask_head(W, cfg, obj_vecs, obj_mask, train):
    """Upsample, BatchNorm, 3x3 conv and ReLU per doubling, a 1x1 conv, a
    sigmoid: (N, O, M, M)."""
    N, O, G = obj_vecs.shape
    steps = int(math.log2(cfg["model"]["mask_size"]))
    x = obj_vecs.reshape(N * O, G, 1, 1)
    flat_mask = obj_mask.reshape(-1)
    for k in range(steps):
        x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = batch_norm(x, W, f"mask_net.{4 * k + 1}", train, flat_mask)
        x = F.relu(F.conv2d(x, W[f"mask_net.{4 * k + 2}.weight"],
                            W[f"mask_net.{4 * k + 2}.bias"], padding=1))
    x = F.conv2d(x, W[f"mask_net.{4 * steps}.weight"],
                 W[f"mask_net.{4 * steps}.bias"])
    M = x.shape[-1]
    return torch.sigmoid(x).reshape(N, O, M, M)


def masks_to_layout(vecs, boxes, masks, obj_mask, H, W):
    """Each object's mask bilinearly warped into its box [x0, y0, x1, y1]
    (grid_sample, align_corners=True, zeros outside), times its vector,
    summed over the real objects -> (N, D, H, W)."""
    N, O, D = vecs.shape
    M = masks.shape[-1]
    x0, y0, x1, y1 = boxes.unbind(-1)
    tx = torch.linspace(0.0, 1.0, W, device=vecs.device)
    ty = torch.linspace(0.0, 1.0, H, device=vecs.device)
    gx = 2.0 * (tx - x0[..., None]) / (x1 - x0)[..., None] - 1.0
    gy = 2.0 * (ty - y0[..., None]) / (y1 - y0)[..., None] - 1.0
    grid = torch.stack([gx[:, :, None, :].expand(N, O, H, W),
                        gy[:, :, :, None].expand(N, O, H, W)], dim=-1)
    finite = torch.isfinite(grid).all(-1)
    grid = torch.where(finite[..., None], grid, torch.zeros_like(grid))
    warp = F.grid_sample(masks.reshape(N * O, 1, M, M),
                         grid.reshape(N * O, H, W, 2), mode="bilinear",
                         padding_mode="zeros", align_corners=True)
    warp = warp.reshape(N, O, H, W) * finite * obj_mask[:, :, None, None]
    return torch.einsum("nohw,nod->ndhw", warp, vecs)


def refinement_net(W, cfg, layout, train):
    """The cascaded refinement network: per stage the features upsampled
    by 2 meet the layout average-pooled to that resolution, then two
    conv-BatchNorm-LeakyReLU blocks; a 3x3 conv, LeakyReLU and a 1x1 conv
    to RGB."""
    N, _, H, Wd = layout.shape
    stages = _stages(cfg)
    n = len(stages)
    feats = torch.zeros(N, 1, H >> n, Wd >> n, device=layout.device)
    for i in range(n):
        factor = 1 << (n - 1 - i)
        level = F.avg_pool2d(layout, factor) if factor > 1 else layout
        up = F.interpolate(feats, scale_factor=2, mode="nearest")
        name = f"refinement_net.refinement_modules.{i}.net"
        x = F.conv2d(torch.cat([level, up], dim=1), W[f"{name}.0.weight"],
                     W[f"{name}.0.bias"], padding=1)
        x = F.leaky_relu(batch_norm(x, W, f"{name}.1", train), LEAKY)
        x = F.conv2d(x, W[f"{name}.3.weight"], W[f"{name}.3.bias"],
                     padding=1)
        feats = F.leaky_relu(batch_norm(x, W, f"{name}.4", train), LEAKY)
    x = F.leaky_relu(F.conv2d(feats, W["refinement_net.output_conv.0.weight"],
                              W["refinement_net.output_conv.0.bias"],
                              padding=1), LEAKY)
    return F.conv2d(x, W["refinement_net.output_conv.2.weight"],
                    W["refinement_net.output_conv.2.bias"])


def encode(W, cfg, objs, triples, obj_mask, triple_mask):
    """Embeddings and the graph convolutions -> (obj_vecs, obj_vecs before
    the convolutions, subject slots, object slots)."""
    m = cfg["model"]
    s, p, o = triples.unbind(-1)
    obj_vecs = W["obj_embeddings.weight"][objs]
    orig = obj_vecs
    pred_vecs = W["pred_embeddings.weight"][p]
    for i in range(m["gconv_num_layers"]):
        name = "gconv" if i == 0 else f"gconv_net.gconvs.{i - 1}"
        obj_vecs, pred_vecs = graph_conv(W, name, obj_vecs, pred_vecs, s, o,
                                         triple_mask, m["gconv_hidden_dim"])
    return obj_vecs, orig, s, o


def heads(W, cfg, obj_vecs, orig, s, o, obj_mask, train):
    """The box head, the relation head and the mask head -> (boxes (N, O,
    4), rel_scores (N, T, num_predicates), masks (N, O, M, M))."""
    rows = torch.arange(obj_vecs.shape[0], device=obj_vecs.device)[:, None]
    boxes = _mlp2(obj_vecs, W, "box_net")
    rel = _mlp2(torch.cat([boxes[rows, s], boxes[rows, o], orig[rows, s],
                           orig[rows, o]], dim=-1), W, "rel_aux_net")
    return boxes, rel, mask_head(W, cfg, obj_vecs, obj_mask, train)


def forward(W, cfg, objs, triples, obj_mask, triple_mask, noise,
            train=False, boxes_gt=None, masks_gt=None, sections=None):
    """The generator -> (imgs (N, 3, H, W), boxes, masks, rel_scores).
    ``noise`` (N, layout_noise_dim, H, W); ``boxes_gt`` / ``masks_gt``
    compose the layout in their place (training).  ``sections``, if given,
    is a dict of context-manager factories by section name ('graph',
    'crn'), entered around each part (FLOP counting by type)."""
    def enter(name):
        return (sections[name]() if sections and name in sections
                else _nullcontext())

    H, Wd = cfg["model"]["image_size"]
    with enter("graph"):
        obj_vecs, orig, s, o = encode(W, cfg, objs, triples, obj_mask,
                                      triple_mask)
        boxes, rel, masks = heads(W, cfg, obj_vecs, orig, s, o, obj_mask,
                                  train)
        layout = masks_to_layout(
            obj_vecs, boxes if boxes_gt is None else boxes_gt,
            masks if masks_gt is None else masks_gt, obj_mask, H, Wd)
    with enter("crn"):
        imgs = refinement_net(W, cfg, torch.cat([layout, noise], dim=1),
                              train)
    return imgs, boxes, masks, rel


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def to_uint8(imgs: torch.Tensor) -> torch.Tensor:
    """sg2im's imagenet_deprocess_batch: (N, 3, H, W) normalised floats ->
    (N, H, W, 3) uint8, each image min-max rescaled, scaled by 255 and
    truncated."""
    x = imgs.permute(0, 2, 3, 1).float()
    x = (x * torch.tensor(IMAGENET_STD, device=x.device)
         + torch.tensor(IMAGENET_MEAN, device=x.device))
    flat = x.reshape(x.shape[0], -1)
    lo = flat.amin(dim=1)[:, None, None, None]
    hi = flat.amax(dim=1)[:, None, None, None]
    return ((x - lo) / (hi - lo) * 255.0).clamp(0, 255).to(torch.uint8)
