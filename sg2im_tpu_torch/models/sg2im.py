"""The sg2im generator: scene graph -> image, NCHW.

Counterpart of ``sg2im_tpu/models/sg2im.py`` (upstream ``Sg2ImModel``),
over padded per-image graph batches:

  objs (N, O) int         object category ids, padded slots 0
  triples (N, T, 3) int   [s, p, o], s and o index the image's object slots
  obj_mask (N, O)         1 for real objects
  triple_mask (N, T)      1 for real triples

Forward: embeddings -> GCN -> box / mask / relation heads -> layout compose
(the Hopper kernel for CUDA tensors) -> layout-noise concat -> CRN.
Parameter names are upstream's, so a reference ``model_state`` loads with
``load_state_dict(strict=True)``.
"""

from __future__ import annotations

import torch
from torch import nn

from sg2im_tpu_torch.nn.crn import CONV0_MODES, RefinementNetwork
from sg2im_tpu_torch.nn.graph import (
    GraphTripleConv,
    GraphTripleConvNet,
    gather_slots,
)
from sg2im_tpu_torch.nn import init
from sg2im_tpu_torch.nn.layers import (
    MLP,
    BatchNorm,
    run_masked,
)
from sg2im_tpu_torch.ops.layout import boxes_to_layout, masks_to_layout

CRN_MODES = CONV0_MODES + ("split_noise",)


class MaskNet(nn.Sequential):
    """Mask head (upstream ``_build_mask_net``): for each doubling step k,
    Upsample at 4k, BatchNorm at 4k+1, Conv3x3 at 4k+2 and a true ReLU at
    4k+3; a final Conv1x1 at 4 * steps.  Input (B, dim, 1, 1)."""

    def __init__(self, dim: int, mask_size: int):
        layers = []
        cur = 1
        while cur < mask_size:
            layers += [nn.Upsample(scale_factor=2, mode="nearest"),
                       BatchNorm(dim), nn.Conv2d(dim, dim, 3, padding=1),
                       nn.ReLU()]
            cur *= 2
        if cur != mask_size:
            raise ValueError("Mask size must be a power of 2")
        layers.append(nn.Conv2d(dim, 1, 1))
        super().__init__(*layers)

    def forward(self, x, sample_mask=None):
        """``sample_mask`` (B,): which rows count in the train-mode
        BatchNorm statistics (padded object slots do not)."""
        return run_masked(self, x, sample_mask)


class Sg2ImGenerator(nn.Module):
    """Generator (upstream ``Sg2ImModel``); constructor arguments mirror
    upstream's.  ``compute_dtype`` (None or torch.bfloat16) and
    ``crn_mode`` are the serving options of the JAX package; in bf16 only
    the CRN chain runs in bf16, while box geometry, the layout compose and
    the GCN / head Linear layers stay float32.  ``crn_mode`` is one of
    ``CRN_MODES``: the CRN's conv0 modes (see ``nn/crn.py``) and
    'split_noise', which is 'split' with the layout noise handed to the
    CRN apart from the layout.
    ``crn_quant='int8'`` is the turbo tier (see ``nn/crn.py``), with its
    band ``crn_quant_min_res`` / ``crn_quant_max_res`` and
    ``crn_quant_head``; its activation scales are
    ``refinement_net.act_scales``, outside the state dict."""

    def __init__(self, vocab, image_size=(64, 64), embedding_dim: int = 64,
                 gconv_dim: int = 128, gconv_hidden_dim: int = 512,
                 gconv_pooling: str = "avg", gconv_num_layers: int = 5,
                 refinement_dims=(1024, 512, 256, 128, 64),
                 normalization: str = "batch",
                 activation: str = "leakyrelu-0.2", mask_size=None,
                 mlp_normalization: str = "none", layout_noise_dim: int = 0,
                 compute_dtype=None, crn_mode: str = "legacy",
                 crn_quant=None, crn_quant_head: bool = True,
                 crn_quant_min_res: int = 32,
                 crn_quant_max_res: int = 1 << 30):
        super().__init__()
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None, float32 or "
                             f"bfloat16, got {compute_dtype}")
        self.vocab = vocab
        self.image_size = tuple(image_size)
        self.gconv_num_layers = gconv_num_layers
        self.mask_size = mask_size
        self.layout_noise_dim = layout_noise_dim
        self.compute_dtype = (None if compute_dtype == torch.float32
                              else compute_dtype)
        num_objs = len(vocab["object_idx_to_name"])
        num_preds = len(vocab["pred_idx_to_name"])

        self.obj_embeddings = nn.Embedding(num_objs + 1, embedding_dim)
        self.pred_embeddings = nn.Embedding(num_preds, embedding_dim)
        if gconv_num_layers == 0:
            self.gconv = nn.Linear(embedding_dim, gconv_dim)
        else:
            self.gconv = GraphTripleConv(
                embedding_dim, output_dim=gconv_dim,
                hidden_dim=gconv_hidden_dim, pooling=gconv_pooling,
                mlp_normalization=mlp_normalization)
        if gconv_num_layers > 1:
            self.gconv_net = GraphTripleConvNet(
                gconv_dim, num_layers=gconv_num_layers - 1,
                hidden_dim=gconv_hidden_dim, pooling=gconv_pooling,
                mlp_normalization=mlp_normalization)
        self.box_net = MLP((gconv_dim, gconv_hidden_dim, 4),
                           batch_norm=mlp_normalization)
        if mask_size is not None and mask_size > 0:
            self.mask_net = MaskNet(gconv_dim, mask_size)
        self.rel_aux_net = MLP(
            (2 * embedding_dim + 8, gconv_hidden_dim, num_preds),
            batch_norm=mlp_normalization)
        if crn_mode not in CRN_MODES:
            raise ValueError(f"unknown crn_mode {crn_mode!r}; one of "
                             f"{CRN_MODES}")
        self.crn_mode = crn_mode
        self.refinement_net = RefinementNetwork(
            (gconv_dim + layout_noise_dim,) + tuple(refinement_dims),
            normalization=normalization, activation=activation,
            conv0_mode="split" if crn_mode == "split_noise" else crn_mode,
            quant=crn_quant, quant_head=crn_quant_head,
            quant_min_res=crn_quant_min_res, quant_max_res=crn_quant_max_res)

    def reset_parameters(self, key) -> None:
        """The JAX package's init for ``key`` (a threefry key, e.g.
        ``ops.prng.prng_key(seed)``): the weights flax's
        ``Sg2ImGenerator.init({'params': key}, ...)`` gives, in every
        ``crn_mode``, drawn where the parameters lie (``nn/init.py``)."""
        init.reset_parameters(self, "g", key)

    # The forward's sections, in order (tools/roofline.py times each).

    def encode_graph(self, objs, triples, obj_mask=None, triple_mask=None):
        """Embeddings and the GCN -> (obj_vecs, pred_vecs, obj_vecs_orig,
        s, o): the objects' vectors after and before the GCN, and each
        triple's subject and object slots."""
        objs = objs.long()
        triples = triples.long()
        s, p, o = triples[..., 0], triples[..., 1], triples[..., 2]
        obj_vecs = self.obj_embeddings(objs)
        obj_vecs_orig = obj_vecs
        pred_vecs = self.pred_embeddings(p)
        edges = torch.stack([s, o], dim=-1)
        if self.gconv_num_layers == 0:
            obj_vecs = self.gconv(obj_vecs)
        else:
            obj_vecs, pred_vecs = self.gconv(obj_vecs, pred_vecs, edges,
                                             triple_mask, obj_mask)
        if self.gconv_num_layers > 1:
            obj_vecs, pred_vecs = self.gconv_net(obj_vecs, pred_vecs, edges,
                                                 triple_mask, obj_mask)
        return obj_vecs, pred_vecs, obj_vecs_orig, s, o

    def predict_boxes_rels(self, obj_vecs, obj_vecs_orig, s, o,
                           obj_mask=None, triple_mask=None):
        """The box head and the relation head -> (boxes (N, O, 4),
        rel_scores (N, T, num_preds))."""
        boxes_pred = self.box_net(obj_vecs, mask=obj_mask)
        rel_aux_in = torch.cat([gather_slots(boxes_pred, s),
                                gather_slots(boxes_pred, o),
                                gather_slots(obj_vecs_orig, s),
                                gather_slots(obj_vecs_orig, o)], dim=-1)
        return boxes_pred, self.rel_aux_net(rel_aux_in, mask=triple_mask)

    def predict_masks(self, obj_vecs, obj_mask=None):
        """The mask head -> masks (N, O, M, M) in [0, 1], or None."""
        if self.mask_size is None or self.mask_size <= 0:
            return None
        N, O = obj_vecs.shape[:2]
        mask_in = obj_vecs.reshape(N * O, -1, 1, 1)
        flat_mask = None if obj_mask is None else obj_mask.reshape(N * O)
        return torch.sigmoid(
            self.mask_net(mask_in, sample_mask=flat_mask)).reshape(
            N, O, self.mask_size, self.mask_size)

    def compose_layout(self, obj_vecs, boxes, masks, obj_mask=None):
        """The layout (N, D, H, W) in the compute dtype: NHWC storage
        viewed as NCHW, a channels_last tensor."""
        H, W = self.image_size
        dtype = self.compute_dtype or torch.float32
        if masks is None:
            layout = boxes_to_layout(obj_vecs, boxes, obj_mask, H,
                                     W).to(dtype)
        else:
            # In bf16 mode the compose still sums in f32 and writes bf16:
            # the layout is narrowed before the noise concat.
            layout = masks_to_layout(obj_vecs, boxes, masks, obj_mask, H, W,
                                     out_dtype=dtype)
        return layout.permute(0, 3, 1, 2)

    def crn_input(self, layout, layout_noise=None):
        """The CRN's inputs -> (layout, noise): the layout with the layout
        noise concatenated, and None; or in 'split_noise' the layout and
        the noise apart."""
        if self.layout_noise_dim <= 0:
            return layout, None
        if layout_noise is None:
            raise ValueError("layout_noise (N, layout_noise_dim, H, W) is "
                             "required when layout_noise_dim > 0")
        noise = layout_noise.to(layout.dtype)
        if self.crn_mode == "split_noise":
            # The noise rides its own pyramid and conv0 kernel slice:
            # the full-resolution concat is never stored.
            return layout, noise
        return torch.cat([layout, noise], dim=1), None

    def forward(self, objs, triples, obj_mask=None, triple_mask=None,
                layout_noise=None, boxes_gt=None, masks_gt=None):
        """
        Args:
          objs (N, O), triples (N, T, 3): integer tensors.
          obj_mask (N, O), triple_mask (N, T): validity or None (all real).
          layout_noise: (N, layout_noise_dim, H, W) when layout_noise_dim
            > 0.  The generator draws no noise itself: the engine and the
            trainer do.
          boxes_gt (N, O, 4), masks_gt (N, O, M, M): ground truth the
            layout is composed from instead of the predictions, as training
            does (upstream ``train.py:524-528``).

        In train mode the BatchNorms of the MLPs and of the mask head take
        batch statistics over the real rows only: ``obj_mask`` for the
        object rows, ``triple_mask`` for the triple rows.

        Returns:
          imgs (N, 3, H, W) float32, boxes (N, O, 4), masks (N, O, M, M) or
          None, rel_scores (N, T, num_preds).
        """
        obj_vecs, pred_vecs, obj_vecs_orig, s, o = self.encode_graph(
            objs, triples, obj_mask, triple_mask)
        boxes_pred, rel_scores = self.predict_boxes_rels(
            obj_vecs, obj_vecs_orig, s, o, obj_mask, triple_mask)
        masks_pred = self.predict_masks(obj_vecs, obj_mask)
        # A generator without a mask head composes from the boxes alone.
        masks = masks_pred if masks_gt is None or masks_pred is None \
            else masks_gt
        layout = self.compose_layout(
            obj_vecs, boxes_pred if boxes_gt is None else boxes_gt, masks,
            obj_mask)
        layout, noise = self.crn_input(layout, layout_noise)
        imgs = self.refinement_net(layout, self.compute_dtype, noise=noise)
        return imgs, boxes_pred, masks_pred, rel_scores
