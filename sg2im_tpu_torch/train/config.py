"""Training configuration (counterpart of ``sg2im_tpu/train/config.py``,
upstream ``scripts/train.py:47-140`` flags).

The same dataclass with the same fields and defaults, so a configuration
or a checkpoint's meta JSON carries across; ``generator_kwargs`` maps
``bf16_compute`` to ``torch.bfloat16``.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class TrainConfig:
    # Optimization (train.py:51-56)
    dataset: str = "coco"
    batch_size: int = 32
    num_iterations: int = 1000000
    learning_rate: float = 1e-4
    eval_mode_after: int = 100000

    # Dataset common (train.py:59-64)
    image_size: tuple[int, int] = (64, 64)
    num_train_samples: int | None = None
    num_val_samples: int = 1024
    shuffle_val: bool = True
    loader_num_workers: int = 4
    cache_dir: str | None = None
    decoder: str = "auto"
    include_relationships: bool = True

    # VG (train.py:67-73)
    vg_image_dir: str = "datasets/vg/images"
    train_h5: str = "datasets/vg/train.h5"
    val_h5: str = "datasets/vg/val.h5"
    vocab_json: str = "datasets/vg/vocab.json"
    max_objects_per_image: int = 10
    vg_use_orphaned_objects: bool = True

    # COCO (train.py:76-92)
    coco_train_image_dir: str = "datasets/coco/images/train2017"
    coco_val_image_dir: str = "datasets/coco/images/val2017"
    coco_train_instances_json: str = (
        "datasets/coco/annotations/instances_train2017.json")
    coco_train_stuff_json: str = (
        "datasets/coco/annotations/stuff_train2017.json")
    coco_val_instances_json: str = (
        "datasets/coco/annotations/instances_val2017.json")
    coco_val_stuff_json: str = (
        "datasets/coco/annotations/stuff_val2017.json")
    instance_whitelist: tuple[str, ...] | None = None
    stuff_whitelist: tuple[str, ...] | None = None
    coco_include_other: bool = False
    min_object_size: float = 0.02
    min_objects_per_image: int = 3
    coco_stuff_only: bool = True

    # Generator (train.py:95-105)
    mask_size: int = 16
    embedding_dim: int = 128
    gconv_dim: int = 128
    gconv_hidden_dim: int = 512
    gconv_num_layers: int = 5
    mlp_normalization: str = "none"
    refinement_network_dims: tuple[int, ...] = (1024, 512, 256, 128, 64)
    normalization: str = "batch"
    activation: str = "leakyrelu-0.2"
    layout_noise_dim: int = 32
    use_boxes_pred_after: int = -1  # parsed but never read upstream

    # Generator losses (train.py:108-113)
    mask_loss_weight: float = 0.0
    l1_pixel_loss_weight: float = 1.0
    bbox_pred_loss_weight: float = 10.0
    predicate_pred_loss_weight: float = 0.0

    # Discriminators (train.py:115-131)
    discriminator_loss_weight: float = 0.01
    gan_loss_type: str = "gan"
    d_clip: float | None = None  # upstream parses it and never applies it
    d_normalization: str = "batch"
    d_padding: str = "valid"
    d_activation: str = "leakyrelu-0.2"
    d_obj_arch: str = "C4-64-2,C4-128-2,C4-256-2"
    crop_size: int = 32
    d_obj_weight: float = 1.0
    ac_loss_weight: float = 0.1
    d_img_arch: str = "C4-64-2,C4-128-2,C4-256-2"
    d_img_weight: float = 1.0

    # Output (train.py:134-140)
    print_every: int = 10
    timing: bool = False
    checkpoint_every: int = 10000
    output_dir: str = "."
    checkpoint_name: str = "checkpoint"
    checkpoint_start_from: str | None = None
    restore_from_checkpoint: bool = False

    # Additions of the JAX package (not upstream's)
    snapshot_every: int = -1
    pad_objects_to: int = 16
    pad_triples_to: int = 48
    seed: int = 0
    data_parallel: int = 1
    bf16_compute: bool = False
    crn_mode: str = "legacy"
    log_jsonl: bool = True
    tensorboard_dir: str | None = None
    async_checkpoint: bool = False

    @classmethod
    def from_dict(cls, cfg: dict) -> "TrainConfig":
        """A config from its JSON form (a checkpoint's ``meta.json``, the
        port's or the JAX package's): lists become tuples, keys that are
        not fields are left out."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in cfg.items() if k in fields})

    @property
    def use_obj_discriminator(self) -> bool:
        return self.discriminator_loss_weight > 0 and self.d_obj_weight > 0

    @property
    def use_img_discriminator(self) -> bool:
        return self.discriminator_loss_weight > 0 and self.d_img_weight > 0

    def generator_kwargs(self) -> dict[str, Any]:
        """Upstream ``build_model`` kwargs (train.py:173-187), plus the
        compute dtype and the CRN mode."""
        extra = {}
        if self.bf16_compute:
            import torch

            extra["compute_dtype"] = torch.bfloat16
        if self.crn_mode != "legacy":
            extra["crn_mode"] = self.crn_mode
        return dict(
            **extra,
            image_size=tuple(self.image_size),
            embedding_dim=self.embedding_dim,
            gconv_dim=self.gconv_dim,
            gconv_hidden_dim=self.gconv_hidden_dim,
            gconv_num_layers=self.gconv_num_layers,
            mlp_normalization=self.mlp_normalization,
            refinement_dims=tuple(self.refinement_network_dims),
            normalization=self.normalization,
            activation=self.activation,
            mask_size=self.mask_size if self.mask_size else None,
            layout_noise_dim=self.layout_noise_dim,
        )

    def d_obj_kwargs(self) -> dict[str, Any]:
        """Upstream ``build_obj_discriminator`` kwargs (train.py:190-208)."""
        return dict(arch=self.d_obj_arch, normalization=self.d_normalization,
                    activation=self.d_activation, padding=self.d_padding,
                    object_size=self.crop_size)

    def d_img_kwargs(self) -> dict[str, Any]:
        """Upstream ``build_img_discriminator`` kwargs (train.py:211-226)."""
        return dict(arch=self.d_img_arch, normalization=self.d_normalization,
                    activation=self.d_activation, padding=self.d_padding)
