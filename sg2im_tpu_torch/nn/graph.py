"""Scene-graph convolution over padded per-image graphs.

Counterpart of ``sg2im_tpu/nn/graph.py``.  Triples index object slots of
their own image; padded triples carry ``triple_mask = 0`` and add neither
messages nor counts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sg2im_tpu_torch.nn.layers import MLP


def gather_slots(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (N, O, D), idx (N, T) -> (N, T, D): out[n, t] = x[n, idx[n, t]]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def pool_messages(s_idx, o_idx, s_msgs, o_msgs, triple_mask, num_objs: int,
                  pooling: str = "avg") -> torch.Tensor:
    """Pool per-triple messages onto object slots with a one-hot batched
    matrix product (deterministic, unlike a scatter with atomics).

    Args:
      s_idx, o_idx: (N, T) subject/object slot indices.
      s_msgs, o_msgs: (N, T, H).
      triple_mask: (N, T) validity or None.
      pooling: 'sum' or 'avg' (divide by the appearance count, at least 1).

    Returns:
      (N, O, H).
    """
    dtype = s_msgs.dtype
    oh_s = F.one_hot(s_idx.long(), num_objs).to(dtype)  # (N, T, O)
    oh_o = F.one_hot(o_idx.long(), num_objs).to(dtype)
    if triple_mask is not None:
        m = triple_mask.to(dtype)[..., None]
        oh_s = oh_s * m
        oh_o = oh_o * m
    pooled = torch.bmm(oh_s.transpose(1, 2), s_msgs)
    pooled = pooled + torch.bmm(oh_o.transpose(1, 2), o_msgs)
    if pooling == "avg":
        counts = oh_s.sum(1) + oh_o.sum(1)  # (N, O)
        pooled = pooled / counts.clamp_min(1.0)[..., None]
    elif pooling != "sum":
        raise ValueError(f'Invalid pooling "{pooling}"')
    return pooled


class GraphTripleConv(nn.Module):
    """One scene-graph convolution (upstream ``graph.py:32-120``): net1 maps
    [s, p, o] triple vectors to (2H + Dout); the H halves pool onto the
    objects and pass through net2."""

    def __init__(self, input_dim: int, output_dim: int | None = None,
                 hidden_dim: int = 512, pooling: str = "avg",
                 mlp_normalization: str = "none"):
        super().__init__()
        output_dim = input_dim if output_dim is None else output_dim
        self.hidden_dim = hidden_dim
        self.output_dim = output_dim
        self.pooling = pooling
        self.net1 = MLP((3 * input_dim, hidden_dim, 2 * hidden_dim
                         + output_dim), batch_norm=mlp_normalization,
                        kernel_init="kaiming_normal")
        self.net2 = MLP((hidden_dim, hidden_dim, output_dim),
                        batch_norm=mlp_normalization,
                        kernel_init="kaiming_normal")

    def forward(self, obj_vecs, pred_vecs, edges, triple_mask=None,
                obj_mask=None):
        """obj_vecs (N, O, Din), pred_vecs (N, T, Din), edges (N, T, 2)
        -> (new obj_vecs (N, O, Dout), new pred_vecs (N, T, Dout)).
        ``triple_mask`` and ``obj_mask`` keep padded rows out of net1's and
        net2's train-mode BatchNorm statistics."""
        H, Dout = self.hidden_dim, self.output_dim
        s_idx, o_idx = edges[..., 0], edges[..., 1]
        cur_t = torch.cat([gather_slots(obj_vecs, s_idx), pred_vecs,
                           gather_slots(obj_vecs, o_idx)], dim=-1)
        new_t = self.net1(cur_t, mask=triple_mask)
        new_s = new_t[..., :H]
        new_p = new_t[..., H:H + Dout]
        new_o = new_t[..., H + Dout:2 * H + Dout]
        pooled = pool_messages(s_idx, o_idx, new_s, new_o, triple_mask,
                               obj_vecs.shape[1], self.pooling)
        return self.net2(pooled, mask=obj_mask), new_p


class GraphTripleConvNet(nn.Module):
    """A stack of GraphTripleConv layers (upstream ``graph.py:123-144``)."""

    def __init__(self, input_dim: int, num_layers: int = 5,
                 hidden_dim: int = 512, pooling: str = "avg",
                 mlp_normalization: str = "none"):
        super().__init__()
        self.gconvs = nn.ModuleList(
            GraphTripleConv(input_dim, hidden_dim=hidden_dim,
                            pooling=pooling,
                            mlp_normalization=mlp_normalization)
            for _ in range(num_layers))

    def forward(self, obj_vecs, pred_vecs, edges, triple_mask=None,
                obj_mask=None):
        for gconv in self.gconvs:
            obj_vecs, pred_vecs = gconv(obj_vecs, pred_vecs, edges,
                                        triple_mask, obj_mask)
        return obj_vecs, pred_vecs
