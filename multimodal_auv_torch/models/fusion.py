"""Multimodal fusion model (port of ``multimodal_auv_tpu/models/fusion.py``).

* ``AdditiveAttention``: Q, K, V = Dense(F->128); weights =
  softmax(Dense(128->128)(tanh(Q + K)), axis 1); output = V * weights,
  elementwise (no reduction).
* ``MultiModalModel``: three ResNet-50 feature trunks (optical RGB, bathy
  RGB, SSS 1-ch) -> per-modality AdditiveAttention -> concat (3 x 128) ->
  fc Dense(384, 1284) -> fc1 Dense(1284, 32) -> fc2 Dense(32, classes),
  with no nonlinearity between the fc layers.

Functional like ``models/resnet.py``: ``forward`` takes the param and
BatchNorm-statistics trees.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from multimodal_auv_torch.models.resnet import ResNet, Tree, dense, dense_init

_TRUNKS = (("image_model_feat", 3), ("bathy_model_feat", 3),
           ("sss_model_feat", 1))
_ATTN = ("attention_image", "attention_bathy", "attention_sss")
_PROJ = ("key_projection", "value_projection", "query_projection")


class AdditiveAttention(nn.Module):
    def __init__(self, hidden_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim, self.dtype = hidden_dim, dtype

    def init(self, gen: torch.Generator, fin: int) -> Tree:
        p = {name: dense_init(gen, fin, self.hidden_dim) for name in _PROJ}
        p["attention_mechanism"] = dense_init(gen, self.hidden_dim,
                                              self.hidden_dim)
        return p

    def forward(self, p: Tree, query: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        keys = dense(query, p["key_projection"], dt)
        values = dense(query, p["value_projection"], dt)
        queries = dense(query, p["query_projection"], dt)
        scores = torch.tanh(queries + keys)
        weights = torch.softmax(dense(scores, p["attention_mechanism"], dt),
                                dim=1)
        return values * weights  # elementwise gate, no reduction


class MultiModalModel(nn.Module):
    def __init__(self, num_classes: int, stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 width: int = 64, dtype: torch.dtype = torch.float32,
                 hidden_dim: int = 128,
                 fusion_dims: Tuple[int, int] = (1284, 32)):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.fusion_dims = tuple(fusion_dims)
        for name, _ in _TRUNKS:
            self.add_module(name, ResNet(stage_sizes, width, None, dtype))
        for name in _ATTN:
            self.add_module(name, AdditiveAttention(hidden_dim, dtype))

    def init(self, gen: torch.Generator) -> Tuple[Tree, Tree]:
        """(params, batch_stats) in the JAX layout (HWIO conv kernels)."""
        p, s = {}, {}
        for name, cin in _TRUNKS:
            p[name], s[name] = getattr(self, name).init(gen, cin)
        feat = getattr(self, _TRUNKS[0][0]).feature_size
        for name in _ATTN:
            p[name] = getattr(self, name).init(gen, feat)
        hidden = getattr(self, _ATTN[0]).hidden_dim
        dims = (3 * hidden,) + self.fusion_dims + (self.num_classes,)
        for name, fin, fout in zip(("fc", "fc1", "fc2"), dims, dims[1:]):
            p[name] = dense_init(gen, fin, fout)
        return p, s

    def forward(self, p: Tree, s: Tree, inputs: torch.Tensor,
                bathy_tensor: torch.Tensor, sss_image: torch.Tensor,
                train: bool = True,
                batch_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        attended = []
        for (trunk, _), attn, x in zip(_TRUNKS, _ATTN,
                                       (inputs, bathy_tensor, sss_image)):
            feats = getattr(self, trunk)(p[trunk], s.get(trunk, {}), x,
                                         train, batch_mask)
            attended.append(getattr(self, attn)(p[attn], feats))
        x = torch.cat(attended, dim=1)
        x = dense(x, p["fc"], self.dtype)
        x = dense(x, p["fc1"], self.dtype)
        return dense(x, p["fc2"], self.dtype)
