"""Grouped-convolution trunks: one conv per layer for all three modalities
(port of ``multimodal_auv_tpu/models/fused.py``).

The multimodal forward runs three ResNet trunks whose conv geometries are
the same except conv1's input channels. Here the three modalities are
concatenated channel-wise in the order (image, bathy, sss), the 1-channel
SSS input zero-padded to 3 channels (two zero input columns in its conv1
kernel make the padding exact), and every trunk layer runs as ONE
``F.conv2d(..., groups=3)``: a third of the trunks' conv launches.

The functions take the STANDARD ``MultiModalModel`` parameter tree in the
forward layout (OIHW conv kernels, what ``PackMeta.unpack`` gives), so the
packed layout, checkpoints and interop are unchanged. Each layer's grouped
kernel is built by concatenating the three trunks' kernels along the
output channel: the sorted packed keys put the trunks in three separate
ranges of the flat vector, so this is a real copy per layer per draw
(``grouped_layer_count`` of them), not a view. The unfused path
copies the same bytes implicitly: the unpacked kernels are permuted views
that the convolution makes contiguous.

BatchNorm is ``models/resnet.py::batch_norm`` (flax train-mode numerics,
masked, synchronised over the data group under a mesh) over the
concatenated 3C channels with the three trunks' scale and bias
concatenated: per channel, so each modality's channels see exactly their
own statistics. Inference only: train-mode BN statistics, no running
statistics update, and ``train=False`` raises, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_auv_torch.models.fusion import _ATTN, AdditiveAttention
from multimodal_auv_torch.models.resnet import Tree, batch_norm, cast, dense
from multimodal_auv_torch.utils.profiling import span

TRUNKS = ("image_model_feat", "bathy_model_feat", "sss_model_feat")


def grouped_layer_count(stage_sizes: Sequence[int]) -> int:
    """The grouped conv layers of one forward: conv1, three per bottleneck
    and one downsample per stage (53 for ResNet-50)."""
    return 1 + 3 * sum(stage_sizes) + len(stage_sizes)


def fused_trunks_features(params: Tree, main: torch.Tensor,
                          bathy: torch.Tensor, sss: torch.Tensor, *,
                          stage_sizes: Sequence[int],
                          dtype: torch.dtype = torch.bfloat16,
                          batch_mask: Optional[torch.Tensor] = None,
                          eps: float = 1e-5
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three trunks as one grouped-conv program over NHWC inputs.
    Returns (image, bathy, sss) features, each (batch, feature_size): the
    values of three separate ``ResNet.forward`` calls in train-mode BN."""
    if sss.shape[-1] == 1:
        sss = F.pad(sss, (0, 2))
    x = torch.cat([cast(main, dtype), cast(bathy, dtype), cast(sss, dtype)],
                  dim=-1).permute(0, 3, 1, 2)
    mask = (None if batch_mask is None
            else batch_mask.reshape(-1).to(torch.bool))

    def node(t, name, sub):
        return (params[t] if sub is None else params[t][sub])[name]

    def gconv(y, name, stride, sub=None):
        with span("auv.conv"):
            ks = []
            for t in TRUNKS:
                k = node(t, name, sub)["kernel"]
                if k.shape[1] == 1:
                    # SSS conv1 is 1-in: zero input columns make the
                    # zero-padded input channels exact no-ops
                    k = F.pad(k, (0, 0, 0, 0, 0, 2))
                ks.append(cast(k, dtype))
            k = torch.cat(ks, dim=0)
            return F.conv2d(y, k, stride=stride, padding=k.shape[-1] // 2,
                            groups=3)

    def gbn(y, name, sub=None):
        p = {f: torch.cat([node(t, name, sub)[f] for t in TRUNKS])
             for f in ("scale", "bias")}
        return batch_norm(y, p, None, True, mask, dtype, eps=eps)[0]

    x = gconv(x, "conv1", 2)
    x = F.max_pool2d(torch.relu(gbn(x, "bn1")), 3, stride=2, padding=1)
    for stage, blocks in enumerate(stage_sizes):
        for blk in range(blocks):
            stride = 2 if (stage > 0 and blk == 0) else 1
            sub = f"layer{stage + 1}_{blk}"
            out = torch.relu(gbn(gconv(x, "conv1", 1, sub), "bn1", sub))
            out = torch.relu(gbn(gconv(out, "conv2", stride, sub), "bn2", sub))
            out = gbn(gconv(out, "conv3", 1, sub), "bn3", sub)
            identity = x
            if blk == 0:
                identity = gbn(gconv(x, "downsample_conv", stride, sub),
                               "downsample_bn", sub)
            x = torch.relu(out + identity)
    feats = x.mean(dim=(2, 3))  # (B, 3 * feature_size)
    return tuple(feats.chunk(3, dim=1))


def fused_multimodal_logits(params: Tree, main: torch.Tensor,
                            bathy: torch.Tensor, sss: torch.Tensor, *,
                            stage_sizes: Sequence[int],
                            dtype: torch.dtype = torch.bfloat16,
                            batch_mask: Optional[torch.Tensor] = None,
                            hidden_dim: int = 128) -> torch.Tensor:
    """The whole ``MultiModalModel`` forward with grouped trunks and the
    standard attention / fc head, from the standard parameter tree."""
    feats = fused_trunks_features(params, main, bathy, sss,
                                  stage_sizes=stage_sizes, dtype=dtype,
                                  batch_mask=batch_mask)
    attn = AdditiveAttention(hidden_dim, dtype)
    x = torch.cat([attn(params[a], f) for a, f in zip(_ATTN, feats)], dim=1)
    for fc in ("fc", "fc1", "fc2"):
        x = dense(x, params[fc], dtype)
    return x


class FusedMultiModal:
    """Drop-in ``module`` for ``engine.mc.mc_logits``: the call contract of
    ``MultiModalModel.forward``, train-mode BN only; with ``mutable`` the
    running statistics come back unchanged (the predict path discards
    them)."""

    def __init__(self, stage_sizes: Sequence[int], width: int,
                 dtype: torch.dtype = torch.bfloat16, hidden_dim: int = 128):
        self.stage_sizes, self.width = tuple(stage_sizes), width
        self.dtype, self.hidden_dim = dtype, hidden_dim

    def __call__(self, p: Tree, s: Tree, inputs: torch.Tensor,
                 bathy_tensor: torch.Tensor, sss_image: torch.Tensor,
                 train: bool = True,
                 batch_mask: Optional[torch.Tensor] = None,
                 mutable: bool = False):
        if not train:
            # the grouped trunks compute train-mode BN only; returning that
            # to an eval-mode caller would be wrong with no signal
            raise NotImplementedError(
                "FusedMultiModal supports train=True (MC predict) only: use "
                "the unfused MultiModalModel for eval-mode BN")
        out = fused_multimodal_logits(p, inputs, bathy_tensor, sss_image,
                                      stage_sizes=self.stage_sizes,
                                      dtype=self.dtype, batch_mask=batch_mask,
                                      hidden_dim=self.hidden_dim)
        return (out, s) if mutable else out


def fused_module_for(module) -> FusedMultiModal:
    """The grouped-trunk twin of a ``MultiModalModel``."""
    trunk = getattr(module, TRUNKS[0])
    return FusedMultiModal(trunk.stage_sizes, trunk.width, module.dtype,
                           getattr(module, _ATTN[0]).hidden_dim)
