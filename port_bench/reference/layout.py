"""Parameter shapes of the two configurations and their packed layout,
worked out from the published architecture (plain Python).

Names follow the published model's flax-style tree: a ResNet trunk has
``conv1``, ``bn1`` and bottlenecks ``layer{stage}_{block}`` with
``conv1..3``, ``bn1..3`` and, in each stage's first block,
``downsample_conv`` / ``downsample_bn``; a classifier adds ``fc``. The
multimodal model holds three trunks (``image_model_feat`` 3 channels,
``bathy_model_feat`` 3, ``sss_model_feat`` 1), an additive attention per
trunk and the ``fc`` -> ``fc1`` -> ``fc2`` head. Conv kernels are HWIO,
dense kernels (in, out).

The variational leaves (every conv and dense ``kernel`` and ``bias``)
are packed into one flat vector in sorted path order, padded to a
multiple of 1024; BatchNorm's ``scale`` and ``bias`` stay outside it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

Path = Tuple[str, ...]
EXPANSION = 4
TRUNKS = (("image_model_feat", 3), ("bathy_model_feat", 3),
          ("sss_model_feat", 1))
ATTENTIONS = ("attention_image", "attention_bathy", "attention_sss")


def _conv(k: int, cin: int, cout: int) -> Dict:
    return {"kernel": (k, k, cin, cout)}


def _bn(c: int) -> Dict:
    return {"scale": (c,), "bias": (c,)}


def _dense(fin: int, fout: int) -> Dict:
    return {"kernel": (fin, fout), "bias": (fout,)}


def block_plan(stage_sizes: Sequence[int], width: int):
    """[(name, planes, stride, downsample)] of a trunk's bottlenecks."""
    plan, planes = [], width
    for s, blocks in enumerate(stage_sizes):
        for b in range(blocks):
            plan.append((f"layer{s + 1}_{b}", planes,
                         2 if (s > 0 and b == 0) else 1, b == 0))
        planes *= 2
    return plan


def trunk_tree(cin: int, stage_sizes: Sequence[int], width: int,
               num_classes=None) -> Dict:
    tree = {"conv1": _conv(7, cin, width), "bn1": _bn(width)}
    c = width
    for name, planes, _, down in block_plan(stage_sizes, width):
        out = planes * EXPANSION
        blk = {"conv1": _conv(1, c, planes), "bn1": _bn(planes),
               "conv2": _conv(3, planes, planes), "bn2": _bn(planes),
               "conv3": _conv(1, planes, out), "bn3": _bn(out)}
        if down:
            blk["downsample_conv"] = _conv(1, c, out)
            blk["downsample_bn"] = _bn(out)
        tree[name] = blk
        c = out
    if num_classes is not None:
        tree["fc"] = _dense(c, num_classes)
    return tree


def feature_size(stage_sizes: Sequence[int], width: int) -> int:
    return width * 2 ** (len(stage_sizes) - 1) * EXPANSION


def model_tree(cfg: Dict) -> Dict:
    """The parameter-shape tree of a configuration file's model."""
    stages, width = tuple(cfg["stage_sizes"]), cfg["width"]
    classes = cfg["num_classes"]
    if cfg["model"] == "unimodal":
        return {"model": trunk_tree(cfg["input_channels"], stages, width,
                                    classes)}
    tree = {name: trunk_tree(cin, stages, width) for name, cin in TRUNKS}
    feat, hidden = feature_size(stages, width), cfg["attention_hidden"]
    for name in ATTENTIONS:
        tree[name] = {p: _dense(feat, hidden) for p in (
            "key_projection", "value_projection", "query_projection")}
        tree[name]["attention_mechanism"] = _dense(hidden, hidden)
    dims = [3 * hidden] + list(cfg["fusion_dims"]) + [classes]
    for name, fin, fout in zip(("fc", "fc1", "fc2"), dims, dims[1:]):
        tree[name] = _dense(fin, fout)
    return tree


@dataclass(frozen=True)
class Entry:
    path: Path
    shape: Tuple[int, ...]
    offset: int
    size: int


@dataclass(frozen=True)
class Layout:
    entries: Tuple[Entry, ...]
    n_real: int
    n_padded: int
    bn_paths: Tuple[Path, ...]  # the BatchNorm groups, in sorted order


def _variational(tree: Dict, path: Path = ()):
    keys = sorted(tree)
    if "kernel" in tree and not isinstance(tree["kernel"], dict):
        for k in keys:
            if k in ("kernel", "bias"):
                yield path + (k,), tree[k]
    for k in keys:
        if isinstance(tree[k], dict):
            yield from _variational(tree[k], path + (k,))


def _bn_groups(tree: Dict, path: Path = ()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            if "scale" in v:
                yield path + (k,)
            else:
                yield from _bn_groups(v, path + (k,))


def layout(tree: Dict, pad_multiple: int = 1024) -> Layout:
    entries: List[Entry] = []
    off = 0
    for path, shape in _variational(tree):
        size = 1
        for s in shape:
            size *= s
        entries.append(Entry(path, tuple(shape), off, size))
        off += size
    padded = -(-max(off, 1) // pad_multiple) * pad_multiple
    return Layout(tuple(entries), off, padded, tuple(_bn_groups(tree)))


def fan_in(e: Entry) -> int:
    """The fan-in of a kernel entry (0 for a bias)."""
    if e.path[-1] != "kernel":
        return 0
    n = 1
    for s in e.shape[:-1]:
        n *= s
    return n


def leaf_name(path: Path) -> str:
    return "/".join(path)
