"""Expected key inventory of the published checkpoint, and the import audit
(port of ``multimodal_auv_tpu/interop/hf_manifest.py``).

The pretrained artifact (``sams-tom/multimodal-auv-bathy-bnn-classifier /
multimodal-bnn/pytorch_model.bin``) is a bayesian-torch ``dnn_to_bnn``
state dict. Its keys follow from the reference's construction:

  * three ResNet-50 trunks at ``{image,bathy,sss}_model_feat``, published
    with an extra ``.model.`` nesting level (stripped at load time), three
    ``AdditiveAttention`` heads and ``fc`` / ``fc1`` / ``fc2``;
  * every Conv2d as ``mu_kernel`` / ``rho_kernel`` parameters plus
    ``eps_kernel`` / ``prior_weight_mu`` / ``prior_weight_sigma`` buffers;
    every Linear as ``mu_weight`` / ``rho_weight`` / ``mu_bias`` /
    ``rho_bias`` plus ``eps_weight`` / ``eps_bias`` / ``prior_*`` buffers
    (buffers are in the file and ignored on import);
  * BatchNorm ``weight`` / ``bias``, ``running_mean`` / ``running_var`` and
    ``num_batches_tracked`` (ignored).

The inventory is generated from a bundle's ``PackMeta``, ``post.det`` and
``batch_stats``, reading only shapes. ``expected_hf_keys.json`` (full
ResNet-50 geometry, 7 classes, published form) is byte-equal to the JAX
package's file of that name, and ``build_flagship_manifest`` regenerates
it from parameter shapes alone (``torch.device("meta")``: no weights are
drawn). ``main`` audits a checkpoint file against it, or rewrites it
(``--write-manifest``).
"""
from __future__ import annotations

import json
import logging
import os
import re
from typing import Any, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

TRUNKS = ("image_model_feat", "bathy_model_feat", "sss_model_feat")
MANIFEST_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "expected_hf_keys.json")

_LAYER_FLAX_RE = re.compile(r"^layer(\d+)_(\d+)$")


def flax_to_torch_mods(path) -> Tuple[str, ...]:
    """Packed-layout module path -> torch module path segments: the
    inverse of ``torch_import._segments_to_flax``."""
    out = []
    for s in path:
        m = _LAYER_FLAX_RE.match(s)
        if m:
            out += [f"layer{m.group(1)}", m.group(2)]
        elif s == "downsample_conv":
            out += ["downsample", "0"]
        elif s == "downsample_bn":
            out += ["downsample", "1"]
        else:
            out.append(s)
    return tuple(out)


def _torch_prefix(path, published: bool) -> str:
    """The torch key prefix of a module path; ``published`` nests the
    trunks' keys under ``.model.``."""
    mods = flax_to_torch_mods(path)
    if published and mods and mods[0] in TRUNKS:
        mods = (mods[0], "model") + mods[1:]
    return ".".join(mods)


def _torch_shape(flax_shape) -> Tuple[int, ...]:
    s = tuple(int(x) for x in flax_shape)
    if len(s) == 4:  # HWIO -> OIHW
        return (s[3], s[2], s[0], s[1])
    if len(s) == 2:  # (in, out) -> (out, in)
        return (s[1], s[0])
    return s


def walk(tree, pre=()):
    """(path, leaf) of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], pre + (k,))
    else:
        yield pre, tree


def buffer_keys(mod_path, leaves: Dict[str, Tuple[int, ...]],
                published: bool) -> Dict[str, Tuple[int, ...]]:
    """{key: torch shape} of the bayesian-torch buffers (eps, prior) of
    one variational layer whose packed leaves have ``leaves``' shapes."""
    pre = _torch_prefix(mod_path, published)
    out = {}
    k_shape = leaves.get("kernel")
    if k_shape is not None:
        tshape = _torch_shape(k_shape)
        wname = "kernel" if len(k_shape) == 4 else "weight"
        out[f"{pre}.eps_{wname}"] = tshape
        out[f"{pre}.prior_weight_mu"] = tshape
        out[f"{pre}.prior_weight_sigma"] = tshape
    b_shape = leaves.get("bias")
    if b_shape is not None:
        tshape = tuple(b_shape)
        out[f"{pre}.eps_bias"] = tshape
        out[f"{pre}.prior_bias_mu"] = tshape
        out[f"{pre}.prior_bias_sigma"] = tshape
    return out


def layers_of(meta) -> Dict[Tuple[str, ...], Dict[str, Tuple[int, ...]]]:
    """Variational layers keyed by module path -> {leaf: packed shape}."""
    by_mod: Dict[Tuple[str, ...], Dict[str, Tuple[int, ...]]] = {}
    for e in meta.entries:
        by_mod.setdefault(tuple(e.path[:-1]), {})[e.path[-1]] = e.shape
    return by_mod


def expected_checkpoint_keys(bundle, *, published: bool = True,
                             include_buffers: Optional[bool] = None
                             ) -> Dict[str, Dict[str, Any]]:
    """{torch_key: {"role": ..., "shape": [...]}} of the checkpoint the
    reference's construction produces from this bundle's geometry.

    ``published=True`` is the artifact's form: trunk keys nested under
    ``.model.`` and every variational layer's eps / prior buffers.
    ``published=False`` is the post-remap, parameters-only form. Roles: mu,
    rho, bn_affine, bn_stats, ignored (buffers and num_batches_tracked:
    in the file, skipped by the importer)."""
    if include_buffers is None:
        include_buffers = published
    out: Dict[str, Dict[str, Any]] = {}
    for mod_path, leaves in sorted(layers_of(bundle.meta).items()):
        pre = _torch_prefix(mod_path, published)
        k_shape = leaves.get("kernel")
        if k_shape is not None:
            wname = "kernel" if len(k_shape) == 4 else "weight"
            tshape = list(_torch_shape(k_shape))
            out[f"{pre}.mu_{wname}"] = {"role": "mu", "shape": tshape}
            out[f"{pre}.rho_{wname}"] = {"role": "rho", "shape": tshape}
        b_shape = leaves.get("bias")
        if b_shape is not None:
            out[f"{pre}.mu_bias"] = {"role": "mu", "shape": list(b_shape)}
            out[f"{pre}.rho_bias"] = {"role": "rho", "shape": list(b_shape)}
        if include_buffers:
            for k, shape in buffer_keys(mod_path, leaves, published).items():
                out[k] = {"role": "ignored", "shape": list(shape)}

    for path, leaf in walk(bundle.post.det):
        pre = _torch_prefix(path[:-1], published)
        name = {"scale": "weight", "bias": "bias"}[path[-1]]
        out[f"{pre}.{name}"] = {"role": "bn_affine",
                                "shape": list(leaf.shape)}
    for path, leaf in walk(bundle.batch_stats):
        pre = _torch_prefix(path[:-1], published)
        name = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        out[f"{pre}.{name}"] = {"role": "bn_stats",
                                "shape": list(leaf.shape)}
        nbt = f"{pre}.num_batches_tracked"
        if nbt not in out:
            out[nbt] = {"role": "ignored", "shape": []}
    return out


def audit_coverage(state_dict: Dict[str, Any],
                   expected: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Classify a state dict's keys (``module.`` stripped) against the
    inventory: {matched, missing, unexpected, shape_mismatch, by_role};
    ``missing`` lists only loadable roles (mu, rho, bn_affine, bn_stats:
    an absent ignored buffer is fine)."""
    sd_keys = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        sd_keys[k] = v

    matched, unexpected, shape_mismatch = [], [], []
    by_role: Dict[str, int] = {}
    for k, v in sd_keys.items():
        info = expected.get(k)
        if info is None:
            unexpected.append(k)
            continue
        want = info.get("shape")
        have = [int(s) for s in v.shape] if hasattr(v, "shape") else []
        if want not in (None, []) and have and want != have:
            shape_mismatch.append((k, have, want))
            continue
        matched.append(k)
        by_role[info["role"]] = by_role.get(info["role"], 0) + 1
    missing = [k for k, info in expected.items()
               if k not in sd_keys and info["role"] != "ignored"]
    return {"matched": matched, "missing": sorted(missing),
            "unexpected": sorted(unexpected),
            "shape_mismatch": shape_mismatch, "by_role": by_role}


def log_coverage(audit: Dict[str, Any], *, name: str = "checkpoint") -> None:
    logger.info(
        "%s coverage: %d matched (%s), %d missing, %d unexpected, "
        "%d shape mismatches", name, len(audit["matched"]),
        ", ".join(f"{k}={v}" for k, v in sorted(audit["by_role"].items())),
        len(audit["missing"]), len(audit["unexpected"]),
        len(audit["shape_mismatch"]))
    for k in audit["missing"][:10]:
        logger.warning("%s: expected key missing: %s", name, k)
    for k in audit["unexpected"][:10]:
        logger.warning("%s: unexpected key: %s", name, k)
    for k, have, want in audit["shape_mismatch"][:10]:
        logger.warning("%s: %s shape %s != expected %s", name, k, have, want)


def load_manifest() -> Dict[str, Dict[str, Any]]:
    """The shipped inventory, ``expected_hf_keys.json``."""
    with open(MANIFEST_PATH) as f:
        return json.load(f)


def build_flagship_manifest() -> Dict[str, Dict[str, Any]]:
    """The shipped inventory regenerated: full ResNet-50 geometry, 7
    classes, published form, from parameter shapes on the meta device."""
    from types import SimpleNamespace

    import torch

    from multimodal_auv_torch.bayes.packing import (
        build_meta,
        deterministic_part,
    )
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig,
        multimodal_module,
    )

    with torch.device("meta"):
        params, stats = multimodal_module(7, ArchConfig()).init(
            torch.Generator())
    meta = build_meta(params)
    bundle = SimpleNamespace(
        meta=meta, post=SimpleNamespace(det=deterministic_part(params, meta)),
        batch_stats=stats)
    return expected_checkpoint_keys(bundle, published=True)


def main(argv=None) -> int:
    """Audit a checkpoint against the shipped inventory, or regenerate it:

    python -m multimodal_auv_torch.interop.hf_manifest <pytorch_model.bin>
    python -m multimodal_auv_torch.interop.hf_manifest --write-manifest

    Exit 0 when no loadable key is missing or of another shape, 1 when
    one is, 2 with nothing to do."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("checkpoint", nargs="?", default=None,
                    help="path to a torch state-dict checkpoint to audit")
    ap.add_argument("--write-manifest", action="store_true",
                    help=f"regenerate {MANIFEST_PATH}")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    if args.write_manifest:
        man = build_flagship_manifest()
        with open(MANIFEST_PATH, "w") as f:
            json.dump(man, f, indent=0, sort_keys=True)
        print(f"wrote {len(man)} keys to {MANIFEST_PATH}")
        return 0
    if not args.checkpoint:
        print("nothing to do (pass a checkpoint path or --write-manifest)")
        return 2
    import torch

    # the raw keys: the inventory is in the published form
    raw = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    audit = audit_coverage(raw, load_manifest())
    log_coverage(audit, name=os.path.basename(args.checkpoint))
    ok = not audit["missing"] and not audit["shape_mismatch"]
    print("COVERAGE OK" if ok else "COVERAGE INCOMPLETE")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
