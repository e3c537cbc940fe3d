"""Survey-tree QA: explain what the datasets will (and won't) load (port of
``multimodal_auv_tpu/dataprep/qa.py``).

The folder-scan rules (data/datasets.py, mirroring the reference's
CustomImageDataset / CustomImageDataset_1, its data/datasets.py:23-337)
SKIP invalid folders silently — a survey with a systematic problem (labels missing,
patches never cut, SSS files misnamed) just trains on fewer samples with
nothing but debug logs. This module walks a tree with the SAME rules and
reports, per folder, exactly which requirement failed, plus tree-level
aggregates (label histogram, patch-size coverage, broken/zero images).

CLI: ``multimodal-auv-torch-data-check --root_dir DIR [--inference] [--deep]``.
Library: ``survey_tree_report(root, kind=..., deep=...)``.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from multimodal_auv_torch.data import transforms as T
from multimodal_auv_torch.data.datasets import (
    _BATHY_PATCH_RE,
    _SSS_PATCH_RE,
    _SSS_SUFFIXES,
)


@dataclass
class FolderVerdict:
    folder: str
    ok: bool
    problems: List[str] = field(default_factory=list)
    label: Optional[str] = None
    patch_sizes: List[str] = field(default_factory=list)


@dataclass
class TreeReport:
    root: str
    kind: str
    folders: List[FolderVerdict]
    label_histogram: Dict[str, int]
    patch_size_coverage: Dict[str, int]  # size -> folders having BOTH patches
    discovered_patch_sizes: List[str]

    @property
    def n_ok(self) -> int:
        return sum(1 for f in self.folders if f.ok)

    def problem_histogram(self) -> Dict[str, int]:
        h: Dict[str, int] = {}
        for f in self.folders:
            for p in f.problems:
                key = p.split(":")[0]
                h[key] = h.get(key, 0) + 1
        return dict(sorted(h.items(), key=lambda kv: -kv[1]))

    def summary_lines(self) -> List[str]:
        lines = [f"{self.root}: {self.n_ok}/{len(self.folders)} folders "
                 f"loadable as {self.kind} samples"]
        for k, v in self.problem_histogram().items():
            lines.append(f"  {v:4d}x {k}")
        if self.label_histogram:
            lines.append("  labels: " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.label_histogram.items())))
        if self.discovered_patch_sizes:
            lines.append("  patch sizes discovered: "
                         + ", ".join(self.discovered_patch_sizes))
            for s, n in sorted(self.patch_size_coverage.items()):
                lines.append(f"    {s}: bathy+SSS pair in {n}/{self.n_ok} "
                             f"loadable folders")
        return lines


def _check_image(path: str, mode: str) -> Optional[str]:
    """Deep check: decodable and non-black. Returns a problem string or
    None (same black-image criterion as the datasets' sum>0 validation)."""
    try:
        if T.image_nonzero_count(path, mode) == 0:
            return f"zero-image: {os.path.basename(path)} decodes all-black"
    except Exception as e:
        return f"broken-image: {os.path.basename(path)} ({e})"
    return None


def _training_verdict(folder_path: str, deep: bool) -> FolderVerdict:
    v = FolderVerdict(folder=folder_path, ok=True)

    mains = glob.glob(os.path.join(folder_path, "*frame*.jpg"))
    if not mains:
        v.problems.append("missing-main: no *frame*.jpg")
    sss = [f for f in os.listdir(folder_path)
           if "SSS" in f and "patch_" not in f]
    if not sss:
        v.problems.append("missing-sss: no non-patch file containing 'SSS'")
    labels = [f for f in os.listdir(folder_path)
              if f.endswith(".txt") and not f.startswith("_")]
    if not labels:
        v.problems.append("missing-label: no non-underscore .txt file")
    else:
        labels.sort(key=lambda x: os.path.getmtime(
            os.path.join(folder_path, x)), reverse=True)
        v.label = os.path.splitext(labels[0])[0]
        if len(labels) > 1:
            v.problems.append(
                f"ambiguous-label: {len(labels)} .txt files; newest wins "
                f"({v.label!r}) — the scan rule, but worth an audit")
    if not os.path.exists(os.path.join(folder_path,
                                       "combined_rgb_bathymetry.jpg")):
        v.problems.append("missing-bathy: no combined_rgb_bathymetry.jpg")

    pb, ps = {}, {}
    for f in os.listdir(folder_path):
        m, s = _BATHY_PATCH_RE.match(f), _SSS_PATCH_RE.match(f)
        if m:
            pb[m.group(1)] = f
        elif s:
            ps[s.group(1)] = f
    if not pb and not ps:
        v.problems.append("missing-patches: no patch_*_combined_bathy.png / "
                          "patch_*_*_SSS.*")
    v.patch_sizes = sorted(set(pb) | set(ps))
    if not os.path.exists(os.path.join(folder_path, "normalised_meta.csv")):
        v.problems.append("missing-meta: no normalised_meta.csv")

    # a hard problem = the dataset would skip this folder (ambiguous-label
    # is advisory only)
    v.ok = not any(not p.startswith("ambiguous-label") for p in v.problems)

    if deep and v.ok:
        for path, mode in ([(mains[0], "RGB")] if mains else []) + \
                [(os.path.join(folder_path, f), "L") for f in sss[:1]]:
            prob = _check_image(path, mode)
            if prob:
                v.problems.append(prob)  # advisory: dataset feeds zeros
    return v


def _inference_verdict(folder_path: str, deep: bool) -> FolderVerdict:
    v = FolderVerdict(folder=folder_path, ok=True)
    mains = glob.glob(os.path.join(folder_path, "[fF]rame*.jpg"))
    if not mains:
        v.problems.append("missing-main: no [fF]rame*.jpg")
    sss = [f for f in os.listdir(folder_path)
           if "SSS" in f and f.lower().endswith(_SSS_SUFFIXES)
           and "patch_" not in f]
    if not sss:
        v.problems.append("missing-sss: no non-patch SSS image")
    has_bathy = (os.path.exists(os.path.join(
        folder_path, "patch_30m_combined_bathy.png"))
        or os.path.exists(os.path.join(folder_path, "combined_bathy.jpg")))
    if not has_bathy:
        v.problems.append("missing-bathy: neither patch_30m_combined_bathy"
                          ".png nor combined_bathy.jpg")
    v.ok = not v.problems
    if deep and v.ok:
        prob = _check_image(mains[0], "RGB")
        if prob:
            v.problems.append(prob)
    return v


def survey_tree_report(root: str, kind: str = "training",
                       deep: bool = False) -> TreeReport:
    """Walk ``root`` with the dataset scan rules; ``deep=True`` also
    decodes each loadable folder's main/SSS images (broken/black check —
    the datasets substitute zeros at load time, which silently changes
    training data)."""
    if kind not in ("training", "inference"):
        raise ValueError(f"kind must be training|inference, got {kind!r}")
    folders = []
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if not os.path.isdir(p):
            continue
        folders.append(_training_verdict(p, deep) if kind == "training"
                       else _inference_verdict(p, deep))
    hist: Dict[str, int] = {}
    coverage: Dict[str, int] = {}
    sizes: set = set()
    for f in folders:
        if f.ok and f.label is not None:
            hist[f.label] = hist.get(f.label, 0) + 1
        if f.ok:
            for s in f.patch_sizes:
                coverage[s] = coverage.get(s, 0) + 1
        sizes.update(f.patch_sizes)
    return TreeReport(root=root, kind=kind, folders=folders,
                      label_histogram=hist, patch_size_coverage=coverage,
                      discovered_patch_sizes=sorted(sizes))


def data_check_cli(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="QA a survey tree: per-folder loadability with reasons, "
                    "label histogram, patch coverage.")
    p.add_argument("--root_dir", required=True)
    p.add_argument("--inference", action="store_true",
                   help="use the inference dataset's scan rules")
    p.add_argument("--deep", action="store_true",
                   help="also decode main/SSS images (broken/black check)")
    p.add_argument("--show_ok", action="store_true",
                   help="list loadable folders too, not only problems")
    args = p.parse_args(argv)

    rep = survey_tree_report(args.root_dir,
                             "inference" if args.inference else "training",
                             deep=args.deep)
    for line in rep.summary_lines():
        print(line)
    for f in rep.folders:
        if f.problems or (args.show_ok and f.ok):
            status = "ok " if f.ok else "SKIP"
            print(f"{status} {f.folder}")
            for prob in f.problems:
                print(f"     - {prob}")
    return 0 if rep.n_ok == len(rep.folders) and rep.n_ok > 0 else 1


if __name__ == "__main__":
    raise SystemExit(data_check_cli())
