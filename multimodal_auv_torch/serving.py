"""Serving artifacts: ``torch.export`` of the packed predict step (port of
``multimodal_auv_tpu/serving.py``).

The packed predict step (uint8 batch -> fused CSV columns: exact MC,
engine/predict.py, or single-pass DVP, engine/moment.py) is exported once
with ``torch.export`` and written to disk next to the posterior and
BatchNorm state. A serving host then needs only this module, torch, numpy
and the port's ops (which register the sampler op the program calls): no
model code and no tracing.

Artifact layout (a directory):

    program.pt2   one MC chunk: (state_leaves, (main_u8, bathy_u8, sss_u8),
                  seeds (1, 2) int64, mask f32) -> (mc_chunk, batch, C)
                  logits (DVP: all num_mc draws in one chunk, f32)
    reduce.pt2    (num_mc, batch, C) logits -> the fused (3 + C, batch) f32
                  output: rows predicted, predictive_u, aleatoric_u, then
                  mean_prob transposed
    state.npz     posterior + BN leaves, ordered (leaf_00000, ...)
    meta.json     the JAX artifact's keys: version, shapes, num_mc,
                  platforms (["cuda"] or ["cpu"]), class names, ...

The loader's call has the JAX artifact's ABI, ``(state_leaves, (main_u8,
bathy_u8, sss_u8), seeds, mask) -> (3 + C, batch) f32``, with the key
replaced by the (nchunks, 2) int64 seed words the in-process step draws
from a ``torch.Generator`` (``ops.sampling.chunk_seed_words``): it runs
the chunk program once per row of ``seeds``, then the reduction. One
program per chunk, not one for all draws: the step unrolls every draw's
three ResNet-50 forwards (~5,600 graph nodes a draw), and the export, save
and load times grow with the nodes.

The program is traced on the device that will serve it: ops that build
tensors bake that device into the graph, so the loader refuses a device
other than the one in ``meta["platforms"]``.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from multimodal_auv_torch.device import DeviceLike, resolve_device
# also registers torch.ops.auv.split_sampler, which the program calls
from multimodal_auv_torch.ops.sampling import chunk_seed_words

logger = logging.getLogger(__name__)

ARTIFACT_VERSION = 1
_PROGRAM = "program.pt2"
_REDUCE = "reduce.pt2"
_STATE = "state.npz"
_META = "meta.json"
_M64 = (1 << 64) - 1


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def fold_seed(seed: int, i: int) -> int:
    """The seed of call ``i`` under ``seed`` (the counterpart of
    ``jax.random.fold_in``): splitmix64 of the pair, cut to 63 bits for
    ``torch.Generator.manual_seed``. The keyless calls of an artifact and
    the HTTP host's chunks of a seeded request draw their seeds here."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(i) + 1) * 0xBF58476D1CE4E5B9
         ) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _tree_set(tree: dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _flatten_state(bundle):
    """(leaves, unflatten): mu, rho, then the det and batch_stats leaves in
    sorted key order; ``unflatten(leaves)`` -> (post, batch_stats)."""
    from multimodal_auv_torch.bayes.packing import PackedPosterior

    det = list(_tree_leaves(bundle.post.det))
    stats = list(_tree_leaves(bundle.batch_stats))
    leaves = ([bundle.post.mu, bundle.post.rho] + [v for _, v in det]
              + [v for _, v in stats])

    def unflatten(state_leaves):
        det_tree, stats_tree = {}, {}
        rest = list(state_leaves[2:])
        for (path, _), v in zip(det, rest[:len(det)]):
            _tree_set(det_tree, path, v)
        for (path, _), v in zip(stats, rest[len(det):]):
            _tree_set(stats_tree, path, v)
        return (PackedPosterior(state_leaves[0], state_leaves[1], det_tree),
                stats_tree)

    return [t.detach() for t in leaves], unflatten


def export_predict_artifact(bundle, out_dir: str, *, batch_size,
                            num_mc_samples: int, image_size: int = 256,
                            mc_chunk: Optional[int] = None,
                            mode: str = "mc",
                            dvp_on_excess: str = "mc",
                            data_shards: int = 1,
                            mc_shards: int = 1,
                            platforms: Optional[Sequence[str]] = None,
                            class_names: Optional[Sequence[str]] = None,
                            fast_sampling: Optional[bool] = None,
                            bn_mode: str = "train",
                            seed: int = 0) -> str:
    """Export the packed predict step + state for ``bundle`` to ``out_dir``,
    on the bundle's device.

    ``batch_size`` is static by default: serve ragged tails by padding +
    the validity ``mask``, as the in-process serving loop does. Pass
    ``batch_size="poly"`` for a batch-polymorphic artifact
    (``torch.export.Dim``): one artifact serves any batch size.
    ``platforms``: None, or the bundle's device type alone (the program is
    traced where it will run).

    ``mode="dvp"`` exports the single-pass DVP logits function
    (engine/moment.py) as the chunk program: it returns all
    ``num_mc_samples`` draws' logits in one call, so the loader serves it
    as one chunk, with the same ABI. The guardrail runs at export: if the
    posterior spread exceeds the validated regime, ``dvp_on_excess``
    decides (default "mc": the artifact holds the exact MC program). The
    mode exported and the spread are recorded in meta.json.
    ``data_shards`` / ``mc_shards`` > 1 are not ported yet and raise,
    naming their ROADMAP item."""
    from multimodal_auv_torch.engine.predict import (
        _default_chunk,
        fused_outputs,
        make_packed_logits_fn,
    )

    if mode not in ("mc", "dvp"):
        raise ValueError(f"mode must be 'mc' or 'dvp', got {mode!r}")
    if mc_shards > 1 and mode != "mc":
        raise ValueError("mc_shards > 1 requires mode='mc' (DVP's trunk "
                         "pass has no MC-draw axis to shard)")
    if data_shards > 1 or mc_shards > 1:
        raise NotImplementedError(
            "data_shards / mc_shards > 1 (sharded artifacts) is not ported "
            "yet: ROADMAP.md, Open items, 1 'Modules to port' item 8 "
            "(parallel)")
    dev = bundle.device
    if platforms and list(platforms) != [dev.type]:
        raise ValueError(f"platforms {list(platforms)}: the program is traced "
                         f"on the bundle's device and runs there, "
                         f"[{dev.type!r}]")
    leaves, unflatten = _flatten_state(bundle)
    if any(t.dtype != torch.float32 for t in leaves):
        raise ValueError("the state's leaves must be f32")
    exported_mode, spread = mode, None
    if mode == "dvp":
        from multimodal_auv_torch.engine.moment import (
            make_dvp_predict_step,
            posterior_spread,
        )

        spread = posterior_spread(bundle.post, bundle.meta)
        step, exported_mode = make_dvp_predict_step(
            bundle, num_mc_samples, on_excess=dvp_on_excess,
            packed_inputs=True, mc_chunk=mc_chunk, return_mode=True,
            spread=spread)
    if exported_mode == "dvp":
        logits_fn, logits_dtype = step.logits_fn, torch.float32
        mc_chunk = num_mc_samples
    else:
        mc_chunk = _default_chunk(num_mc_samples, mc_chunk)
        if num_mc_samples % mc_chunk:
            raise ValueError(f"num_mc_samples {num_mc_samples} must be "
                             f"divisible by mc_chunk {mc_chunk}")
        logits_fn = make_packed_logits_fn(bundle, mc_chunk=mc_chunk,
                                          fast_sampling=fast_sampling,
                                          bn_mode=bn_mode)
        logits_dtype = bundle.module.dtype

    class ChunkProgram(torch.nn.Module):
        def forward(self, state_leaves, u8_inputs, seeds, mask):
            post, batch_stats = unflatten(state_leaves)
            return logits_fn(post, batch_stats, u8_inputs, seeds, mask)

    class ReduceProgram(torch.nn.Module):
        def forward(self, logits):
            return fused_outputs(logits)

    s = int(image_size)
    poly = batch_size == "poly"
    b = 2 if poly else int(batch_size)
    u8 = tuple(torch.zeros((b, s, s, c), dtype=torch.uint8, device=dev)
               for c in (3, 3, 1))
    seeds = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    mask = torch.ones((b,), dtype=torch.float32, device=dev)
    num_classes = bundle.module.num_classes
    logits = torch.zeros((num_mc_samples, b, num_classes),
                         dtype=logits_dtype, device=dev)
    chunk_dims = reduce_dims = None
    if poly:
        batch = torch.export.Dim("batch", min=1)
        chunk_dims = ([None] * len(leaves), ({0: batch},) * 3, None,
                      {0: batch})
        reduce_dims = ({1: batch},)
    with torch.no_grad():
        program = torch.export.export(ChunkProgram(), (leaves, u8, seeds, mask),
                                      dynamic_shapes=chunk_dims, strict=False)
        reduce = torch.export.export(ReduceProgram(), (logits,),
                                     dynamic_shapes=reduce_dims, strict=False)
    # torch.export.save would write the example inputs into the file: the
    # whole state, on the export device, loaded back with the program
    program.example_inputs = reduce.example_inputs = None

    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _PROGRAM))
    torch.export.save(reduce, os.path.join(out_dir, _REDUCE))
    np.savez(os.path.join(out_dir, _STATE),
             **{f"leaf_{i:05d}": t.cpu().numpy() for i, t in enumerate(leaves)})
    digests = {name: _sha256(os.path.join(out_dir, name))
               for name in (_PROGRAM, _REDUCE, _STATE)}
    meta = {
        "version": ARTIFACT_VERSION,
        "batch_size": "poly" if poly else b,
        "image_size": s,
        "num_mc_samples": num_mc_samples,
        "num_state_leaves": len(leaves),
        "num_classes": num_classes,
        "class_names": list(class_names) if class_names else None,
        "platforms": [dev.type],
        "seed": seed,
        "mode": exported_mode,
        # None = resolved at trace time (engine/mc.py::_resolve_fast); the
        # choice is traced into the program, so it is made at export
        "fast_sampling": fast_sampling,
        # "train" = the reference's BN in train mode at inference; "eval" =
        # frozen running statistics
        "bn_mode": bn_mode,
        "posterior_spread": (None if spread is None
                             else round(float(spread), 6)),
        "data_shards": int(data_shards),
        "mc_shards": int(mc_shards),
        "sha256": digests,
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    logger.info("Exported serving artifact to %s (mode=%s, platforms=%s, "
                "batch=%s, mc=%d in chunks of %d, %d state leaves)", out_dir,
                exported_mode, meta["platforms"], batch_size, num_mc_samples,
                mc_chunk, len(leaves))
    return out_dir


def _to_device(a, dtype, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the device's queue: a
    pinned copy sent asynchronously."""
    t = torch.as_tensor(np.ascontiguousarray(a, dtype=dtype))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


class ServingArtifact:
    """A loaded serving artifact: ``predict`` runs the exported programs.

    Needs only torch, numpy and the port's ops at load time: the model is
    in the exported graphs."""

    def __init__(self, program, reduce, state_leaves, meta: dict,
                 device: torch.device):
        self._program = program.module()
        self._reduce = reduce.module()
        self._leaves = state_leaves
        self.meta = meta
        self.device = device
        b = meta["batch_size"]
        self.batch_size = b if b == "poly" else int(b)
        self.image_size = int(meta["image_size"])
        self.mode = meta.get("mode", "mc")
        # the chunk program's draws per call: its output's first dimension
        out = next(n for n in program.graph.nodes if n.op == "output")
        self.mc_chunk = int(out.args[0][0].meta["val"].shape[0])
        self.nchunks = int(meta["num_mc_samples"]) // self.mc_chunk
        self._num_calls = 0  # fresh-draw counter for key=None predict()

    @classmethod
    def load(cls, artifact_dir: str, *, device: DeviceLike = None,
             verify_integrity: bool = True) -> "ServingArtifact":
        """``device``: None = the card; it must be of the type the artifact
        was exported on (``meta["platforms"]``)."""
        dev = resolve_device(device)
        with open(os.path.join(artifact_dir, _META)) as f:
            meta = json.load(f)
        if meta.get("version") != ARTIFACT_VERSION:
            raise ValueError(
                f"serving artifact version {meta.get('version')} != "
                f"supported {ARTIFACT_VERSION}")
        if (int(meta.get("data_shards", 1)) > 1
                or int(meta.get("mc_shards", 1)) > 1):
            raise NotImplementedError(
                "sharded artifacts are not ported yet: ROADMAP.md, Open "
                "items, 1 'Modules to port' item 8 (parallel)")
        if [dev.type] != list(meta.get("platforms") or []):
            raise ValueError(
                f"artifact exported for {meta.get('platforms')}, asked to "
                f"load on {dev}: its program was traced on that device "
                f"(pass device=...)")
        if verify_integrity and meta.get("sha256"):
            # a truncated copy or a bit-rotted state file would otherwise
            # serve wrong predictions without an error
            for name, want in meta["sha256"].items():
                got = _sha256(os.path.join(artifact_dir, name))
                if got != want:
                    raise ValueError(
                        f"artifact integrity check failed for {name}: "
                        f"sha256 {got[:16]}... != recorded {want[:16]}... "
                        f"(re-export, or load with verify_integrity=False "
                        f"to debug)")
        program = torch.export.load(os.path.join(artifact_dir, _PROGRAM))
        reduce = torch.export.load(os.path.join(artifact_dir, _REDUCE))
        npz = np.load(os.path.join(artifact_dir, _STATE))
        leaves = [torch.from_numpy(npz[f"leaf_{i:05d}"]).to(dev)
                  for i in range(int(meta["num_state_leaves"]))]
        return cls(program, reduce, leaves, meta, dev)

    def _validate(self, main_u8, bathy_u8, sss_u8):
        b = (np.shape(main_u8)[0] if self.batch_size == "poly"
             else self.batch_size)
        for name, a, ch in (("main", main_u8, 3), ("bathy", bathy_u8, 3),
                            ("sss", sss_u8, 1)):
            a = np.asarray(a)
            if a.shape != (b, self.image_size, self.image_size, ch):
                raise ValueError(
                    f"{name} batch shape {a.shape} != artifact's "
                    f"({b}, {self.image_size}, {self.image_size}, {ch})")
            if a.dtype != np.uint8:
                raise ValueError(f"{name} batch must be uint8, got {a.dtype}")

    def seeds_for(self, key) -> torch.Tensor:
        """The (nchunks, 2) seed words of a call, on the host: ``key`` an
        int (the seed of a ``torch.Generator``) or a ``torch.Generator``
        (drawn from, as the in-process step draws)."""
        if isinstance(key, (int, np.integer)):
            key = torch.Generator().manual_seed(int(key))
        if not isinstance(key, torch.Generator):
            raise ValueError(f"key: an int seed or a torch.Generator, got "
                             f"{type(key).__name__}")
        return chunk_seed_words(key, self.nchunks)

    @torch.inference_mode()
    def call(self, state_leaves, u8_inputs, seeds: torch.Tensor,
             mask) -> torch.Tensor:
        """The artifact's ABI, ``(state_leaves, (main_u8, bathy_u8,
        sss_u8), seeds, mask) -> (3 + C, batch)`` f32, on device tensors
        (``seeds``: the (nchunks, 2) words): the chunk program once per row
        of ``seeds``, then the reduction. Returns without waiting for the
        device."""
        logits = [self._program(state_leaves, u8_inputs, seeds[k:k + 1], mask)
                  for k in range(seeds.shape[0])]
        return self._reduce(torch.cat(logits))

    def _dispatch(self, main_u8, bathy_u8, sss_u8, key, mask):
        """Run one batch, returning the device-resident fused output
        (3 + C, batch): no host fetch."""
        self._validate(main_u8, bathy_u8, sss_u8)
        if key is None:
            # fresh MC draws per call: a per-artifact call counter folded
            # into the export seed. Reusing one seed would score every
            # batch of a survey with the same weight samples. Pass an
            # explicit key for reproducibility.
            key = fold_seed(int(self.meta.get("seed", 0)), self._num_calls)
            self._num_calls += 1
        if mask is None:
            mask = np.ones((np.shape(main_u8)[0],), np.float32)
        dev = self.device
        u8 = tuple(_to_device(a, np.uint8, dev)
                   for a in (main_u8, bathy_u8, sss_u8))
        return self.call(self._leaves, u8,
                         _to_device(self.seeds_for(key), np.int64, dev),
                         _to_device(mask, np.float32, dev))

    @staticmethod
    def _unpack(fused) -> dict:
        """One device-to-host copy, then the fused rows unpacked."""
        f = fused.cpu().numpy()
        return {
            "predicted": f[0].astype(np.int32),
            "predictive_uncertainty": f[1],
            "aleatoric_uncertainty": f[2],
            "mean_prob": f[3:].T,
            "csv_cols": f[:3],
        }

    def predict(self, main_u8, bathy_u8, sss_u8, *, key=None, mask=None):
        """Run one batch. Inputs are uint8 NHWC host arrays of the
        artifact's batch size (pad + mask a ragged tail; any size if the
        artifact is batch-polymorphic). Returns a dict of numpy arrays
        (predicted class, both uncertainties, mean softmax, fused
        csv_cols), fetched in one device-to-host copy. With ``key=None``
        each call folds a per-artifact counter into the export seed
        (``fold_seed``), so repeated calls draw fresh MC weight samples
        (call i matches ``predict_batches``'s batch i); pass a key (see
        ``seeds_for``) to reproduce a draw."""
        return self._unpack(self._dispatch(main_u8, bathy_u8, sss_u8,
                                           key, mask))

    def predict_async(self, main_u8, bathy_u8, sss_u8, *, key=None,
                      mask=None):
        """Dispatch one batch without waiting for the result: returns an
        opaque handle (the device tensor); pass it to ``fetch``. A
        multi-threaded host (serve_http.py) holds its lock only for the
        dispatch, so request k+1's compute overlaps request k's copy to
        the host."""
        return self._dispatch(main_u8, bathy_u8, sss_u8, key, mask)

    def fetch(self, handle):
        """Wait for a ``predict_async`` handle; one device-to-host copy,
        the same dict as ``predict``."""
        return self._unpack(handle)

    def predict_batches(self, batches, *, key: Optional[int] = None):
        """Serve a stream: iterate ``(main_u8, bathy_u8, sss_u8)`` or
        ``(main_u8, bathy_u8, sss_u8, mask)`` tuples, yielding one output
        dict (numpy) per batch in order, with the fetch lagged one batch:
        batch k+1 is dispatched before batch k's copy to the host, so the
        copy overlaps device work. Batch i draws with the seed
        ``fold_seed(key, i)`` (``key``: an int, default the export seed),
        computed on the host."""
        key = int(self.meta.get("seed", 0)) if key is None else int(key)
        prev = None
        for i, batch in enumerate(batches):
            mask = batch[3] if len(batch) == 4 else None
            out = self._dispatch(batch[0], batch[1], batch[2],
                                 fold_seed(key, i), mask)
            if prev is not None:
                yield self._unpack(prev)
            prev = out
        if prev is not None:
            yield self._unpack(prev)


def load_predict_artifact(artifact_dir: str, *,
                          device: DeviceLike = None) -> ServingArtifact:
    return ServingArtifact.load(artifact_dir, device=device)
