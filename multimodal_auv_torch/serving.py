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

``mc_shards=M`` (the JAX package's MC-ensemble sharding): M devices each
run mc_chunk / M draws of every chunk of the same batch, on the stacked
sampler (f32 noise), and the estimators are reduced over all the draws.
Train-mode BN normalises within each draw over the whole batch, so a
shard's program holds no collective: the program is one shard's, the
same for every shard, drawing its rows through ``auv::stacked_sampler``
from its seeds input and running their forwards as one ``map`` over the
rows (``engine/mc.py::stacked_mc_logits``: one draw's graph, not one per
row). The loader hands shard m of chunk k the chunk's words with the
shard's first row folded in (``draw_offset_seed``), runs the program once
per shard and chunk on the shard's device, gathers the logits on the
first device in chunk and shard order, and runs the reduction once: the
draws and their order are the one-process stacked path's, so the logits
equal it bit for bit.

``data_shards=N`` (the JAX package's batch sharding): N devices each run
b / N rows of every batch. Train-mode BN normalises over the whole batch,
so every BN layer needs the sum of the shards' statistics, which JAX's
SPMD program holds as a collective and a ``torch.export`` program cannot.
The exported program is one data shard's, traced at b / N rows under
``bn_sync(local_shards(N))``: each BN layer's sums go through the op
``auv::shard_sum`` (``parallel/local_shards.py``). The loader starts N
worker threads, one per data shard; on each call worker d takes rows
[d b / N, (d + 1) b / N) of the inputs and the mask, runs the program for
every seed row in ``seeds_for``'s order (the same on every worker) under
its shard context, and the op sums the N shards' statistics in shard
order at each BN layer. The logits are gathered on the first device along
the batch in shard order, and reduced once. With ``mc_shards=M`` as well
the program is the mc shard's (the op inside its ``map`` body) and runs
on N x M devices, data shard d's mc shard m on device d M + m (the order
of JAX's ``Mesh(devices.reshape(data, mc))``); the data shards of one mc
column draw from the same seed row, so the same weights. On one card the
shards share the card: the layout checks the semantics, it does not
scale.

The DVP program with ``data_shards=N`` is one data shard's DVP logits
function (engine/moment.py) over a local-shards mesh
(``parallel/mesh.py::local_shards_mesh``), traced at b / N rows under
``bn_sync(local_shards(N))``: its moment BN sums go through
``auv::shard_sum``; it gathers the shards' pooled feature moments with
``auv::shard_gather``, draws every row's features and head weights with
one split-sampler call from the one seed row (the same draws on every
shard), runs the head on the whole batch and keeps its own rows with
``auv::shard_rows``, whose index is the worker thread's shard. The
loader runs it as any data-sharded program, one chunk of all the draws.

The program is traced on the device that will serve it: ops that build
tensors bake that device into the graph, so the loader refuses a device
other than the one in ``meta["platforms"]``, and moves the program to
each other card a sharded artifact is loaded on.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import queue
import threading
import weakref
from typing import Optional, Sequence

import numpy as np
import torch

from multimodal_auv_torch.device import DeviceLike, resolve_device
# also registers torch.ops.auv.split_sampler and auv::stacked_sampler,
# which the programs call
from multimodal_auv_torch.ops.sampling import (
    chunk_seed_words,
    draw_offset_seed,
)
# also registers torch.ops.auv.shard_sum, shard_gather and shard_rows,
# which data-sharded programs call
from multimodal_auv_torch.parallel.collectives import bn_sync, local_shards
from multimodal_auv_torch.parallel.local_shards import (
    DEFAULT_TIMEOUT,
    ShardGroup,
    Turn,
    shard_context,
)
from multimodal_auv_torch.utils.profiling import span

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

    ``mc_shards=M`` exports one shard's program: mc_chunk / M draws of the
    stacked sampler (f32 noise, ``fast_sampling`` does not reach it), the
    loader running it on M devices (module docstring). Exact MC only, a
    static ``batch_size``; ``mc_chunk`` defaults to all the draws (one
    stack, split over the shards) and must divide by M, as must
    ``num_mc_samples``.

    ``data_shards=N`` exports one data shard's program over batch_size / N
    rows, its BN statistics summed over the shards by ``auv::shard_sum``
    (module docstring); the loader runs it on N devices (N x M with
    ``mc_shards``). A static ``batch_size`` divisible by N; with
    ``bn_mode="eval"`` the program holds no op (no batch statistics). The
    DVP program also gathers the shards' feature moments
    (``auv::shard_gather``) and keeps its own rows of the whole batch's
    logits (``auv::shard_rows``); an MC fallback of the guardrail exports
    as an MC data-sharded program."""
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
    if mc_shards > 1 and num_mc_samples % mc_shards:
        raise ValueError(f"num_mc_samples {num_mc_samples} must be "
                         f"divisible by mc_shards {mc_shards}")
    if mc_shards > 1:
        if mc_chunk is None:
            mc_chunk = num_mc_samples  # one stack of all draws, sharded
        if mc_chunk % mc_shards:
            raise ValueError(f"mc_chunk {mc_chunk} must be divisible by "
                             f"mc_shards {mc_shards}")
    if data_shards < 1 or mc_shards < 1:
        raise ValueError(f"data_shards {data_shards} and mc_shards "
                         f"{mc_shards} must be at least 1")
    if (data_shards > 1 or mc_shards > 1) and batch_size == "poly":
        raise ValueError("sharded export requires a static batch_size "
                         "(the per-device shard shape must be static)")
    if batch_size != "poly" and int(batch_size) % data_shards:
        raise ValueError(f"batch_size {int(batch_size)} must be divisible "
                         f"by data_shards {data_shards}")
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
        _, exported_mode = make_dvp_predict_step(
            bundle, num_mc_samples, on_excess=dvp_on_excess,
            packed_inputs=True, mc_chunk=mc_chunk, return_mode=True,
            spread=spread)
    if exported_mode == "dvp":
        from multimodal_auv_torch.engine.moment import make_dvp_logits_fn
        from multimodal_auv_torch.parallel.mesh import local_shards_mesh

        # data shards: the feature gathers and the own-rows slice meet the
        # shards' threads
        logits_fn = make_dvp_logits_fn(
            bundle, num_mc_samples, packed_inputs=True,
            mesh=local_shards_mesh(data_shards) if data_shards > 1 else None)
        logits_dtype = torch.float32
        mc_chunk = num_mc_samples
    else:
        mc_chunk = _default_chunk(num_mc_samples, mc_chunk)
        if num_mc_samples % mc_chunk:
            raise ValueError(f"num_mc_samples {num_mc_samples} must be "
                             f"divisible by mc_chunk {mc_chunk}")
        if mc_shards > 1:
            logits_fn = _shard_logits_fn(bundle, mc_chunk // mc_shards,
                                         bn_mode)
            fast_sampling = False  # the stacked sampler's f32 noise
        else:
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
    rows = b // data_shards  # one data shard's rows
    u8 = tuple(torch.zeros((rows, s, s, c), dtype=torch.uint8, device=dev)
               for c in (3, 3, 1))
    seeds = torch.zeros((1, 2), dtype=torch.int64, device=dev)
    mask = torch.ones((rows,), dtype=torch.float32, device=dev)
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
        # a data shard's BN sums: one auv::shard_sum per BN call (DVP's
        # gathers and own rows on the same axis)
        with bn_sync(local_shards(data_shards) if data_shards > 1 else None):
            program = torch.export.export(
                ChunkProgram(), (leaves, u8, seeds, mask),
                dynamic_shapes=chunk_dims, strict=False)
        reduce = torch.export.export(ReduceProgram(), (logits,),
                                     dynamic_shapes=reduce_dims, strict=False)
    # torch.export.save would write the example inputs into the file: the
    # whole state, on the export device, loaded back with the program
    program.example_inputs = reduce.example_inputs = None
    _drop_stack_traces(program)

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
        # the programs are torch.export's serialisation, which another
        # torch release may not read alike (the loader refuses it)
        "torch_version": torch.__version__,
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    logger.info("Exported serving artifact to %s (mode=%s, platforms=%s, "
                "batch=%s over %d data shards, mc=%d in chunks of %d over %d "
                "mc shards, %d state leaves)", out_dir, exported_mode,
                meta["platforms"], batch_size, data_shards, num_mc_samples,
                mc_chunk, mc_shards, len(leaves))
    return out_dir


def _shard_logits_fn(bundle, rows: int, bn_mode: str):
    """One mc shard's logits function over uint8 NHWC batches: ``rows``
    draws of the stacked sampler (f32 noise) per row of ``seeds``
    (``engine/mc.py::stacked_mc_logits``), bf16 weights as the packed
    predict step samples them."""
    from multimodal_auv_torch.engine.mc import stacked_mc_logits
    from multimodal_auv_torch.engine.predict import _check_bn_mode
    from multimodal_auv_torch.ops.preprocess import normalize_multimodal

    _check_bn_mode(bn_mode, False)

    def logits_fn(post, batch_stats, u8_inputs, seeds, mask):
        return stacked_mc_logits(
            bundle.module, bundle.meta, post, batch_stats,
            normalize_multimodal(*u8_inputs), seeds, rows=rows,
            train=(bn_mode == "train"), sample_dtype=torch.bfloat16,
            batch_mask=mask)

    return logits_fn


def _drop_stack_traces(program) -> None:
    """Drop each node's source stack trace, which the serialised program
    would keep: a ``map`` body's nodes each quote the whole ``map`` call
    with its hundreds of state operands, most of an mc-sharded program's
    file."""
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for node in gm.graph.nodes:
                node.meta.pop("stack_trace", None)


def _release(version: str) -> str:
    """A torch version without its local build tag ("2.5.1+cu124")."""
    return version.split("+")[0]


def _indexed(dev: torch.device) -> torch.device:
    """``dev`` with its index: a bare "cuda" is the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _shard_devices(device: DeviceLike, devices, mc_shards: int,
                   data_shards: int = 1):
    """The shards' devices, data shard d's mc shard m at index d M + m:
    ``devices`` as given (one per shard; one device may serve several
    shards), else data_shards x mc_shards consecutive cards from
    ``device``'s (ValueError when fewer are visible; an unsharded
    artifact: ``device`` alone)."""
    n = data_shards * mc_shards
    if devices is not None:
        if device is not None:
            raise ValueError("pass device= or devices=, not both")
        devs = [_indexed(resolve_device(d)) for d in devices]
        if len(devs) != n:
            raise ValueError(f"devices: one per mc shard of each data shard "
                             f"({data_shards} x {mc_shards} = {n}), got "
                             f"{len(devs)}")
        return devs
    dev = _indexed(resolve_device(device))
    if n == 1:
        return [dev]
    visible = torch.cuda.device_count() if dev.type == "cuda" else 1
    first = dev.index or 0
    if visible - first < n:
        raise ValueError(f"{data_shards} x {mc_shards} (data x mc) shards "
                         f"but only {visible - first} {dev.type} devices are "
                         f"visible from {dev} (pass devices=, which may "
                         f"repeat one)")
    return [torch.device(dev.type, first + i) if dev.type == "cuda" else dev
            for i in range(n)]


def _to_device(a, dtype, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev`` without waiting for the device's queue: a
    pinned copy sent asynchronously."""
    with span("auv.place"):
        t = torch.as_tensor(np.ascontiguousarray(a, dtype=dtype))
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t


class _ShardWorkers:
    """One daemon thread per data shard. ``run(fn)`` calls ``fn(d)`` on
    worker d, each under ``torch.inference_mode`` (thread-local, as the
    current card is), and returns the N results in shard order once every
    worker has finished; a worker that raises calls ``on_error`` at once
    (which breaks the shards' barriers), and the call then raises the
    first shard's error that is not a broken barrier."""

    def __init__(self, n: int):
        self._tasks = [queue.Queue() for _ in range(n)]
        self._threads = [threading.Thread(target=self._loop, args=(q,),
                                          name=f"auv-data-shard-{d}",
                                          daemon=True)
                         for d, q in enumerate(self._tasks)]
        for t in self._threads:
            t.start()

    @staticmethod
    def _loop(tasks: "queue.Queue") -> None:
        while True:
            item = tasks.get()
            if item is None:
                return
            fn, d, on_error, done = item
            try:
                with torch.inference_mode():
                    done.put((d, fn(d), None))
            except BaseException as e:  # noqa: BLE001 - handed to the caller
                on_error()
                done.put((d, None, e))

    def run(self, fn, on_error):
        done: "queue.Queue" = queue.Queue()
        for d, tasks in enumerate(self._tasks):
            tasks.put((fn, d, on_error, done))
        results, errors = [None] * len(self._tasks), []
        for _ in self._tasks:
            d, out, err = done.get()
            results[d] = out
            if err is not None:
                errors.append((d, err))
        if errors:
            errors.sort(key=lambda e: e[0])
            first = next((e for _, e in errors
                          if not isinstance(e, threading.BrokenBarrierError)),
                         errors[0][1])
            raise first
        return results

    def close(self) -> None:
        """Stop the workers: each ends after its current task."""
        for tasks in self._tasks:
            tasks.put(None)
        for t in self._threads:
            t.join(timeout=10)


def _on_card(dev: torch.device):
    """``dev`` made this thread's current card (no-op on the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class ServingArtifact:
    """A loaded serving artifact: ``predict`` runs the exported programs.

    Needs only torch, numpy and the port's ops at load time: the model is
    in the exported graphs. ``devices``: the shards' devices, data shard
    d's mc shard m at index d * mc_shards + m (one, the artifact's
    ``device``, when it is not sharded); ``programs`` and ``state_leaves``
    map each distinct one to the chunk program and the state there. A
    data-sharded artifact starts one worker thread per data shard;
    ``close`` stops them (a later call starts them again).
    ``shard_timeout``: seconds a data shard waits for the others at one
    rendezvous (``local_shards.DEFAULT_TIMEOUT``)."""

    def __init__(self, programs: dict, reduce, state_leaves: dict,
                 meta: dict, devices):
        self.devices = list(devices)
        self.device = self.devices[0]
        self._programs = {d: p.module() for d, p in programs.items()}
        self._reduce = reduce.module()
        self._state = state_leaves
        self._leaves = state_leaves[self.device]
        self.meta = meta
        b = meta["batch_size"]
        self.batch_size = b if b == "poly" else int(b)
        self.image_size = int(meta["image_size"])
        self.mode = meta.get("mode", "mc")
        self.data_shards = int(meta.get("data_shards", 1))
        self.mc_shards = int(meta.get("mc_shards", 1))
        self.shard_timeout = DEFAULT_TIMEOUT
        # the chunk program's draws per call (one shard's): its output's
        # first dimension
        program = programs[self.device]
        out = next(n for n in program.graph.nodes if n.op == "output")
        self.shard_rows = int(out.args[0][0].meta["val"].shape[0])
        self.mc_chunk = self.shard_rows * self.mc_shards
        self.nchunks = int(meta["num_mc_samples"]) // self.mc_chunk
        self._num_calls = 0  # fresh-draw counter for key=None predict()
        self._workers = None
        if self.data_shards > 1:
            self._start_workers()

    def _start_workers(self) -> "_ShardWorkers":
        if self._workers is None:
            self._workers = _ShardWorkers(self.data_shards)
            # idle workers end with the artifact
            self._finalizer = weakref.finalize(self, self._workers.close)
        return self._workers

    def close(self) -> None:
        """Stop the data shards' workers (nothing else to release)."""
        if self._workers is not None:
            self._finalizer.detach()
            self._workers.close()
            self._workers = None

    @classmethod
    def load(cls, artifact_dir: str, *, device: DeviceLike = None,
             devices=None, verify_integrity: bool = True
             ) -> "ServingArtifact":
        """``device``: None = the card; it must be of the type the artifact
        was exported on (``meta["platforms"]``). A sharded artifact runs
        its data_shards x mc_shards shards on as many consecutive cards
        from ``device``'s, or on ``devices`` instead (one per shard, data
        shard d's mc shard m at index d * mc_shards + m, repeats allowed).
        The torch release must be the exporter's."""
        # a missing card raises before anything is read
        resolve_device(device if devices is None else devices[0])
        with open(os.path.join(artifact_dir, _META)) as f:
            meta = json.load(f)
        if meta.get("version") != ARTIFACT_VERSION:
            raise ValueError(
                f"serving artifact version {meta.get('version')} != "
                f"supported {ARTIFACT_VERSION}")
        exported = meta.get("torch_version", "(not recorded)")
        if _release(exported) != _release(torch.__version__):
            raise ValueError(
                f"serving artifact exported with torch {exported}, loading "
                f"with torch {torch.__version__}: its programs are "
                f"torch.export's serialisation, read only by the release "
                f"that wrote it (re-export with this torch)")
        devs = _shard_devices(device, devices, int(meta.get("mc_shards", 1)),
                              int(meta.get("data_shards", 1)))
        for dev in devs:
            if [dev.type] != list(meta.get("platforms") or []):
                raise ValueError(
                    f"artifact exported for {meta.get('platforms')}, asked "
                    f"to load on {dev}: its program was traced on that "
                    f"device (pass device=...)")
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
        programs, state = {}, {}
        npz = np.load(os.path.join(artifact_dir, _STATE))
        host = [torch.from_numpy(npz[f"leaf_{i:05d}"])
                for i in range(int(meta["num_state_leaves"]))]
        for dev in dict.fromkeys(devs):
            program = torch.export.load(os.path.join(artifact_dir, _PROGRAM))
            if programs:
                # traced on the first device: another card's copy makes
                # its tensors there
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, dev)
            programs[dev] = program
            state[dev] = [t.to(dev) for t in host]
        reduce = torch.export.load(os.path.join(artifact_dir, _REDUCE))
        return cls(programs, reduce, state, meta, devs)

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
        """The seed words of a call, on the host: ``key`` an int (the seed
        of a ``torch.Generator``) or a ``torch.Generator`` (drawn from, as
        the in-process step draws). (nchunks, 2) chunk words; for an
        mc-sharded artifact the rows the program takes, (nchunks *
        mc_shards, 2), chunk k's shard m in row k * mc_shards + m
        (``shard_seeds``)."""
        if isinstance(key, (int, np.integer)):
            key = torch.Generator().manual_seed(int(key))
        if not isinstance(key, torch.Generator):
            raise ValueError(f"key: an int seed or a torch.Generator, got "
                             f"{type(key).__name__}")
        return self.shard_seeds(chunk_seed_words(key, self.nchunks))

    def shard_seeds(self, words: torch.Tensor) -> torch.Tensor:
        """The program's seed rows of (nchunks, 2) chunk words: shard m of
        chunk k draws rows [m k', (m + 1) k') of the chunk (k' the
        program's draws), so its words are the chunk's with m k' draws
        folded in (``draw_offset_seed`` over the packed size). Unsharded:
        ``words`` as they are."""
        if self.mc_shards == 1:
            return words
        P = int(self._leaves[0].shape[0])
        return torch.tensor(
            [draw_offset_seed(w, m * self.shard_rows, P)
             for w in words.tolist() for m in range(self.mc_shards)],
            dtype=torch.int64)

    @torch.inference_mode()
    def logits(self, state_leaves, u8_inputs, seeds: torch.Tensor,
               mask) -> torch.Tensor:
        """The (num_mc, batch, C) logits on the first device: the chunk
        program once per row of ``seeds`` (``seeds_for``'s rows, on the
        first device), row i on shard i % mc_shards's device (with its
        copy of the state and of the inputs, ``state_leaves`` standing for
        the first device's), gathered in row order; a data-sharded
        artifact's rows of each data shard on its worker
        (``_data_sharded_logits``)."""
        if self.data_shards > 1:
            return self._data_sharded_logits(state_leaves, u8_inputs, seeds,
                                             mask)
        placed = {self.device: (state_leaves, u8_inputs, seeds, mask)}
        out = []
        for i in range(seeds.shape[0]):
            dev = self.devices[i % self.mc_shards]
            if dev not in placed:
                placed[dev] = (self._state[dev],
                               tuple(a.to(dev) for a in u8_inputs),
                               seeds.to(dev), mask.to(dev))
            leaves, u8, sd, m = placed[dev]
            out.append(self._programs[dev](leaves, u8, sd[i:i + 1], m)
                       .to(self.device))
        return torch.cat(out)

    def _data_sharded_logits(self, state_leaves, u8_inputs, seeds, mask):
        """``logits`` of a data-sharded artifact: worker d runs the program
        on its b / N rows for every row i of ``seeds`` in order, on device
        d * mc_shards + i % mc_shards, as shard d of mc column i %
        mc_shards's group (the op ``auv::shard_sum`` sums the column's N
        shards' BN statistics; a DVP program's ``auv::shard_gather`` and
        ``auv::shard_rows`` meet in the same group and read the same
        index); the logits are gathered on the first device along the
        batch in shard order. The workers' Python runs in turns
        (``local_shards.Turn``)."""
        N, M = self.data_shards, self.mc_shards
        rows = u8_inputs[0].shape[0] // N
        groups = [ShardGroup(N, self.shard_timeout) for _ in range(M)]
        turn = Turn(self.shard_timeout)

        def shard(d):
            own = slice(d * rows, (d + 1) * rows)
            placed, out = {}, []
            turn.take()
            try:
                for i in range(seeds.shape[0]):
                    dev = self.devices[d * M + i % M]
                    if dev not in placed:
                        leaves = (state_leaves if dev == self.device
                                  else self._state[dev])
                        placed[dev] = (
                            leaves, tuple(a[own].to(dev) for a in u8_inputs),
                            seeds.to(dev), mask[own].to(dev))
                    leaves, u8, sd, m = placed[dev]
                    with _on_card(dev), shard_context(groups[i % M], d, turn):
                        out.append(self._programs[dev](leaves, u8,
                                                       sd[i:i + 1], m)
                                   .to(self.device))
            finally:
                turn.give()
            return out

        def abort():
            for g in groups:
                g.abort()

        parts = self._start_workers().run(shard, abort)
        return torch.cat([torch.cat([p[i] for p in parts], dim=1)
                          for i in range(seeds.shape[0])])

    @torch.inference_mode()
    def call(self, state_leaves, u8_inputs, seeds: torch.Tensor,
             mask) -> torch.Tensor:
        """The artifact's ABI, ``(state_leaves, (main_u8, bathy_u8,
        sss_u8), seeds, mask) -> (3 + C, batch)`` f32, on device tensors
        (``seeds``: the (nchunks, 2) words, an mc-sharded artifact's rows
        per shard, ``seeds_for``): ``logits``, then the reduction. Returns
        without waiting for the device."""
        return self._reduce(self.logits(state_leaves, u8_inputs, seeds,
                                        mask))

    def _inputs(self, main_u8, bathy_u8, sss_u8, key, mask):
        """One batch's device tensors: (u8 inputs, seeds, mask) on the
        first device."""
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
        return (u8, _to_device(self.seeds_for(key), np.int64, dev),
                _to_device(mask, np.float32, dev))

    def _dispatch(self, main_u8, bathy_u8, sss_u8, key, mask):
        """Run one batch, returning the device-resident fused output
        (3 + C, batch): no host fetch."""
        return self.call(self._leaves, *self._inputs(main_u8, bathy_u8,
                                                     sss_u8, key, mask))

    def predict_logits(self, main_u8, bathy_u8, sss_u8, *, key=None,
                       mask=None) -> torch.Tensor:
        """One batch's (num_mc, batch, C) logits on the first device, the
        draws of ``predict`` with the same key (no reduction)."""
        return self.logits(self._leaves, *self._inputs(main_u8, bathy_u8,
                                                       sss_u8, key, mask))

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


def load_predict_artifact(artifact_dir: str, *, device: DeviceLike = None,
                          devices=None) -> ServingArtifact:
    return ServingArtifact.load(artifact_dir, device=device, devices=devices)
