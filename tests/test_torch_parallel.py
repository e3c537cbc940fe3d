"""The parallel layer (``parallel/``, the mesh paths of the steps, the
loops and the pipelines) on the CPU: single-process checks, then two
spawned gloo process groups of two ranks each.

Each group runs ``_WORKER`` in two fresh processes (torch and the port
only: no JAX), rendezvousing at a port the parent found free by binding
port 0; every process group has a 60 s ``init_process_group`` timeout,
every process a 120 s subprocess timeout, and the processes are killed in
a ``finally``. The ranks write their results to npz files that the
parent holds against the JAX package's mesh step (8 virtual CPU devices,
tests/conftest.py) and against the port's own one-process path, at
micro() geometry and 32 px.

BatchNorm statistics must be the global batch's: the data=2 train step is
held against JAX's (and the one-process step) on the updated mu, which
the BN backward's all_reduce decides; the fused trunks' BN and DVP's
moment BN are held against their one-process outputs. A rank that took
per-rank statistics fails these.
"""
import csv
import json
import os
import shutil
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_auv_torch.ops.sampling as torch_sampling
from multimodal_auv_torch.bayes.packing import PackedPosterior
from multimodal_auv_torch.config import BNNPriorSpec, MeshSpec
from multimodal_auv_torch.data.loaders import DataLoader, HostShardLoader
from multimodal_auv_torch.data.packing import (
    HostShardPackedBatches,
    PackedTrainBatches,
)
from multimodal_auv_torch.engine.mc import chunk_seeds, mc_logits
from multimodal_auv_torch.engine.moment import make_dvp_predict_step
from multimodal_auv_torch.engine.optim import BayesTrainState, make_optimizer
from multimodal_auv_torch.engine.predict import make_packed_predict_step
from multimodal_auv_torch.engine.steps import make_train_step
from multimodal_auv_torch.interop.from_jax import from_jax
from multimodal_auv_torch.models.model_utils import ArchConfig
from multimodal_auv_torch.ops.preprocess import normalize_multimodal
from multimodal_auv_torch.ops.sampling import (
    BLOCK_ELEMS,
    chunk_seed_words,
    eps_plain,
    draw_offset_seed,
    gaussian_noise,
    seed_tensor,
    split_draws,
    stacked_plain,
)
from multimodal_auv_torch.parallel import mesh as M
from multimodal_auv_torch.parallel.distributed import host_shard_indices
from multimodal_auv_torch.pipelines.inference import run_auv_inference
from multimodal_auv_torch.pipelines.training import run_AUV_training_from_scratch
from multimodal_auv_tpu.config import BNNPriorSpec as JSpec
from multimodal_auv_tpu.config import MeshSpec as JMeshSpec
from multimodal_auv_tpu.engine.optim import BayesTrainState as JState
from multimodal_auv_tpu.engine.optim import make_optimizer as jmake_optimizer
from multimodal_auv_tpu.engine.steps import make_train_step as jmake_train_step
from multimodal_auv_tpu.models.model_utils import ArchConfig as JArch
from multimodal_auv_tpu.models.model_utils import make_multimodal_bundle as jmake
from multimodal_auv_tpu.parallel import mesh as JM
from tests.fixtures.make_tree import make_inference_tree, make_training_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_MC = 2
LR, KL_WEIGHT = 1e-3, 1e-6
SUBPROCESS_TIMEOUT = 120
# the data=2 mesh step against a data_shards=2 serving artifact: micro(),
# 3 classes, b4 x 4 MC (one draw a chunk) at 32 px, one row masked out
SERVE_CLASSES, SERVE_MC, SERVE_SEED = 3, 4, 5
SERVE_MASK = [1.0, 1.0, 1.0, 0.0]

# One rank of a spawned group: argv = group, rank, port, work directory.
_WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from multimodal_auv_torch.config import BNNPriorSpec, DistSpec, MeshSpec
from multimodal_auv_torch.parallel import mesh as M
from multimodal_auv_torch.parallel.distributed import (
    maybe_initialize_distributed)

group, rank, port, work = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
maybe_initialize_distributed(DistSpec(
    coordinator=f"127.0.0.1:{{port}}", num_processes=2, process_id=rank,
    initialization_timeout=60))


def steps():
    import multimodal_auv_torch.ops.sampling as S
    from multimodal_auv_torch.bayes.packing import PackedPosterior
    from multimodal_auv_torch.engine.mc import mc_logits
    from multimodal_auv_torch.engine.moment import make_dvp_predict_step
    from multimodal_auv_torch.engine import checkpointing as ckpt
    from multimodal_auv_torch.engine.optim import (
        BayesTrainState, ShardedAdam, full_posterior, make_optimizer)
    from multimodal_auv_torch.parallel import collectives as C
    from multimodal_auv_torch.engine.predict import make_packed_predict_step
    from multimodal_auv_torch.engine.steps import make_train_step
    from multimodal_auv_torch.models.model_utils import (
        ArchConfig, make_multimodal_bundle)
    from multimodal_auv_torch.ops.preprocess import normalize_multimodal

    saved = torch.load(os.path.join(work, "bundle.pt"), weights_only=False)
    inp = np.load(os.path.join(work, "inputs.npz"))
    eps = np.load(os.path.join(work, "eps.npz"))
    u8 = [torch.from_numpy(inp[k]) for k in ("main", "bathy", "sss")]
    labels, mask = torch.from_numpy(inp["labels"]), torch.from_numpy(
        inp["mask"])
    clone = lambda t: ({{k: clone(v) for k, v in t.items()}}
                       if isinstance(t, dict) else t.clone())

    def bundle():
        b = make_multimodal_bundle(7, BNNPriorSpec(),
                                   torch.Generator().manual_seed(0),
                                   ArchConfig.micro(), device="cpu")
        b.post = PackedPosterior(clone(saved["mu"]), clone(saved["rho"]),
                                 clone(saved["det"]))
        b.batch_stats = clone(saved["bs"])
        return b

    def fresh(mesh, fsdp):
        b = bundle()
        state = M.shard_state(mesh, BayesTrainState(b.post, None,
                                                    b.batch_stats),
                              make_optimizer({lr!r}, 1e-5), fsdp)
        step = M.wrap_train_step(mesh, make_train_step(
            b.module, b.meta, BNNPriorSpec(), {num_mc}, mc_chunk=mesh.mc,
            packed_inputs=True, mesh=mesh))
        return state, step

    def summary(state, m):
        full = full_posterior(state)
        grad = lambda t: (C.all_gather_flat(t.grad, state.opt_state.axis,
                                            full.mu.shape[0])
                          if full.mu is not state.post.mu else t.grad)
        bs = state.batch_stats["image_model_feat"]["bn1"]
        return {{"loss": m["loss"].numpy(), "fused": m["fused"].numpy(),
                "mu": full.mu.detach().numpy().copy(),
                "rho": full.rho.detach().numpy().copy(),
                "grad_mu": grad(state.post.mu).numpy().copy(),
                "grad_rho": grad(state.post.rho).numpy().copy(),
                "bs_mean": bs["mean"].numpy(),
                "exp_avg": state.opt_state.state_dict()["state"][0][
                    "exp_avg"].numpy()}}

    def train(mesh, fsdp=False):
        state, step = fresh(mesh, fsdp)
        state, m = step(state, u8, labels, mask,
                        torch.Generator().manual_seed(9), {kl!r}, 4.0)
        return state, step, m

    out = {{}}
    data2, mc2 = M.make_mesh(MeshSpec(2, 1)), M.make_mesh(MeshSpec(1, 2))
    assert data2.coords == (rank, 0) and mc2.coords == (0, rank)
    # data=2 under the JAX chunk keys' eps, with and without fsdp (the
    # fsdp one under the dedicated gloo ops); each state's checkpoint, and
    # (plain noise) one more step after restoring the other layout's
    plain = S.eps_plain
    S.eps_plain = lambda P, seed, n, device=None, noise="f32": (
        torch.from_numpy(eps["%d_%d" % tuple(seed)][:n]))
    states = {{}}
    for fsdp in (False, True):
        C.reset_counts()
        state, step, m = train(data2, fsdp)
        out[f"counts_fsdp{{int(fsdp)}}"] = np.array(
            [C.COUNTS[k] for k in ("all_reduce", "all_gather",
                                   "reduce_scatter")])
        for k, v in summary(state, m).items():
            out[f"data2_fsdp{{int(fsdp)}}_{{k}}"] = v
        out[f"rank_shape_fsdp{{int(fsdp)}}"] = np.array(
            [state.post.mu.shape[0], state.post.rho.shape[0],
             state.post.mu.grad.shape[0]])
        ckpt.save_train_state(os.path.join(work, f"ckpt_fsdp{{int(fsdp)}}.pt"),
                              state, 1, {{"multimodal": 1}})
        states[fsdp] = state
    out["rank_bounds"] = np.array(states[True].opt_state.own(
        torch.arange(states[True].opt_state.n))[[0, -1]].numpy())
    del states
    S.eps_plain = plain
    dist.barrier()  # rank 0 has written both files
    for fsdp in (False, True):
        state, step = fresh(data2, fsdp)
        state, _, _ = ckpt.restore_train_state(
            os.path.join(work, f"ckpt_fsdp{{int(not fsdp)}}.pt"), state)
        state, m = step(state, u8, labels, mask,
                        torch.Generator().manual_seed(10), {kl!r}, 4.0)
        for k, v in summary(state, m).items():
            out[f"resumed_fsdp{{int(fsdp)}}_{{k}}"] = v
    # a NaN planted in rank 1's shard of the mu gradient: every rank skips
    scatter = ShardedAdam.scatter_grads

    def planted(self, full, shard):
        scatter(self, full, shard)
        if rank == 1:
            shard.mu.grad[0] = float("nan")

    ShardedAdam.scatter_grads = planted
    state, step = fresh(data2, True)
    before = full_posterior(state).mu.clone()
    state, m = step(state, u8, labels, mask,
                    torch.Generator().manual_seed(9), {kl!r}, 4.0)
    ShardedAdam.scatter_grads = scatter
    out["nan_skipped"] = np.array([bool(m["skipped"]), torch.equal(
        full_posterior(state).mu, before), state.step])
    # the flat collectives in both formulations at a ragged n (1500: the
    # last shard short) and one with an empty trailing shard (700), -0.0
    # among the values: the same bits
    ded = C.dedicated_ops
    for n in (1500, 700):
        g = torch.Generator().manual_seed(100 + rank)
        lo, hi = C.flat_bounds(n, data2.world_axis)
        full = torch.randn(n, generator=g)
        full[::7] = -0.0
        shard = full[lo:hi].clone()
        for name, fn in (("dedicated", ded), ("all_reduce",
                                              lambda axis, t: False)):
            C.dedicated_ops = fn
            C.reset_counts()
            out[f"flat_gather_{{n}}_{{name}}"] = C.all_gather_flat(
                shard, data2.world_axis, n).numpy()
            out[f"rank_flat_scatter_{{n}}_{{name}}"] = C.reduce_scatter_flat(
                full.clone(), data2.world_axis, (lo, hi)).numpy()
            out[f"flat_counts_{{n}}_{{name}}"] = np.array(
                [C.COUNTS[k] for k in ("all_reduce", "all_gather",
                                       "reduce_scatter")])
        C.dedicated_ops = ded
    # mc=2: each rank draws its row of every chunk of 2
    state, _, m = train(mc2)
    for k, v in summary(state, m).items():
        out[f"mc2_{{k}}"] = v
    b = bundle()
    with torch.no_grad():
        out["mc2_logits"] = mc_logits(
            b.module, b.meta, b.post, b.batch_stats,
            normalize_multimodal(*u8), torch.Generator().manual_seed(11),
            4, mc_chunk=2, train=True, remat=False, batch_mask=mask,
            ws_sharding=mc2).numpy()
    # the fused trunks' BN and DVP's moment BN over the data axis
    fused = make_packed_predict_step(b, 4, mc_chunk=2,
                                     sample_dtype=torch.float32,
                                     fused_trunks=True, mesh=data2)
    out["fused_mean_prob"] = fused(b.post, b.batch_stats, u8,
                                   torch.Generator().manual_seed(3),
                                   mask.bool())["mean_prob"].numpy()
    dvp = make_dvp_predict_step(b, 8, packed_inputs=True, spread=0.0,
                                mesh=data2)
    o = dvp(b.post, b.batch_stats, u8, torch.Generator().manual_seed(4),
            mask.bool())
    out["dvp_csv_cols"] = o["csv_cols"].numpy()
    out["dvp_mean_prob"] = o["mean_prob"].numpy()
    # this rank's logits: near-uniform outputs hide little in the above
    from multimodal_auv_torch.ops.sampling import chunk_seed_words
    from multimodal_auv_torch.parallel.collectives import bn_sync
    with torch.no_grad(), bn_sync(data2.data_axis):
        out["rank_dvp_logits"] = dvp.logits_fn(
            b.post, b.batch_stats, [x[2 * rank:2 * rank + 2] for x in u8],
            chunk_seed_words(torch.Generator().manual_seed(4), 1)).numpy()
    np.savez(os.path.join(work, f"steps_{{rank}}.npz"), **out)


def pipelines():
    from multimodal_auv_torch.models.model_utils import ArchConfig
    from multimodal_auv_torch.pipelines.inference import run_auv_inference
    from multimodal_auv_torch.pipelines.training import (
        run_AUV_training_from_scratch)

    cwd = os.path.join(work, f"rank{{rank}}")
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)  # logs/ and tensorboard_logs/ are cwd-relative
    mesh = MeshSpec(2, 1)
    for tree, spec in (("tree", mesh), ("tree_fsdp", MeshSpec(2, 1,
                                                                fsdp=True))):
        ok = run_AUV_training_from_scratch(
            {{}}, {lr!r}, 1, {num_mc}, 10, 10, 4, os.path.join(work, tree),
            arch=ArchConfig.micro(), device="cpu", use_packed_loader=True,
            strict_errors=True, handle_preemption=False, mesh_spec=spec,
            resume_checkpoint=os.path.join(work, f"state_{{tree}}.pt"))
        assert ok
    run_auv_inference(os.path.join(work, "dives"), batch_size=4,
                      output_csv=os.path.join(work, "mesh.csv"),
                      num_mc_samples={num_mc}, allow_random_init=True,
                      arch=ArchConfig.micro(), use_packed_loader=True,
                      mesh_spec=mesh, device="cpu")

    # the unfused packed step on the data=2 mesh: the logits of this
    # rank's rows, which a data-sharded serving artifact must reproduce
    import multimodal_auv_torch.engine.predict as P
    from multimodal_auv_torch.models.model_utils import make_multimodal_bundle
    b = make_multimodal_bundle({serve_classes}, BNNPriorSpec(),
                               torch.Generator().manual_seed(0),
                               ArchConfig.micro(), device="cpu")
    rng = np.random.default_rng({serve_seed})
    u8 = [torch.from_numpy(rng.integers(0, 255, (4, 32, 32, c),
                                        dtype=np.uint8)) for c in (3, 3, 1)]
    seen, fused = [], P.fused_outputs
    P.fused_outputs = lambda logits: (seen.append(logits), fused(logits))[1]
    step = P.make_packed_predict_step(b, {serve_mc}, mc_chunk=1,
                                      mesh=M.make_mesh(mesh))
    step(b.post, b.batch_stats, u8, torch.Generator().manual_seed(
        {serve_seed}), torch.tensor({serve_mask}) > 0)
    P.fused_outputs = fused
    np.save(os.path.join(work, f"mesh_logits_{{rank}}.npy"),
            seen[0].float().numpy())

    # the DVP logits function on the same mesh and batch: this rank's
    # rows, which a data-sharded DVP serving artifact must reproduce
    from multimodal_auv_torch.engine.moment import make_dvp_logits_fn
    from multimodal_auv_torch.ops.sampling import chunk_seed_words
    from multimodal_auv_torch.parallel.collectives import bn_sync
    data2 = M.make_mesh(mesh)
    dvp = make_dvp_logits_fn(b, {serve_mc}, packed_inputs=True, mesh=data2)
    with torch.no_grad(), bn_sync(data2.data_axis):
        logits = dvp(b.post, b.batch_stats,
                     [x[2 * rank:2 * rank + 2] for x in u8],
                     chunk_seed_words(torch.Generator().manual_seed(
                         {serve_seed}), 1))
    np.save(os.path.join(work, f"mesh_dvp_logits_{{rank}}.npy"),
            logits.numpy())


try:
    {{"steps": steps, "pipelines": pipelines}}[group]()
finally:
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use (and the spawned ranks')."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(group: str, work: str) -> None:
    """Run ``group`` on two ranks; raise with both ranks' output if either
    fails or outlives ``SUBPROCESS_TIMEOUT``."""
    code = _WORKER.format(repo=REPO, lr=LR, kl=KL_WEIGHT, num_mc=NUM_MC,
                          serve_classes=SERVE_CLASSES, serve_mc=SERVE_MC,
                          serve_seed=SERVE_SEED, serve_mask=SERVE_MASK)
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, group, str(r),
                               port, work], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=work)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=SUBPROCESS_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    assert rcs == [0, 0], "\n".join(f"--- rank {r} rc {rc}\n{o[-4000:]}"
                                    for r, (rc, o) in enumerate(zip(rcs,
                                                                    outs)))


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

def test_make_mesh_shapes_and_errors():
    """Without a process group the mesh is one rank, every axis of size 1
    (JAX's one-device mesh); a layout that needs more processes than the
    group has raises (a rank cannot idle, unlike a JAX device)."""
    for spec in (None, MeshSpec(1, 1), MeshSpec(0, 1),
                 MeshSpec(1, 1, fsdp=True)):
        mesh = M.make_mesh(spec)
        assert mesh.shape == {"data": 1, "mc": 1} and mesh.rank == 0
        assert mesh.coords == (0, 0)
        assert (mesh.data_axis.size, mesh.mc_axis.size,
                mesh.world_axis.size) == (1, 1, 1)
    assert M.make_mesh(MeshSpec(1, 1, fsdp=True)).fsdp
    for spec in (MeshSpec(2, 1), MeshSpec(1, 2), MeshSpec(0, 2),
                 MeshSpec(4, 2)):
        with pytest.raises(ValueError, match="processes"):
            M.make_mesh(spec)
    mesh = M.make_mesh()
    assert M.posterior_sharding(mesh, 5000, False) is None
    assert M.posterior_sharding(mesh, 5000, True) == (0, 5000)
    mesh, chunk = M.training_mesh(MeshSpec(1, 1), 4, 4, 2)
    assert mesh.shape == {"data": 1, "mc": 1} and chunk == 2


def test_dist_spec_from_env(monkeypatch):
    """``DistSpec.from_env``: the AUV_* variables (as the JAX package's),
    else torchrun's; one process or none set gives None."""
    from multimodal_auv_torch.config import DistSpec

    for k in ("AUV_COORDINATOR", "AUV_NUM_PROCESSES", "AUV_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert DistSpec.from_env() is None
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29400")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert DistSpec.from_env() == DistSpec("10.0.0.1:29400", 4, 3)
    monkeypatch.setenv("AUV_COORDINATOR", "h:1")
    monkeypatch.setenv("AUV_NUM_PROCESSES", "2")
    monkeypatch.setenv("AUV_PROCESS_ID", "1")
    assert DistSpec.from_env() == DistSpec("h:1", 2, 1)
    monkeypatch.setenv("AUV_NUM_PROCESSES", "1")
    assert DistSpec.from_env() is None


@pytest.mark.parametrize("gated", [False, True], ids=["adam", "gated"])
def test_sharded_adam_matches_adam(gated):
    """``ShardedAdam`` on a one-rank mesh (its shard is the whole vector,
    every gather a no-op) against the optimizer it wraps, plain Adam or
    the frozen-backbone gated Adam: two steps on the same gradients give
    the same posterior to the bit, and its ``state_dict`` is the plain
    optimizer's format, which loads back into a fresh ``ShardedAdam``."""
    from multimodal_auv_torch.engine.optim import (
        make_backbone_freeze_mask,
        make_optimizer_with_freeze,
        trainable_leaves,
    )
    from multimodal_auv_torch.models.model_utils import make_multimodal_bundle

    def bundle():
        return make_multimodal_bundle(3, BNNPriorSpec(),
                                      torch.Generator().manual_seed(0),
                                      ArchConfig.micro(), device="cpu")

    def tx_for(b):
        if gated:
            return make_optimizer_with_freeze(
                1e-3, 1e-5, make_backbone_freeze_mask(b.meta, b.post))
        return make_optimizer(1e-3, 1e-5)

    mesh = M.make_mesh(MeshSpec(1, 1, fsdp=True))

    def state_for(b, sharded):
        st = BayesTrainState(b.post, None, b.batch_stats)
        return M.shard_state(mesh, st, tx_for(b), sharded)

    runs = []
    for sharded in (False, True):
        b = bundle()
        st = state_for(b, sharded)
        opt = st.opt_state
        g = torch.Generator().manual_seed(5)
        for _ in range(2):
            opt.zero_grad(set_to_none=True)
            for p in trainable_leaves(st.post):
                p.grad = torch.randn(p.shape, generator=g)
            opt.step()
        runs.append((st, opt))
    (b0, o0), (b1, o1) = runs
    assert type(o1).__name__ == "ShardedAdam"
    for a, c in zip(trainable_leaves(b0.post), trainable_leaves(b1.post)):
        assert torch.equal(a.detach(), c.detach())
    sd0, sd1 = o0.state_dict(), o1.state_dict()
    assert sorted(sd0["state"]) == sorted(sd1["state"])
    for i in sd0["state"]:
        for k, v in sd0["state"][i].items():
            assert torch.equal(v, sd1["state"][i][k]), (i, k)
    o2 = state_for(bundle(), True).opt_state
    o2.load_state_dict(sd1)
    assert torch.equal(o2.state_dict()["state"][0]["exp_avg"],
                       sd1["state"][0]["exp_avg"])


def test_host_shard_indices_cover_disjointly():
    """As the JAX package's test: across process counts and ragged sizes
    the shards partition range(n), contiguous and in order."""
    for n in (1, 5, 8, 9, 10, 17, 64):
        for pc in (1, 2, 3, 4, 8):
            shards = [host_shard_indices(n, process_index=pi,
                                         process_count=pc)
                      for pi in range(pc)]
            assert [i for s in shards for i in s] == list(range(n)), (n, pc)
            assert max(len(s) for s in shards) <= -(-n // pc)


class _Samples:
    """A labelled dataset of numbered arrays."""

    def __init__(self, n):
        self.labels = [i % 3 for i in range(n)]
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"main_image": np.full((2, 2, 3), i + 1, np.uint8),
                "label": np.int32(self.labels[i])}


@pytest.mark.parametrize("kind", ["folders", "packed"])
def test_host_shard_loaders_global_view(kind):
    """Both host-shard loaders over 2 data ranks, 10 samples in global
    batches of 4 (a ragged tail of 2), shuffled: every rank sees the plain
    loader's batch order and every label; its own rows carry the real
    pixels, the other rank's rows are zeros, and the two ranks' real rows
    together are the plain batch."""
    n, bs = 10, 4
    if kind == "folders":
        ds = _Samples(n)
        plain = DataLoader(ds, bs, shuffle=True, num_workers=0, seed=3)
        ranks = [HostShardLoader.from_loader(plain, r, 2) for r in range(2)]
        key = "main_image"
    else:
        rng = np.random.default_rng(0)
        packed = {k: rng.integers(1, 255, (n, 2, 2, c), dtype=np.uint8)
                  for k, c in (("main", 3), ("bathy", 3), ("sss", 1))}
        packed["labels"] = (np.arange(n) % 3).astype(np.int32)
        plain = PackedTrainBatches(packed, bs, np.arange(n), shuffle=True,
                                   seed=3)
        ranks = [HostShardPackedBatches.from_batches(plain, r, 2)
                 for r in range(2)]
        key = "sss_image"
    for epoch in (0, 1):
        for it in [plain] + ranks:
            it.set_epoch(epoch)
        want = list(plain)
        got = [list(r) for r in ranks]
        assert len(got[0]) == len(got[1]) == len(want) == 3
        for j, w in enumerate(want):
            rows = len(w["label"])
            for r in range(2):
                g = got[r][j]
                np.testing.assert_array_equal(g["label"], w["label"])
                own = slice(2 * r, min(2 * r + 2, rows))
                np.testing.assert_array_equal(g[key][own], w[key][own])
                other = [i for i in range(rows) if not own.start <= i
                         < own.stop]
                assert not np.any(g[key][other])
    with pytest.raises(ValueError, match="divisible"):
        HostShardLoader(_Samples(4), 3, process_index=0, process_count=2)


@pytest.mark.parametrize("kernel", ["split_1", "stacked_2", "eps_3"])
def test_seed_fold_draws_equal_unsharded_rows(kernel):
    """Rank m of an mc axis of 2 or 4 draws rows [m k, (m + 1) k) of a
    chunk from the chunk's seed with its draw offset folded in: bit-equal
    to those rows of the unsharded stack, for #1's op (the folded
    seed as its device seed tensor), #2's and #3's plain versions (seeds
    by value), at a P of
    one 65536-element block plus a partial second, so a draw spans two
    streams, and at a seed whose folded words wrap around 2^32."""
    P = BLOCK_ELEMS + 256
    gen = torch.Generator().manual_seed(1)
    mu = torch.randn(P, generator=gen)
    sigma = torch.rand(P, generator=gen) + 0.1
    for seed, n, mc in (((12345, 678), 4, 2), ((7, 0xFFFFFFFF - 2), 4, 4)):
        k = n // mc
        if kernel == "split_1":
            full = split_draws(mu, sigma, seed_tensor(seed, "cpu"), n)
            rows = [split_draws(mu, sigma, seed_tensor(
                draw_offset_seed(seed, m * k, P), "cpu"), k)
                for m in range(mc)]
        elif kernel == "stacked_2":
            full = stacked_plain(mu, sigma, seed, n, torch.float32)
            rows = [stacked_plain(mu, sigma, draw_offset_seed(seed, m * k, P),
                                  k, torch.float32) for m in range(mc)]
        else:
            full = gaussian_noise(P, seed, n, "cpu")
            rows = [eps_plain(P, draw_offset_seed(seed, m * k, P), k, "cpu")
                    for m in range(mc)]
        assert torch.equal(torch.cat(rows), full), (seed, n, mc)
    # two blocks a draw: an offset of 2 draws adds 4 to seed1, mod 2^32
    assert draw_offset_seed((1, 2), 2, P) == (1, 6)
    assert draw_offset_seed((3, 0xFFFFFFFF), 2, P) == (3, 3)


# ---------------------------------------------------------------------------
# Two-rank gloo groups
# ---------------------------------------------------------------------------

def _u8_batch():
    rng = np.random.default_rng(7)
    return ({k: rng.integers(0, 256, (4, 32, 32, c), dtype=np.uint8)
             for k, c in (("main", 3), ("bathy", 3), ("sss", 1))},
            np.array([1, 4, 4, 2], np.int32),
            np.array([1.0, 1.0, 1.0, 0.0], np.float32))


def _one_process_train(pb_state, u8, labels, mask, mc_chunk):
    pb, state = pb_state
    step = make_train_step(pb.module, pb.meta, BNNPriorSpec(), NUM_MC,
                           mc_chunk=mc_chunk, packed_inputs=True)
    return step(state, [torch.from_numpy(u8[k])
                        for k in ("main", "bathy", "sss")],
                torch.from_numpy(labels), torch.from_numpy(mask),
                torch.Generator().manual_seed(9), KL_WEIGHT, 4.0)


def _carried(jb):
    return from_jax(np.asarray(jb.post.mu), np.asarray(jb.post.rho),
                    jax.tree_util.tree_map(np.asarray, jb.post.det),
                    jax.tree_util.tree_map(np.asarray, jb.batch_stats),
                    [(e.path, e.shape, e.offset, e.size)
                     for e in jb.meta.entries],
                    num_classes=7, arch=ArchConfig.micro(), device="cpu")


def _fresh_state(pb):
    return BayesTrainState(pb.post, make_optimizer(LR, 1e-5).init(pb.post),
                           pb.batch_stats)


@pytest.fixture(scope="module")
def steps_run(tmp_path_factory):
    """The ``steps`` group's two ranks, spawned once on the JAX bundle's
    posterior carried over, with the eps of JAX's chunk keys: (the JAX
    bundle, both ranks' npz results, the eps, the JAX key, the work
    directory)."""
    jb = jmake(7, JSpec(), jax.random.PRNGKey(0), JArch.micro())
    pb = _carried(jb)
    P = pb.meta.n_padded
    u8, labels, mask = _u8_batch()
    work = str(tmp_path_factory.mktemp("steps"))
    torch.save({"mu": pb.post.mu, "rho": pb.post.rho, "det": pb.post.det,
                "bs": pb.batch_stats}, os.path.join(work, "bundle.pt"))
    np.savez(os.path.join(work, "inputs.npz"), labels=labels, mask=mask,
             **u8)
    key = jax.random.PRNGKey(42)
    seeds = chunk_seeds(torch.Generator().manual_seed(9), NUM_MC)
    eps = {f"{a}_{b}": np.asarray(jax.random.normal(k, (1, P), jnp.float32))
           for (a, b), k in zip(seeds, jax.random.split(key, NUM_MC))}
    np.savez(os.path.join(work, "eps.npz"), **eps)
    _spawn("steps", work)
    ranks = [np.load(os.path.join(work, f"steps_{r}.npz")) for r in range(2)]
    return jb, ranks, eps, key, work


def _jax_mesh_step(jb, key, fsdp: bool):
    """JAX's train step on a data=2 mesh of its virtual devices, the
    packed posterior and its moments sharded over the mesh under
    ``fsdp``: (new state, metrics)."""
    u8, labels, mask = _u8_batch()
    tx = jmake_optimizer(LR, 1e-5)
    jstep = jmake_train_step(jb.module, jb.meta, JSpec(), tx, NUM_MC,
                             impl="jnp", packed_inputs=True)
    jstate = JState(post=jb.post, opt_state=tx.init(jb.post),
                    batch_stats=jb.batch_stats,
                    step=jnp.zeros((), jnp.int32))
    jmesh = JM.make_mesh(JMeshSpec(data=2, mc=1))
    with jax.set_mesh(jmesh):
        st = JM.shard_state(jmesh, jstate, fsdp=fsdp)
        return jstep(st, tuple(JM.shard_batch(jmesh, u8[k])
                               for k in ("main", "bathy", "sss")),
                     JM.shard_batch(jmesh, labels),
                     JM.shard_batch(jmesh, mask), key, KL_WEIGHT, 4.0)


def _held(grad_mu, meta) -> np.ndarray:
    """The elements of the updated mu held against another framework's:
    Adam's first step moves an element by lr * g / (|g| + 1e-8), whose
    sensitivity to the gradient's rounding is lr * 1e-8 / g^2, and near
    g = 0 the sign itself is rounding noise, so the updated mu is held
    where the gradient exceeds 1e-5; and against JAX, whose gradients
    differ from the port's by rounding that flips the sign of a few
    percent-of-a-percent-sized ones (tests/test_torch_train.py bounds them
    by 2% plus 1e-3 of their leaf's scale), where it exceeds 1e-2 of its
    leaf's largest too. Returns (live, held) masks."""
    g = np.abs(grad_mu)
    floor = np.zeros_like(g)
    for e in meta.entries:
        sl = slice(e.offset, e.offset + e.size)
        floor[sl] = 1e-2 * g[sl].max()
    live = g > 1e-5
    return live, live & (g > floor)


def test_two_rank_steps(steps_run, monkeypatch):
    """Two gloo ranks, one data=2 mesh and one mc=2 mesh over them.

    * data=2 train step (remat on, chained BN, a ragged mask) under the
      eps of JAX's chunk keys, against JAX's train step on a data=2 mesh
      of its 8 virtual devices: loss rel 1e-4 (as JAX's own sharded-step
      test), updated mu atol 1e-5; and against the port's one-process
      step under the same eps: loss rel 1e-5, the gradients of mu and rho
      to 1e-4 relative L2 error (the reduction order differs), mu, rho
      and the chained running mean atol 1e-6. The updated mu is held on
      the elements whose gradient exceeds 1e-5 and 1e-2 of its leaf's
      largest (see the comment there). Both ranks hold the same mu and
      gradients.
    * the same step with fsdp (mu and rho sharded at rest, gathered for
      the forward, their gradients reduce-scattered): the gathered mu,
      rho, gradients, Adam moment, loss and statistics bit-equal to the
      plain data=2 step's (a sum of two terms has one order).
    * mc=2 (each rank draws its row of every chunk of 2, the real plain
      noise): eval logits bit-equal to the one-process stacked path's
      (the draws are bit-equal, the forwards the same code); the train
      step's loss rel 1e-5 and mu atol 1e-6 against the one-process step.
    * the fused trunks' predict step and DVP's, data=2: mean
      probabilities to 1e-5 of one process's, and each rank's DVP logits
      (|logit| ~1e-2: the random weights' near-uniform probabilities move
      little) to 1e-6 of its rows of the one-process logits.
    """
    jb, ranks, eps, key, _ = steps_run
    u8, labels, mask = _u8_batch()
    out = ranks[0]
    for k in out.files:
        if not k.startswith("rank_"):
            np.testing.assert_array_equal(ranks[1][k], out[k], err_msg=k)

    # JAX's step on a data=2 mesh of virtual devices, the same eps
    jstate2, jm = _jax_mesh_step(jb, key, fsdp=False)
    # the port's one-process step under the same eps
    monkeypatch.setattr(torch_sampling, "eps_plain",
                        lambda P_, seed, n, device=None, noise="f32":
                        torch.from_numpy(
                            eps["%d_%d" % tuple(seed)][:n].copy()))
    one = _carried(jb)
    state, m = _one_process_train((one, _fresh_state(one)), u8, labels,
                                  mask, 1)

    np.testing.assert_allclose(float(out["data2_fsdp0_loss"]),
                               float(jm["loss"]), rtol=1e-4)
    # the updated mu is held where its gradient is not rounding noise
    # (``_held``; the gradients themselves are held below, everywhere)
    live, held = _held(state.post.mu.grad.numpy(), one.meta)
    assert live.mean() > 0.2
    assert held.sum() > 1e5
    jmu = np.asarray(jstate2.post.mu)
    np.testing.assert_allclose(out["data2_fsdp0_mu"][held], jmu[held],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(out["data2_fsdp0_loss"]),
                               float(m["loss"]), rtol=1e-5)
    for name in ("mu", "rho"):
        want = getattr(state.post, name).grad.numpy()
        err = np.linalg.norm(out[f"data2_fsdp0_grad_{name}"] - want)
        assert err <= 1e-4 * np.linalg.norm(want), name
    mu1 = state.post.mu.detach().numpy()
    np.testing.assert_allclose(out["data2_fsdp0_mu"][held], mu1[held],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["data2_fsdp0_rho"],
                               state.post.rho.detach().numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        out["data2_fsdp0_bs_mean"],
        state.batch_stats["image_model_feat"]["bn1"]["mean"].numpy(),
        rtol=0, atol=1e-6)
    monkeypatch.undo()
    for name in ("mu", "rho", "grad_mu", "grad_rho", "exp_avg", "loss",
                 "fused", "bs_mean"):
        np.testing.assert_array_equal(out[f"data2_fsdp1_{name}"],
                                      out[f"data2_fsdp0_{name}"],
                                      err_msg=name)

    # mc=2 against the one-process stacked path and step (plain noise)
    one = _carried(jb)
    x = normalize_multimodal(*[torch.from_numpy(u8[k])
                               for k in ("main", "bathy", "sss")])
    with torch.no_grad():
        want = mc_logits(one.module, one.meta, one.post, one.batch_stats, x,
                         torch.Generator().manual_seed(11), 4, mc_chunk=2,
                         train=True, remat=False,
                         batch_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(out["mc2_logits"], want.numpy())
    state, m = _one_process_train((one, _fresh_state(one)), u8, labels,
                                  mask, 2)
    np.testing.assert_allclose(float(out["mc2_loss"]), float(m["loss"]),
                               rtol=1e-5)
    for name in ("mu", "rho"):
        want = getattr(state.post, name).grad.numpy()
        err = np.linalg.norm(out[f"mc2_grad_{name}"] - want)
        assert err <= 1e-4 * np.linalg.norm(want), name
    mu1 = state.post.mu.detach().numpy()
    np.testing.assert_allclose(out["mc2_mu"][held], mu1[held], rtol=0,
                               atol=1e-6)

    # fused trunks and DVP, one process
    one = _carried(jb)
    t8 = [torch.from_numpy(u8[k]) for k in ("main", "bathy", "sss")]
    tmask = torch.from_numpy(mask).bool()
    fused = make_packed_predict_step(one, 4, mc_chunk=2,
                                     sample_dtype=torch.float32,
                                     fused_trunks=True)
    want = fused(one.post, one.batch_stats, t8,
                 torch.Generator().manual_seed(3), tmask)["mean_prob"]
    np.testing.assert_allclose(out["fused_mean_prob"], want.numpy(), rtol=0,
                               atol=1e-5)
    dvp = make_dvp_predict_step(one, 8, packed_inputs=True, spread=0.0)
    want = dvp(one.post, one.batch_stats, t8,
               torch.Generator().manual_seed(4), tmask)
    for k in ("csv_cols", "mean_prob"):
        np.testing.assert_allclose(out[f"dvp_{k}"], want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    with torch.no_grad():
        want = dvp.logits_fn(one.post, one.batch_stats, t8, chunk_seed_words(
            torch.Generator().manual_seed(4), 1))
    assert float(want.abs().max()) > 1e-2
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["rank_dvp_logits"],
                                   want[:, 2 * r:2 * r + 2].numpy(), rtol=0,
                                   atol=1e-6)


def test_fsdp_state_holds_its_shard(steps_run):
    """Under fsdp each rank's state holds mu, rho and mu's gradient at
    the length of its ``posterior_sharding`` slice only (P / 2 each here,
    the last shard ragged by the pad), data=2 the whole P; the fsdp step
    issues one dedicated all_gather per vector and one reduce_scatter per
    gradient (gloo carries both for CPU tensors) and one all_reduce more
    than data=2 (the NaN guard's verdict)."""
    from multimodal_auv_torch.parallel.collectives import Axis, flat_bounds

    _, ranks, _, _, _ = steps_run
    P = ranks[0]["data2_fsdp0_mu"].shape[0]
    spans = [flat_bounds(P, Axis(2, r)) for r in range(2)]
    assert spans[0][1] == spans[1][0] and spans[1][1] == P
    for r, (lo, hi) in enumerate(spans):
        assert 0 < hi - lo < P
        np.testing.assert_array_equal(ranks[r]["rank_shape_fsdp1"],
                                      [hi - lo] * 3)
        np.testing.assert_array_equal(ranks[r]["rank_shape_fsdp0"], [P] * 3)
        np.testing.assert_array_equal(ranks[r]["rank_bounds"], [lo, hi - 1])
    c0, c1 = ranks[0]["counts_fsdp0"], ranks[0]["counts_fsdp1"]
    assert list(c0[1:]) == [0, 0] and list(c1[1:]) == [2, 2]
    assert c1[0] == c0[0] + 1


def test_fsdp_checkpoint_and_resume(steps_run):
    """The fsdp state's ``save_train_state`` file is the data=2 state's,
    tensor for tensor (rank 0 writes the gathered posterior and moments);
    each layout restored from the other's file and stepped once more
    gives the same posterior, gradients, moments and loss, bit for bit."""
    _, ranks, _, _, work = steps_run
    got, gflat = _flat_state(os.path.join(work, "ckpt_fsdp1.pt"))
    want, wflat = _flat_state(os.path.join(work, "ckpt_fsdp0.pt"))
    assert (got["epoch"], got["meta"]) == (want["epoch"], want["meta"])
    assert sorted(gflat) == sorted(wflat) and len(wflat) > 50
    for k in wflat:
        assert gflat[k].dtype == wflat[k].dtype, k
        np.testing.assert_array_equal(gflat[k], wflat[k], err_msg=k)
    out = ranks[0]
    for name in ("mu", "rho", "grad_mu", "grad_rho", "exp_avg", "loss",
                 "bs_mean"):
        np.testing.assert_array_equal(out[f"resumed_fsdp1_{name}"],
                                      out[f"resumed_fsdp0_{name}"],
                                      err_msg=name)
    # the resumed step moved the posterior on from the first step's
    assert not np.array_equal(out["resumed_fsdp1_mu"],
                              out["data2_fsdp1_mu"])


def test_fsdp_nan_in_one_shard_skips_every_rank(steps_run):
    """A NaN planted in rank 1's shard of the mu gradient (after the
    reduce-scatter, where rank 0 cannot see it) makes both ranks skip the
    update: the verdict is summed over the world, and the gathered mu is
    unchanged on both."""
    _, ranks, _, _, _ = steps_run
    for r in range(2):
        skipped, unchanged, step = ranks[r]["nan_skipped"]
        assert skipped and unchanged and step == 1, r


def test_fsdp_step_against_jax_fsdp(steps_run):
    """The port's fsdp step (two gloo ranks) against the JAX package's
    step on a data=2 mesh of its virtual devices with the posterior and
    its moments sharded (``shard_state(fsdp=True)``), under the same eps:
    loss rel 1e-4, the updated mu atol 1e-5 where its gradient is not
    rounding noise (``_held``), the data=2 tolerances of
    ``test_two_rank_steps``."""
    jb, ranks, _, key, _ = steps_run
    out = ranks[0]
    jstate, jm = _jax_mesh_step(jb, key, fsdp=True)
    assert len(jstate.post.mu.sharding.device_set) == 2
    np.testing.assert_allclose(float(out["data2_fsdp1_loss"]),
                               float(jm["loss"]), rtol=1e-4)
    _, held = _held(out["data2_fsdp1_grad_mu"], _carried(jb).meta)
    assert held.sum() > 1e5
    np.testing.assert_allclose(out["data2_fsdp1_mu"][held],
                               np.asarray(jstate.post.mu)[held], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1500, 700], ids=["ragged", "empty_tail"])
def test_flat_collectives_both_formulations(steps_run, n):
    """``all_gather_flat`` and ``reduce_scatter_flat`` on two gloo ranks
    at a ragged n (1500 over chunks of 1024) and at one whose trailing
    shard is empty (700), with -0.0 among the values: the dedicated
    operations and the all_reduce formulation give the same bits, the
    gather is the ranks' slices in order and the reduce-scatter this
    rank's slice of the sum; each issues one operation of its kind."""
    from multimodal_auv_torch.parallel.collectives import Axis, flat_bounds

    _, ranks, _, _, _ = steps_run
    fulls = []
    for r in range(2):
        full = torch.randn(n, generator=torch.Generator().manual_seed(
            100 + r))
        full[::7] = -0.0
        fulls.append(full.numpy())
    spans = [flat_bounds(n, Axis(2, r)) for r in range(2)]
    gathered = np.concatenate([fulls[r][lo:hi]
                               for r, (lo, hi) in enumerate(spans)])
    bits = lambda a: np.asarray(a, np.float32).view(np.uint32)
    for r, (lo, hi) in enumerate(spans):
        out = ranks[r]
        for name in ("dedicated", "all_reduce"):
            np.testing.assert_array_equal(
                bits(out[f"flat_gather_{n}_{name}"]), bits(gathered))
            np.testing.assert_array_equal(
                bits(out[f"rank_flat_scatter_{n}_{name}"]),
                bits((fulls[0] + fulls[1])[lo:hi]))
        np.testing.assert_array_equal(out[f"flat_counts_{n}_dedicated"],
                                      [0, 1, 1])
        np.testing.assert_array_equal(out[f"flat_counts_{n}_all_reduce"],
                                      [2, 0, 0])
    assert spans[1][1] - spans[1][0] == (0 if n == 700 else n - 1024)


def test_flat_collectives_at_world_one():
    """Under a process group of one rank (gloo, CPU tensors), as on an
    axis of size 1 without one, ``all_gather_flat`` and
    ``reduce_scatter_flat`` issue nothing and hand back the vector; the
    dedicated formulations themselves (``_gather_dedicated``,
    ``_scatter_dedicated``, which chip_smoke.py's NCCL check calls at
    world 1) issue one operation each and give the vector's bits, -0.0
    included, at a ragged n."""
    import torch.distributed as dist

    from multimodal_auv_torch.parallel import collectives as C

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        axis = M.make_mesh(MeshSpec(1, 1, fsdp=True)).world_axis
        v = torch.randn(1500, generator=torch.Generator().manual_seed(5))
        v[::7] = -0.0
        bits = lambda t: t.view(torch.int32)
        C.reset_counts()
        assert C.all_gather_flat(v, axis, 1500) is v
        assert torch.equal(bits(C.reduce_scatter_flat(v, axis, (0, 1500))),
                           bits(v))
        assert not any(C.COUNTS.values())
        assert torch.equal(bits(C._gather_dedicated(v, axis, 1500)), bits(v))
        assert torch.equal(bits(C._scatter_dedicated(v.clone(), axis,
                                                     (0, 1500))), bits(v))
        assert (C.COUNTS["all_gather"], C.COUNTS["reduce_scatter"],
                C.COUNTS["all_reduce"]) == (1, 1, 0)
    finally:
        dist.destroy_process_group()


def test_fsdp_step_frees_its_gathered_vectors():
    """On one rank (no process group, every flat collective a no-op) the
    fsdp state's step equals the plain step bit for bit, and the whole mu
    and rho it gathered for its forward are freed by the time it
    returns (weak references to them are dead)."""
    import weakref

    from multimodal_auv_torch.engine.optim import (
        ShardedAdam,
        full_posterior,
    )
    from multimodal_auv_torch.models.model_utils import make_multimodal_bundle

    u8, labels, mask = _u8_batch()
    t8 = [torch.from_numpy(u8[k]) for k in ("main", "bathy", "sss")]
    gathered = []
    gather = ShardedAdam.gather

    def recording(self, shard, requires_grad=False):
        full = gather(self, shard, requires_grad)
        gathered.extend(weakref.ref(t) for t in (full.mu, full.rho))
        return full

    results = []
    for fsdp in (False, True):
        b = make_multimodal_bundle(7, BNNPriorSpec(),
                                   torch.Generator().manual_seed(0),
                                   ArchConfig.micro(), device="cpu")
        mesh = M.make_mesh(MeshSpec(1, 1, fsdp=fsdp))
        state = M.shard_state(mesh, BayesTrainState(b.post, None,
                                                    b.batch_stats),
                              make_optimizer(LR, 1e-5), fsdp)
        step = make_train_step(b.module, b.meta, BNNPriorSpec(), NUM_MC,
                               packed_inputs=True, mesh=mesh)
        ShardedAdam.gather = recording
        try:
            state, m = step(state, t8, torch.from_numpy(labels),
                            torch.from_numpy(mask),
                            torch.Generator().manual_seed(9), KL_WEIGHT, 4.0)
        finally:
            ShardedAdam.gather = gather
        if fsdp:
            assert len(gathered) == 2
            assert all(ref() is None for ref in gathered)
        results.append((full_posterior(state), m))
    (p0, m0), (p1, m1) = results
    assert torch.equal(m0["fused"], m1["fused"])
    for a, c in ((p0.mu, p1.mu), (p0.rho, p1.rho)):
        assert torch.equal(a.detach(), c.detach())


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def _flat_state(path):
    d = torch.load(path, weights_only=True)
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k in sorted(t, key=str):
                walk(f"{prefix}/{k}", t[k])
        elif isinstance(t, torch.Tensor):
            out[prefix] = t.numpy()
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(f"{prefix}/{i}", v)

    walk("", d["state"])
    return d, out


@pytest.fixture(scope="module")
def pipelines_run(tmp_path_factory):
    """The ``pipelines`` group's two ranks, spawned once: (their work
    directory, an untouched copy of its trees for the one-process run)."""
    tmp = tmp_path_factory.mktemp("pipelines")
    work = str(tmp / "mesh")
    os.makedirs(work)
    make_training_tree(os.path.join(work, "tree"), n_samples=10)
    make_inference_tree(os.path.join(work, "dives"), n_samples=5)
    single = str(tmp / "single")
    shutil.copytree(work, single)
    shutil.copytree(os.path.join(work, "tree"),
                    os.path.join(work, "tree_fsdp"))
    _spawn("pipelines", work)
    return work, single


def test_two_rank_pipelines(pipelines_run, monkeypatch):
    """``run_AUV_training_from_scratch`` (one epoch, packed loader, global
    batch 4 on a data=2 mesh) and ``run_auv_inference`` (5 dives, batch
    4, 2 draws) on two gloo ranks, against the same calls in one process:
    the resume checkpoint, written once by rank 0 in the one-process
    format, holds the same Adam moments (relative L2 1e-4), running
    statistics and step (atol 1e-5) and posterior (99.9% of elements to
    1e-5, all to 4 lr); the CSV ledgers have one header and one row each, the
    TensorBoard events exist under rank 0's working directory only; the
    inference CSV, written by rank 0, has the one-process CSV's names and
    classes and its uncertainties to 1e-5."""
    work, single = pipelines_run
    monkeypatch.chdir(single)
    assert run_AUV_training_from_scratch(
        {}, LR, 1, NUM_MC, 10, 10, 4, os.path.join(single, "tree"),
        arch=ArchConfig.micro(), device="cpu", use_packed_loader=True,
        strict_errors=True, handle_preemption=False,
        resume_checkpoint=os.path.join(single, "state.pt"))
    run_auv_inference(os.path.join(single, "dives"), batch_size=4,
                      output_csv=os.path.join(single, "single.csv"),
                      num_mc_samples=NUM_MC, allow_random_init=True,
                      arch=ArchConfig.micro(), use_packed_loader=True,
                      device="cpu")

    got, gflat = _flat_state(os.path.join(work, "state_tree.pt"))
    want, wflat = _flat_state(os.path.join(single, "state.pt"))
    assert got["epoch"] == want["epoch"] == 1
    assert got["meta"] == want["meta"]
    assert sorted(gflat) == sorted(wflat) and len(wflat) > 50
    # the Adam moments are linear in the gradients and the running
    # statistics come from the forwards: both held tightly; the posterior
    # moves by lr * m / (sqrt(v) + 1e-8), whose sign is rounding noise
    # where the gradient is ~0, so it is held on all but 0.1% of elements
    post = [k for k in wflat if k.startswith("/post/")]
    moments = [k for k in wflat if "/exp_avg" in k]
    assert len(moments) > 20
    for k in wflat:
        g, w = gflat[k].astype(np.float64), wflat[k].astype(np.float64)
        if k in moments:
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w) + 1e-12, k
        elif k not in post:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=k)
    d = np.concatenate([np.abs(gflat[k] - wflat[k]).ravel() for k in post])
    assert (d <= 1e-5).mean() >= 0.999 and d.max() <= 4 * LR
    for name in ("multimodal_train_results.csv",
                 "multimodal_eval_results.csv"):
        rows = _rows(os.path.join(work, "tree", "csvs", name))
        assert len(rows) == 2, name
        assert rows[0] == _rows(os.path.join(single, "tree", "csvs",
                                             name))[0]
    with open(os.path.join(work, "tree", "csvs", "run_manifest.json")) as f:
        manifest = json.load(f)
    config = manifest.get("config", manifest)
    assert config["mesh"] == {"data": 2, "mc": 1, "fsdp": False}
    assert config["num_processes"] == 2
    assert os.listdir(os.path.join(work, "rank0", "tensorboard_logs"))
    assert not os.path.exists(os.path.join(work, "rank1",
                                           "tensorboard_logs"))
    leftovers = [f for f in os.listdir(work) if f.endswith(".tmp")]
    assert leftovers == []

    mesh_rows = _rows(os.path.join(work, "mesh.csv"))
    one_rows = _rows(os.path.join(single, "single.csv"))
    assert len(mesh_rows) == len(one_rows) == 6
    assert [r[:2] for r in mesh_rows] == [r[:2] for r in one_rows]
    np.testing.assert_allclose(
        np.array([[float(v) for v in r[2:]] for r in mesh_rows[1:]]),
        np.array([[float(v) for v in r[2:]] for r in one_rows[1:]]),
        rtol=0, atol=1e-5)


def test_two_rank_fsdp_pipeline_equals_data2(pipelines_run):
    """``run_AUV_training_from_scratch`` on the same two ranks with
    ``MeshSpec(2, 1, fsdp=True)`` (mu, rho and their moments sharded at
    rest; the loops' evaluation and checkpoints gather them) against the
    data=2 run on a copy of the same tree: the resume checkpoint, the
    epoch-0 ``save_model`` file and the ledgers are the same, bit for bit
    (the manifest records fsdp)."""
    work, _ = pipelines_run
    got, gflat = _flat_state(os.path.join(work, "state_tree_fsdp.pt"))
    want, wflat = _flat_state(os.path.join(work, "state_tree.pt"))
    assert (got["epoch"], got["meta"]) == (want["epoch"], want["meta"])
    assert sorted(gflat) == sorted(wflat) and len(wflat) > 50
    for k in wflat:
        np.testing.assert_array_equal(gflat[k], wflat[k], err_msg=k)
    models = [os.path.join(work, t, "models") for t in ("tree_fsdp", "tree")]
    (name,) = os.listdir(models[1])
    assert os.listdir(models[0]) == [name]
    a, b = (torch.load(os.path.join(d, name), weights_only=True)
            for d in models)
    for k in ("mu", "rho"):
        assert torch.equal(a[k], b[k]), k
    for name in ("multimodal_train_results.csv",
                 "multimodal_eval_results.csv"):
        assert _rows(os.path.join(work, "tree_fsdp", "csvs", name)) == \
            _rows(os.path.join(work, "tree", "csvs", name)), name
    with open(os.path.join(work, "tree_fsdp", "csvs",
                           "run_manifest.json")) as f:
        manifest = json.load(f)
    assert manifest.get("config", manifest)["mesh"] == {
        "data": 2, "mc": 1, "fsdp": True}


def test_data_sharded_artifact_equals_mesh_step(pipelines_run, tmp_path):
    """A data_shards=2 serving artifact (serving.py: one data shard's
    program, its BN sums through ``auv::shard_sum`` over two worker
    threads) against the unfused packed step on the data=2 mesh of two
    gloo ranks (their logits, saved by the ``pipelines`` group) at the
    same seed, one row masked out: bit for bit. With two shards each BN
    sum is one IEEE add of the two partial sums, on either side."""
    from multimodal_auv_torch.models.model_utils import make_multimodal_bundle
    from multimodal_auv_torch.serving import (
        export_predict_artifact,
        load_predict_artifact,
    )

    work, _ = pipelines_run
    mesh = np.concatenate([np.load(os.path.join(work, f"mesh_logits_{r}.npy"))
                           for r in range(2)], axis=1)
    bundle = make_multimodal_bundle(SERVE_CLASSES, BNNPriorSpec(),
                                    torch.Generator().manual_seed(0),
                                    ArchConfig.micro(), device="cpu")
    d = str(tmp_path / "art")
    export_predict_artifact(bundle, d, batch_size=4,
                            num_mc_samples=SERVE_MC, image_size=32,
                            mc_chunk=1, data_shards=2)
    art = load_predict_artifact(d, devices=["cpu", "cpu"])
    try:
        rng = np.random.default_rng(SERVE_SEED)
        batch = [rng.integers(0, 255, (4, 32, 32, c), dtype=np.uint8)
                 for c in (3, 3, 1)]
        got = art.predict_logits(*batch, key=SERVE_SEED,
                                 mask=np.array(SERVE_MASK, np.float32))
    finally:
        art.close()
    assert mesh.shape == (SERVE_MC, 4, SERVE_CLASSES)
    np.testing.assert_array_equal(got.float().numpy(), mesh)


def test_dvp_data_sharded_artifact_equals_mesh_step(pipelines_run,
                                                    tmp_path, monkeypatch):
    """A data_shards=2 DVP serving artifact (serving.py: one data shard's
    DVP program, its moment BN sums through ``auv::shard_sum``, its
    feature moments gathered with ``auv::shard_gather`` and its own rows
    kept with ``auv::shard_rows``) against the DVP logits function on the
    data=2 mesh of two gloo ranks (saved by the ``pipelines`` group) at
    the same seed words: bit for bit. A planted wrong-rows fault (each
    shard handed the other shard's slice) fails the same gate."""
    from multimodal_auv_torch.models.model_utils import make_multimodal_bundle
    from multimodal_auv_torch.parallel import local_shards as L
    from multimodal_auv_torch.serving import (
        export_predict_artifact,
        load_predict_artifact,
    )

    work, _ = pipelines_run
    mesh = np.concatenate([np.load(os.path.join(
        work, f"mesh_dvp_logits_{r}.npy")) for r in range(2)], axis=1)
    bundle = make_multimodal_bundle(SERVE_CLASSES, BNNPriorSpec(),
                                    torch.Generator().manual_seed(0),
                                    ArchConfig.micro(), device="cpu")
    d = str(tmp_path / "dvp")
    export_predict_artifact(bundle, d, batch_size=4,
                            num_mc_samples=SERVE_MC, image_size=32,
                            mode="dvp", data_shards=2)
    art = load_predict_artifact(d, devices=["cpu", "cpu"])
    rng = np.random.default_rng(SERVE_SEED)
    batch = [rng.integers(0, 255, (4, 32, 32, c), dtype=np.uint8)
             for c in (3, 3, 1)]
    try:
        assert (art.meta["mode"], art.data_shards, art.nchunks) == (
            "dvp", 2, 1)
        got = art.predict_logits(*batch, key=SERVE_SEED)
        rows_of = L.rows_of
        monkeypatch.setattr(L, "rows_of", lambda x, n, dim, i: rows_of(
            x, n, dim, (i + 1) % n))
        bad = art.predict_logits(*batch, key=SERVE_SEED)
    finally:
        art.close()
    assert mesh.shape == (SERVE_MC, 4, SERVE_CLASSES)
    assert float(np.abs(mesh).max()) > 1e-2
    np.testing.assert_array_equal(got.numpy(), mesh)
    assert not np.array_equal(bad.numpy(), mesh)
