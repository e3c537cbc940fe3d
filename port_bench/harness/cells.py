"""The cell loops: the program's own entry points, driven from the seed.

A traffic mix names its ``entry``:

* ``packed_predict``: ``engine/predict.py::make_packed_predict_step``
  driven by ``_serve_batches``, the loop of the packed inference
  pipeline (place batch k, launch it, drain batch k - 1's CSV columns);
* ``unimodal_predict``: ``pipelines/unimodal.py::unimodal_predict_and_save``
  over the pool's batches, writing its CSV;
* ``train``: ``engine/steps.py::make_train_step`` built as
  ``run_unimodal_training`` builds it, driven by ``engine/loops.py::
  train_unimodal_model`` (its placement, lagged metrics and ledger row).

Each loop takes batches from a pool of distinct ones made from the seed,
in turn, for a number of batches or until a deadline. The program's
generator (its MC seeds) is made from the seed as well, and its state is
kept at every batch, so the reference can draw the same chunk seeds. Each
loop times, on the host's clock, the call that enqueues a batch's MC work
in the window (the packed step, the unimodal pipeline's ``mc_logits``,
the train step).
"""
from __future__ import annotations

import csv
import gc
import os
import time
from typing import Dict, List, Optional

import torch

from harness import inputs, program
from harness.flops import forward_flops
from reference import predict as ref_predict
from reference import train as ref_train


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host copy (``.cpu()`` of a host tensor is the tensor itself)."""
    return t.detach().to("cpu", copy=True)


def _seed_words(state: torch.Tensor, nchunks: int) -> List:
    """The chunk seeds a generator in ``state`` gives next: one (2,)
    draw of 32-bit words per chunk, as the program draws them."""
    g = torch.Generator()
    g.set_state(state)
    words = torch.randint(0, 1 << 32, (nchunks, 2), generator=g,
                          dtype=torch.int64)
    return [(int(a), int(b)) for a, b in words.tolist()]


def _norm_gap(cand: torch.Tensor, ref: torch.Tensor) -> float:
    """max |cand - ref| over the largest |ref|."""
    return float((cand - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _leaf_gaps(cand: Dict, ref: Dict, keep=None):
    """(gap, leaf) of the worst leaf: the gap of norms, | |c| - |r| |, over
    the larger of the leaf's reference norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    rn = torch.tensor([float(ref[k].double().norm()) for k in names])
    cn = torch.tensor([float(cand[k].double().norm()) for k in names])
    med = float(rn.median())
    gaps = (cn - rn).abs() / torch.clamp_min(rn, med)
    k = int(gaps.argmax())
    return float(gaps[k]), "/".join(map(str, names[k])), float(gaps.median())


class Loop:
    """Shared plumbing: the pool, the program's generator, the window."""

    flops_per_draw_item = 1.0  # forward passes per item and draw
    records_at_yield = True    # False: the step wrapper records instead

    def __init__(self, cell, seed: int, device, scratch: str):
        self.cell, self.seed, self.dev = cell, int(seed), torch.device(device)
        self.cfg, self.tr = cell.config, cell.traffic
        self.scratch = scratch
        self.records: List = []   # (pool index, generator state[, outputs])
        self.recording = False
        self.next_index = 0
        self.gen = inputs.host_generator(self.seed, "program")
        self.phases: Dict[str, float] = {}  # set-up seconds by part
        self.marks: List[float] = []
        self.intervals: List[float] = []
        self.enqueue: List[float] = []  # seconds of each timed call
        self.on_batch = None  # called as each batch is handed over
        self._t = time.perf_counter()

    def timed(self, fn):
        """``fn`` with its calls in the window timed into ``enqueue``."""
        def call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            if self.recording:
                self.enqueue.append(time.perf_counter() - t)
            return out

        return call

    def phase(self, name: str) -> None:
        now = time.perf_counter()
        self.phases[name] = now - self._t
        self._t = now

    # -- data ---------------------------------------------------------
    def make_inputs(self, dtype: str) -> None:
        self.lay, self.mu, self.rho = inputs.posterior(self.cfg, self.seed,
                                                       self.dev)
        self.bn = inputs.bn_init(self.lay, self.dev,
                                 self.cfg["init"]["residual_bn_scale"])
        self.stats = inputs.stats_init(self.lay, self.dev)
        self.pool = inputs.batches(
            self.seed, self.tr["pool"], self.tr["batch"],
            self.cfg["image_size"], [c for _, c in self.cfg["modalities"]],
            dtype, self.cfg["num_classes"], self.dev)

    def feed(self, n: Optional[int], deadline: Optional[float], make):
        k = 0
        while ((n is None or k < n)
               and (deadline is None or time.perf_counter() < deadline)):
            j = self.next_index % len(self.pool)
            self.next_index += 1
            if self.recording:
                self.marks.append(time.perf_counter())
            if self.recording and self.records_at_yield:
                self.records.append((j, self.gen.get_state()))
            if self.on_batch is not None:
                self.on_batch()
            yield make(j)
            k += 1

    # -- what the harness calls ----------------------------------------
    def window(self, seconds: float) -> Dict:
        self.records.clear()
        self.enqueue.clear()
        self.recording = True
        t0 = time.perf_counter()
        self.marks = [t0]
        items = self.loop(deadline=t0 + seconds)
        elapsed = time.perf_counter() - t0
        self.recording = False
        # host seconds between the window's batches being handed over
        self.intervals = [b - a for a, b in zip(self.marks, self.marks[1:])]
        draws = self.tr["num_mc"]
        return {"items": items, "seconds": elapsed,
                "enqueue_s": list(self.enqueue),
                "attempted": len(self.records) * self.tr["batch"],
                "flops": items * draws * self.flops_per_draw_item
                * forward_flops(self.cfg)}

    def traced(self) -> Dict:
        n = self.tr["trace_batches"]
        self.loop(n=n)
        return {"batches": n, "draws": n * self.tr["num_mc"]}

    def steady(self, next_batch) -> Dict:
        """The steady pass: a fill batch and ``idle_batches`` more, with
        ``next_batch`` called at each hand-over."""
        n = 1 + self.tr["idle_batches"]
        self.on_batch = next_batch
        try:
            self.loop(n=n)
        finally:
            self.on_batch = None
        return {"batches": n}

    def free(self) -> None:
        """Drop the program's state (the benchmark's inputs stay)."""
        self.untime()
        for name in ("bundle", "step", "state"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def untime(self) -> None:
        """Put back what ``setup`` wrapped to time (nothing by default)."""

    def sample(self, n: int) -> List[int]:
        """``n`` record indices drawn from the seed."""
        g = inputs.host_generator(self.seed, "sample")
        n = min(n, len(self.records))
        return sorted(torch.randperm(len(self.records), generator=g)[:n]
                      .tolist())

    def device_batch(self, j: int) -> List[torch.Tensor]:
        return [torch.from_numpy(x).to(self.dev) for x in self.pool[j]["x"]]


class PackedPredict(Loop):
    records_at_yield = False

    def setup(self) -> None:
        from multimodal_auv_torch.engine.predict import (
            _placer,
            make_packed_predict_step,
        )

        self.make_inputs("uint8")
        self.phase("inputs")
        self.bundle = program.bundle(self.cfg, self.lay, self.mu, self.rho,
                                     self.bn, self.stats)
        self.phase("bundle")
        step = make_packed_predict_step(
            self.bundle, self.tr["num_mc"], mc_chunk=self.tr["mc_chunk"],
            sample_dtype=program.DTYPES[self.tr["sample_dtype"]])
        self.place = _placer(self.bundle, self.dev)
        self.names = [f"p{i}" for i in range(self.tr["batch"])]
        self.fed: List[int] = []

        step = self.timed(step)

        def wrapped(post, batch_stats, u8, generator, mask=None):
            state = generator.get_state() if self.recording else None
            out = step(post, batch_stats, u8, generator, mask)
            if self.recording:
                self.records.append((self.fed[len(self.records)], state, {
                    k: out[k] for k in ("mean_prob", "predictive_uncertainty",
                                        "aleatoric_uncertainty", "csv_cols")}))
            return out

        self.step = wrapped
        self.loop(n=self.tr["warmup_batches"])
        self.phase("warm_up")

    def loop(self, n=None, deadline=None) -> int:
        from multimodal_auv_torch.engine.predict import _serve_batches

        rows = [0]

        class Sink:
            def writerow(self, row):
                rows[0] += 1

        def make(j):
            self.fed.append(j)
            x = self.pool[j]["x"]
            return x[0], x[1], x[2], self.names

        self.fed = []
        _serve_batches(self.step, self.bundle.post, self.bundle.batch_stats,
                       self.place, self.feed(n, deadline, make), Sink(),
                       self.gen, nominal=self.tr["batch"])
        return rows[0]

    def sampler_calls(self, launched: Dict) -> List:
        return [("split", launched.get("split_sampler", 0),
                 self.tr["mc_chunk"], self.tr["sample_dtype"],
                 self.tr["sample_dtype"], True)]

    def outputs(self, k: int):
        _, _, out = self.records[k]
        return {"mean_prob": out["mean_prob"].float(),
                "pu": out["predictive_uncertainty"].float(),
                "au": out["aleatoric_uncertainty"].float(),
                "cls": out["csv_cols"][0].long()}

    def judge(self, quant: Optional[str] = None) -> Dict[str, float]:
        return _judge_predict(self, quant)


class UnimodalPredict(Loop):

    def setup(self) -> None:
        from multimodal_auv_torch.pipelines import unimodal

        self.make_inputs("float32")
        self.phase("inputs")
        self.bundle = program.bundle(self.cfg, self.lay, self.mu, self.rho,
                                     self.bn, self.stats)
        self.phase("bundle")
        self.rows = None
        # the benchmark's span around the call that enqueues a batch's MC
        # draws (the pipeline's step is a closure of its own)
        self._inner = unimodal.mc_logits
        unimodal.mc_logits = self.timed(self._inner)
        self.loop(n=self.tr["warmup_batches"])
        self.phase("warm_up")

    def loop(self, n=None, deadline=None) -> int:
        from multimodal_auv_torch.pipelines.unimodal import (
            unimodal_predict_and_save,
        )

        names = [f"p{i}" for i in range(self.tr["batch"])]

        def make(j):
            return None, None, self.pool[j]["x"][0], names

        # the window's CSV is kept apart from the warm-up's and the trace's
        path = os.path.join(self.scratch,
                            "window.csv" if self.recording else "other.csv")
        fed = [0]

        def counted(j):
            fed[0] += 1
            return make(j)

        unimodal_predict_and_save(
            self.bundle, self.feed(n, deadline, counted), path,
            self.tr["num_mc"], model_type=self.tr["modality"],
            generator=self.gen, mc_chunk=self.tr["mc_chunk"], device=self.dev)
        # every batch is full: its rows are written before the call returns
        return fed[0] * self.tr["batch"]

    def untime(self) -> None:
        from multimodal_auv_torch.pipelines import unimodal

        if getattr(self, "_inner", None) is not None:
            unimodal.mc_logits, self._inner = self._inner, None

    def sampler_calls(self, launched: Dict) -> List:
        return [("stacked", launched.get("stacked_sampler", 0),
                 self.tr["mc_chunk"], "float32", "float32", False)]

    def outputs(self, k: int):
        """Batch k's CSV rows of the window's run (read back after it)."""
        if self.rows is None:
            with open(os.path.join(self.scratch, "window.csv"),
                      newline="") as f:
                self.rows = list(csv.reader(f))[1:]
            if len(self.rows) != len(self.records) * self.tr["batch"]:
                raise RuntimeError(f"{len(self.rows)} CSV rows for "
                                   f"{len(self.records)} batches")
        b = self.tr["batch"]
        rows = self.rows[k * b:(k + 1) * b]
        col = lambda i: torch.tensor([float(r[i]) for r in rows],
                                     device=self.dev)
        return {"pu": col(2), "au": col(3), "cls": col(1).long()}

    def judge(self, quant: Optional[str] = None) -> Dict[str, float]:
        return _judge_predict(self, quant)


def _judge_predict(run: Loop, quant: Optional[str]) -> Dict[str, float]:
    """The gaps between the program's outputs of the sampled batches (or,
    with ``quant``, the reference's at that precision) and the
    reference's, over every patch of them."""
    cfg, tr = run.cfg, run.tr
    nchunks = tr["num_mc"] // tr["mc_chunk"]
    mask = torch.ones(tr["batch"], device=run.dev)
    cands, refs = [], []
    for k in run.sample(tr["check_batches"]):
        j, state = run.records[k][0], run.records[k][1]
        x = ref_predict.normalise(cfg, run.device_batch(j))
        seeds = _seed_words(state, nchunks)
        with torch.no_grad():
            ref = ref_predict.reductions(ref_predict.mc_logits(
                cfg, run.lay, run.mu, run.rho, run.bn, x, mask, seeds,
                tr["mc_chunk"], tr["sample_dtype"]))
            if quant is None:
                cand = run.outputs(k)
            else:
                c = ref_predict.reductions(ref_predict.mc_logits(
                    cfg, run.lay, run.mu, run.rho, run.bn, x, mask, seeds,
                    tr["mc_chunk"], tr["sample_dtype"], quant))
                cand = {"mean_prob": c["mean_prob"],
                        "pu": c["predictive_uncertainty"],
                        "au": c["aleatoric_uncertainty"],
                        "cls": c["mean_prob"].argmax(-1)}
        cands.append(cand)
        refs.append({"mean_prob": ref["mean_prob"],
                     "pu": ref["predictive_uncertainty"],
                     "au": ref["aleatoric_uncertainty"]})
    cat = lambda rows, key: torch.cat([r[key] for r in rows])
    out = {"pu_gap": _norm_gap(cat(cands, "pu"), cat(refs, "pu"))}
    ln_c = torch.log(torch.tensor(float(cfg["num_classes"])))
    au_c, au_r = cat(cands, "au"), cat(refs, "au")
    out["au_gap"] = float((au_c - au_r).abs().max()
                          / (ln_c - au_r).abs().max().clamp_min(1e-30))
    # the class each patch is given: how far the reference's probability
    # of it lies below the reference's best, over the widest spread of a
    # patch's reference probabilities (0 where the classes agree)
    p_ref = cat(refs, "mean_prob")
    got = p_ref.gather(1, cat(cands, "cls").long()[:, None])[:, 0]
    spread = (p_ref.max(-1).values - p_ref.min(-1).values).max()
    out["class_gap"] = float((p_ref.max(-1).values - got).max()
                             / spread.clamp_min(1e-30))
    if "mean_prob" in cands[0]:
        lp = lambda p: torch.log(p) - torch.log(p).mean(-1, keepdim=True)
        out["logprob_gap"] = _norm_gap(lp(cat(cands, "mean_prob")),
                                       lp(cat(refs, "mean_prob")))
    return out


class Train(Loop):
    flops_per_draw_item = 3.0  # forward and backward, remat's not counted

    def setup(self) -> None:
        from multimodal_auv_torch.config import BNNPriorSpec
        from multimodal_auv_torch.engine.optim import (
            BayesTrainState,
            make_optimizer,
        )
        from multimodal_auv_torch.engine.steps import make_train_step

        tr = self.tr
        self.make_inputs("float32")
        self.phase("inputs")
        # the program trains its own copy; the inputs stay for the reference
        self.start = {"mu": _host(self.mu), "rho": _host(self.rho),
                      "bn": {k: _host(v) for k, v in self.bn.items()},
                      "stats": {k: (_host(m), _host(v))
                                for k, (m, v) in self.stats.items()}}
        self.bundle = program.bundle(
            self.cfg, self.lay, self.mu.clone(), self.rho.clone(),
            {k: v.clone() for k, v in self.bn.items()},
            {k: (m.clone(), v.clone()) for k, (m, v) in self.stats.items()})
        del self.mu, self.rho
        spec = BNNPriorSpec(**self.cfg["prior"])
        tx = make_optimizer(tr["lr"], tr["weight_decay"])
        post = self.bundle.post
        self.state = BayesTrainState(post=post, opt_state=tx.init(post),
                                     batch_stats=self.bundle.batch_stats)
        self.step = self.timed(make_train_step(
            self.bundle.module, self.bundle.meta, spec, tr["num_mc"],
            mc_chunk=tr["mc_chunk"], remat=tr["remat"]))
        self.phase("bundle")
        self.csv = os.path.join(self.scratch, "train.csv")
        # the checked steps: the first ones, through the window's own call
        self.recording = True
        self.losses = []
        for t in range(tr["check_steps"]):
            _, loss = self._epoch(n=1)
            self.losses.append(loss * tr["batch"])
            if t == 0:
                self.grad1 = self._adam_gradient()
        self.checked = list(self.records)
        self.after = self._snapshot()
        self.recording = False
        self.phase("checked_steps")

    def _leaves(self) -> Dict:
        post = self.state.post
        out = {"mu": post.mu, "rho": post.rho}
        out.update(program.leaves(post.det))
        return out

    def _adam_gradient(self) -> Dict:
        """The first step's gradient as Adam took it: its first moment
        after one step over (1 - beta1)."""
        opt = self.state.opt_state
        out = {}
        for k, p in self._leaves().items():
            st = opt.state.get(p, {})
            m = st.get("exp_avg")
            beta1 = opt.param_groups[0]["betas"][0]
            out[k] = _host(torch.zeros_like(p) if m is None
                           else m / (1 - beta1))
        return out

    def _snapshot(self) -> Dict:
        stats = program.leaves(self.state.batch_stats)
        return {"params": {k: _host(v) for k, v in self._leaves().items()},
                "stats": {k: _host(v) for k, v in stats.items()}}

    def _epoch(self, n=None, deadline=None):
        from multimodal_auv_torch.engine.loops import train_unimodal_model
        from multimodal_auv_torch.utils.tb import NullSummaryWriter

        tr = self.tr
        key = {"image": "main_image", "sss": "sss_image",
               "bathy": "bathy_image"}[tr["modality"]]
        count = [0]

        def make(j):
            count[0] += 1
            b = self.pool[j]
            return {key: b["x"][0], "label": b["labels"]}

        feed = self.feed

        class Loader:
            batch_size = tr["batch"]

            def __iter__(self):
                return feed(n, deadline, make)

        self.state, _, loss = train_unimodal_model(
            self.step, self.state, Loader(), tr["epoch"], tr["num_epochs"],
            self.csv, tr["modality"], NullSummaryWriter(), self.gen,
            tr["lr"], strict_errors=True)
        return count[0] * tr["batch"], loss

    def loop(self, n=None, deadline=None) -> int:
        return self._epoch(n, deadline)[0]

    def sampler_calls(self, launched: Dict) -> List:
        c = self.tr["mc_chunk"]
        return [("stacked", launched.get("stacked_sampler", 0), c,
                 "float32", "float32", False),
                ("eps", launched.get("eps", 0), c, "float32", "float32",
                 False)]

    def judge(self, quant: Optional[str] = None) -> Dict[str, float]:
        tr, cfg, dev = self.tr, self.cfg, self.dev
        nchunks = tr["num_mc"] // tr["mc_chunk"]
        mask = torch.ones(tr["batch"], device=dev)
        batches, seeds = [], []
        for j, state in self.checked:
            b = self.pool[j]
            batches.append((torch.from_numpy(b["x"][0]).to(dev),
                            torch.from_numpy(b["labels"]).to(dev).long(),
                            mask))
            seeds.append(_seed_words(state, nchunks))
        s = self.start
        kl_weight = 2.0 ** (tr["epoch"] + 1 - tr["num_epochs"])
        run = lambda q: ref_train.run_steps(
            cfg, self.lay, s["mu"].to(dev), s["rho"].to(dev),
            {k: v.to(dev) for k, v in s["bn"].items()},
            {k: (m.to(dev), v.to(dev)) for k, (m, v) in s["stats"].items()},
            batches, seeds, tr["mc_chunk"], kl_weight, float(tr["batch"]),
            tr["lr"], tr["weight_decay"], q)
        ref = run(None)
        if quant is None:
            cand = {"loss": self.losses, "grad1": self.grad1,
                    "params": self.after["params"],
                    "stats": self.after["stats"]}
        else:
            c = run(quant)
            cand = {"loss": c["loss"], "grad1": c["grad1"],
                    "params": c["params"],
                    "stats": _stat_leaves(c["stats"])}
        return _judge_train(self.lay, s, ref, cand)


def _stat_leaves(stats: Dict) -> Dict:
    out = {}
    for path, (m, v) in stats.items():
        out[path + ("mean",)] = m
        out[path + ("var",)] = v
    return out


def _split(lay, tensors: Dict) -> Dict:
    """mu and rho cut into the layout's entries, beside the other leaves."""
    out = {}
    for k, v in tensors.items():
        if k in ("mu", "rho"):
            v = v.reshape(-1)
            for e in lay.entries:
                out[(k,) + e.path] = v[e.offset:e.offset + e.size]
        else:
            out[k] = v
    return out


def _judge_train(lay, start: Dict, ref: Dict, cand: Dict) -> Dict[str, float]:
    cpu = lambda d: {k: v.detach().float().cpu() for k, v in d.items()}
    loss = max(abs(c - r) / abs(rc) for c, r, rc in
               zip(cand["loss"], ref["loss"], ref["ce"]))
    g_ref = _split(lay, cpu(ref["grad1"]))
    g_cand = _split(lay, cpu(cand["grad1"]))
    grad, grad_leaf, grad_med = _leaf_gaps(g_cand, g_ref)
    # leaves the reference's gradient leaves at rounding (under a
    # thousandth of the median leaf's) move by round-off alone under Adam
    norms = {k: float(v.double().norm()) for k, v in g_ref.items()}
    med = float(torch.tensor(list(norms.values())).median())
    moved = {k for k, n in norms.items() if n >= 1e-3 * med}
    p0 = dict(start["bn"], mu=start["mu"], rho=start["rho"])
    d_ref = _split(lay, {k: v.float().cpu() - p0[k].float()
                         for k, v in ref["params"].items()})
    d_cand = _split(lay, {k: v.float().cpu() - p0[k].float()
                          for k, v in cand["params"].items()})
    change, change_leaf, change_med = _leaf_gaps(d_cand, d_ref, moved)
    stats, stats_leaf, _ = _leaf_gaps(cpu(cand["stats"]),
                                      cpu(_stat_leaves(ref["stats"])))
    return {"loss_gap": loss, "grad_median_gap": grad_med,
            "change_gap": change, "stats_gap": stats,
            # not compared (PERF.md): the worst leaf's gradient gap, the
            # median leaf's change, what they name
            "grad_gap": grad, "change_median_gap": change_med,
            "leaves_left_out": len(norms) - len(moved),
            "worst_leaves": [grad_leaf, change_leaf, stats_leaf]}


ENTRIES = {"packed_predict": PackedPredict,
           "unimodal_predict": UnimodalPredict, "train": Train}
