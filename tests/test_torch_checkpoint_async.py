"""Async checkpoint saves and the tolerant posterior restore of the port
(``engine/checkpointing.py``), against the JAX package's contract
(orbax's ``AsyncCheckpointer`` through ``save_pytree`` /
``wait_for_saves``, and ``load_and_fix_state_dict``).

A background write is held back, where the order of events matters, by a
writer that waits on an event the test sets: so each check holds whatever
the thread scheduling.
"""
import logging
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_auv_torch.bayes.packing import PackedPosterior
from multimodal_auv_torch.engine import checkpointing as ckpt
from multimodal_auv_torch.engine.optim import BayesTrainState, make_optimizer
from multimodal_auv_tpu.bayes.packing import PackedPosterior as JPost
from multimodal_auv_tpu.engine import checkpointing as jckpt


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _post(seed=0, P=256):
    g = torch.Generator().manual_seed(seed)
    det = {"bn": {"scale": torch.rand(4, generator=g),
                  "bias": torch.rand(4, generator=g)},
           "head": {"bias": torch.rand(3, generator=g)}}
    return PackedPosterior(torch.randn(P, generator=g),
                           torch.randn(P, generator=g) - 3.0, det)


def _state(seed=0):
    post = _post(seed)
    opt = make_optimizer(1e-2).init(post)
    (post.mu.sum() + post.rho.sum()).backward()
    opt.step()  # Adam moments exist
    return BayesTrainState(post=post, opt_state=opt,
                           batch_stats={"bn": {"mean": torch.zeros(4),
                                               "var": torch.ones(4)}},
                           step=3)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    else:
        yield path, tree


def _assert_files_equal(a, b):
    fa = dict(_flat(torch.load(a, weights_only=True)))
    fb = dict(_flat(torch.load(b, weights_only=True)))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


@pytest.fixture
def held_writer(monkeypatch):
    """Background writes wait for ``release.set()`` (10 s at most)."""
    release = threading.Event()
    real = ckpt._write

    def held(obj, path):
        assert release.wait(10)
        real(obj, path)

    monkeypatch.setattr(ckpt, "_write", held)
    yield release
    release.set()
    ckpt.wait_for_saves()


def test_async_file_equals_sync(tmp_path):
    """``save_train_state(async_save=True)`` writes the file the
    synchronous save writes (posterior, Adam state, statistics, step,
    epoch, scheduler counts); so does ``save_model``."""
    st = _state()
    a, b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    assert ckpt.save_train_state(a, st, 2, {"m": 1}, async_save=True) == a
    ckpt.save_train_state(b, st, 2, {"m": 1})
    ckpt.wait_for_saves()
    _assert_files_equal(a, b)
    csv = str(tmp_path / "run" / "csvs" / "x.csv")
    path = ckpt.save_model(st.post, csv, "m", async_save=True)
    ckpt.wait_for_saves()
    got = ckpt.load_posterior(path)
    assert torch.equal(got.mu, st.post.mu.detach())
    assert torch.equal(got.det["bn"]["scale"], st.post.det["bn"]["scale"])


def test_async_snapshot_ignores_later_updates(tmp_path, held_writer):
    """The copy is made before the call returns: a state updated in place
    after the call (an optimizer step, a BN update) does not reach the
    file, although the write runs after it."""
    st = _state()
    want = {k: v.detach().clone() for k, v in
            (("mu", st.post.mu), ("rho", st.post.rho))}
    m0 = st.opt_state.state_dict()["state"][0]["exp_avg"].clone()
    path = str(tmp_path / "s.pt")
    ckpt.save_train_state(path, st, 1, async_save=True)
    with torch.no_grad():
        st.post.mu.add_(1.0)
        st.post.rho.mul_(2.0)
        st.opt_state.state[st.post.mu]["exp_avg"].add_(5.0)
    held_writer.set()
    ckpt.wait_for_saves()
    d = torch.load(path, weights_only=True)
    assert torch.equal(d["state"]["post"]["mu"], want["mu"])
    assert torch.equal(d["state"]["post"]["rho"], want["rho"])
    assert torch.equal(d["state"]["opt_state"]["state"][0]["exp_avg"], m0)


def test_sync_save_after_async_save_wins(tmp_path, held_writer):
    """A synchronous save (the loops' crash-save) drains the queue first,
    so an older background write never lands over the newer file; back-to-
    back async saves commit in order."""
    path = str(tmp_path / "s.pt")
    old, new = _state(0), _state(1)
    ckpt.save_train_state(path, old, 1, async_save=True)
    ckpt.save_train_state(path, _state(2), 2, async_save=True)
    threading.Timer(0.3, held_writer.set).start()
    ckpt.save_train_state(path, new, 3)  # waits for both, then writes
    d = torch.load(path, weights_only=True)
    assert d["epoch"] == 3
    assert torch.equal(d["state"]["post"]["mu"], new.post.mu.detach())
    assert not ckpt._PENDING


def test_background_error_is_raised(tmp_path, monkeypatch):
    """A failure of the background write is not swallowed:
    ``wait_for_saves`` raises it (``save_model`` too, whose synchronous
    failures are logged and return None), and the queue is empty after."""
    def broken(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", broken)
    st = _state()
    ckpt.save_train_state(str(tmp_path / "s.pt"), st, 1, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_saves()
    assert ckpt.save_model(st.post, str(tmp_path / "c" / "x.csv"), "m",
                           async_save=True)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_saves()
    ckpt.wait_for_saves()  # nothing left
    assert ckpt.save_model(st.post, str(tmp_path / "c" / "x.csv"),
                           "m") is None


def test_concurrent_async_saves(tmp_path):
    """12 threads (more than the cores a test worker has) each queue 4
    async saves of their own posterior, with the interpreter switching
    threads every 10 us: after one ``wait_for_saves`` every file holds
    its thread's last posterior and the queue is empty (a lost append to
    the queue would leave a file unwritten or stale). Each join is
    bounded, and every thread must have finished."""
    import sys

    posts = [_post(i, P=128) for i in range(12)]
    errors = []

    def worker(i):
        try:
            for rep in range(4):
                with torch.no_grad():
                    posts[i].mu.fill_(float(100 * i + rep))
                ckpt.save_model(posts[i], str(tmp_path / f"r{i}" / "c" /
                                              "x.csv"), "m", async_save=True)
        except Exception as e:  # reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(posts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads) and not errors
        ckpt.wait_for_saves()
    finally:
        sys.setswitchinterval(switch)
    assert not ckpt._PENDING
    for i in range(len(posts)):
        got = ckpt.load_posterior(str(tmp_path / f"r{i}" / "models" /
                                      "bayesian_model_typem"))
        assert torch.all(got.mu == float(100 * i + 3)), i


def test_restore_waits_for_the_write(tmp_path, held_writer):
    """``restore_train_state`` and ``load_posterior`` read only after the
    background writes have committed."""
    path = str(tmp_path / "s.pt")
    st = _state(4)
    ckpt.save_train_state(path, st, 7, {"m": 2}, async_save=True)
    assert not os.path.exists(path)
    threading.Timer(0.3, held_writer.set).start()
    template = _state(5)
    restored, epoch, sched = ckpt.restore_train_state(path, template)
    assert (epoch, sched) == (7, {"m": 2})
    assert torch.equal(restored.post.mu.detach(), st.post.mu.detach())


def test_epoch_loop_returns_with_nothing_in_flight(tmp_path, monkeypatch):
    """``run_unimodal_training(async_checkpoints=True)`` with a resume
    checkpoint, epochs 0 and 1: the three background writes (epoch 0's
    posterior, each epoch's train state) have committed when it returns
    (the loops' ``finally``), and the file is the run's last epoch."""
    from multimodal_auv_torch.models.model_utils import ArchConfig
    from multimodal_auv_torch.pipelines.unimodal import run_unimodal_training
    from tests.fixtures.make_tree import make_training_tree

    monkeypatch.chdir(tmp_path)
    writes = []
    real = ckpt._write

    def slow(obj, path):
        threading.Event().wait(0.2)
        real(obj, path)
        writes.append(path)

    monkeypatch.setattr(ckpt, "_write", slow)
    root = make_training_tree(str(tmp_path / "tree"), n_samples=6)
    state_path = str(tmp_path / "state.pt")
    state = run_unimodal_training(root, "image", num_epochs=2, num_mc=2,
                                  batch_size=2, arch=ArchConfig.micro(),
                                  handle_preemption=False, device="cpu",
                                  resume_checkpoint=state_path,
                                  skip_epoch_zero=False,
                                  async_checkpoints=True)
    assert not ckpt._PENDING
    assert writes.count(state_path) == 2 and len(writes) == 3
    saved = torch.load(state_path, weights_only=True)
    assert saved["epoch"] == 2 and saved["state"]["step"] == state.step


# ---------------------------------------------------------------- restore


def _raw(post, drop=(), reshape=(), extra=False):
    """The save_model dict of ``post`` with leaves dropped or reshaped (by
    path) and an unknown leaf added."""
    d = {"mu": post.mu, "rho": post.rho,
         "det": {k: dict(v) for k, v in post.det.items()}}
    for path in drop:
        node = d
        for p in path[:-1]:
            node = node[p]
        del node[path[-1]]
    for path in reshape:
        node = d
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = torch.zeros(node[path[-1]].numel() + 1)
    if extra:
        d["det"]["unknown"] = {"w": torch.ones(2)}
    return d


def _kept(result, caller):
    """The paths whose leaf comes from the file (differs from the
    caller's)."""
    got = dict(_flat({"mu": result.mu, "rho": result.rho,
                      "det": result.det}))
    own = dict(_flat({"mu": caller.mu, "rho": caller.rho,
                      "det": caller.det}))
    return sorted(k for k in got if not np.array_equal(np.asarray(got[k]),
                                                       np.asarray(own[k])))


CASES = {
    "all": dict(),
    "dropped": dict(drop=[("det", "head", "bias"), ("rho",)]),
    "mismatched": dict(reshape=[("mu",), ("det", "bn", "scale")],
                       extra=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_and_fix_keeps_the_leaves_jax_keeps(tmp_path, caplog, case):
    """The same trees through both packages: the file (a torch file here,
    an orbax directory there) holds ``_post(1)`` with leaves dropped,
    reshaped or added; the caller's posterior is ``_post(0)``. Both return
    ok and keep the same leaves from the file, bit-equal values, the rest
    the caller's; the warning names the dropped leaves."""
    src, caller = _post(1), _post(0)
    raw = _raw(src, **CASES[case])
    tpath = str(tmp_path / "t.pt")
    torch.save(raw, tpath)
    jpath = str(tmp_path / "orbax")
    to_j = lambda t: {k: to_j(v) for k, v in t.items()} if isinstance(
        t, dict) else np.asarray(t)
    jckpt.save_pytree(jpath, to_j(raw))
    jcaller = JPost(jnp.asarray(caller.mu.numpy()),
                    jnp.asarray(caller.rho.numpy()),
                    jax_tree(caller.det))
    jout, jok = jckpt.load_and_fix_state_dict(jcaller, jpath)
    with caplog.at_level(logging.WARNING):
        out, ok = ckpt.load_and_fix_state_dict(caller, tpath)
    assert ok and jok
    jres = PackedPosterior(torch.from_numpy(np.array(jout.mu)),
                           torch.from_numpy(np.array(jout.rho)),
                           torch_tree(jout.det))
    kept = _kept(out, caller)
    assert kept == _kept(jres, caller)
    n_dropped = 5 - len(kept)
    assert n_dropped == {"all": 0, "dropped": 2, "mismatched": 2}[case]
    for path, leaf in _flat({"mu": out.mu, "rho": out.rho, "det": out.det}):
        src_leaf = dict(_flat({"mu": src.mu, "rho": src.rho,
                               "det": src.det}))[path]
        want = src_leaf if path in kept else dict(_flat(
            {"mu": caller.mu, "rho": caller.rho, "det": caller.det}))[path]
        assert torch.equal(leaf, want), path
    if n_dropped:
        assert "keep their input values" in caplog.text


def jax_tree(tree):
    return {k: jax_tree(v) for k, v in tree.items()} if isinstance(
        tree, dict) else jnp.asarray(tree.numpy())


def torch_tree(tree):
    return {k: torch_tree(v) for k, v in tree.items()} if isinstance(
        tree, dict) else torch.from_numpy(np.array(tree))


def test_load_and_fix_failures(tmp_path, caplog):
    """An unreadable path (missing, a garbage file, a directory such as an
    orbax checkpoint) and a file that matches no leaf return (post, False)
    with the caller's posterior itself; dtype and device of kept leaves
    are the caller's."""
    caller = _post(0)
    garbage = tmp_path / "g.pt"
    garbage.write_bytes(b"not a checkpoint")
    os.makedirs(tmp_path / "orbax")
    nomatch = str(tmp_path / "n.pt")
    torch.save({"other": {"w": torch.ones(3)}}, nomatch)
    with caplog.at_level(logging.ERROR):
        for path in (str(tmp_path / "missing.pt"), str(garbage),
                     str(tmp_path / "orbax"), nomatch):
            out, ok = ckpt.load_and_fix_state_dict(caller, path)
            assert ok is False and out is caller, path
    assert "matched zero leaves" in caplog.text
    half = _raw(_post(1))
    half["mu"] = half["mu"].to(torch.float64)
    path = str(tmp_path / "h.pt")
    torch.save(half, path)
    out, ok = ckpt.load_and_fix_state_dict(caller, path)
    assert ok and out.mu.dtype == torch.float32
    assert torch.equal(out.mu, _post(1).mu)
