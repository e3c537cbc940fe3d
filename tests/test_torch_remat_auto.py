"""``make_train_step(remat="auto")`` of the port (``engine/steps.py``):
the JAX package's contract (``_AutoRematTrainStep``) with the port's own
measure, the bytes the no-remat step keeps for its backward.

The step resolves on its first call and then computes what the explicitly
chosen remat computes: the same loss, the same updated posterior and
statistics, the same generator state. Without a budget (the CPU) it is
remat on; a budget is injected (``steps.device_memory_budget``) to reach
the other branches.
"""
import numpy as np
import pytest
import torch

from multimodal_auv_torch.config import BNNPriorSpec
from multimodal_auv_torch.engine import steps
from multimodal_auv_torch.engine.optim import BayesTrainState, make_optimizer
from multimodal_auv_torch.models.model_utils import (
    ArchConfig,
    make_multimodal_bundle,
)

NUM_MC = 2


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """Small graphs: one intra-op thread, so no idle OpenMP threads spin on
    the cores the suite's other workers use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bundle():
    return make_multimodal_bundle(7, BNNPriorSpec(),
                                  torch.Generator().manual_seed(0),
                                  ArchConfig.micro(), device="cpu")


def _batch():
    rng = np.random.default_rng(3)
    u8 = [torch.from_numpy(rng.integers(0, 256, (3, 32, 32, c),
                                        dtype=np.uint8)) for c in (3, 3, 1)]
    return u8, torch.tensor([0, 2, 2]), torch.tensor([1.0, 1.0, 0.0])


def _run(remat, monkeypatch=None, budget_bytes=None):
    """One step of a fresh micro() state: (step, loss, mu, rho, stats,
    generator state after the step); ``budget_bytes`` injected as the
    device's budget."""
    if budget_bytes is not None:
        monkeypatch.setattr(steps, "device_memory_budget",
                            lambda device: budget_bytes)
    b = _bundle()
    state = BayesTrainState(b.post, make_optimizer(1e-3).init(b.post),
                            b.batch_stats)
    step = steps.make_train_step(b.module, b.meta, BNNPriorSpec(), NUM_MC,
                                 packed_inputs=True, remat=remat)
    gen = torch.Generator().manual_seed(7)
    u8, labels, mask = _batch()
    state, m = step(state, u8, labels, mask, gen, 1e-6, 3.0)
    return (step, m["loss"], state.post.mu.detach().clone(),
            state.post.rho.detach().clone(), state.batch_stats,
            gen.get_state())


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _assert_same(a, b):
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    want = dict(_flat(b[4]))
    for path, leaf in _flat(a[4]):
        assert torch.equal(leaf, want[path]), path
    assert torch.equal(a[5], b[5])


@pytest.fixture(scope="module")
def explicit():
    return {r: _run(r) for r in ("on", "off")}


def test_auto_on_cpu_is_remat_on(explicit):
    """No budget on the CPU: remat on, with no trial; the first step is
    the explicit "on" step's bit for bit, generator state included."""
    got = _run("auto")
    step = got[0]
    assert isinstance(step, steps.AutoRematTrainStep)
    assert step.remat_used is True and step.budget_bytes is None
    assert step.need_bytes is None
    _assert_same(got, explicit["on"])


def test_auto_large_budget_is_remat_off(monkeypatch, explicit):
    """A budget the measure fits: remat off, bit-equal to the explicit
    "off" step; the need is positive and logged in bytes."""
    got = _run("auto", monkeypatch, budget_bytes=1 << 40)
    step = got[0]
    assert step.remat_used is False and 0 < step.need_bytes < 1 << 40
    _assert_same(got, explicit["off"])


def test_auto_small_budget_is_remat_on(monkeypatch, explicit):
    """A budget below the measured need: remat on, bit-equal to "on"."""
    got = _run("auto", monkeypatch, budget_bytes=1024)
    step = got[0]
    assert step.remat_used is True and step.need_bytes > 1024
    _assert_same(got, explicit["on"])


def test_measure_scales_with_draws(monkeypatch):
    """The need grows with num_mc by the bytes one draw keeps (two trials:
    one and two draws), and the trials leave no gradient and consume no
    draw of the caller's generator."""
    monkeypatch.setattr(steps, "device_memory_budget", lambda d: 1 << 40)
    b = _bundle()
    u8, labels, mask = _batch()
    need = {}
    for n in (2, 4):
        auto = steps.make_train_step(b.module, b.meta, BNNPriorSpec(), n,
                                     packed_inputs=True, remat="auto")
        state = BayesTrainState(b.post, make_optimizer(1e-3).init(b.post),
                                b.batch_stats)
        gen = torch.Generator().manual_seed(1)
        before = gen.get_state()
        assert auto._fits(state, u8, labels, mask, gen, 1e-6, 3.0)
        assert torch.equal(gen.get_state(), before)
        assert b.post.mu.grad is None and b.post.rho.grad is None
        need[n] = auto.need_bytes
    per_draw = (need[4] - need[2]) / 2
    assert per_draw > 0 and need[2] > 2 * per_draw  # a fixed part too


@pytest.mark.parametrize("error,falls_back", [
    (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate"), True),
    (RuntimeError("boom"), False)])
def test_auto_trial_errors(monkeypatch, explicit, error, falls_back):
    """Only running out of memory in the trial falls back to remat on
    (bit-equal to "on"); any other error is raised."""
    def failing(fn):
        raise error

    monkeypatch.setattr(steps, "saved_bytes", failing)
    if falls_back:
        got = _run("auto", monkeypatch, budget_bytes=1 << 40)
        assert got[0].remat_used is True
        _assert_same(got, explicit["on"])
    else:
        with pytest.raises(RuntimeError, match="boom"):
            _run("auto", monkeypatch, budget_bytes=1 << 40)
