"""Train-mode BatchNorm's forward as two kernels (``csrc/batchnorm.cu``).

* ``bn_stats`` (the op ``torch.ops.auv.bn_stats``): one read of the
  activation gives a (2C + 1) f32 tensor, the per-channel sums of x and x^2
  over the rows the batch mask keeps and their element count, or with
  ``means`` the sums divided by the count (E[x], E[x^2]);
* ``bn_apply`` (``torch.ops.auv.bn_apply``): y = ((x - mean) * mul + bias)
  rounded to x's type, mul = rsqrt(var + eps) * scale, from the mean and
  E[x^2] (var = E[x^2] - E[x]^2 clipped at 0) or, with ``second_is_var``,
  the variance itself; then, optionally, + a residual (rounded again) and
  ReLU.

Each op dispatches by device: on a CUDA tensor it launches its kernel; on
the CPU it runs its plain version below (``stats_plain``, ``apply_plain``),
which is ``models/resnet.py``'s plain BatchNorm operation for operation.
The kernels round where the plain versions round (f32 arithmetic, then the
activation's type, then the residual add in f32 and its rounding), so
their outputs differ only by the order in which the statistics are summed.
Both ops have fake implementations, so ``torch.export`` programs made on
the card carry them.

The kernels read channels-last tensors, what the trunks hand BatchNorm (they
permute NHWC inputs to NCHW views). A contiguous NCHW tensor is converted
to that layout and the output back (``rows_layout`` tells them apart from
the strides); any other layout is refused. The geometry of a launch (``geometry``) depends on the
shape and the card's SM count alone, so a call is deterministic. The
statistics kernel's last block of each channel tile adds the blocks'
partial sums in order; it finds out it is last from an integer ticket in a
buffer kept per (card, stream) (``_tickets``), which every launch leaves
zeroed for the next one on its stream.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from multimodal_auv_torch.ops import kernels

THREADS = 256          # a block of the apply kernel
STATS_THREADS = 512    # a block of the statistics kernel
TILE = 32              # the most channel vectors a block's row spans
BLOCKS_PER_SM = 4      # the grid: about one wave of resident blocks ...
STATS_BLOCKS_PER_SM = 2  # ... two of the statistics kernel's
ROWS_PER_THREAD = 32   # a statistics block's least rows a thread

_DTYPES = (torch.float32, torch.bfloat16)
_SMS: Dict[int, int] = {}
_PLANS: Dict[tuple, tuple] = {}
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_TICKETS_LOCK = threading.Lock()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float32 else t.to(torch.float32)


def stats_plain(x: torch.Tensor, mask: Optional[torch.Tensor],
                means: bool = False) -> torch.Tensor:
    """The plain version of ``bn_stats``: ``models/resnet.py``'s masked
    sums, as a (2C + 1) f32 tensor [sums of x | sums of x^2 | count], with
    ``means`` the first 2C divided by the count."""
    sums, count = masked_sums(_f32(x), mask)
    if means:
        sums = sums / count
    return torch.cat([sums, torch.as_tensor(
        count, dtype=torch.float32, device=x.device).reshape(1)])


def masked_sums(x32: torch.Tensor, mask: Optional[torch.Tensor]):
    """(per-channel sums of x and x^2 as one 2C tensor, their element
    count) over the rows of NCHW f32 ``x32`` that the bool (N,) ``mask``
    keeps: the count is a Python int without a mask, else a 0-d f32
    tensor."""
    rows = x32.shape[0]
    if mask is not None:
        x32 = torch.where(mask.view(-1, 1, 1, 1), x32, 0.0)
        rows = mask.sum().to(torch.float32)
    sums = torch.cat([x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3))])
    return sums, rows * (x32.shape[2] * x32.shape[3])


def apply_plain(x: torch.Tensor, mean: torch.Tensor, second: torch.Tensor,
                scale: torch.Tensor, bias: torch.Tensor, eps: float,
                second_is_var: bool, residual: Optional[torch.Tensor],
                relu: bool, dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """The plain version of ``bn_apply``: the normalisation in f32, cast to
    ``dtype`` (x's by default), then + ``residual`` and ReLU."""
    var = second if second_is_var else torch.clamp_min(
        second - mean * mean, 0.0)
    y = _f32(x) - mean.view(1, -1, 1, 1)
    mul = torch.rsqrt(var + eps) * scale
    y = y * mul.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    dtype = x.dtype if dtype is None else dtype
    y = y if y.dtype == dtype else y.to(dtype)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def rows_layout(x: torch.Tensor) -> bool:
    """True for a channels-last (N, C, H, W) tensor, False for a
    contiguous NCHW one (channels-last first: with H W = 1 or C = 1 they
    are the same memory); any other layout raises."""
    if x.dim() != 4:
        raise ValueError(f"BatchNorm kernels take (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    if x.is_contiguous():
        return False
    raise ValueError(f"BatchNorm kernels take channels-last or contiguous "
                     f"NCHW tensors, got strides {x.stride()} for "
                     f"{tuple(x.shape)}")


def geometry(N: int, C: int, HW: int, vec: int, sms: int,
             stats: bool) -> Tuple[int, int]:
    """(tx, grid) of a launch: ``tx`` channel vectors a block's row (the
    largest divisor of C / vec up to ``TILE``) and the blocks along the
    rows. About ``BLOCKS_PER_SM`` blocks an SM in all (the statistics'
    ``STATS_BLOCKS_PER_SM``), fewer where a statistics block would get
    fewer than ``ROWS_PER_THREAD`` rows a thread."""
    cv = C // vec
    tx = max(d for d in range(1, min(cv, TILE) + 1) if cv % d == 0)
    ty = (STATS_THREADS if stats else THREADS) // tx
    wave = (STATS_BLOCKS_PER_SM if stats else BLOCKS_PER_SM) * sms
    work = -(-N * HW // (ty * (ROWS_PER_THREAD if stats else 1)))
    return tx, max(1, min(work, -(-wave // (cv // tx))))


def _sms(index: int) -> int:
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def _tickets(index: int, stream: int, n: int) -> torch.Tensor:
    """The statistics kernel's zeroed tickets for launches on ``stream``
    of card ``index``, at least ``n`` of them (each launch leaves them
    zeroed)."""
    key = (index, stream)
    with _TICKETS_LOCK:
        t = _TICKETS.get(key)
        if t is None or t.numel() < n:
            t = torch.zeros(max(n, 1024), dtype=torch.int32,
                            device=torch.device("cuda", index))
            _TICKETS[key] = t
        return t


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"bn_stats_launch": [_P] * 5 + [_I] * 8 + [_P],
             "bn_apply_launch": [_P] * 7 + [ctypes.c_float] + [_I] * 9
             + [_P]}
_FNS: Dict[str, object] = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(kernels.load("batchnorm"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch(name: str, index: int, args_of) -> None:
    """Call launch function ``name`` with ``args_of(stream)`` on card
    ``index``'s current stream, that card made current for the call (the
    ctypes calls set no device of their own)."""
    fn = _fn(name)
    if torch.cuda.current_device() == index:
        rc = fn(*args_of(torch._C._cuda_getCurrentRawStream(index)))
    else:
        with torch.cuda.device(index):
            rc = fn(*args_of(torch._C._cuda_getCurrentRawStream(index)))
    kernels.check(rc, name)


def _plan(x: torch.Tensor, stats: bool, aligned: bool) -> tuple:
    """(vec, tx, grid, bf16) of a launch over channels-last ``x``, kept by
    its shape, type and card (every layer of a forward meets the same
    few): the elements a thread loads (16 bytes where ``aligned`` and the
    row allows), and the geometry."""
    key = (x.shape, x.dtype, x.get_device(), stats, aligned)
    plan = _PLANS.get(key)
    if plan is None:
        if x.dtype not in _DTYPES:
            raise ValueError(f"BatchNorm kernels take f32 or bf16, got "
                             f"{x.dtype}")
        N, C, H, W = x.shape
        if N * H * W >= 2 ** 31:
            raise ValueError(f"BatchNorm kernels take fewer than 2^31 rows, "
                             f"got {N * H * W}")
        v = 16 // x.element_size()
        vec = v if aligned and C % v == 0 else 1
        tx, grid = geometry(N, C, H * W, vec, _sms(x.get_device()), stats)
        plan = _PLANS[key] = (vec, tx, grid, int(x.dtype == torch.bfloat16))
    return plan


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the kernels' channels-last layout: itself, or a contiguous
    NCHW tensor converted."""
    return x if rows_layout(x) else x.contiguous(
        memory_format=torch.channels_last)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts if t is not None)


def _stats_cuda(x: torch.Tensor, mask: Optional[torch.Tensor],
                means: bool) -> torch.Tensor:
    x = _rows(x)
    vec, tx, grid, bf16 = _plan(x, True, _aligned(x))
    N, C, H, W = x.shape
    index = x.get_device()
    if mask is not None:
        if mask.dtype != torch.bool or not mask.is_contiguous():
            mask = mask.reshape(-1).to(torch.bool).contiguous()
        if mask.numel() != N or mask.get_device() != index:
            raise ValueError(f"mask: ({N},) on {x.device}, got "
                             f"{tuple(mask.shape)} on {mask.device}")
    # the result, then the blocks' partial sums
    buf = x.new_empty(2 * C + 1 + grid * 2 * C, dtype=torch.float32)
    ptr = buf.data_ptr()

    def args(stream):
        tickets = _tickets(index, stream, C // vec // tx)
        return (x.data_ptr(), None if mask is None else mask.data_ptr(), ptr,
                ptr + 4 * (2 * C + 1), tickets.data_ptr(), N, C, H * W, bf16,
                vec, tx, grid, int(means), stream)

    _launch("bn_stats_launch", index, args)
    kernels.count("bn_stats")
    return buf[:2 * C + 1]


def _channel_vector(t: torch.Tensor, C: int, index: int) -> torch.Tensor:
    if (t.dtype == torch.float32 and t.is_contiguous() and t.dim() == 1
            and t.shape[0] == C and t.get_device() == index):
        return t
    t = _f32(t).contiguous()
    if t.shape != (C,) or t.get_device() != index:
        raise ValueError(f"per-channel vectors: ({C},) on cuda:{index}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t


def _apply_cuda(x, mean, second, scale, bias, eps, second_is_var, residual,
                relu):
    N, C, H, W = x.shape
    index = x.get_device()
    vecs = [_channel_vector(t, C, index) for t in (mean, second, scale, bias)]
    nchw = not rows_layout(x)
    if nchw:
        x = x.contiguous(memory_format=torch.channels_last)
    if residual is not None:
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError(f"residual: {tuple(x.shape)} {x.dtype}, got "
                             f"{tuple(residual.shape)} {residual.dtype}")
        if residual.stride() != x.stride():
            residual = residual.contiguous(memory_format=torch.channels_last)
    vec, tx, grid, bf16 = _plan(x, False, _aligned(x, residual))
    y = torch.empty_like(x)
    _launch("bn_apply_launch", index, lambda stream: (
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        y.data_ptr(), *(t.data_ptr() for t in vecs), float(eps),
        int(second_is_var), int(relu), N, C, H * W, bf16, vec, tx, grid,
        stream))
    kernels.count("bn_apply")
    return y.contiguous() if nchw else y


def _eager_cuda(x: torch.Tensor) -> bool:
    """A real CUDA tensor outside any tracing: the kernel is launched
    directly. Through the op, torch's custom-op wrapper costs ~10 us of
    host a call, and its first call imports torch._dynamo (~8 s of set-up
    in a process that calls no other op). Under ``torch.export`` (fake
    tensors) or dynamo the op is called, so a program records it."""
    return (type(x) is torch.Tensor and x.is_cuda
            and not torch.compiler.is_compiling())


def stats(x: torch.Tensor, mask: Optional[torch.Tensor],
          means: bool) -> torch.Tensor:
    """``auv::bn_stats``, launched directly on a real CUDA tensor."""
    if _eager_cuda(x):
        return _stats_cuda(x, mask, means)
    return torch.ops.auv.bn_stats(x, mask, means)


def apply(x, mean, second, scale, bias, eps: float, second_is_var: bool,
          residual: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    """``auv::bn_apply``, launched directly on a real CUDA tensor."""
    if _eager_cuda(x):
        return _apply_cuda(x, mean, second, scale, bias, eps, second_is_var,
                           residual, relu)
    return torch.ops.auv.bn_apply(x, mean, second, scale, bias, eps,
                                  second_is_var, residual, relu)


@torch.library.custom_op("auv::bn_stats", mutates_args=(), device_types="cpu")
def bn_stats(x: torch.Tensor, mask: Optional[torch.Tensor],
             means: bool) -> torch.Tensor:
    """BatchNorm's statistics of NCHW ``x`` over the rows the bool (N,)
    ``mask`` keeps (None: all): (2C + 1) f32, [sums of x | sums of x^2 |
    count], or with ``means`` [E[x] | E[x^2] | count]. This body is the
    CPU implementation, the plain version."""
    return stats_plain(x, mask, means)


@bn_stats.register_kernel("cuda")
def _bn_stats_kernel(x, mask, means):
    return _stats_cuda(x, mask, means)


@bn_stats.register_fake
def _bn_stats_fake(x, mask, means):
    return x.new_empty(2 * x.shape[1] + 1, dtype=torch.float32)


@torch.library.custom_op("auv::bn_apply", mutates_args=(), device_types="cpu")
def bn_apply(x: torch.Tensor, mean: torch.Tensor, second: torch.Tensor,
             scale: torch.Tensor, bias: torch.Tensor, eps: float,
             second_is_var: bool, residual: Optional[torch.Tensor],
             relu: bool) -> torch.Tensor:
    """BatchNorm of NCHW ``x`` from its per-channel mean and E[x^2] (the
    variance with ``second_is_var``), then + ``residual`` and ReLU, in x's
    type and layout. This body is the CPU implementation, the plain
    version."""
    return apply_plain(x, mean, second, scale, bias, eps, second_is_var,
                       residual, relu)


@bn_apply.register_kernel("cuda")
def _bn_apply_kernel(x, mean, second, scale, bias, eps, second_is_var,
                     residual, relu):
    return _apply_cuda(x, mean, second, scale, bias, eps, second_is_var,
                       residual, relu)


@bn_apply.register_fake
def _bn_apply_fake(x, mean, second, scale, bias, eps, second_is_var,
                   residual, relu):
    return torch.empty_like(x)


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def on_kernels(x: torch.Tensor, *others: Optional[torch.Tensor]) -> bool:
    """Whether BatchNorm over ``x`` takes the kernels: a CUDA tensor of f32
    or bf16 through which autograd records nothing (neither ``x`` nor any
    of ``others`` requires grad while grad mode is on). Anything else, the
    CPU and a training forward among it, takes the plain operations: the
    kernels have no backward."""
    if torch.is_grad_enabled() and (x.requires_grad or any(
            t is not None and t.requires_grad for t in others)):
        return False
    return _on_card(x) and x.dtype in _DTYPES
