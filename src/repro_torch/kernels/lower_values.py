"""The value lowering for Hopper, beside its plain PyTorch version.

A hand-written kernel with no TPU counterpart: in the reference, XLA
fuses this work inside the jitted lowering (``repro/serve/compile.py``'s
gathers and ``repro/serve/admission.py::quantize_states_device``):

  lower_values_cuda (the lower_values kernel) <- none (XLA-fused);
  plain: lower_values_plain

For each (slot, device) element of a realized workload (arrival ``on``,
image ``img``, channel rate ``rates``) the lowering writes the state
index ``j`` (0 where no task arrives) and the raw overlay values o, h, w,
correct_local, correct_cloud and d_local.  Every one of them is a
function of (rate, image) alone: o and o's level of the rate; h, w
(``clamp(risk_adjusted_gain(phi_hat, sigma) - zeta_pen, 0, 1)``), their
levels and the three pool values of the image.  So :func:`value_tables`
resolves them once per compile into :class:`ValueTables`' records, with
the plain route's own ops on the (R,) and (S,) arrays: an elementwise op
gives the same value for the same input however many elements it runs
over, so the records hold, bit for bit, what the plain route computes per
element.  This module owns the records' format; the kernel reads it.  The kernel (``lower_values_kernel`` in ``csrc/draws.cu``, the
lowering's library; its note there gives the bound) is then a pure
gather: ``j = on ? rate_part[rate] + image_part[img] : 0`` and six
copies.  The plain version is the eager per-element code, unchanged.
``lower_values_cuda.launches`` counts calls, one kernel each.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.onalgo import risk_adjusted_gain
from repro_torch.kernels import build
from repro_torch.serve.admission import nearest_level, quantize_states_device

_SOURCE = "draws"  # the lowering's library: the draws and this kernel
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
IMAGE_FIELDS = 8  # int32 words of an image record: 24 B of fields, 8 pad


@dataclasses.dataclass(frozen=True)
class ValueTables:
    """The value lowering's inputs on one device, both routes' forms.

    The plain route's: ``space`` (the calibrated state space), the float32
    per-rate ``o_levels`` (R,) and per-image ``cycles``, ``phi_hat``,
    ``sigma``, ``d_local``, ``corr_local``, ``corr_cloud`` (S,), and the
    float32 scalars ``v_risk`` and ``zeta_pen``.  The kernel's, resolved
    from them: ``rate_rec`` (R, 2) int32, a rate's o (float32 bits) and
    its part of j, ``io * lh * lw + 1`` (null-aware); ``image_rec`` (S, 8)
    int32, an image's ``ih * lw + iw`` and the float32 bits of its
    cycles, w, correct_local, correct_cloud and d_local, then two words of
    padding: a 32-byte record, one L2 sector."""

    space: object
    o_levels: torch.Tensor
    cycles: torch.Tensor
    phi_hat: torch.Tensor
    sigma: torch.Tensor
    d_local: torch.Tensor
    corr_local: torch.Tensor
    corr_cloud: torch.Tensor
    v_risk: float
    zeta_pen: float
    rate_rec: torch.Tensor
    image_rec: torch.Tensor


def value_tables(space, o_levels, cycles, phi_hat, sigma, d_local,
                 corr_local, corr_cloud, v_risk, zeta_pen) -> ValueTables:
    """The value lowering's inputs with their per-rate and per-image
    records, on the arrays' device.  The records come from the plain
    route's own ops on the (R,) and (S,) arrays: the same
    ``risk_adjusted_gain``, the same clamp of ``w - zeta_pen``, the same
    float32 ``nearest_level``; elementwise, so they hold, bit for bit, what
    the plain route computes for every element of their rate or image.
    Uploads nothing but the level grids' first (``level_grid``) and reads
    nothing back."""
    w = risk_adjusted_gain(phi_hat, sigma, v_risk)
    w = torch.clamp(w - zeta_pen, 0.0, 1.0)
    io = nearest_level(o_levels, space.o_levels)
    ih = nearest_level(cycles, space.h_levels)
    iw = nearest_level(w, space.w_levels)
    lw = space.num_levels[2]
    i32 = lambda x: x.to(torch.int32)
    bits = lambda x: x.contiguous().view(torch.int32)
    pad = torch.zeros_like(ih, dtype=torch.int32)
    rate_rec = torch.stack([bits(o_levels), i32(space.encode(io, 0, 0))],
                           dim=1)
    image_rec = torch.stack(
        [i32(ih * lw + iw), bits(cycles), bits(w), bits(corr_local),
         bits(corr_cloud), bits(d_local)] + [pad] * (IMAGE_FIELDS - 6),
        dim=1)
    return ValueTables(space, o_levels, cycles, phi_hat, sigma, d_local,
                       corr_local, corr_cloud, v_risk, zeta_pen,
                       rate_rec=rate_rec, image_rec=image_rec)


def lower_values_plain(on, img, rates, tables: ValueTables) -> tuple:
    """Plain version of the lower_values kernel (the eager per-element
    lowering): (j int32, o, h, w, correct_local, correct_cloud, d_local
    float32), each of ``img``'s shape."""
    t = tables
    img = img.long()
    o_raw = t.o_levels[rates.long()]
    h_raw = t.cycles[img]
    w_raw = risk_adjusted_gain(t.phi_hat[img], t.sigma[img], t.v_risk)
    w_raw = torch.clamp(w_raw - t.zeta_pen, 0.0, 1.0)
    j = quantize_states_device(t.space, o_raw, h_raw, w_raw, on)
    return (j, o_raw, h_raw, w_raw, t.corr_local[img], t.corr_cloud[img],
            t.d_local[img])


@functools.lru_cache(maxsize=None)
def _lib():
    """The kernel's library (built on first use), with its C signatures."""
    lib = build.load(_SOURCE)
    lib.draws_error_string.argtypes = [_I]
    lib.draws_error_string.restype = ctypes.c_char_p
    lib.lower_values_launch.argtypes = (
        [_VP] * 3 + [_VP, _I, _VP, _I, _LL] + [_VP] * 7 + [_VP])
    lib.lower_values_launch.restype = _I
    return lib


def _check(on, img, rates, tables):
    """Raise unless the call is one the kernel takes."""
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"lower_values_cuda: device must be CUDA, got {dev}")
    for name, x, dt in (("on", on, torch.bool), ("img", img, torch.int32),
                        ("rates", rates, torch.int32)):
        if (x.dtype != dt or x.shape != img.shape or x.device != dev
                or not x.is_contiguous()):
            raise ValueError(
                f"lower_values_cuda: {name} must be a contiguous {dt} "
                f"tensor of shape {tuple(img.shape)} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    R, S = tables.rate_rec.shape[0], tables.image_rec.shape[0]
    for name, x, shape in (("rate_rec", tables.rate_rec, (R, 2)),
                           ("image_rec", tables.image_rec,
                            (S, IMAGE_FIELDS))):
        if (x.dtype != torch.int32 or tuple(x.shape) != shape or R < 1
                or S < 1 or x.device != dev or not x.is_contiguous()):
            raise ValueError(
                f"lower_values_cuda: tables.{name} must be a contiguous "
                f"int32 tensor of shape {shape} on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    for name, x, to in (("on", on, 4), ("img", img, 16),
                        ("rates", rates, 16),
                        ("tables.image_rec", tables.image_rec, 32)):
        if x.data_ptr() % to:
            raise ValueError(f"lower_values_cuda: {name} must start on a "
                             f"{to}-byte boundary")


def lower_values_cuda(on, img, rates, tables: ValueTables) -> tuple:
    """The lower_values kernel on the card: same contract and results as
    ``lower_values_plain``, bit for bit, in one launch on the current
    stream; it uploads nothing and reads nothing back.  An image or rate
    index outside its table (which the draws never give) reads entry 0
    and writes j = -1, which the rollout's range check reports."""
    _check(on, img, rates, tables)
    dev = img.device
    j = torch.empty(img.shape, dtype=torch.int32, device=dev)
    vals = [torch.empty(img.shape, dtype=torch.float32, device=dev)
            for _ in range(6)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = _lib().lower_values_launch(
            _VP(on.data_ptr()), _VP(img.data_ptr()), _VP(rates.data_ptr()),
            _VP(tables.rate_rec.data_ptr()), tables.rate_rec.shape[0],
            _VP(tables.image_rec.data_ptr()), tables.image_rec.shape[0],
            img.numel(), _VP(j.data_ptr()),
            *(_VP(v.data_ptr()) for v in vals), _VP(stream))
    if err != 0:
        msg = _lib().draws_error_string(err).decode()
        raise RuntimeError(f"lower_values launch: CUDA error {err} ({msg})")
    lower_values_cuda.launches += 1
    return (j, *vals)


lower_values_cuda.launches = 0

# name -> wrapper, for the launch counts
KERNELS = {"lower_values": lower_values_cuda}
