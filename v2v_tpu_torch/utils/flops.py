"""Matmul and convolution FLOP accounting on
torch.utils.flop_counter.FlopCounterMode (port of v2v_tpu/utils/flops.py,
which walks a jaxpr).

Only matmuls and convolutions count, a multiply-add as 2, as the JAX
counter counts dot_general and conv_general_dilated; elementwise work is
left out. The port runs its T recurrent steps as a Python loop, so each
step is counted as it runs (the JAX counter multiplies a scan's body by
its length), and a backward pass counts as the ops autograd runs.

Convolutions follow the JAX package's rule, so that the two packages
count one model alike: a convolution counts 2 x (its output's elements) x
(kernel taps) x (input channels per group). A transposed convolution is
one with a dilated input there (conv_general_dilated with lhs_dilation),
so it counts over its output; torch's own formula counts it over its
input, stride^2 less. A convolution's gradients follow from the same
rule: the weight's counts as the forward, the input's as 2 x (the input's
elements) x taps x (output channels per group). A bilinear upsample
counts as the JAX package's jax.image.resize runs it, a matmul with the
interpolation matrix along each spatial axis (E2VID's upsample convs),
and its gradient as many; ATen's upsample is no matmul, so on the card
this is work the count books, not work the tensor cores do.

FlopCounterMode sees ATen ops only. The port's kernels are ctypes calls
it cannot see: where a CUDA tensor launches one, its work is left out of
the count. K1 (simulate_batch) and K2 do no matmul or convolution, so
nothing is missing for them; K3 (attention, ETNet above 4,096 tokens)
leaves out its two matmuls, 4 x B x heads x Nq x Nk x 32; K4
(dynamic_shift_sum, HyperE2VID) leaves out its 25-offset, M-atom
contraction, 2 x B x H x W x CO x M x 25, and its gradient twice that.
On the CPU every wrapper runs its plain version, whose matmuls count.

    flops = count_flops(model, x)                 # runs model(x) once
    hist = count_flops_by_shape(model, x)         # {op signature: flops}
    flops, out = step_flops(step, batch, g)       # one train step
    entries, out = record_ops(step, batch, g)     # replayable, by call
    args, kwargs = replay_inputs(entries[0], device)
    replay(entries[0], args, kwargs)              # one call of entry 0

`record_ops` keeps, for each distinct call (op, every tensor's shape,
dtype and strides, every other argument: stride, padding, dilation,
groups, transposed, output padding, output mask, sizes), its count and
FLOPs, so that a call can be replayed alone (scripts/roofline_floor.py);
its entries' FLOPs sum to `step_flops`'s count.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode, flop_registry

aten = torch.ops.aten


def _conv_flop(x_shape, w_shape, _bias, _stride, _padding, _dilation,
               transposed, _output_padding, groups, *args, out_shape=None,
               **kwargs) -> int:
    return 2 * math.prod(out_shape) * math.prod(w_shape[2:]) * (
        x_shape[1] // groups)


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias_sizes,
                        _stride, _padding, _dilation, _transposed,
                        _output_padding, groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    taps = math.prod(w_shape[2:])
    flops = 0
    if output_mask[0]:
        flops += 2 * math.prod(x_shape) * taps * (grad_out_shape[1] // groups)
    if output_mask[1]:
        flops += 2 * math.prod(grad_out_shape) * taps * (x_shape[1] // groups)
    return flops


def _resize_flop(x_shape, *args, out_shape=None, **kwargs) -> int:
    """A bilinear resize (N, C, h, w) -> (N, C, H, W) as the JAX package's
    jax.image.resize computes it: a matmul with the interpolation matrix
    along H, then one along W, 2 x N x C x (H x h x w + H x W x w)."""
    n, c, h, w = x_shape
    big_h, big_w = out_shape[2:]
    return 2 * n * c * (big_h * h * w + big_h * big_w * w)


def _resize_backward_flop(grad_out_shape, _output_size, input_size, *args,
                          out_shape=None, **kwargs) -> int:
    """The resize's gradient: the two matmuls transposed, as many FLOPs."""
    return _resize_flop(input_size, out_shape=grad_out_shape)


# FlopCounterMode wraps these into shape formulas (shape_wrapper)
_CONV_RULES = {aten.convolution: _conv_flop, aten._convolution: _conv_flop,
               aten.convolution_backward: _conv_backward_flop,
               aten.upsample_bilinear2d: _resize_flop,
               aten.upsample_bilinear2d_backward: _resize_backward_flop}


def _mapping() -> Dict[Any, Callable]:
    """FlopCounterMode's custom_mapping: the JAX rule for convolutions and
    resizes, torch's formulas otherwise."""
    return dict(_CONV_RULES)


def _run(mapping, fn: Callable, args, kwargs) -> Tuple[float, Any]:
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        out = fn(*args, **kwargs)
    return float(counter.get_total_flops()), out


def count_flops(fn: Callable, *args, **kwargs) -> float:
    """Matmul and convolution FLOPs of one call `fn(*args, **kwargs)`
    (the call runs)."""
    return _run(_mapping(), fn, args, kwargs)[0]


def count_flops_by_shape(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """The FLOPs of one call by op and shapes, `"<op> <operand shapes>->
    <result shapes>"`: which matmul and convolution shapes carry the
    work (record_ops' entries summed by those keys)."""
    hist: Dict[str, float] = defaultdict(float)
    for e in record_ops(fn, *args, **kwargs)[0]:
        ins = "x".join(str(t.shape) for t in e["tensors"][:2])
        hist[f"{e['name']} {ins}->{e['outs']}"] += e["flops"]
    return dict(hist)


def step_flops(step: Callable, *args, **kwargs) -> Tuple[float, Any]:
    """FLOPs of one call of a train step and what the step returned: the
    counted step is a real one (its update applies), so a caller that
    times the step keeps it as its first, untimed step."""
    return _run(_mapping(), step, args, kwargs)


class TensorSpec(NamedTuple):
    """A recorded tensor argument: enough to make one like it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    stride: Tuple[int, ...]


def _spec(a) -> Any:
    if isinstance(a, torch.Tensor):
        return TensorSpec(tuple(a.shape), a.dtype, tuple(a.stride()))
    if isinstance(a, (list, tuple)):
        return tuple(_spec(x) for x in a)
    return a


def _tensor_specs(spec) -> List[TensorSpec]:
    if isinstance(spec, TensorSpec):
        return [spec]
    if isinstance(spec, tuple):
        return [t for x in spec for t in _tensor_specs(x)]
    return []


def record_ops(fn: Callable, *args, **kwargs
               ) -> Tuple[List[Dict[str, Any]], Any]:
    """Every matmul, convolution and booked resize of one call `fn(*args,
    **kwargs)` (the call runs), grouped by everything a replay needs:
    [{"op": the aten op, "name", "args", "kwargs" (tensors as
    TensorSpec), "count", "flops" (the count's total, by the rules
    above), "tensors": the TensorSpecs in order, "outs": the result's
    shape (a tuple of shapes for several)}], largest FLOPs first, and
    what `fn` returned."""
    from torch.utils.flop_counter import shape_wrapper
    formulas = dict(flop_registry)
    formulas.update({k: shape_wrapper(v) for k, v in _CONV_RULES.items()})
    entries: Dict[Any, Dict[str, Any]] = {}
    mapping = {}
    for op, formula in formulas.items():
        def recording(*a, out_val=None, _op=op, _f=formula, **kw):
            n = _f(*a, out_val=out_val, **kw)
            if n:
                sa, skw = _spec(a), tuple(sorted((k, _spec(v))
                                                 for k, v in kw.items()))
                key = (str(_op), sa, skw)
                e = entries.get(key)
                if e is None:
                    outs = [tuple(t.shape)
                            for t in _tensor_specs(_spec(out_val))]
                    e = entries[key] = {
                        "op": _op, "name": getattr(_op, "__name__",
                                                   str(_op)),
                        "args": sa, "kwargs": dict(skw), "count": 0,
                        "flops": 0.0, "tensors": _tensor_specs(sa),
                        "outs": outs[0] if len(outs) == 1 else tuple(outs)}
                e["count"] += 1
                e["flops"] += n
            return n
        recording._get_raw = True
        mapping[op] = recording
    _, out = _run(mapping, fn, args, kwargs)
    return sorted(entries.values(), key=lambda e: -e["flops"]), out


def _make(spec: TensorSpec, device, generator) -> torch.Tensor:
    """A tensor of `spec`'s shape, dtype and strides on `device`, its
    storage filled with unit normals (zeros for an integer dtype)."""
    size = 1 + sum((n - 1) * st for n, st in zip(spec.shape, spec.stride)
                   if n > 0)
    if any(n == 0 for n in spec.shape):
        size = 0
    buf = torch.empty(size, dtype=spec.dtype, device=device)
    if buf.is_floating_point():
        buf.normal_(generator=generator)
    else:
        buf.zero_()
    return buf.as_strided(spec.shape, spec.stride)


def _materialize(spec, device, generator) -> Any:
    if isinstance(spec, TensorSpec):
        return _make(spec, device, generator)
    if isinstance(spec, tuple):           # torch takes any int[] as a list
        return [_materialize(x, device, generator) for x in spec]
    return spec


def replay_inputs(entry: Dict[str, Any], device, generator=None
                  ) -> Tuple[list, dict]:
    """(args, kwargs) for one call of a recorded entry on `device`."""
    return ([_materialize(a, device, generator) for a in entry["args"]],
            {k: _materialize(v, device, generator)
             for k, v in entry["kwargs"].items()})


def replay(entry: Dict[str, Any], args: tuple, kwargs: dict) -> Any:
    """One call of a recorded entry's op on `replay_inputs`' tensors."""
    return entry["op"](*args, **kwargs)
