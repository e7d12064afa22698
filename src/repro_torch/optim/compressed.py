"""int8-compressed cross-replica gradient reduction, a two-phase ring
(PyTorch port of ``repro/optim/compressed.py``).

The reference runs one replica a device inside ``shard_map`` and moves the
chunks with ``ppermute``. Here the K replicas are K tensors held by one
process, on one device or several, and a hop is a copy of the sent chunk
(int8) and its float32 scale to the next replica's device. The hop order,
the chunking and every quantization are the reference's:

  phase 1, reduce-scatter: the tensor is split into K chunks; in each of
  K - 1 hops replica i quantizes its running chunk (i - t) mod K and sends
  it to replica i + 1, which dequantizes it and adds it to its own copy of
  that chunk in float32. Replica i then owns the reduced chunk (i + 1) mod
  K.

  phase 2, all-gather: each replica quantizes its owned chunk once, and
  the int8 chunks circulate for K - 1 hops; every replica dequantizes the
  same bits, so all K results are bit-identical.

The result is divided by K (a mean). ``compressed_reduce`` carries each
replica's own quantization residual into the next step (error feedback).

The arithmetic is the reference's ring as XLA compiles it: the scale's
division by 127 folded into a multiply by the float32 reciprocal of 127,
and each hop's dequantize-and-add ``acc + q * s`` contracted into one
fused multiply-add, rounded once. The port computes that fused form in
float64, where the product of an int8 and a float32 is exact, and rounds
once to float32: the same bits on the card and on the CPU, whichever
contractions their compilers make. Every division is by a tensor on the
operands' device (CUDA divides by a host scalar as a multiply by its
reciprocal, which rounds otherwise).
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, map_tree


def _quantize(xf):
    scale = torch.clamp(xf.abs().max(), min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _fma(acc, q, s):
    """float32 ``acc + q * s`` rounded once, as a fused multiply-add."""
    return (acc.double() + q.double() * s.double()).float()


def _dequantize(q, s, device):
    """A received chunk: its int8 values times its scale, on ``device``."""
    return q.to(device).float() * s.to(device)


def ring_allreduce_int8(xs):
    """Mean-reduce the K tensors ``xs`` (one a replica, all of one shape),
    int8 on the wire. Returns K float32 tensors, bit-identical, each on its
    replica's device."""
    K = len(xs)
    xf = [x.float() for x in xs]
    if K == 1:
        return xf
    shape, n = xf[0].shape, xf[0].numel()
    pad = (-n) % K
    acc = [torch.cat([x.reshape(-1), x.new_zeros(pad)]).reshape(K, -1)
           for x in xf]

    # ---- phase 1: reduce-scatter ----------------------------------------
    for t in range(K - 1):
        sent = [_quantize(acc[i][(i - t) % K]) for i in range(K)]
        for i in range(K):
            q, s = sent[(i - 1) % K]
            j = (i - t - 1) % K
            acc[i][j] = _fma(acc[i][j], q.to(acc[i].device),
                             s.to(acc[i].device))

    # ---- phase 2: all-gather (the same int8 bits everywhere) ------------
    held = [_quantize(acc[i][(i + 1) % K]) for i in range(K)]
    out = [torch.zeros_like(a) for a in acc]
    for i, (q, s) in enumerate(held):
        out[i][(i + 1) % K] = _dequantize(q, s, out[i].device)
    for t in range(K - 1):
        held = [held[(i - 1) % K] for i in range(K)]
        for i, (q, s) in enumerate(held):
            out[i][(i - t) % K] = _dequantize(q, s, out[i].device)
    return [o.reshape(-1)[:n].reshape(shape)
            / torch.full((), float(K), device=o.device) for o in out]


def init_error_feedback(grads):
    """Zero residuals of ``grads``' shapes (one replica's tree), float32."""
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def compressed_reduce(grads, err):
    """Error-feedback compressed reduce over K replicas: ``grads`` and
    ``err`` are K trees each (one a replica; ``err`` from the previous step
    or ``init_error_feedback``). Returns (values, new_err), K trees each:
    every leaf ring-reduced from ``g + err``, and each replica's residual
    of quantizing its own ``g + err``."""
    gin = [map_tree(lambda g, e: g.float() + e, g, e)
           for g, e in zip(grads, err)]
    by_leaf = zip(*(leaves(t) for t in gin))
    reduced = list(zip(*(ring_allreduce_int8(list(xs)) for xs in by_leaf)))

    def residual(x):
        q, s = _quantize(x)
        return x - q.float() * s

    values = []
    for tree, vals in zip(gin, reduced):
        it = iter(vals)
        values.append(map_tree(lambda _: next(it), tree))
    return values, [map_tree(residual, t) for t in gin]
