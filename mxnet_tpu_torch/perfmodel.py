"""Roofline cost model on the NVIDIA H100.

Counterpart of ``roofline_seconds``, ``speculation_depth`` and
``recommend_request_seconds`` in ``mxnet_tpu/perfmodel.py``, with the
H100's published rates in place of the TPU capability tables. The
decode engine's admission retry-after and drain budgets, the speculative
depth an artifact is exported with, the recommend queue's gather
unit and the DDP gradient bucket size (``group_link_bytes_per_s``) come
from here.
"""
from __future__ import annotations

__all__ = ["H100_HBM_BYTES_PER_S", "H100_F32_FLOPS_PER_S",
           "H100_HOST_LINK_BYTES_PER_S", "group_link_bytes_per_s",
           "roofline_seconds", "speculation_depth",
           "recommend_request_seconds"]

# NVIDIA H100 SXM, published: HBM3 bandwidth and f32 rate outside the
# tensor cores (the port's matmuls run in full f32, TF32 off)
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS_PER_S = 67e12
# NVIDIA H100 SXM datasheet: PCIe Gen5, 128 GB/s in both directions
# together, so 64 GB/s one way. The port's process group is gloo, which
# moves a card tensor through host memory: its bytes cross this link
# (the JAX package sizes its buckets by the TPU's ICI instead). This is
# the link's peak, not the rate a gloo all-reduce reaches: gloo's host
# copies and its loopback transport make that far lower (PERF.md, the
# multi-process rows, has the measured one).
H100_HOST_LINK_BYTES_PER_S = 64e9


def group_link_bytes_per_s():
    """Peak bytes/s of the link the process group's collectives move a
    card's bytes over: the host link (gloo stages through host memory).
    A bound, not what a collective achieves."""
    return H100_HOST_LINK_BYTES_PER_S


def roofline_seconds(flops, bytes_moved):
    """Roofline lower bound on one program run on an H100: the slower of
    the compute term (flops over the f32 rate) and the memory term
    (bytes over the HBM bandwidth)."""
    return max(max(0.0, float(flops)) / H100_F32_FLOPS_PER_S,
               max(0.0, float(bytes_moved)) / H100_HBM_BYTES_PER_S)


def speculation_depth(t_draft, t_verify, max_k=8, acceptance=0.8):
    """Optimal speculation depth for a draft/verify decode pipeline.

    Pure math over two step costs: ``t_draft`` is one draft token-step's
    seconds, ``t_verify`` either a constant verifier cost or a callable
    ``width -> seconds``. Under a geometric acceptance model a step of
    depth k emits ``E[k] = (1 - a^(k+1)) / (1 - a)`` expected tokens and
    costs ``k * t_draft + t_verify(k+1)``; the returned k maximizes the
    rate, breaking exact ties toward the shallower depth, clamped to
    ``[1, max_k]``."""
    a = min(max(float(acceptance), 1e-3), 0.999)
    t_draft = max(float(t_draft), 1e-30)
    tv = t_verify if callable(t_verify) else (
        lambda _w, _c=float(t_verify): _c)
    best_k, best_rate = 1, 0.0
    for kk in range(1, max(1, int(max_k)) + 1):
        expected = (1.0 - a ** (kk + 1)) / (1.0 - a)
        rate = expected / (kk * t_draft + max(float(tv(kk + 1)), 1e-30))
        if rate > best_rate:
            best_k, best_rate = kk, rate
    return best_k


def recommend_request_seconds(gathers, dim, corpus_rows, dtype_bytes=4):
    """Roofline floor of one recommend request, charged by its gather
    count (the unit the recommend admission queue bills in): the
    lookup's bytes (``gathers`` rows of ``dim``) and the corpus scoring
    product (``2 * corpus_rows * dim`` flops)."""
    gathers = max(1, int(gathers))
    lookup_bytes = gathers * int(dim) * int(dtype_bytes)
    score_flops = 2.0 * int(corpus_rows) * int(dim)
    return roofline_seconds(score_flops, lookup_bytes)
