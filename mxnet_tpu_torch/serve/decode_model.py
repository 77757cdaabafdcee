"""The GPT-block decoder family behind the continuous-batching engine.

Counterpart of ``mxnet_tpu/serve/decode_model.py``. Plain torch
functions over ONE weight set (the gluon GPT of
``examples/train_transformer_lm.py``: token and position embeddings,
pre-LN blocks of causal attention and a ReLU MLP, a separate head):

* ``make_prefill`` - dense causal forward over a padded ``(b, P)``
  prompt batch; the first sampled token plus every layer's K/V rows.
  Its attention is the tier's ``flash_attn``.
* ``make_decode`` - ONE token for every slot at once: writes the step's
  K/V row into the paged cache IN PLACE, attends each slot's pages
  through the block table (``flash_attn_paged``, or the ``take_rows``
  gather and a dense softmax when the tier declines) and samples.
* ``make_commit`` - copies a prefilled prompt's K/V rows into its pages.
* ``make_chunk_prefill`` - one fixed-shape chunk of a long prompt
  straight into the paged cache (``flash_attn_paged`` with W = P), over
  f32 weights or their int8 twin (``quantize_decoder_params``).
* ``make_draft_verify`` - one speculative step: k int8 draft token-steps
  over the draft cache (``flash_attn_paged`` with W = 1), one f32
  verifier pass over the (k+1)-token window (W = k+1) and the
  acceptance rule, returning one packed int32 array.

Each ``make_*`` returns a function on tensors (numpy arrays are taken
too, and copied to the weights' device), closed over the weights it was
given, which must already lie on one device. The kernel tier in force
when a function is made is the one it runs under, whatever thread calls
it (the counterpart of the JAX package resolving the tier at export).
The cache tensors ``(L, R, C)`` are updated in place with
``index_copy_`` (the JAX package's donated buffers); no call allocates
a new cache. Inactive slots and padding rows all write row 0 of the
scratch page 0, which no live sequence reads.

Sampling is bitwise JAX's: the key is ``fold_in(fold_in(PRNGKey(0),
seed), position)`` (:mod:`._threefry`), so a request's tokens depend on
neither its slot nor its batchmates. ``temp <= 0`` is greedy argmax.
When the temperatures arrive as a host (numpy) array, only the rows that
sample draw random numbers; nothing here reads a device value back.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as _np
import torch

from ..base import MXNetError
from ..config import override
from ..context import resolve_device
from ..kernels import attention as _attn
from ..kernels import take as _take
from ..kernels import tier as _tier
from ..ops.quant_serve import _ALIGN, _int8_matmul
from .. import perfmodel as _perfmodel
from . import _threefry

__all__ = ["DecoderSpec", "init_params", "params_from_reference",
           "quantize_decoder_params", "make_prefill", "make_decode",
           "make_commit", "make_chunk_prefill", "make_draft_verify",
           "suggest_speculation_depth", "reference_generate"]

_LN_EPS = 1e-5   # gluon nn.LayerNorm default
_NEG_INF = -1e30


class DecoderSpec(NamedTuple):
    """Static geometry of a generate artifact: model dims + cache layout.

    ``num_pages`` INCLUDES the reserved scratch page 0 (never allocated;
    inactive slots and overflow rows write there). A sequence may span at
    most ``max_pages_per_slot`` pages, so its context is capped at
    ``max_context = page_size * max_pages_per_slot`` tokens (prompt +
    generated).
    """

    vocab: int
    dim: int
    num_heads: int
    num_layers: int
    max_prompt_len: int        # P: prefill pad length (prompt capacity)
    page_size: int             # tokens per KV page
    max_pages_per_slot: int    # block-table width per slot
    max_slots: int             # decode step capacity [max_slots, 1]
    num_pages: int             # total pages in the cache, incl. scratch 0
    eos_id: int = -1           # host-side stop token; -1 = none

    @property
    def head_dim(self):
        return self.dim // self.num_heads

    @property
    def max_context(self):
        return self.page_size * self.max_pages_per_slot

    @property
    def prompt_pages(self):
        """Width of commit's page-id vector: pages covering a full prompt."""
        return -(-self.max_prompt_len // self.page_size)

    @property
    def cache_rows(self):
        """KV rows per layer: every page's tokens, flat."""
        return self.num_pages * self.page_size

    def validate(self):
        if self.dim % self.num_heads:
            raise MXNetError("DecoderSpec: dim %d not divisible by "
                             "num_heads %d" % (self.dim, self.num_heads))
        if self.max_prompt_len > self.max_context:
            raise MXNetError(
                "DecoderSpec: max_prompt_len %d exceeds max_context %d "
                "(page_size * max_pages_per_slot)"
                % (self.max_prompt_len, self.max_context))
        if self.num_pages < 2:
            raise MXNetError("DecoderSpec: num_pages must be >= 2 (page 0 "
                             "is the reserved scratch page)")
        return self

    def cache_bytes(self, dtype_bytes=4):
        """Device footprint of the paged K+V cache (both tensors)."""
        return 2 * self.num_layers * self.cache_rows * self.dim * dtype_bytes


# -- parameters -------------------------------------------------------------

def _param_names(spec):
    names = ["tok_w", "pos_w"]
    for i in range(spec.num_layers):
        names += ["l%d_ln1_g" % i, "l%d_ln1_b" % i,
                  "l%d_qkv_w" % i, "l%d_qkv_b" % i,
                  "l%d_proj_w" % i, "l%d_proj_b" % i,
                  "l%d_ln2_g" % i, "l%d_ln2_b" % i,
                  "l%d_mlp1_w" % i, "l%d_mlp1_b" % i,
                  "l%d_mlp2_w" % i, "l%d_mlp2_b" % i]
    return names + ["lnf_g", "lnf_b", "head_w", "head_b"]


def _param_shapes(spec):
    C, V = spec.dim, spec.vocab
    per_layer = {"ln1_g": (C,), "ln1_b": (C,), "qkv_w": (3 * C, C),
                 "qkv_b": (3 * C,), "proj_w": (C, C), "proj_b": (C,),
                 "ln2_g": (C,), "ln2_b": (C,), "mlp1_w": (4 * C, C),
                 "mlp1_b": (4 * C,), "mlp2_w": (C, 4 * C), "mlp2_b": (C,)}
    shapes = {"tok_w": (V, C), "pos_w": (spec.max_context, C),
              "lnf_g": (C,), "lnf_b": (C,), "head_w": (V, C),
              "head_b": (V,)}
    for i in range(spec.num_layers):
        for k, s in per_layer.items():
            shapes["l%d_%s" % (i, k)] = s
    return shapes


def init_params(spec, seed=0):
    """Random f32 numpy parameters, the JAX package's draw exactly
    (``RandomState(seed).normal(0, 0.02)`` in the same order; gluon Dense
    convention: W is (out, in), the forward computes ``x @ W.T + b``)."""
    spec.validate()
    rng = _np.random.RandomState(seed)
    C, V = spec.dim, spec.vocab

    def n(*shape):
        return rng.normal(0.0, 0.02, shape).astype(_np.float32)

    p = {"tok_w": n(V, C), "pos_w": n(spec.max_context, C)}
    for i in range(spec.num_layers):
        p["l%d_ln1_g" % i] = _np.ones(C, _np.float32)
        p["l%d_ln1_b" % i] = _np.zeros(C, _np.float32)
        p["l%d_qkv_w" % i] = n(3 * C, C)
        p["l%d_qkv_b" % i] = _np.zeros(3 * C, _np.float32)
        p["l%d_proj_w" % i] = n(C, C)
        p["l%d_proj_b" % i] = _np.zeros(C, _np.float32)
        p["l%d_ln2_g" % i] = _np.ones(C, _np.float32)
        p["l%d_ln2_b" % i] = _np.zeros(C, _np.float32)
        p["l%d_mlp1_w" % i] = n(4 * C, C)
        p["l%d_mlp1_b" % i] = _np.zeros(4 * C, _np.float32)
        p["l%d_mlp2_w" % i] = n(C, 4 * C)
        p["l%d_mlp2_b" % i] = _np.zeros(C, _np.float32)
    p["lnf_g"] = _np.ones(C, _np.float32)
    p["lnf_b"] = _np.zeros(C, _np.float32)
    p["head_w"] = n(V, C)
    p["head_b"] = _np.zeros(V, _np.float32)
    return p


# Dense weights eligible for int8 draft quantization. Embeddings,
# LayerNorms and biases stay f32: they are a small fraction of the bytes
# and the per-row math (LN, sampling keys) must stay the f32 reference's
# so the acceptance rule compares like with like.
_QUANT_SUFFIXES = ("qkv_w", "proj_w", "mlp1_w", "mlp2_w")


def _quantizable(name):
    return name.endswith(_QUANT_SUFFIXES) or name == "head_w"


def _expected(params, spec):
    """{name: (shape, dtype)} in parameter order: every quantizable
    weight the dict gives as ``<w>_q`` is expected as int8 ``<w>_q``
    and its f32 per-output-channel ``<w>_deq``; everything else f32."""
    want = {}
    shapes = _param_shapes(spec)
    for name in _param_names(spec):
        shape = shapes[name]
        if _quantizable(name) and name + "_q" in params:
            want[name + "_q"] = (shape, torch.int8)
            want[name + "_deq"] = (shape[:1], torch.float32)
        else:
            want[name] = (shape, torch.float32)
    return want


def params_from_reference(params, spec, device=None):
    """The JAX package's decoder parameters (numpy arrays, names
    unchanged) as tensors on ``device`` (default cuda:0): f32 weights,
    or a :func:`quantize_decoder_params` dict (int8 ``<w>_q``, f32
    ``<w>_deq``). Every name, shape and int8 dtype is checked against
    the spec."""
    dev = resolve_device(device)
    spec.validate()
    want = _expected(params, spec)
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise MXNetError("decoder parameters do not match the spec:%s%s"
                         % (" missing %s" % missing if missing else "",
                            " unexpected %s" % extra if extra else ""))
    out = {}
    for name, (shape, dtype) in want.items():
        v = params[name]
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.from_numpy(_np.ascontiguousarray(v)))
        if tuple(t.shape) != shape:
            raise MXNetError("decoder parameter %r has shape %s, the spec "
                             "needs %s" % (name, tuple(t.shape), shape))
        if dtype == torch.int8 and t.dtype != torch.int8:
            raise MXNetError("decoder parameter %r is %s, not int8"
                             % (name, t.dtype))
        out[name] = t.to(device=dev, dtype=dtype).contiguous()
    return out


def quantize_decoder_params(params, eps=1e-8):
    """Per-output-channel symmetric int8 quantization of the decoder's
    dense weights (gluon layout: W is (out, in), quantized along rows),
    numpy in and out, bitwise the JAX package's.

    Every eligible ``<name>`` becomes ``<name>_q`` (int8, same shape)
    and ``<name>_deq`` (f32 (out,), the dequant scale 1/wsc); everything
    else passes through. The dict drives the int8 DRAFT model of
    :func:`make_draft_verify`: the same architecture over a quarter of
    the weight bytes."""
    out = {}
    for name, w in params.items():
        if _quantizable(name):
            w = _np.asarray(w, _np.float32)
            amax = _np.maximum(_np.abs(w).max(axis=1), eps)
            wsc = (127.0 / amax).astype(_np.float32)       # (out,)
            wq = _np.clip(_np.round(w * wsc[:, None]), -127, 127)
            out[name + "_q"] = wq.astype(_np.int8)
            out[name + "_deq"] = (1.0 / wsc).astype(_np.float32)
        else:
            out[name] = _np.asarray(w)
    return out


def _int8_aligned(p):
    """``p`` with every int8 weight's rows (the product's N) padded with
    zeros to a multiple of 8, as ``torch._int_mm`` takes them: done once
    per weight set, not on every product (``_dense_int8`` slices the
    padded columns off). Aligned tensors come back as they are."""
    out = dict(p)
    for name, t in p.items():
        if name.endswith("_q") and t.shape[0] % _ALIGN:
            pad = t.new_zeros((-t.shape[0] % _ALIGN,) + tuple(t.shape[1:]))
            out[name] = torch.cat([t, pad])
    return out


def _weights(params):
    """The weight dict a ``make_*`` closes over, int8 weights aligned,
    and its device."""
    dev = params["tok_w"].device
    if any(not isinstance(v, torch.Tensor) or v.device != dev
           for v in params.values()):
        raise MXNetError("make_*: parameters must be tensors on one device "
                         "(see params_from_reference)")
    return _int8_aligned(params), dev


# -- shared layer math ------------------------------------------------------

def _ln(x, g, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * g + b


def _dense(x, w, b):
    # gluon FullyConnected convention: w is (out, in)
    return x @ w.T + b


def _dense_int8(x, wq, deq, b):
    """int8 dense with PER-ROW dynamic activation quantization: each row
    of ``x`` is scaled on its own (its max magnitude -> 127, rounded half
    to even, clipped to +-127), the product accumulates in int32
    (``torch._int_mm`` behind the port's padding helper; ``wq`` may
    carry zero rows past ``deq``'s length), and the epilogue folds both
    scales back in f32, outside any kernel as in the JAX package. Rows
    stay independent: a slot's math never depends on its batchmates."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    ascale = 127.0 / amax.clamp_min(1e-8)
    xq = torch.round(x * ascale).clamp_(-127, 127).to(torch.int8)
    n = deq.shape[0]
    acc = _int8_matmul(xq, wq)[:, :n].reshape(*x.shape[:-1], n)
    return acc.float() * (deq / ascale) + b


def _dense_p(p, x, w, b):
    """Dense through whichever precision the weight dict carries:
    ``<w>_q``/``<w>_deq`` (a :func:`quantize_decoder_params` dict) takes
    the int8 path, plain ``<w>`` the f32 one."""
    if (w + "_q") in p:
        return _dense_int8(x, p[w + "_q"], p[w + "_deq"], p[b])
    return _dense(x, p[w], p[b])


def _mlp(h, p, i):
    x = _ln(h, p["l%d_ln2_g" % i], p["l%d_ln2_b" % i])
    x = torch.relu(_dense_p(p, x, "l%d_mlp1_w" % i, "l%d_mlp1_b" % i))
    return h + _dense_p(p, x, "l%d_mlp2_w" % i, "l%d_mlp2_b" % i)


def _as(x, dtype, dev):
    """A numpy array, number or tensor as a tensor of ``dtype`` on
    ``dev`` (a host-to-device copy at most; never a device read)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(_np.asarray(x), dtype=dtype, device=dev)


def _host(x):
    """The host copy of ``x`` when it already is one (numpy, a number or
    a CPU tensor), else None: a CUDA tensor is never read back."""
    if isinstance(x, torch.Tensor):
        return x.numpy() if x.device.type == "cpu" else None
    return _np.asarray(x)


def _sample(logits, temps, seeds, counters, host_temps=None):
    """Per-row sampling. The key is a pure function of the request's
    seed and the POSITION the sampled token will occupy; temp <= 0
    selects greedy argmax. With ``host_temps`` (numpy), only rows with a
    positive temperature draw; without, every row draws and the result
    is selected on the device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    key0 = _threefry.prng_key(0, device=logits.device)
    if host_temps is not None:
        rows = _np.nonzero(_np.asarray(host_temps).reshape(-1) > 0)[0]
        if rows.size == 0:
            return greedy
        sel = torch.as_tensor(rows, device=logits.device)
        key = _threefry.fold_in(_threefry.fold_in(key0, seeds[sel]),
                                counters[sel])
        lg = logits[sel] / temps[sel].clamp_min(1e-6)[:, None]
        out = greedy.clone()
        out[sel] = _threefry.categorical(key, lg).to(torch.int32)
        return out
    key = _threefry.fold_in(_threefry.fold_in(key0, seeds), counters)
    drawn = _threefry.categorical(key, logits / temps.clamp_min(1e-6)[:,
                                                                      None])
    return torch.where(temps > 0, drawn.to(torch.int32), greedy)


def _under_tier(fn):
    """``fn`` run under the kernel tier in force now, from any thread."""
    tier_now = _tier.tier()

    def run(*args, **kw):
        with override(kernel_tier=tier_now), torch.inference_mode():
            return fn(*args, **kw)

    return run


# -- prefill ----------------------------------------------------------------

def _dense_attend(qh, kh, vh):
    """Tier-dispatched dense causal attention for prefill: (b, T, H, Dh)
    in, same layout out, or None on fallback. Prefill's ``causal &
    valid`` mask equals plain causal on every row a consumer reads (row
    ``r < length`` attends columns ``<= r``, all valid; rows ``>=
    length`` are garbage but unread: commit scratches their K/V and
    sampling reads row ``length-1``), so the kernel serves the site with
    its causal mask alone."""
    o = _attn.attend_or_none(qh.transpose(1, 2), kh.transpose(1, 2),
                             vh.transpose(1, 2), causal=True)
    return None if o is None else o.transpose(1, 2)


def make_prefill(params, spec):
    """Dense causal forward over a right-padded prompt batch.

    (tokens[b,P] i32, lengths[b] i32, temps[b] f32, seeds[b] i32) ->
    (first_token[b] i32, k[b,L,P,C] f32, v[b,L,P,C] f32)
    """
    spec.validate()
    P, C, H = spec.max_prompt_len, spec.dim, spec.num_heads
    Dh, L, V = spec.head_dim, spec.num_layers, spec.vocab
    scale = 1.0 / math.sqrt(Dh)
    p, dev = _weights(params)
    pos = torch.arange(P, device=dev)
    causal = pos[None, :] <= pos[:, None]                        # (P, P)

    def prefill(tokens, lengths, temps, seeds):
        host_temps = _host(temps)
        tokens = _as(tokens, torch.int64, dev)
        lengths = _as(lengths, torch.int64, dev)
        temps = _as(temps, torch.float32, dev)
        seeds = _as(seeds, torch.int64, dev)
        b = tokens.shape[0]
        tok = tokens.clamp(0, V - 1)
        h = p["tok_w"][tok] + p["pos_w"][:P][None]
        ks, vs = [], []
        mask = None
        for i in range(L):
            x = _ln(h, p["l%d_ln1_g" % i], p["l%d_ln1_b" % i])
            qkv = _dense(x, p["l%d_qkv_w" % i], p["l%d_qkv_b" % i])
            q, k, v = qkv.split(C, dim=-1)
            ks.append(k)
            vs.append(v)
            qh = q.reshape(b, P, H, Dh)
            kh = k.reshape(b, P, H, Dh)
            vh = v.reshape(b, P, H, Dh)
            oh = _dense_attend(qh, kh, vh)
            if oh is None:
                if mask is None:
                    valid = pos[None, None, :] < lengths[:, None, None]
                    mask = causal[None] & valid                  # (b,P,P)
                s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
                s = torch.where(mask[:, None], s,
                                torch.full((), _NEG_INF, device=dev))
                w = torch.softmax(s, dim=-1)
                oh = torch.einsum("bhqk,bkhd->bqhd", w, vh)
            o = oh.reshape(b, P, C)
            h = h + _dense(o, p["l%d_proj_w" % i], p["l%d_proj_b" % i])
            h = _mlp(h, p, i)
        hf = _ln(h, p["lnf_g"], p["lnf_b"])
        last = hf[torch.arange(b, device=dev), (lengths - 1).clamp(0, P - 1)]
        logits = _dense(last, p["head_w"], p["head_b"])
        # the sampled token will sit at position `length`
        nxt = _sample(logits, temps, seeds, lengths, host_temps)
        return nxt, torch.stack(ks, dim=1), torch.stack(vs, dim=1)

    return _under_tier(prefill)


# -- decode -----------------------------------------------------------------

def _context_rows(bt, page):
    """(S, MP) block table -> (S, MP * page) flat cache rows."""
    offs = torch.arange(page, device=bt.device)
    return (bt[..., :, None] * page + offs).reshape(*bt.shape[:-1], -1)


def _attend_pages(q, k_tbl, v_tbl, bt32, pos32, qpos, *, heads, page_size):
    """Attention of (S, W, C) queries over one layer's paged cache
    through the block table: row ``w`` of slot ``s`` sits at position
    ``qpos[s, w]`` (``pos32[s] + w``) and sees positions ``<=`` its own.
    The tier's ``flash_attn_paged`` kernel, or, where the tier or its
    guard declines (the reason is then in ``tier.stats()['fallback']``),
    the context gathered through ``take_rows`` and a masked softmax."""
    o = _attn.paged_attend_or_none(q, k_tbl, v_tbl, bt32, pos32,
                                   heads=heads, page_size=page_size)
    if o is not None:
        return o
    S, W, C = q.shape
    Dh = C // heads
    ctx_idx = _context_rows(bt32.long(), page_size)               # (S, ctx)
    ctx = ctx_idx.shape[1]
    kh = _take.gather_pages(k_tbl, ctx_idx).reshape(S, ctx, heads, Dh)
    vh = _take.gather_pages(v_tbl, ctx_idx).reshape(S, ctx, heads, Dh)
    s = torch.einsum("swhd,sthd->shwt", q.reshape(S, W, heads, Dh),
                     kh) * (1.0 / math.sqrt(Dh))
    tpos = torch.arange(ctx, device=q.device)
    att = tpos[None, None, :] <= qpos[:, :, None]                 # (S, W, ctx)
    s = torch.where(att[:, None], s, torch.full((), _NEG_INF,
                                                device=q.device))
    a = torch.softmax(s, dim=-1)
    return torch.einsum("shwt,sthd->swhd", a, vh).reshape(S, W, C)


def make_decode(params, spec):
    """One decode step for every slot: write this token's K/V row into
    the paged cache IN PLACE, attend each slot's pages through its block
    table, sample.

    (tokens[S,1] i32, positions[S] i32, block_tables[S,MP] i32,
     temps[S] f32, seeds[S] i32, k_pages[L,R,C] f32, v_pages[L,R,C] f32)
    -> (next_token[S] i32, k_pages, v_pages), the caches the same
    tensors, updated.

    Inactive slots carry position 0 and an all-zeros block-table row, so
    their writes land in scratch page 0 and their sampled token is
    garbage the host scheduler ignores.
    """
    spec.validate()
    S, MP, page = spec.max_slots, spec.max_pages_per_slot, spec.page_size
    C, H, L, V = spec.dim, spec.num_heads, spec.num_layers, spec.vocab
    ctx = spec.max_context
    p, dev = _weights(params)
    slots = torch.arange(S, device=dev)

    def decode(tokens, positions, block_tables, temps, seeds, k_pages,
               v_pages):
        host_temps = _host(temps)
        t = _as(tokens, torch.int64, dev)[:, 0].clamp(0, V - 1)
        pos32 = _as(positions, torch.int32, dev)
        bt32 = _as(block_tables, torch.int32, dev)
        temps = _as(temps, torch.float32, dev)
        seeds = _as(seeds, torch.int64, dev)
        positions, bt = pos32.long(), bt32.long()
        h = p["tok_w"][t] + p["pos_w"][positions.clamp(0, ctx - 1)]
        # flat cache row this token writes: its page * page_size + offset
        write_idx = (bt[slots, (positions // page).clamp(0, MP - 1)] * page
                     + positions % page)                          # (S,)
        for i in range(L):
            x = _ln(h, p["l%d_ln1_g" % i], p["l%d_ln1_b" % i])
            qkv = _dense(x, p["l%d_qkv_w" % i], p["l%d_qkv_b" % i])
            q, k, v = qkv.split(C, dim=-1)                        # (S, C)
            k_pages[i].index_copy_(0, write_idx, k)
            v_pages[i].index_copy_(0, write_idx, v)
            o = _attend_pages(q[:, None, :], k_pages[i], v_pages[i], bt32,
                              pos32, positions[:, None], heads=H,
                              page_size=page)[:, 0, :]            # (S, C)
            h = h + _dense(o, p["l%d_proj_w" % i], p["l%d_proj_b" % i])
            h = _mlp(h, p, i)
        logits = _dense(_ln(h, p["lnf_g"], p["lnf_b"]),
                        p["head_w"], p["head_b"])
        nxt = _sample(logits, temps, seeds, positions + 1, host_temps)
        return nxt, k_pages, v_pages

    return _under_tier(decode)


# -- commit (prompt KV -> pages) -------------------------------------------

def make_commit(spec):
    """Copy one prefilled prompt's K/V rows into its pages, in place.

    (k_pages[L,R,C], v_pages[L,R,C], k_new[L,P,C], v_new[L,P,C],
     page_ids[prompt_pages] i32, n_rows () i32) -> (k_pages, v_pages)

    Rows >= n_rows (prompt padding) are routed to scratch page 0.
    """
    spec.validate()
    P, page = spec.max_prompt_len, spec.page_size

    def commit(k_pages, v_pages, k_new, v_new, page_ids, n_rows):
        dev = k_pages.device
        i = torch.arange(P, device=dev)
        ids = _as(page_ids, torch.int64, dev)
        rows = ids[i // page] * page + i % page
        rows = torch.where(i < _as(n_rows, torch.int64, dev), rows,
                           torch.zeros((), dtype=torch.int64, device=dev))
        k_pages.index_copy_(1, rows, k_new.to(dev))
        v_pages.index_copy_(1, rows, v_new.to(dev))
        return k_pages, v_pages

    return _under_tier(commit)


# -- chunked prefill (long prompts through the paged cache) -----------------

def make_chunk_prefill(params, spec, logits=False):
    """One fixed-shape prompt CHUNK for a single sequence: write the
    chunk's K/V rows straight into the sequence's pages, attend over
    everything committed so far (earlier chunks included, through the
    block table), and sample the token that follows the prompt.

    (tokens[P] i32, start () i32, n () i32, block_table[MP] i32,
     temp () f32, seed () i32, k_pages[L,R,C] f32, v_pages[L,R,C] f32)
    -> (next_token () i32, k_pages, v_pages)

    ``start``, ``n``, ``temp`` and ``seed`` are host scalars. The chunk
    covers positions ``start .. start+P-1``; rows at chunk offsets >=
    ``n`` (padding) and any position >= ``max_context`` are routed to
    scratch page 0. ``next_token`` is sampled at position ``start + n``
    from query row ``n - 1``; only the final chunk's token means
    anything. With ``logits=True`` the function returns the ``(P, V)``
    logits of every chunk row in place of the token: a teacher-forced
    replay of a sequence through the paged path.

    ``params`` are f32 weights or a :func:`quantize_decoder_params`
    dict: a speculative session fills its draft cache with the int8
    variant of this same function, so the draft's prompt K/V rows are
    the ones its decode steps would have written.
    """
    spec.validate()
    P, MP, page = spec.max_prompt_len, spec.max_pages_per_slot, spec.page_size
    C, H, L, V = spec.dim, spec.num_heads, spec.num_layers, spec.vocab
    ctx = spec.max_context
    p, dev = _weights(params)
    rows_p = torch.arange(P, device=dev)

    def chunk_prefill(tokens, start, n, block_table, temp, seed, k_pages,
                      v_pages):
        start, n = int(start), int(n)
        tok = _as(tokens, torch.int64, dev).clamp(0, V - 1)
        bt32 = _as(block_table, torch.int32, dev)
        pos = start + rows_p                                      # (P,)
        h = p["tok_w"][tok] + p["pos_w"][pos.clamp(0, ctx - 1)]
        widx = bt32.long()[(pos // page).clamp(0, MP - 1)] * page + pos % page
        widx = torch.where((rows_p < n) & (pos < ctx), widx,
                           torch.zeros((), dtype=torch.int64, device=dev))
        start_t = torch.full((1,), start, dtype=torch.int32, device=dev)
        for i in range(L):
            x = _ln(h, p["l%d_ln1_g" % i], p["l%d_ln1_b" % i])
            qkv = _dense_p(p, x, "l%d_qkv_w" % i, "l%d_qkv_b" % i)
            q, k, v = qkv.split(C, dim=-1)                        # (P, C)
            k_pages[i].index_copy_(0, widx, k)
            v_pages[i].index_copy_(0, widx, v)
            o = _attend_pages(q[None], k_pages[i], v_pages[i], bt32[None],
                              start_t, pos[None], heads=H,
                              page_size=page)[0]                  # (P, C)
            h = h + _dense_p(p, o, "l%d_proj_w" % i, "l%d_proj_b" % i)
            h = _mlp(h, p, i)
        hf = _ln(h, p["lnf_g"], p["lnf_b"])
        if logits:
            return _dense_p(p, hf, "head_w", "head_b"), k_pages, v_pages
        last = hf[min(max(n - 1, 0), P - 1)]
        lg = _dense_p(p, last[None], "head_w", "head_b")
        host_temps = _np.asarray([float(temp)], _np.float32)
        nxt = _sample(lg, torch.tensor(host_temps, device=dev),
                      torch.tensor([int(seed)], device=dev),
                      torch.tensor([start + n], device=dev), host_temps)[0]
        return nxt, k_pages, v_pages

    return _under_tier(chunk_prefill)


# -- speculative decode (int8 draft + f32 verify, one call) -----------------

def make_draft_verify(params, draft_params, spec, k, logits=False):
    """One SPECULATIVE step for every slot: ``k`` sequential int8 draft
    token-steps over the draft KV cache, ONE f32 verifier pass over the
    (k+1)-token window, and the acceptance rule; its only result the
    host reads is one packed int32 array.

    (tokens[S,1] i32, positions[S] i32, block_tables[S,MP] i32,
     temps[S] f32, seeds[S] i32,
     k_pages[L,R,C] f32, v_pages[L,R,C] f32,          # verifier cache
     dk_pages[L,R,C] f32, dv_pages[L,R,C] f32)        # draft cache
    -> (packed[S, k+2] i32, k_pages, v_pages, dk_pages, dv_pages)

    ``packed[s] = [n_accept, v_1, ..., v_{k+1}]``: ``v_j`` is the
    VERIFIER's position-keyed sample for position ``pos+j`` and
    ``n_accept`` counts the draft proposals that equal it from the left
    (``cumprod`` of the matches). The emitted tokens are ``v_1 ..
    v_{n_accept+1}``. The sampling key is a pure function of (seed,
    position), exactly :func:`_sample`'s, so the verifier's sample at a
    position IS the token plain decode would emit there, at any
    temperature: the draft only decides how many positions a step
    advances.

    Cache discipline: the draft writes rows pos..pos+k-1 of the draft
    cache, the verifier rows pos..pos+k of its own. There is no
    rollback: rejected rows are overwritten by the next step's window
    (it starts at pos + n_accept + 1 <= pos + k + 1) before any query
    attends to them, and the position mask hides whatever a query could
    see past its own position. Writes past ``max_context`` go to scratch
    page 0. All four caches are updated in place.

    With ``logits=True`` the function returns ``(packed, proposals[S,k]
    i32, draft_logits[S,k,V], verify_logits[S,k+1,V])`` in place of the
    caches (still updated in place): the draft's and the verifier's
    logits behind every sample.
    """
    spec.validate()
    if not 1 <= k <= spec.max_prompt_len:
        raise MXNetError("make_draft_verify: speculation depth %d outside "
                         "[1, max_prompt_len=%d]" % (k, spec.max_prompt_len))
    S, MP, page = spec.max_slots, spec.max_pages_per_slot, spec.page_size
    C, H, L, V = spec.dim, spec.num_heads, spec.num_layers, spec.vocab
    ctx = spec.max_context
    W = k + 1
    p, dev = _weights(params)
    dp, ddev = _weights(draft_params)
    if ddev != dev:
        raise MXNetError("make_draft_verify: draft weights on %s, verifier "
                         "weights on %s" % (ddev, dev))
    slots = torch.arange(S, device=dev)
    wrange = torch.arange(W, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def draft_step(cur, dpos, bt, bt32, temps, seeds, host_temps, dk, dv):
        """One int8 single-token step over the draft cache: the proposal
        sampled at position dpos+1, and its logits."""
        h = dp["tok_w"][cur.clamp(0, V - 1)] + dp["pos_w"][dpos.clamp(
            0, ctx - 1)]
        widx = bt[slots, (dpos // page).clamp(0, MP - 1)] * page + dpos % page
        widx = torch.where(dpos < ctx, widx, zero)
        dpos32 = dpos.to(torch.int32)
        for i in range(L):
            x = _ln(h, dp["l%d_ln1_g" % i], dp["l%d_ln1_b" % i])
            qkv = _dense_p(dp, x, "l%d_qkv_w" % i, "l%d_qkv_b" % i)
            q, kk, vv = qkv.split(C, dim=-1)                      # (S, C)
            dk[i].index_copy_(0, widx, kk)
            dv[i].index_copy_(0, widx, vv)
            o = _attend_pages(q[:, None, :], dk[i], dv[i], bt32, dpos32,
                              dpos[:, None], heads=H,
                              page_size=page)[:, 0, :]            # (S, C)
            h = h + _dense_p(dp, o, "l%d_proj_w" % i, "l%d_proj_b" % i)
            h = _mlp(h, dp, i)
        lg = _dense_p(dp, _ln(h, dp["lnf_g"], dp["lnf_b"]), "head_w",
                      "head_b")
        return _sample(lg, temps, seeds, dpos + 1, host_temps), lg

    def draft_verify(tokens, positions, block_tables, temps, seeds,
                     k_pages, v_pages, dk_pages, dv_pages):
        host_temps = _host(temps)
        cur = _as(tokens, torch.int64, dev)[:, 0]
        pos32 = _as(positions, torch.int32, dev)
        bt32 = _as(block_tables, torch.int32, dev)
        temps = _as(temps, torch.float32, dev)
        seeds = _as(seeds, torch.int64, dev)
        positions, bt = pos32.long(), bt32.long()

        # -- k int8 draft steps (sequential by construction) -------------
        props, dlogits = [], []
        tok = cur
        for j in range(k):
            prop, lg = draft_step(tok, positions + j, bt, bt32, temps, seeds,
                                  host_temps, dk_pages, dv_pages)
            props.append(prop)
            dlogits.append(lg)
            tok = prop.long()
        props = torch.stack(props, dim=1)                         # (S, k)

        # -- one f32 verifier pass over the (k+1)-token window -----------
        win = torch.cat([cur[:, None], props.long()], dim=1)      # (S, W)
        wpos = positions[:, None] + wrange[None, :]               # (S, W)
        h = p["tok_w"][win.clamp(0, V - 1)] + p["pos_w"][wpos.clamp(
            0, ctx - 1)]
        widx = (torch.gather(bt, 1, (wpos // page).clamp(0, MP - 1)) * page
                + wpos % page)
        widx = torch.where(wpos < ctx, widx, zero).reshape(S * W)
        for i in range(L):
            x = _ln(h, p["l%d_ln1_g" % i], p["l%d_ln1_b" % i])
            qkv = _dense(x, p["l%d_qkv_w" % i], p["l%d_qkv_b" % i])
            q, kk, vv = qkv.split(C, dim=-1)                      # (S, W, C)
            k_pages[i].index_copy_(0, widx, kk.reshape(S * W, C))
            v_pages[i].index_copy_(0, widx, vv.reshape(S * W, C))
            o = _attend_pages(q, k_pages[i], v_pages[i], bt32, pos32, wpos,
                              heads=H, page_size=page)
            h = h + _dense(o, p["l%d_proj_w" % i], p["l%d_proj_b" % i])
            h = _mlp(h, p, i)
        vlogits = _dense(_ln(h, p["lnf_g"], p["lnf_b"]), p["head_w"],
                         p["head_b"])                             # (S, W, V)
        vs = _sample(vlogits.reshape(S * W, V), temps.repeat_interleave(W),
                     seeds.repeat_interleave(W), (wpos + 1).reshape(S * W),
                     None if host_temps is None
                     else _np.repeat(host_temps.reshape(-1), W)
                     ).reshape(S, W)

        # -- acceptance: the leading proposals that equal the verifier ---
        match = (props == vs[:, :k]).to(torch.int32)              # (S, k)
        n_accept = torch.cumprod(match, dim=1).sum(dim=1)         # (S,)
        packed = torch.cat([n_accept[:, None].to(torch.int32), vs],
                           dim=1).to(torch.int32)                 # (S, k+2)
        if logits:
            return packed, props, torch.stack(dlogits, dim=1), vlogits
        return packed, k_pages, v_pages, dk_pages, dv_pages

    return _under_tier(draft_verify)


def suggest_speculation_depth(spec, max_k=8, acceptance=0.8,
                              draft_bytes_ratio=0.25):
    """Roofline-derived speculation depth on the H100's rates
    (:mod:`mxnet_tpu_torch.perfmodel`).

    Models one step of each program: decode is bound by its weight
    bytes, so the int8 draft moves ``draft_bytes_ratio`` of the
    verifier's weight bytes (1/4 for int8 over f32), and the (k+1)-wide
    verifier reads its weights once for k+1 tokens. Both read every
    slot's full context of K and V. The two costs go to
    :func:`~mxnet_tpu_torch.perfmodel.speculation_depth`, which picks
    the k with the most expected tokens a second under a geometric
    acceptance model. The result lies in ``[1, min(max_k,
    max_prompt_len)]``: :func:`make_draft_verify` takes no deeper
    window."""
    spec.validate()
    L, C, V = spec.num_layers, spec.dim, spec.vocab
    S, ctx = spec.max_slots, spec.max_context
    n_par = float(12 * L * C * C + 2 * V * C + ctx * C)
    verify_w_bytes = 4.0 * n_par             # f32 weight read
    kv_bytes = 2.0 * L * ctx * C * 4 * S     # every slot's full context
    ratio = min(max(float(draft_bytes_ratio), 1e-3), 1.0)
    t_draft = _perfmodel.roofline_seconds(
        2.0 * n_par * S, ratio * verify_w_bytes + kv_bytes)

    def t_verify(width):
        return _perfmodel.roofline_seconds(2.0 * n_par * S * width,
                                           verify_w_bytes + kv_bytes)

    window = max(1, min(int(max_k), spec.max_prompt_len))
    return _perfmodel.speculation_depth(t_draft, t_verify, max_k=window,
                                        acceptance=acceptance)


# -- dense reference ---------------------------------------------------------

def _dense_logits(p, tokens, H, L):
    """Dense causal forward over a token vector -> the logits of every
    row: row ``j`` predicts position ``j + 1``. Masked scores an exact
    -1e30, as in the JAX package's oracle."""
    T = tokens.shape[0]
    V, C = p["tok_w"].shape
    Dh = C // H
    scale = 1.0 / math.sqrt(Dh)
    dev = tokens.device
    h = p["tok_w"][tokens.clamp(0, V - 1)] + p["pos_w"][:T]
    pos = torch.arange(T, device=dev)
    mask = pos[None, :] <= pos[:, None]
    for i in range(L):
        x = _ln(h, p["l%d_ln1_g" % i], p["l%d_ln1_b" % i])
        qkv = _dense(x, p["l%d_qkv_w" % i], p["l%d_qkv_b" % i])
        q, k, v = qkv.split(C, dim=-1)
        qh = q.reshape(T, H, Dh)
        kh = k.reshape(T, H, Dh)
        vh = v.reshape(T, H, Dh)
        s = torch.einsum("qhd,khd->hqk", qh, kh) * scale
        s = torch.where(mask[None], s, torch.full((), _NEG_INF, device=dev))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("hqk,khd->qhd", w, vh).reshape(T, C)
        h = h + _dense(o, p["l%d_proj_w" % i], p["l%d_proj_b" % i])
        h = _mlp(h, p, i)
    return _dense(_ln(h, p["lnf_g"], p["lnf_b"]), p["head_w"], p["head_b"])


def reference_generate(params, spec, prompt, max_new_tokens,
                       temperature=0.0, seed=0):
    """Slow, paging-free reference: a dense forward over the whole token
    prefix for every generated token. Same math, same sampling keys: the
    KV-cache-correctness oracle (greedy comparisons are exact-token; the
    paged path reassociates reductions, so logits agree only to fp
    tolerance). ``params`` are the port's tensors (on any one device)."""
    spec.validate()
    p, dev = _weights(params)
    toks = [int(t) for t in prompt]
    out = []
    with torch.inference_mode():
        for _ in range(max_new_tokens):
            n = len(toks)   # position the new token will occupy
            lg = _dense_logits(p, torch.tensor(toks, device=dev),
                               spec.num_heads, spec.num_layers)[n - 1]
            temps = _np.asarray([temperature], _np.float32)
            nxt = _sample(lg[None], torch.tensor(temps, device=dev),
                          torch.tensor([int(seed)], device=dev),
                          torch.tensor([n], device=dev), temps)
            tok = int(nxt[0])
            out.append(tok)
            toks.append(tok)
            if spec.eos_id >= 0 and tok == spec.eos_id:
                break
    return out
