"""The GPT-block decoder family behind the continuous-batching engine.

Counterpart of ``mxnet_tpu/serve/decode_model.py`` (f32 weights; the
int8 draft and the speculative step are not ported yet). Plain torch
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
  straight into the paged cache (``flash_attn_paged`` with W = P).

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
from . import _threefry

__all__ = ["DecoderSpec", "init_params", "params_from_reference",
           "make_prefill", "make_decode", "make_commit",
           "make_chunk_prefill", "reference_generate"]

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


def params_from_reference(params, spec, device=None):
    """The JAX package's decoder parameters (numpy arrays, names
    unchanged) as f32 tensors on ``device`` (default cuda:0). Every name
    and shape is checked against the spec."""
    dev = resolve_device(device)
    want = _param_shapes(spec.validate())
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise MXNetError("decoder parameters do not match the spec:%s%s"
                         % (" missing %s" % missing if missing else "",
                            " unexpected %s" % extra if extra else ""))
    out = {}
    for name in _param_names(spec):
        v = params[name]
        t = (v.detach() if isinstance(v, torch.Tensor)
             else torch.from_numpy(_np.ascontiguousarray(v)))
        if tuple(t.shape) != want[name]:
            raise MXNetError("decoder parameter %r has shape %s, the spec "
                             "needs %s" % (name, tuple(t.shape), want[name]))
        out[name] = t.to(device=dev, dtype=torch.float32).contiguous()
    return out


def _weights(params):
    """The weight dict a ``make_*`` closes over, and its device."""
    dev = params["tok_w"].device
    if any(not isinstance(v, torch.Tensor) or v.device != dev
           for v in params.values()):
        raise MXNetError("make_*: parameters must be tensors on one device "
                         "(see params_from_reference)")
    return dict(params), dev


# -- shared layer math ------------------------------------------------------

def _ln(x, g, b):
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * g + b


def _dense(x, w, b):
    # gluon FullyConnected convention: w is (out, in)
    return x @ w.T + b


def _mlp(h, p, i):
    x = _ln(h, p["l%d_ln2_g" % i], p["l%d_ln2_b" % i])
    x = torch.relu(_dense(x, p["l%d_mlp1_w" % i], p["l%d_mlp1_b" % i]))
    return h + _dense(x, p["l%d_mlp2_w" % i], p["l%d_mlp2_b" % i])


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

def _gather_rows(table, idx):
    """(rows, C) table gathered by (S, ctx) indices -> (S, ctx, C), through
    the tier's ``take_rows`` kernel when it allows."""
    return _take.gather_pages(table, idx)


def _paged_attend(q, k_tbl, v_tbl, bt, pos, *, heads, page_size):
    """Tier-dispatched paged attention over the block table: (S, W, C)
    queries, row ``w`` of slot ``s`` at position ``pos[s] + w``. None
    when the tier or the guard keeps the site on its gather + softmax
    path (the reason is then in ``tier.stats()['fallback']``)."""
    return _attn.paged_attend_or_none(q, k_tbl, v_tbl, bt, pos,
                                      heads=heads, page_size=page_size)


def _context_rows(bt, page):
    """(S, MP) block table -> (S, MP * page) flat cache rows."""
    offs = torch.arange(page, device=bt.device)
    return (bt[..., :, None] * page + offs).reshape(*bt.shape[:-1], -1)


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
    C, H, Dh, L, V = (spec.dim, spec.num_heads, spec.head_dim,
                      spec.num_layers, spec.vocab)
    ctx = spec.max_context
    scale = 1.0 / math.sqrt(Dh)
    p, dev = _weights(params)
    slots = torch.arange(S, device=dev)
    tpos = torch.arange(ctx, device=dev)

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
            o3 = _paged_attend(q[:, None, :], k_pages[i], v_pages[i],
                               bt32, pos32, heads=H, page_size=page)
            if o3 is not None:
                o = o3[:, 0, :]                                   # (S, C)
            else:
                ctx_idx = _context_rows(bt, page)                 # (S, ctx)
                kh = _gather_rows(k_pages[i], ctx_idx).reshape(S, ctx, H, Dh)
                vh = _gather_rows(v_pages[i], ctx_idx).reshape(S, ctx, H, Dh)
                qh = q.reshape(S, H, Dh)
                s = torch.einsum("shd,sthd->sht", qh, kh) * scale
                att = tpos[None, :] <= positions[:, None]         # (S, ctx)
                s = torch.where(att[:, None, :], s,
                                torch.full((), _NEG_INF, device=dev))
                w = torch.softmax(s, dim=-1)
                o = torch.einsum("sht,sthd->shd", w, vh).reshape(S, C)
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
    """
    spec.validate()
    P, MP, page = spec.max_prompt_len, spec.max_pages_per_slot, spec.page_size
    C, H, Dh, L, V = (spec.dim, spec.num_heads, spec.head_dim,
                      spec.num_layers, spec.vocab)
    ctx = spec.max_context
    scale = 1.0 / math.sqrt(Dh)
    p, dev = _weights(params)
    rows_p = torch.arange(P, device=dev)
    tpos = torch.arange(ctx, device=dev)

    def chunk_prefill(tokens, start, n, block_table, temp, seed, k_pages,
                      v_pages):
        start, n = int(start), int(n)
        tok = _as(tokens, torch.int64, dev).clamp(0, V - 1)
        bt32 = _as(block_table, torch.int32, dev)
        bt = bt32.long()
        pos = start + rows_p                                      # (P,)
        h = p["tok_w"][tok] + p["pos_w"][pos.clamp(0, ctx - 1)]
        widx = bt[(pos // page).clamp(0, MP - 1)] * page + pos % page
        widx = torch.where((rows_p < n) & (pos < ctx), widx,
                           torch.zeros((), dtype=torch.int64, device=dev))
        start_t = torch.full((1,), start, dtype=torch.int32, device=dev)
        for i in range(L):
            x = _ln(h, p["l%d_ln1_g" % i], p["l%d_ln1_b" % i])
            qkv = _dense(x, p["l%d_qkv_w" % i], p["l%d_qkv_b" % i])
            q, k, v = qkv.split(C, dim=-1)                        # (P, C)
            k_pages[i].index_copy_(0, widx, k)
            v_pages[i].index_copy_(0, widx, v)
            o3 = _paged_attend(q[None], k_pages[i], v_pages[i], bt32[None],
                               start_t, heads=H, page_size=page)
            if o3 is not None:
                o = o3[0]                                         # (P, C)
            else:
                ctx_idx = _context_rows(bt, page)                 # (ctx,)
                kh = _take.gather_pages(k_pages[i], ctx_idx[None])[0]
                vh = _take.gather_pages(v_pages[i], ctx_idx[None])[0]
                kh = kh.reshape(ctx, H, Dh)
                vh = vh.reshape(ctx, H, Dh)
                qh = q.reshape(P, H, Dh)
                s = torch.einsum("qhd,thd->hqt", qh, kh) * scale
                att = tpos[None, :] <= pos[:, None]               # (P, ctx)
                s = torch.where(att[None], s,
                                torch.full((), _NEG_INF, device=dev))
                w = torch.softmax(s, dim=-1)
                o = torch.einsum("hqt,thd->qhd", w, vh).reshape(P, C)
            h = h + _dense(o, p["l%d_proj_w" % i], p["l%d_proj_b" % i])
            h = _mlp(h, p, i)
        hf = _ln(h, p["lnf_g"], p["lnf_b"])
        if logits:
            return _dense(hf, p["head_w"], p["head_b"]), k_pages, v_pages
        last = hf[min(max(n - 1, 0), P - 1)]
        lg = _dense(last[None], p["head_w"], p["head_b"])
        host_temps = _np.asarray([float(temp)], _np.float32)
        nxt = _sample(lg, torch.tensor(host_temps, device=dev),
                      torch.tensor([int(seed)], device=dev),
                      torch.tensor([start + n], device=dev), host_temps)[0]
        return nxt, k_pages, v_pages

    return _under_tier(chunk_prefill)


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
