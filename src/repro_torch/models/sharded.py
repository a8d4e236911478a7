"""The model stacks over a device mesh: training, prefill and dense
decode with FSDP x TP under the single controller (the counterpart of
the reference's GSPMD-partitioned ``train_loss``, ``prefill`` and
``decode_step``).

The state is stored as :class:`~repro_torch.dist.sharding.Sharded`
blocks by the policy's specs (a tree of whole tensors is cut by the
policy on entry, differentiably, so its gradients reach it).  Each data
row of the mesh takes its slice of the batch (the policy's batch rule; a
batch that does not divide is computed once, by row 0) and runs the
stack on its devices, gathering each layer's blocks where they are used
(:class:`~repro_torch.dist.fsdp.Row`):

- a row of one column runs the one-device layer code
  (:func:`~repro_torch.models.transformer._apply_layer`) on the row's
  gathered weights, so every family trains and serves over the data
  axis (an encoder-decoder gathers its whole tree and runs its own
  entry points);
- a row of several columns runs the tensor-parallel split of an
  attention layer with a dense MLP: column-parallel q/k/v and gate/up
  (each column its contiguous head or ff block), row-parallel o and
  down (partials added in column order), the embedding and the loss
  head split on vocab; an attention whose heads the columns do not
  divide (gemma-2b's 8 over 16) runs whole on the row's first device.
  Training runs each column's attention over its own heads; a k/v
  projection that the columns cannot split by whole heads (gemma-2b's
  one kv head, whose 256 columns ``spec_for`` still halves) is gathered
  whole on every column, each column reading the kv heads its q heads
  group onto.  Prefill and decode gather the columns'
  q/k/v on the row's first device and attend there over the row's whole
  cache, which is sharded on its batch dim only;
- under a sequence-parallel policy (``fsdp_tp_sp``) the residual stream
  and the norms are split along seq over the columns: gathered before
  each column-parallel projection, each row-parallel output added and
  split (the reduce-scatter); the numbers are ``fsdp_tp``'s.

The loss head is vocab-split: each column's logits of a sequence chunk
are gathered (concatenated in vocab order) on the row's first device,
which is exact, and the chunk's log-sum-exp and label logit taken there,
each chunk under a checkpoint that gathers the head inside it.  The rows'
summed negative log-likelihoods and counts add on the mesh's first
device, so the loss is the whole batch's mean; a MoE layer's
load-balance loss is formed from the rows' routing sums
(:func:`~repro_torch.models.moe.route_stats`), the whole batch's.
At more than one column a MoE layer runs over the columns' experts and
a recurrent mixer over their slices of its width or heads (the serving
forms, :func:`~repro_torch.models.moe.apply_tp`,
:func:`~repro_torch.models.rglru.forward_tp`,
:func:`~repro_torch.models.ssm.forward_tp`, with the copies made by
:func:`~repro_torch.dist.fsdp.move`), the whole state of a prefill or
decode step kept on the row's first column; an encoder-decoder keeps its
blocks stored by the policy and runs on each row's first device over the
gathered tree, as the reference cannot tensor-parallel serve it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ATTN, DENSE, MOE, ModelConfig
from repro_torch.dist import fsdp
from repro_torch.dist import tp
from repro_torch.dist.sharding import (POLICIES, Sharded, cut_tree,
                                       is_spec, spec_axes)
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import transformer as tr
from repro_torch.models.common import BATCH, EMBED, SEQ, nll_sum, rms_norm, \
    softcap
from repro_torch.tree import leaves, tree_map


def policy_of(flags):
    return flags.policy if flags.policy is not None else POLICIES["tp"]


def stored(params, cfg: ModelConfig, flags):
    """``params`` as blocks: a tree of whole tensors is cut by the policy
    (differentiably: the blocks' gradients reach the whole tensors)."""
    if all(isinstance(x, Sharded) for x in leaves(params)):
        return params
    from repro_torch.models.registry import param_build
    specs = param_build(cfg).specs
    pol = policy_of(flags)
    return cut_tree(params, pol.param_shardings(flags.mesh, params, specs),
                    flags.mesh)


def _splits(x, axis: str, dim: int) -> bool:
    """True when leaf ``x``'s spec splits dimension ``dim`` over ``axis``
    (and over nothing else)."""
    return (isinstance(x, Sharded)
            and spec_axes(x.spec[dim % len(x.spec)]) == (axis,))


# ---------------------------------------------------------------------------
# the batch over the rows
# ---------------------------------------------------------------------------

def batch_axes(flags, leaf) -> tuple:
    """The mesh axes the policy splits a batch leaf's axis 0 over."""
    spec = policy_of(flags).batch_sharding(flags.mesh, leaf)
    return spec_axes(spec[0]) if len(spec) else ()


def place_batch(batch: dict, flags) -> dict:
    """Each computing row's slice of every batch leaf on the row's first
    device: ``{key: [slice of row 0, ...]}`` in
    :meth:`~repro_torch.dist.fsdp.MeshPlan.batch_rows` order.  A batch
    already placed (lists) is returned as it is."""
    if all(isinstance(v, list) for v in batch.values()):
        return batch
    plan = fsdp.MeshPlan(flags.mesh, flags.tp_axis)
    first = next(iter(batch.values()))
    rows = plan.batch_rows(batch_axes(flags, first))
    out = {}
    for key, v in batch.items():
        v = torch.as_tensor(v)
        out[key] = [(torch.chunk(v, n, dim=0)[b] if n > 1 else v).to(
            plan.device(plan.index(r, 0))) for r, b, n in rows]
    return out


def row_batches(batch: dict, flags, regather=None):
    """[(Row, that row's batch dict, its batch block)] of the rows that
    compute, the batch placed on them."""
    plan = fsdp.MeshPlan(flags.mesh, flags.tp_axis)
    placed = place_batch(batch, flags)
    first = next(iter(placed.values()))
    whole = torch.empty((sum(t.shape[0] for t in first),), device="meta")
    return [(fsdp.Row(plan, r, regather), {k: v[i] for k, v in placed.items()},
             b)
            for i, (r, b, _) in enumerate(plan.batch_rows(
                batch_axes(flags, whole)))]


# ---------------------------------------------------------------------------
# one row: embedding, layers, loss head
# ---------------------------------------------------------------------------

class _RowRun:
    """The stack over one data row's columns."""

    def __init__(self, row: fsdp.Row, params, cfg: ModelConfig, flags,
                 mode: str):
        self.row, self.params, self.cfg, self.mode = row, params, cfg, mode
        self.policy = policy_of(flags)
        self.flags = dataclasses.replace(flags, mesh=None, policy=None)
        self.axis = row.plan.tp_axis
        self.n = row.plan.cols
        self.g = tp.RowGroup(row)
        self.sp = False

    def move(self, t, src: int, dst: int, kind: str):
        """``t`` from column ``src`` to column ``dst``
        (:func:`~repro_torch.dist.tp.move`: counted by kind)."""
        return tp.move(self.g, t, src, dst, kind)

    # -- residual stream layout ------------------------------------------
    def _sl(self, j, s):
        w = s // self.n
        return slice(j * w, (j + 1) * w)

    def split_seq(self, x):
        """The residual stream as seq chunks on the columns (SP) or
        whole on the first column."""
        if not self.sp:
            return x
        s = x.shape[1]
        return [self.move(x[:, self._sl(j, s)], 0, j, "seq")
                for j in range(self.n)]

    def whole(self, x):
        if not self.sp:
            return x
        return torch.cat([self.move(xj, j, 0, "seq")
                          for j, xj in enumerate(x)], dim=1)

    def norm(self, x, leaf, i):
        if not self.sp:
            return rms_norm(x, self.row.gather(leaf, 0, False, i))
        return [rms_norm(xj, self.row.gather(leaf, j, False, i))
                for j, xj in enumerate(x)]

    def col_inputs(self, h, kind):
        """What each column's column-parallel projection reads: the
        normed stream, whole, on every column (the SP all-gather)."""
        if not self.sp:
            return tp.broadcast(self.g, h, kind)
        return [torch.cat([self.move(hj, j, c, kind)
                           for j, hj in enumerate(h)], dim=1)
                for c in range(self.n)]

    def reduce(self, parts, kind):
        """The row-parallel partials added in column order: on the first
        column, or (SP) each seq chunk on its own column."""
        if not self.sp:
            return tp.reduce_sum(self.g, parts, kind)
        s = parts[0].shape[1]
        out = []
        for j in range(self.n):
            acc = self.move(parts[0][:, self._sl(j, s)], 0, j, kind)
            for c, p in enumerate(parts[1:], 1):
                acc = acc + self.move(p[:, self._sl(j, s)], c, j, kind)
            out.append(acc)
        return out

    def add(self, x, y):
        return x + y if not self.sp else [a + b for a, b in zip(x, y)]

    # -- embedding and head ----------------------------------------------
    def embed(self, tokens):
        emb = self.params["embed"]["tok"]
        if self.n == 1 or not _splits(emb, self.axis, 0):
            table = self.row.gather(emb, 0, False)
            return tr.embed_tokens({"embed": {"tok": table}}, self.cfg,
                                   tokens)
        parts = []
        for c in range(self.n):
            with fsdp.on(self.row.cols[c]):
                w = self.row.gather(emb, c, True)
                rows = w.shape[0]
                t = self.move(tokens, 0, c, "embed").long() - c * rows
                inside = ((t >= 0) & (t < rows))[..., None]
                got = w[t.clamp(0, rows - 1)]
                parts.append(torch.where(inside, got, torch.zeros(
                    (), dtype=got.dtype, device=got.device)))
        return tr._scale_embedding(self.cfg,
                                   tp.reduce_sum(self.g, parts, "embed"))

    def head_logits(self, x):
        """Softcapped logits of ``x`` (on the first column), the columns'
        vocab slices concatenated there when the head is vocab-split."""
        tied = "lm_head" not in self.params
        leaf = self.params["embed"]["tok"] if tied else self.params["lm_head"]
        cap = self.cfg.final_logit_softcap
        vdim = 0 if tied else 1
        if self.n == 1 or not _splits(leaf, self.axis, vdim):
            w = self.row.gather(leaf, 0, False)
            return softcap(x @ (w.T if tied else w), cap)
        parts = []
        for c in range(self.n):
            with fsdp.on(self.row.cols[c]):
                w = self.row.gather(leaf, c, True)
                parts.append(softcap(self.move(x, 0, c, "head in")
                                     @ (w.T if tied else w), cap))
        return torch.cat([self.move(p, c, 0, "logits") for c, p in
                          enumerate(parts)], dim=-1)

    def _chunk_nll(self, xb, lb):
        return nll_sum(self.head_logits(xb), lb)

    def nll(self, x, labels):
        """(summed nll, count) over sequence chunks of ``loss_chunk``
        positions, each under a checkpoint (the head gathered inside
        it), the chunks added in order; ``loss_chunk=0``: one shot."""
        if self.flags.loss_chunk <= 0:
            return self._chunk_nll(x, labels)
        from torch.utils.checkpoint import checkpoint
        s = x.shape[1]
        c = min(self.flags.loss_chunk, s)
        assert s % c == 0, f"sequence {s} does not divide by loss chunk {c}"
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.int64, device=x.device)
        for i in range(0, s, c):
            t, n = checkpoint(self._chunk_nll, x[:, i:i + c],
                              labels[:, i:i + c], use_reentrant=False)
            tot, cnt = tot + t, cnt + n
        return tot, cnt

    # -- layers -----------------------------------------------------------
    def layer(self, lp, i, x, spec, cache=None, pos=None, stats=None):
        """One layer (``lp`` its stored leaves, ``i`` the index on their
        LAYERS axis or None): (x, its cache as the one-device layer
        returns it)."""
        if self.n == 1:
            p = tree_map(lambda leaf: self.row.gather(leaf, 0, False, i), lp)
            with fsdp.on(self.row.home):
                x, cache, _ = tr._apply_layer(p, x, self.cfg, spec,
                                              self.flags, self.mode, cache,
                                              pos, None, None, stats=stats)
            return x, cache
        h = self.norm(x, lp["ln1"], i)
        if spec.mixer == ATTN:
            mix, cache = self.attention(lp["attn"], i, h, spec, cache, pos)
        else:
            mix, cache = self.recurrent(lp, i, h, spec, cache)
        x = self.add(x, mix)
        if spec.mlp == DENSE:
            x = self.add(x, self.mlp(lp["mlp"], i,
                                     self.norm(x, lp["ln2"], i)))
        elif spec.mlp == MOE:
            x = self.add(x, self.moe(lp["moe"], i,
                                     self.norm(x, lp["ln2"], i), stats))
        return x, cache

    def _col_params(self, leaves, i):
        """Each column's blocks of a layer's leaves, gathered on it."""
        out = []
        for c in range(self.n):
            with fsdp.on(self.row.cols[c]):
                out.append(tree_map(
                    lambda leaf: self.row.gather(leaf, c, True, i), leaves))
        return out

    def moe(self, mp, i, h, stats):
        """The MoE layer over the columns' experts (routed once, on the
        first column); its load-balance loss from the routing sums."""
        cfg, x = self.cfg, self.whole(h)
        ps = self._col_params(mp, i)
        with fsdp.on(self.row.home):
            out, _ = moe_mod.apply_tp(
                ps, x, cfg.num_experts_per_tok, cfg.activation,
                self.g, impl=self.flags.moe_impl,
                capacity_factor=cfg.moe_capacity_factor, d_ff=cfg.d_ff,
                stats=stats)
        return self.split_seq(out)

    def recurrent(self, lp, i, h, spec, cache):
        """A recurrent mixer over the columns' slices of its width or
        heads; a prefill or decode step's state (the row's cache, on its
        first column) is sent to each column in its slices and comes back
        whole."""
        name, mod, state_type = tr.RECURRENT[spec.mixer]
        g = self.g
        ps = self._col_params(lp[name], i)
        hs = tp.broadcast(g, self.whole(h), "mixer in")
        if self.mode == "train":
            out, _ = mod.forward_tp(ps, hs, self.cfg, g)
        elif self.mode == "prefill":
            out, new = mod.forward_tp(ps, hs, self.cfg, g,
                                      return_state=True, to=(0,))
            cache = new[0]._asdict()
        else:
            states = [state_type(**cache)] + [None] * (self.n - 1)
            out, new = mod.decode_step_tp(ps, hs, states, self.cfg, g,
                                          to=(0,))
            for n, v in new[0]._asdict().items():
                cache[n].copy_(v)
        return self.split_seq(out), cache

    def mlp(self, mp, i, h):
        act = self.cfg.activation
        if not _splits(mp["w_up"], self.axis, -1):
            p = tree_map(lambda leaf: self.row.gather(leaf, 0, False, i), mp)
            return self.split_seq(mlp_mod.apply(p, self.whole(h), act))
        hs = self.col_inputs(h, "mlp in")
        parts = []
        for c in range(self.n):
            with fsdp.on(self.row.cols[c]):
                p = tree_map(lambda leaf: self.row.gather(leaf, c, True, i),
                             mp)
                parts.append(mlp_mod.apply(p, hs[c], act))
        return self.reduce(parts, "mlp out")

    def attention(self, ap_leaves, i, h, spec, cache, pos):
        cfg, row = self.cfg, self.row
        hd = cfg.resolved_head_dim
        ap = tr._attn_params(cfg, spec, self.flags)
        if (cfg.num_heads % self.n
                or not _splits(ap_leaves["wq"], self.axis, -1)):
            p = tree_map(lambda leaf: row.gather(leaf, 0, False, i),
                         ap_leaves)
            with fsdp.on(row.home):
                o, cache = tr._apply_attn(p, self.whole(h), cfg, spec,
                                          self.flags, self.mode, cache, pos,
                                          None, None)
            return self.split_seq(o), cache
        kv_keep = (cfg.num_kv_heads % self.n == 0
                   and _splits(ap_leaves["wk"], self.axis, -1))
        hs = self.col_inputs(h, "attn in")
        group = cfg.num_heads // cfg.num_kv_heads
        cols = []
        for c in range(self.n):
            with fsdp.on(row.cols[c]):
                w = {k: row.gather(ap_leaves[k], c,
                                   kv_keep if k in ("wk", "wv") else True, i)
                     for k in ("wq", "wk", "wv", "wo")}
                hq = w["wq"].shape[-1] // hd
                hkv = w["wk"].shape[-1] // hd
                pos_c = (pos if not isinstance(pos, torch.Tensor)
                         else self.move(pos, 0, c, "positions"))
                q, k, v, posv, _ = tr._qkv(w, hs[c], cfg, hq, hkv, self.mode,
                                          pos_c)
                cols.append((w, q, k, v, posv, hq))
        bsz, s = hs[0].shape[:2]
        if self.mode == "train":
            parts = []
            for c, (w, q, k, v, _, hq) in enumerate(cols):
                with fsdp.on(row.cols[c]):
                    if not kv_keep:
                        k, v = _kv_for(k, v, c, hq, group)
                    o = attn_mod.attention(q, k, v, ap)
                    parts.append(o.reshape(bsz, s, hq * hd) @ w["wo"])
            return self.reduce(parts, "attn out"), None
        # prefill/decode: the row's cache holds every head on its first
        # column, which attends over all of them
        def heads(j):
            return torch.cat([self.move(t[j], c, 0, "attn heads")
                              for c, t in enumerate(cols)], dim=2)

        q = heads(1)
        if kv_keep:
            k, v = heads(2), heads(3)
        else:
            k, v = cols[0][2], cols[0][3]
        with fsdp.on(row.home):
            quant = tr._quantize(k, v, self.flags)
            o, cache = tr._dense_attn(q, k, v, quant, cache, ap, spec,
                                      cols[0][4], self.mode)
        parts = []
        for c, (w, _, _, _, _, hq) in enumerate(cols):
            with fsdp.on(row.cols[c]):
                oc = self.move(o[:, :, c * hq:(c + 1) * hq], 0, c,
                               "attn heads")
                parts.append(oc.reshape(bsz, s, hq * hd) @ w["wo"])
        return self.reduce(parts, "attn out"), cache

    # -- the stack ----------------------------------------------------------
    def stack(self, x, cache=None, pos=None, stats=None):
        """The layers over the residual stream ``x`` (the first column's
        embeddings): (final-normed hidden states on the first column, the
        cache: the one given, written in place, or the prompt's new one
        in prefill)."""
        cfg = self.cfg
        if self.mode == "train" and self.n > 1:
            layout = self.policy.sharder(self.row.plan.mesh)(
                x, (BATCH, SEQ, EMBED))
            self.sp = self.axis in spec_axes(layout[1])
        x = self.split_seq(x)
        blocks = {f"p{j}": [] for j, _ in enumerate(cfg.layer_pattern)}
        pp = self.params
        for i in range(cfg.num_pattern_blocks):
            def block(x, i=i):
                st, cs = [], []
                for j, spec in enumerate(cfg.layer_pattern):
                    c = (None if cache is None
                         else tr._pick(cache["blocks"][f"p{j}"], i))
                    x, c = self.layer(pp["blocks"][f"p{j}"], i, x, spec, c,
                                      pos, st)
                    cs.append(c)
                return x, st, cs
            if self.mode == "train":
                x, st, _ = tr._remat(self.flags.remat, block, x)
            else:
                x, st, cs = block(x)
                for j, c in enumerate(cs):
                    blocks[f"p{j}"].append(c)
            if stats is not None:
                stats.extend(st)
        rem = {}
        for j, spec in enumerate(cfg.remainder_specs):
            c = None if cache is None else cache["rem"][f"r{j}"]

            def one(x, spec=spec, j=j, c=c):
                st = []
                x, c2 = self.layer(pp["rem"][f"r{j}"], None, x, spec, c, pos,
                                   st)
                return x, st, c2
            if self.mode == "train":
                x, st, _ = tr._remat(tr._layer_remat(self.flags), one, x)
            else:
                x, st, rem[f"r{j}"] = one(x)
            if stats is not None:
                stats.extend(st)
        x = rms_norm(self.whole(x), self.row.gather(pp["final_norm"], 0,
                                                    False))
        if self.mode == "prefill":
            cache = dict(blocks={name: {k: torch.stack([c[k] for c in cs])
                                        for k in cs[0]}
                                 for name, cs in blocks.items()}, rem=rem)
        return x, cache


def _kv_for(k, v, c: int, hq: int, group: int):
    """The kv heads column ``c``'s q heads (``hq`` of them, from head
    ``c * hq``) group onto, out of all of them: a contiguous run when
    each of its heads serves the same number of q heads, else one kv
    head per q head."""
    idx = [(c * hq + j) // group for j in range(hq)]
    lo, hi = idx[0], idx[-1] + 1
    width = hi - lo
    if hq % width == 0 and idx == [lo + j // (hq // width)
                                   for j in range(hq)]:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _embed_input(run: _RowRun, b: dict):
    x = run.embed(b["tokens"])
    pe = b.get("patch_embeds")
    if pe is not None:
        x = torch.cat([pe.to(x.device, x.dtype), x], dim=1)
    return x


def _gather_tree(row, params):
    return tree_map(lambda leaf: row.gather(leaf, 0, False), params)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def train_loss(params, cfg: ModelConfig, flags, batch: dict):
    """The mesh's :func:`~repro_torch.models.transformer.train_loss`:
    (loss on the mesh's first device, dict(ce=, aux=)), with the graph
    kept for autograd; ``batch`` whole or placed (:func:`place_batch`)."""
    params = stored(params, cfg, flags)
    regather = fsdp.Regather()
    sums, stats, homes = [], [], []
    with regather.active():
        for row, b, _ in row_batches(batch, flags, regather):
            homes.append(row.home)
            if cfg.enc_dec:
                sums.append(_encdec_row_nll(row, params, cfg, flags, b))
                continue
            run = _RowRun(row, params, cfg, flags, "train")
            st = []
            x, _ = run.stack(_embed_input(run, b), stats=st)
            sums.append(run.nll(x, b["labels"]))
            stats.append(st)

    def total(parts):
        out = None
        for t, k in zip(parts, homes):
            t = fsdp.move(t, flags.mesh, k, 0)
            out = t if out is None else out + t
        return out

    ce = total([t for t, _ in sums]) / torch.clamp(
        total([n for _, n in sums]), min=1)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    for layer in range(len(stats[0]) if stats else 0):
        per = [st[layer] for st in stats]
        aux = aux + moe_mod.lb_from_stats(
            total([x[0] for x in per]), total([x[1] for x in per]),
            sum(x[2] for x in per), sum(x[3] for x in per))
    return ce + flags.aux_loss_weight * aux, dict(ce=ce, aux=aux)


def _encdec_row_nll(row, params, cfg, flags, b):
    from repro_torch.models import encdec
    p = _gather_tree(row, params)
    f1 = dataclasses.replace(flags, mesh=None, policy=None)
    with fsdp.on(row.home):
        memory = encdec.encode(p, cfg, f1, b["frames"])
        x = encdec._embed(p, b["dec_tokens"])
        x, _ = encdec._decoder(p, cfg, f1, x, memory=memory, mode="train")
    return _RowRun(row, params, cfg, flags, "train").nll(x, b["labels"])


def _row_cache(cache, b_idx):
    """A row's dense cache: each leaf's batch block (or its one block)."""
    def pick(x):
        if not isinstance(x, Sharded):
            return x
        return x.blocks[b_idx] if len(x.blocks) > 1 else x.blocks[0]
    return tree_map(pick, cache)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, flags, batch: dict):
    """The mesh's prefill: (the dense cache, each leaf cut on its batch
    dim over the rows, as :class:`~repro_torch.dist.sharding.Sharded`;
    the last logits (B, V) on the mesh's first device)."""
    plan = fsdp.MeshPlan(flags.mesh, flags.tp_axis)
    params = stored(params, cfg, flags)
    caches, logits, rows = [], [], []
    f1 = dataclasses.replace(flags, mesh=None, policy=None)
    for row, b, _ in row_batches(batch, flags):
        if plan.cols == 1 or cfg.enc_dec:
            from repro_torch.models.registry import stack_of
            with fsdp.on(row.home):
                c, lg = stack_of(cfg).prefill(_gather_tree(row, params), cfg,
                                              f1, b)
        else:
            run = _RowRun(row, params, cfg, flags, "prefill")
            x, c = run.stack(_embed_input(run, b))
            lg = run.head_logits(_last(x, b.get("valid_len")))[:, 0]
        caches.append(c)
        logits.append(fsdp.move(lg, flags.mesh, row.home, 0))
        rows.append(row)
    return _join_cache(caches, rows, flags), torch.cat(logits, dim=0)


def _last(x, vl):
    if vl is None:
        return x[:, -1:]
    bsz = x.shape[0]
    idx = torch.as_tensor(vl, device=x.device).reshape(-1).long(
        ).expand(bsz) - 1
    return x[torch.arange(bsz, device=x.device), idx][:, None]


def _join_cache(caches, rows, flags):
    """The rows' caches as one tree of Sharded leaves, each cut on its
    batch dim (:func:`repro_torch.dist.steps.cache_shardings`' specs):
    row i's cache is block i, on the row's first device; a leaf whose
    batch the policy replicates is one block on the mesh's first."""
    from repro_torch.dist.steps import batch_dim, cache_shardings
    from repro_torch.tree import leaves_with_paths, unflatten_like
    mesh = flags.mesh
    per_row = [dict(leaves_with_paths(c)) for c in caches]
    whole = {}
    for path, first in per_row[0].items():
        bdim = batch_dim(path)
        shape = list(first.shape)
        shape[bdim] = sum(pr[path].shape[bdim] for pr in per_row)
        whole[path] = torch.empty(shape, dtype=first.dtype, device="meta")
    specs = cache_shardings(mesh, unflatten_like(caches[0], whole),
                            policy_of(flags))
    spec_of = dict(leaves_with_paths(specs, is_leaf=is_spec))
    out = {}
    for path, w in whole.items():
        parts = [pr[path] for pr in per_row]
        spec, bdim = spec_of[path], batch_dim(path)
        if len(parts) > 1 and spec_axes(spec[bdim]):
            owners, blocks = [row.home for row in rows], parts
        else:
            owners = [0]
            blocks = [torch.cat([fsdp.move(p, mesh, row.home, 0)
                                 for p, row in zip(parts, rows)], dim=bdim)]
        out[path] = Sharded(w.shape, w.dtype, spec, mesh,
                            [b.contiguous() for b in blocks], owners)
    return unflatten_like(caches[0], out)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, flags, cache, tokens, pos):
    """The mesh's dense decode tick: ``cache`` a tree of Sharded leaves
    cut on the batch dim, written in place; ``pos`` a scalar or a
    per-slot (B,) vector.  Returns (logits (B, V) on the mesh's first
    device, cache)."""
    plan = fsdp.MeshPlan(flags.mesh, flags.tp_axis)
    params = stored(params, cfg, flags)
    vec = isinstance(pos, torch.Tensor) and pos.dim() > 0
    batch = dict(tokens=tokens)
    if vec:
        batch["pos"] = pos
    f1 = dataclasses.replace(flags, mesh=None, policy=None)
    out = []
    for row, b, bi in row_batches(batch, flags):
        c = _row_cache(cache, bi)
        p_r = b["pos"] if vec else (
            pos.to(row.devs[0]) if isinstance(pos, torch.Tensor) else pos)
        if plan.cols == 1 or cfg.enc_dec:
            from repro_torch.models.registry import stack_of
            with fsdp.on(row.home):
                lg, _ = stack_of(cfg).decode_step(
                    _gather_tree(row, params), cfg, f1, c, b["tokens"], p_r)
        else:
            run = _RowRun(row, params, cfg, flags, "decode")
            x, _ = run.stack(run.embed(b["tokens"]), cache=c, pos=p_r)
            lg = run.head_logits(x)[:, 0]
        out.append(fsdp.move(lg, flags.mesh, row.home, 0))
    return torch.cat(out, dim=0), cache
