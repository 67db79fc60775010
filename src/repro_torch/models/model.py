"""Public model API: ``build(cfg) -> Model`` with init / loss / prefill /
decode (port of :mod:`repro.models.model`: every family of the registry).

``Model.loss`` is differentiated by autograd: on the CPU through the
kernels' plain versions, on the card through each kernel wrapper's
``torch.autograd.Function`` (the kernel forward; backward by recompute of
the plain attention and chunked SSD forms, and the RG-LRU adjoint scan on
the same kernel), with every layer rematerialized where ``cfg.remat``.

Under a mesh (``ctx``, :mod:`repro_torch.models.sharding`) the parameters
are each rank's blocks (:meth:`Model.shard_params` of one full tree) and
the batch its rows; the loss is the global one on every rank: the masked
sums and counts are summed over the data axes, the vocab-parallel max and
log-sum-exp over 'model', and the moe ``aux`` averaged over the data
ranks.  Every family runs tensor parallel.  Prefill and decode take the
global batch and return every row and vocab column of the logits on
every rank; each rank keeps its blocks of the decode caches
(:meth:`Model.cache_specs`, the reference's rule): the batch over the
data axes and, on a 4-D leaf, axis 1 over 'model' (a KV cache's
positions, decoded context parallel; an SSM state's heads).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import schema as schema_mod
from repro_torch.models import sharding
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import COMPUTE_DTYPE, vocab_parallel

def cross_entropy(logits, labels, mask=None, z_loss: float = 1e-4,
                  ctx=None, split_vocab: bool = False):
    """Mean CE over valid tokens; f32; optional z-loss regularizer.  A
    masked label may be negative (it is read as 0 and weighs nothing).
    Under a mesh: ``logits`` the rank's rows (and, ``split_vocab``, its
    vocab columns), the mean over every rank's tokens."""
    logits = logits.float()
    labels = labels.long().clamp(min=0)
    if split_vocab:
        m = sharding.all_reduce(logits.detach().amax(dim=-1), ctx,
                                ctx.tp_axis, "max")
        lse = m + torch.log(sharding.leave_tp(
            torch.exp(logits - m[..., None]).sum(dim=-1), ctx))
        local = labels - ctx.tp_index() * logits.shape[-1]
        mine = (local >= 0) & (local < logits.shape[-1])
        gold = torch.gather(logits, -1, torch.where(mine, local, 0)[
            ..., None])[..., 0]
        gold = sharding.leave_tp(torch.where(mine, gold, 0.0), ctx)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * torch.square(lse)
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    total, count = torch.sum(nll * mask), torch.sum(mask)
    if sharding.active(ctx):
        total = sharding.reduce_dp(total, ctx)
        count = sharding.all_reduce(count, ctx, ctx.dp_axes)
    return total / torch.clamp(count, min=1.0)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- schema / params -----------------------------------------------------
    @property
    def schema(self):
        if self.cfg.is_encdec:
            return encdec_mod.encdec_schema(self.cfg)
        return tf_mod.model_schema(self.cfg)

    def init(self, gen: torch.Generator):
        """Random parameters drawn from ``gen`` on ``gen``'s device."""
        return schema_mod.init_params(self.schema, gen, gen.device)

    def param_count(self) -> int:
        return schema_mod.param_count(self.schema)

    def param_specs(self, ctx):
        """The spec of every parameter leaf (the reference's
        ``PartitionSpec`` entries) on ``ctx``'s mesh."""
        return sharding.tree_specs(self.schema, ctx)

    def shard_params(self, params, ctx):
        """This rank's block of every leaf of a full parameter tree (from
        :meth:`init` or :func:`repro_torch.convert.model_params`)."""
        return sharding.shard_tree(params, self.param_specs(ctx), ctx)

    def abstract_params(self, ctx=None, device="meta"):
        """Empty tensors of every parameter leaf's shape and dtype on
        ``device`` (``"meta"``: no memory; inside a ``FakeTensorMode``,
        fake tensors), or of this rank's block under a mesh ``ctx`` (the
        reference's ``abstract_params``, whose avals the dry run lowers
        with)."""
        specs = self.param_specs(ctx) if sharding.active(ctx) else None

        def walk(node, spec):
            if isinstance(node, schema_mod.Leaf):
                shape = node.shape if spec is None else \
                    sharding.local_shape(node.shape, spec, ctx)
                return torch.empty(shape, dtype=node.dtype, device=device)
            return {k: walk(node[k], None if spec is None else spec[k])
                    for k in sorted(node)}
        return walk(self.schema, specs)

    def check_mesh(self, ctx) -> None:
        """The mesh check of every entry point: every family runs tensor
        parallel on any ``ctx``, with or without ``sequence_parallel``, so
        nothing is refused."""

    # -- abstract inputs for the dry run --------------------------------------
    def input_specs(self, shape, device="meta"):
        """Empty tensors of the inputs of one step of ``shape`` (a
        :class:`~repro_torch.configs.shapes.ShapeSpec`), the reference's
        ``input_specs``: ``tokens`` and ``labels`` (train), with
        ``patch_embeds`` (vision) or ``frames`` (encoder-decoder) in
        bf16; decode: ``tokens``, ``positions`` [B, 1] and the whole
        ``caches`` of ``seq_len`` positions."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        tok = lambda *sh: torch.empty(sh, dtype=torch.int32, device=device)
        emb = lambda *sh: torch.empty(sh, dtype=COMPUTE_DTYPE,
                                      device=device)
        if shape.kind == "decode":
            return {"tokens": tok(b, 1), "positions": tok(b, 1),
                    "caches": self._global_caches(b, s, device)}
        if cfg.is_encdec:
            out = {"frames": emb(b, s, cfg.d_model), "tokens": tok(b, s)}
        elif cfg.frontend == "vision":
            p = cfg.frontend_tokens
            out = {"tokens": tok(b, s - p),
                   "patch_embeds": emb(b, p, cfg.d_model)}
        else:
            out = {"tokens": tok(b, s)}
        if shape.kind == "train":
            out["labels"] = tok(*out["tokens"].shape)
        return out

    def input_shardings(self, shape, ctx, specs=None):
        """The spec of every leaf of :meth:`input_specs` (the reference's
        ``input_shardings``): the batch over the data axes, the decode
        caches as :meth:`cache_specs`."""
        specs = self.input_specs(shape) if specs is None else specs

        def one(name, t):
            if name == "caches":
                return sharding.map_tree(
                    lambda c: sharding.cache_spec(tuple(c.shape), ctx), t)
            axes = ("batch",) + (None,) * (t.ndim - 1)
            if name in ("patch_embeds", "frames"):
                axes = ("batch", None, "embed_act")
            return ctx.spec(axes, tuple(t.shape))
        return {k: one(k, v) for k, v in specs.items()}

    def local_inputs(self, shape, ctx, device="meta"):
        """This rank's blocks of :meth:`input_specs` (empty tensors): the
        prefill and decode entry points take the global ``tokens``,
        ``positions``, ``patch_embeds`` and ``frames`` and pick their
        rows themselves, so only the train batch and the caches are
        blocks."""
        full = self.input_specs(shape)
        specs = self.input_shardings(shape, ctx, full)

        def local(t, spec):
            return torch.empty(sharding.local_shape(tuple(t.shape), spec,
                                                    ctx),
                               dtype=t.dtype, device=device)
        out = {}
        for k, t in full.items():
            keep_whole = shape.kind != "train" and k != "caches"
            out[k] = sharding.map_tree(
                lambda c: torch.empty(c.shape, dtype=c.dtype, device=device),
                t) if keep_whole else sharding.map_specs(local, t, specs[k])
        return out

    def cache_specs(self, ctx, batch: int, max_len: int):
        """The spec of every decode-cache leaf for ``batch`` sequences of
        up to ``max_len`` positions (the caches' counterpart of
        :meth:`param_specs`; :func:`sharding.cache_spec`)."""
        return sharding.map_tree(
            lambda t: sharding.cache_spec(tuple(t.shape), ctx),
            self._global_caches(batch, max_len, "meta"))

    # -- forwards --------------------------------------------------------------
    def loss(self, params, batch, ctx=None):
        """-> (loss, metrics).  ``batch``: ``tokens`` and ``labels`` [B, S]
        int, and ``patch_embeds`` [B, P, d] (vision) or ``frames`` [B, Se,
        d] (encoder-decoder); labels are aligned with the token positions
        of the logits (a vision model's patch positions are sliced off).
        The loss is next-token CE (labels < 0 masked) plus 0.01 x the moe
        load-balancing loss.  Under a mesh ``params`` and ``batch`` are the
        rank's; the loss and metrics are the global ones."""
        cfg = self.cfg
        self.check_mesh(ctx)
        if cfg.is_encdec:
            logits, aux = encdec_mod.forward_encdec(
                params, batch["tokens"], cfg, mode="train",
                frames=batch["frames"], ctx=ctx)
        else:
            pe = batch.get("patch_embeds") if cfg.frontend == "vision" \
                else None
            logits, aux = tf_mod.forward(params, batch["tokens"], cfg,
                                         mode="train", patch_embeds=pe,
                                         ctx=ctx)
            if pe is not None:
                logits = logits[:, pe.shape[1]:, :]
        if sharding.active(ctx):
            aux = sharding.reduce_dp(aux, ctx) / ctx.dp_size()
        labels = batch["labels"]
        ce = cross_entropy(logits[:, :-1, :], labels[:, 1:],
                           mask=(labels[:, 1:] >= 0), ctx=ctx,
                           split_vocab=vocab_parallel(cfg, ctx))
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, tokens, pad_cache_to: Optional[int] = None, *,
                patch_embeds=None, frames=None, ctx=None):
        """tokens [B, S] -> (last-position logits [B, V], caches).  A vision
        model may take ``patch_embeds`` [B, P, d], prepended to the text;
        an encoder-decoder model needs ``frames`` [B, Se, d] for its
        encoder.

        Under a mesh the inputs are the global batch and the logits every
        row and column on every rank; the rank computes its rows (those of
        its data index where the batch divides over the data axes, else
        all) and returns its blocks of the caches (:meth:`cache_specs`).
        Full-attention self caches are padded to ``pad_cache_to``
        positions (before they split over 'model')."""
        cfg = self.cfg
        self.check_mesh(ctx)
        if patch_embeds is not None and cfg.frontend != "vision":
            raise ValueError(f"{cfg.name}: patch_embeds given to a model "
                             f"with no vision frontend")
        if cfg.is_encdec and frames is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder prefill "
                             f"needs frames [B, Se, d]")
        if frames is not None and not cfg.is_encdec:
            raise ValueError(f"{cfg.name}: frames given to a model "
                             f"with no encoder")
        ctx, rows = sharding.batch_rows(ctx, tokens.shape[0])
        pick = lambda t: None if t is None else t[rows]
        kw = dict(mode="prefill", ctx=ctx, cache_len=pad_cache_to)
        if cfg.is_encdec:
            logits, caches = encdec_mod.forward_encdec(
                params, tokens[rows], cfg, frames=pick(frames), **kw)
        else:
            logits, caches = tf_mod.forward(
                params, tokens[rows], cfg, patch_embeds=pick(patch_embeds),
                **kw)
        return sharding.gather_rows(logits, ctx), caches

    def decode_step(self, params, tokens, caches, positions, ctx=None):
        """tokens [B,1] int; positions [B,1] int (absolute).  Under a mesh
        ``tokens`` and ``positions`` are the global batch, ``caches`` the
        rank's blocks (as :meth:`prefill` and :meth:`init_decode_caches`
        give them), and the logits every row and column."""
        self.check_mesh(ctx)
        ctx, rows = sharding.batch_rows(ctx, tokens.shape[0])
        kw = dict(mode="decode", caches=caches, positions=positions[rows],
                  ctx=ctx)
        if self.cfg.is_encdec:
            logits, caches = encdec_mod.forward_encdec(
                params, tokens[rows], self.cfg, **kw)
        else:
            logits, caches = tf_mod.forward(params, tokens[rows], self.cfg,
                                            **kw)
        return sharding.gather_rows(logits, ctx), caches

    def _global_caches(self, batch: int, max_len: int, device):
        if self.cfg.is_encdec:
            return encdec_mod.init_decode_caches(self.cfg, batch, max_len,
                                                 device)
        return tf_mod.init_decode_caches(self.cfg, batch, max_len, device)

    def init_decode_caches(self, batch: int, max_len: int, device,
                           ctx=None):
        """Zero caches for ``batch`` sequences of up to ``max_len``
        positions; under a mesh the rank's blocks (:meth:`cache_specs`).
        Under 'model' ranks every 4-D leaf must split (a KV cache's
        positions: the context-parallel decode reads them as split)."""
        if not sharding.active(ctx):
            return self._global_caches(batch, max_len, device)
        self.check_mesh(ctx)
        full = self._global_caches(batch, max_len, "meta")
        specs = self.cache_specs(ctx, batch, max_len)

        def local(t, spec):
            if t.ndim == 4 and ctx.tp_size() > 1 and \
                    ctx.tp_axis not in sharding.sharded_axes(spec):
                raise ValueError(
                    f"{self.cfg.name}: a decode cache of shape "
                    f"{tuple(t.shape)} does not split over "
                    f"{ctx.tp_size()} 'model' ranks; the context-parallel "
                    f"decode needs a max_len that divides")
            return torch.zeros(sharding.local_shape(tuple(t.shape), spec,
                                                    ctx),
                               dtype=t.dtype, device=device)
        return sharding.map_specs(local, full, specs)


def device_bytes(tree, specs, ctx) -> int:
    """Per-rank bytes of a tree of (global) tensors under their ``specs``
    (the reference dry run's ``_tree_device_bytes``: each leaf's bytes
    floor-divided by the number of blocks its spec cuts it into)."""
    total = [0]

    def add(t, spec):
        n = t.numel() * t.element_size()
        parts = ctx.size_of(sharding.sharded_axes(spec)) if spec else 1
        total[0] += n // parts
    sharding.map_specs(add, tree, specs)
    return total[0]


def build(cfg: ModelConfig) -> Model:
    if "ssm" in cfg.layer_kinds() and cfg.ssm_groups != 1:
        raise NotImplementedError(
            f"{cfg.name}: ssm_groups={cfg.ssm_groups}; the port's Mamba2 "
            f"block takes one B/C group: the reference's one-step decode "
            f"sums B and C over the groups where its prefill gives each "
            f"head its own group (ROADMAP.md, R7), so no grouped result "
            f"can be held against it")
    return Model(cfg)
