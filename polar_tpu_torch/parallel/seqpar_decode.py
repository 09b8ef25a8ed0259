"""Element-sharded (sequence-parallel) Fast-SSC decode for huge N.

The port of ``polar_tpu.parallel.seqpar_decode``. The top tree levels'
f / g / combine math (``polar_decoder.hh:28-59``) runs over the mesh with
the codeword's element axis sharded, exchanging partner blocks with one
whole ring shift per exchange (:mod:`.rdma`); below the shard size the
recursion hands each subtree to the local tree decoder
(:class:`polar_tpu_torch.decode.fastssc._TreeDecoder`).

Representation. The JAX package runs one SPMD program under ``shard_map``;
here one process drives the mesh and a sharded value is the list of
per-position blocks, element-major ``(S, B)`` (``S`` elements per
position, frames trailing: the port's global layout). A tree node of
``n_sh * S`` elements occupies positions ``[base, base + n_sh)``; its
value is valid there and don't-care elsewhere. Every elementwise op and
every exchange runs on every position, as the SPMD program runs them; a
role mask (``jnp.where(is_lower, ...)``) becomes a per-position choice,
since the values a mask discards are never read. Child values live on the
first half of the parent's range.

At ``n_sh == 1`` the subtree's input lies wholly on position ``base``: it
is copied to every position and decoded there, redundantly (SC is
sequential across subtrees, so the other positions would idle), or with
``batch_split`` each position decodes its share of the frames and the
results are gathered back. On CUDA blocks with int8 arithmetic the local
decoder routes composite nodes to the hybrid's subtree kernels at the
kernel level and style :mod:`polar_tpu_torch.decode.auto` picks; on the
CPU, and for other arithmetic, it runs eagerly.

The decoder returns the u-domain leaf estimate, sharded like its input
(frozen slots +1), or the ``(K, B)`` message. Semantics are op for op
those of the local decoder, so int8 decodes stay bit-exact with the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

from ..code.compiler import Node, compile_code
from ..code.construction import PolarCode
from ..decode import auto
from ..decode.fastssc import (_resolve_arith, _TreeDecoder, frame_major,
                              make_kernel_for)
from ..ops.arith import Int8Arith
from ..ops.transform import polar_transform
from .mesh import Mesh
from .rdma import transport
from .seqpar import SEQ_AXIS


class _ShardedTreeDecoder:
    """The recursion over the tree above the shard level, on per-position
    blocks. ``devices`` are the mesh's; ``comm`` the transport
    (:mod:`.rdma`); ``local_kernels(level, batch)`` the subtree router of
    the local decoder (None: eager)."""

    def __init__(self, ph, devices, comm: str = "ppermute",
                 batch_split: bool = False, local_kernels=None):
        self.ph = ph
        self.devices = devices
        self.n_dev = len(devices)
        self.comm = comm
        self.shift = transport(comm)
        self.batch_split = batch_split
        self.local_kernels = local_kernels

    # -- communication helpers -------------------------------------------
    def _pull_from(self, x, offset: int):
        """Every position receives x from the one ``offset`` ahead
        (d + offset, wrapping; wrapped positions are masked by role)."""
        return self.shift(x, offset)

    def _push_right(self, x, offset: int):
        """Every position receives x from ``offset`` positions behind."""
        return self.shift(x, -offset)

    def _bcast_from(self, x, src: int):
        """Position ``src``'s block on every position (the values of
        ``all_gather(x)[src]``, one copy per position)."""
        return [x[src] if d == src else x[src].to(dev, copy=True)
                for d, dev in enumerate(self.devices)]

    def _in(self, d: int, base: int, n_sh: int) -> bool:
        return base <= d < base + n_sh

    @staticmethod
    def _map(fn, *lists):
        return [fn(*xs) for xs in zip(*lists)]

    def _left_then_push(self, soft, n2: int, decode_left):
        """Decode the left child and push ``(soft, hard_l)`` right by
        ``n2``; returns ``(hard_l, u_l, soft_pushed, hard_pushed)``. The
        ring-shift kernel takes the stacked exchange, as the JAX package's
        RDMA transport does; the plain transport pushes ``soft`` before the
        left decode, as its ppermute does. Identical values either way."""
        if self.comm == "rdma":
            hard_l, u_l = decode_left()
            pushed = self._push_right(
                self._map(lambda s, h: torch.stack([s, h]), soft, hard_l), n2)
            return hard_l, u_l, [p[0] for p in pushed], [p[1] for p in pushed]
        soft_p = self._push_right(soft, n2)
        hard_l, u_l = decode_left()
        return hard_l, u_l, soft_p, self._push_right(hard_l, n2)

    # -- distributed polar transform over a shard range -------------------
    def _transform(self, x, base: int, n_sh: int):
        """Value-domain polar transform of a node's hard estimate over
        ``[base, base + n_sh)``: local stages, then one exchange per
        cross-shard stage (the decode-side twin of
        :func:`polar_tpu_torch.parallel.seqpar.sharded_transform`)."""
        x = [polar_transform(b, axis=0) for b in x]
        m = 1
        while m < n_sh:
            partner = self._pull_from(x, m)
            x = [self.ph.qmul(x[d], partner[d]) if ((d - base) // m) % 2 == 0
                 else x[d] for d in range(self.n_dev)]
            m *= 2
        return x

    # -- sharded node kinds -------------------------------------------------
    def decode(self, node: Node, soft, base: int, n_sh: int):
        """Returns ``(hard, u)``: the node's codeword estimate and u-domain
        leaf estimate, both over the node's range."""
        if n_sh == 1:
            return self._local_subtree(node, soft, base)
        ph = self.ph
        kind = node.kind
        n2 = n_sh // 2
        rng = range(self.n_dev)
        if kind == "rate0":
            ones = [torch.ones_like(s) for s in soft]
            return ones, ones
        if kind == "rate1":
            hard = self._map(ph.signum, soft)
            return hard, self._transform(hard, base, n_sh)
        if kind == "rep":
            acc, m = soft, n_sh
            while m > 1:
                acc = self._map(ph.qadd, acc, self._pull_from(acc, m // 2))
                m //= 2
            local = []      # valid on position `base`
            for a in acc:
                while a.shape[0] > 1:
                    half = a.shape[0] // 2
                    a = ph.qadd(a[:half], a[half:])
                local.append(ph.signum(a))
            bit = self._bcast_from(local, base)
            hard = [b.expand_as(s) for b, s in zip(bit, soft)]
            u = []
            for d in rng:
                ones = torch.ones_like(soft[d])
                if d == base + n_sh - 1:
                    ones[-1] = bit[d][0]
                u.append(ones)
            return hard, u
        if kind == "spc":
            hard = self._map(ph.decide, soft)
            sabs = self._map(ph.qabs, soft)
            # torch.prod of int8 returns int64: narrow back
            par = [torch.prod(h, dim=0, keepdim=True).to(h.dtype) for h in hard]
            weak = [torch.amin(s, dim=0, keepdim=True) for s in sabs]
            m = n_sh
            while m > 1:
                # one stacked exchange per stage, as the JAX package's
                both = self._pull_from(
                    self._map(lambda p, w: torch.stack([p, w]), par, weak),
                    m // 2)
                par = [ph.qmul(p, b[0]) for p, b in zip(par, both)]
                weak = [ph.qmin(w, b[1]) for w, b in zip(weak, both)]
                m //= 2
            par = self._bcast_from(par, base)
            weak = self._bcast_from(weak, base)
            hard = self._map(ph.flip, hard, par, weak, sabs)
            trans = self._transform(hard, base, n_sh)
            u = []
            for d in rng:
                t = trans[d]
                if d == base:
                    t = t.clone()
                    t[0] = 1
                u.append(t)
            return hard, u
        if kind == "rate0_right":
            # g with an implicit all-(+1) left half: saturating add
            child = self._map(ph.qadd, soft, self._pull_from(soft, n2))
            hard_r, u_r = self.decode(node.right, child, base, n2)
            del child
            pushed = self._push_right(
                self._map(lambda h, u: torch.stack([h, u]), hard_r, u_r), n2)
            hard = [hard_r[d] if self._in(d, base, n2) else pushed[d][0]
                    for d in rng]
            u = [torch.ones_like(soft[d]) if self._in(d, base, n2)
                 else pushed[d][1] for d in rng]
            return hard, u
        if kind in ("rate1_comb", "branch"):
            child = self._map(ph.prod, soft, self._pull_from(soft, n2))
            hard_l, u_l, soft_p, hard_p = self._left_then_push(
                soft, n2, lambda: self.decode(node.left, child, base, n2))
            del child
            child_r = self._map(ph.madd, hard_p, soft_p, soft)
            del soft_p, hard_p
            if kind == "rate1_comb":
                hard_r = self._map(ph.signum, child_r)
                u_r = self._transform(hard_r, base + n2, n2)
            else:
                hard_r, u_r = self.decode(node.right, child_r, base + n2, n2)
            del child_r
            upper = self._pull_from(hard_r, n2)
            hard = [ph.qmul(hard_l[d], upper[d]) if self._in(d, base, n2)
                    else hard_r[d] for d in rng]
            u = [u_l[d] if self._in(d, base, n2) else u_r[d] for d in rng]
            return hard, u
        raise AssertionError(kind)  # pragma: no cover

    def _tree_decoder(self, level: int, batch: int) -> _TreeDecoder:
        kernel_for = (self.local_kernels(level, batch)
                      if self.local_kernels is not None else None)
        return _TreeDecoder(self.ph, kernel_for, axis=0)

    def _local_subtree(self, node: Node, soft, base: int):
        """Shard-size node: the whole subtree by the local decoder, on
        every position (redundant), or, with ``batch_split`` and a batch
        that divides over the mesh, each position its share of the frames,
        the results gathered back onto every position."""
        info = np.flatnonzero(_leaf_frozen(node) == 0)
        b = soft[base].shape[1]

        def run(inp):
            dec = self._tree_decoder(node.level, inp.shape[1])
            hard, _ = dec.decode(node, inp)
            u = torch.ones_like(inp)
            if dec.mesg:
                u[torch.as_tensor(info, device=inp.device)] = torch.cat(
                    dec.mesg, dim=0)
            return hard, u

        if self.batch_split and b % self.n_dev == 0:
            nb = b // self.n_dev
            parts = [run(soft[base][:, d * nb:(d + 1) * nb].to(dev, copy=True)
                         .contiguous())
                     for d, dev in enumerate(self.devices)]
            hard = [torch.cat([h.to(dev) for h, _ in parts], dim=1)
                    for dev in self.devices]
            u = [torch.cat([p.to(dev) for _, p in parts], dim=1)
                 for dev in self.devices]
            return hard, u
        outs = [run(x) for x in self._bcast_from(soft, base)]
        return [h for h, _ in outs], [u for _, u in outs]


def _leaf_frozen(node: Node) -> np.ndarray:
    """Reconstruct the subtree's frozen mask from its node kinds."""
    n = 1 << node.level
    if node.kind == "rate0":
        return np.ones(n, np.uint8)
    if node.kind == "rate1":
        return np.zeros(n, np.uint8)
    if node.kind == "rep":
        m = np.ones(n, np.uint8)
        m[-1] = 0
        return m
    if node.kind == "spc":
        m = np.zeros(n, np.uint8)
        m[0] = 1
        return m
    if node.kind == "rate0_right":
        return np.concatenate([np.ones(n // 2, np.uint8),
                               _leaf_frozen(node.right)])
    if node.kind == "rate1_comb":
        return np.concatenate([_leaf_frozen(node.left),
                               np.zeros(n // 2, np.uint8)])
    return np.concatenate([_leaf_frozen(node.left), _leaf_frozen(node.right)])


def make_seqpar_decoder(
    code: PolarCode,
    mesh: Mesh,
    axis: str = SEQ_AXIS,
    *,
    tree: Node | None = None,
    compute=None,
    output: str = "u_full",
    batch_split: bool = False,
    comm: str = "ppermute",
):
    """Element-sharded Fast-SSC decoder over ``mesh[axis]``.

    * ``decode(llrs)`` — global frame-major ``(B, N)`` LLRs (transposed
      once to element-major and cut into the positions' blocks) → the
      u-domain estimate ``(B, N)`` (``output="u_full"``; frozen slots +1)
      or the message ``(B, K)`` (``output="u"``), on the input's device;
    * ``decode.lane_major(llr_t)`` — element-major ``(N, B)`` → ``(N, B)``
      or ``(K, B)``;
    * ``decode.shards(blocks)`` — the per-position ``(S, B)`` blocks in,
      the per-position output blocks out, sharded like the input (with
      ``output="u"`` each position's info rows).

    ``compute`` as :func:`polar_tpu_torch.decode.fastssc.make_fastssc_decoder`'s
    (None: from the dtype). ``batch_split``: each shard-size subtree
    decodes the frame batch split over the mesh (B divisible by the
    position count) instead of redundantly on every position. ``comm``:
    ``"ppermute"`` (the plain transport) or ``"rdma"`` (the ring-shift
    kernel, :mod:`.rdma`). All give identical results.
    """
    if tree is None:
        tree = compile_code(code)
    n_dev = mesh.shape[axis]
    if code.N % n_dev or (n_dev & (n_dev - 1)):
        raise ValueError(f"N={code.N} needs a power-of-two shard count, "
                         f"got {n_dev}")
    shard = code.N // n_dev
    if shard < 4:
        raise ValueError(f"shard size {shard} < 4 (use fewer devices)")
    if output not in ("u_full", "u"):
        raise ValueError(f"unknown output mode {output!r}")
    transport(comm)   # raises on an unknown transport
    devices = mesh.devices
    info = code.info_indices
    local_info = [info[(info >= d * shard) & (info < (d + 1) * shard)]
                  - d * shard for d in range(n_dev)]
    routers: dict = {}

    def local_kernels(level: int, batch: int):
        """The hybrid's subtree router at this subtree level, in the
        kernel style the auto decoder takes for the batch."""
        style = auto.kernel_style(level, False, batch, hybrid=True)
        key = (level, style)
        if key not in routers:
            routers[key] = make_kernel_for(auto.hybrid_kernel_level(level),
                                           style=style)
        return routers[key]

    def shards(blocks):
        if len(blocks) != n_dev:
            raise ValueError(f"expected {n_dev} blocks, got {len(blocks)}")
        for d, (blk, dev) in enumerate(zip(blocks, devices)):
            if blk.ndim != 2 or blk.shape[0] != shard or blk.device != dev:
                raise ValueError(f"block {d}: expected ({shard}, B) on {dev}, "
                                 f"got {tuple(blk.shape)} on {blk.device}")
        ph, work_dtype = _resolve_arith(compute, blocks[0].dtype)
        x = [b if work_dtype is None else b.to(work_dtype) for b in blocks]
        kernels = (local_kernels if isinstance(ph, Int8Arith)
                   and all(dev.type == "cuda" for dev in devices) else None)
        dec = _ShardedTreeDecoder(ph, devices, comm, batch_split=batch_split,
                                  local_kernels=kernels)
        _, u = dec.decode(tree, x, 0, n_dev)
        if output == "u":
            return [ub[torch.as_tensor(li, device=ub.device)]
                    for ub, li in zip(u, local_info)]
        return u

    def lane_major(llr_t):
        if llr_t.ndim != 2 or llr_t.shape[0] != code.N:
            raise ValueError(f"expected (N={code.N}, B) lane-major LLRs")
        blocks = [llr_t[d * shard:(d + 1) * shard].to(dev)
                  for d, dev in enumerate(devices)]
        return torch.cat([o.to(llr_t.device) for o in shards(blocks)], dim=0)

    entry = frame_major(lane_major, "sharded decoder")

    def decode(llrs):
        if llrs.ndim != 2 or llrs.shape[1] != code.N:
            raise ValueError(f"expected (B, N={code.N}) LLRs")
        return entry(llrs)

    decode.lane_major = lane_major
    decode.shards = shards
    return decode
