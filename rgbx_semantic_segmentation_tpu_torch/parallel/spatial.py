"""Image-height sharding for the data x spatial mesh (`--mesh 2d:D,S`; the
counterpart of the 'spatial' axis of rgbx_semantic_segmentation_tpu/
parallel/mesh.py:40-62, 165-172, where GSPMD inserts the halo exchanges and
gathers by itself).

The design rule. Every gradient on every rank is a partial sum: the
contribution of the rank's own images and rows. The summing DDP comm hook
(train.py) then adds them over the whole world, the loss divides by the
world's all-reduced count of valid pixels and parallel/sync_bn.py sums its
statistics over the world: together the global mean and the global batch
statistics that the JAX mesh computes. So each move between layouts below
has the backward that keeps the rule:

- `gather_rows`, the all-gather of the S row blocks: its backward sums the
  gradient over the spatial group (an all-reduce; gloo has no
  reduce-scatter) and keeps the rank's own block;
- `own_rows`, a slice of a replicated tensor back to the own block: its
  backward pads with zeros (autograd's own);
- `halo_rows` (inside `conv2d_rows`), the exchange of the rows a
  convolution's window reaches across a block edge: its backward sends the
  halo's gradient back to the rank that owns those rows and adds it there;
- `spatial_sum`, the sum over the spatial group: its backward sums the
  incoming gradients over the group too, since each rank's gradient of the
  replicated sum is partial (an identity would lose the other ranks' rows);
- `spatial_amax`, the max over the spatial group: its backward sends the
  gradient, summed over the group, to where the max lies, ties split evenly
  as torch.amax splits them;
- `ring_rows`, any contiguous range of the rows of the map padded with zero
  rows and closed into a ring (the Swin block's rolled, padded image;
  `window_slab_plan`), fetched from their owners: its backward sends each
  row's gradient back to its owner and adds it there. `ring_rows_back` is
  its transpose: a rank's slab returned to the rows' owners.

Row blocks are equal: rank s of S holds rows [s H / S, (s + 1) H / S) of a
map of height H, which must divide. The collectives are all_reduce and
all_gather on the spatial group only, so gloo runs them on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SpatialGroup:
    """The S ranks that hold one image's row blocks: their process group,
    this rank's place among them and their count."""

    group: object
    rank: int
    size: int


def row_range(height: int, sp: SpatialGroup) -> Tuple[int, int]:
    """The half-open rows of a map of `height` rows that the rank holds."""
    if height % sp.size:
        raise ValueError(f"{height} rows do not divide over {sp.size} "
                         "spatial ranks")
    per = height // sp.size
    return sp.rank * per, (sp.rank + 1) * per


def rows_ok(height: int, kv_tokens: int, sp: SpatialGroup) -> bool:
    """Whether a stage of `height` rows whose attention has `kv_tokens`
    keys shards its rows: the JAX Attention's gate (dual_segformer.py:
    113-118), rows that divide and at least one key per spatial rank."""
    return height % sp.size == 0 and kv_tokens >= sp.size


def _all_gather(x: torch.Tensor, sp: SpatialGroup) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(sp.size)]
    dist.all_gather(parts, x.contiguous(), group=sp.group)
    return parts


def _all_reduce(x: torch.Tensor, sp: SpatialGroup,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=sp.group)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, dim):
        ctx.sp, ctx.dim, ctx.n = sp, dim, x.shape[dim]
        return torch.cat(_all_gather(x, sp), dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.sp)
        return g.narrow(ctx.dim, ctx.sp.rank * ctx.n, ctx.n), None, None


def gather_rows(x: torch.Tensor, sp: SpatialGroup, dim: int) -> torch.Tensor:
    """The whole tensor from the ranks' equal blocks along `dim`, in rank
    order (on every rank)."""
    return _GatherRows.apply(x, sp, dim)


def own_rows(x: torch.Tensor, sp: SpatialGroup, dim: int) -> torch.Tensor:
    """The rank's block along `dim` of a tensor every rank holds whole."""
    r0, r1 = row_range(x.shape[dim], sp)
    return x.narrow(dim, r0, r1 - r0)


class _SpatialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _all_reduce(x, sp)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.sp), None


def spatial_sum(x: torch.Tensor, sp: SpatialGroup) -> torch.Tensor:
    """The sum of the ranks' `x` (a partial sum over their rows)."""
    return _SpatialSum.apply(x, sp)


class _SpatialAmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, dims):
        # max is exact in any float dtype: reduce in fp32 (or float64)
        wide = torch.float64 if x.dtype == torch.float64 else torch.float32
        m = _all_reduce(x.amax(dims).to(wide), sp, dist.ReduceOp.MAX)
        shape = list(x.shape)
        for d in dims:
            shape[d] = 1
        m_b = m.to(x.dtype).view(shape)
        hit = x == m_b
        ties = _all_reduce(hit.sum(dims).to(wide), sp)
        ctx.sp = sp
        ctx.save_for_backward(hit, ties.view(shape))
        return m_b.view(m.shape)

    @staticmethod
    def backward(ctx, g):
        hit, ties = ctx.saved_tensors
        g = _all_reduce(g, ctx.sp).view(ties.shape)
        return (hit * (g / ties)).to(g.dtype), None, None


def spatial_amax(x: torch.Tensor, sp: SpatialGroup,
                 dims: Sequence[int]) -> torch.Tensor:
    """torch.amax(whole, dims) of the map whose row blocks the ranks hold
    (`dims` the reduced ones, rows among them), on every rank."""
    return _SpatialAmax.apply(x, sp, tuple(dims))


class _HaloRows(torch.autograd.Function):
    """Rows 2 of `x` extended by the `tops[s]` last rows of rank s - 1 and
    the `bottoms[s]` first rows of rank s + 1 (s this rank)."""

    @staticmethod
    def forward(ctx, x, sp, tops, bottoms):
        s, n = sp.rank, x.shape[2]
        T, Bn = max(tops), max(bottoms)
        ctx.sp, ctx.tops, ctx.bottoms, ctx.n = sp, tops, bottoms, n
        parts = _all_gather(torch.cat([x[:, :, :Bn], x[:, :, n - T:]], 2),
                            sp)
        pieces = [x]
        if tops[s]:
            pieces.insert(0, parts[s - 1][:, :, Bn + T - tops[s]:])
        if bottoms[s]:
            pieces.append(parts[s + 1][:, :, :bottoms[s]])
        return torch.cat(pieces, 2)

    @staticmethod
    def backward(ctx, g):
        sp, tops, bottoms, n = ctx.sp, ctx.tops, ctx.bottoms, ctx.n
        s, T, Bn = sp.rank, max(tops), max(bottoms)
        t = tops[s]
        # what goes back: the top halo's gradient (rows of rank s - 1), the
        # bottom halo's (rows of rank s + 1), each padded to the widest
        send = g.new_zeros(g.shape[:2] + (T + Bn,) + g.shape[3:])
        if t:
            send[:, :, T - t:T] = g[:, :, :t]
        if bottoms[s]:
            send[:, :, T:T + bottoms[s]] = g[:, :, t + n:]
        parts = _all_gather(send, sp)
        dx = g[:, :, t:t + n].clone()
        if s + 1 < sp.size and tops[s + 1]:
            k = tops[s + 1]
            dx[:, :, n - k:] += parts[s + 1][:, :, T - k:T]
        if s > 0 and bottoms[s - 1]:
            k = bottoms[s - 1]
            dx[:, :, :k] += parts[s - 1][:, :, T:T + k]
        return dx, None, None, None


def conv_rows_plan(h_in: int, kernel: int, stride: int, padding: int,
                   sp: SpatialGroup):
    """For a conv over a map of h_in rows whose output rows the ranks hold
    in equal blocks (from input rows held so): per rank, the rows to fetch
    from the rank above and below (negative: own rows the window does not
    reach) and the zero rows past the image's edges. Raises when the
    output rows do not divide or a halo reaches past the next rank."""
    h_out = (h_in + 2 * padding - kernel) // stride + 1
    if h_in % sp.size or h_out % sp.size:
        raise ValueError(f"a conv of {h_in} -> {h_out} rows does not shard "
                         f"over {sp.size} spatial ranks")
    n_in, n_out = h_in // sp.size, h_out // sp.size
    plan = []
    for s in range(sp.size):
        need0 = s * n_out * stride - padding
        need1 = ((s + 1) * n_out - 1) * stride - padding + kernel
        top = s * n_in - max(need0, 0)
        bottom = min(need1, h_in) - (s + 1) * n_in
        if max(top, bottom) > n_in:
            raise ValueError(f"a {kernel}x{kernel}/s{stride} conv's halo of "
                             f"{max(top, bottom)} rows reaches past the "
                             f"next of {sp.size} blocks of {n_in} rows")
        plan.append((top, bottom, max(0, -need0), max(0, need1 - h_in)))
    return plan


def conv2d_rows(x: torch.Tensor, conv: torch.nn.Conv2d,
                sp: SpatialGroup) -> torch.Tensor:
    """`conv` (any kernel, stride and symmetric padding; dilation 1) of the
    map whose row blocks the ranks hold: the rank's block of the output
    rows, from its own input rows and the halo rows its window reaches
    (exchanged with the neighbours; the image's edges padded with zeros,
    as the conv pads them)."""
    (k, kw), (st, stw), (p, pw) = conv.kernel_size, conv.stride, conv.padding
    if k != kw or st != stw or p != pw or conv.dilation != (1, 1):
        raise ValueError(f"conv2d_rows takes square kernels, strides and "
                         f"padding without dilation, not {conv}")
    plan = conv_rows_plan(x.shape[2] * sp.size, k, st, p, sp)
    top, bottom, pad_top, pad_bottom = plan[sp.rank]
    tops = [max(t, 0) for t, _, _, _ in plan]
    bottoms = [max(b, 0) for _, b, _, _ in plan]
    if max(tops) or max(bottoms):
        x = _HaloRows.apply(x, sp, tops, bottoms)
    if top < 0 or bottom < 0:
        x = x[:, :, max(-top, 0):x.shape[2] - max(-bottom, 0)]
    if pad_top or pad_bottom:
        x = F.pad(x, (0, 0, pad_top, pad_bottom))
    return F.conv2d(x, conv.weight, conv.bias, (st, st), (0, p), 1,
                    conv.groups)


# A piece of a rank's ring range: rows [start, stop) of rank `owner`'s
# block, or, with owner -1, stop - start zero rows (the padding).
Piece = Tuple[int, int, int]


def ring_rows_plan(height: int, padded: int,
                   spans: Sequence[Tuple[int, int]], size: int
                   ) -> Tuple[Tuple[Piece, ...], ...]:
    """For a map of `height` rows held in equal blocks by `size` ranks,
    extended by zero rows to `padded` rows and closed into a ring (row
    `padded` is row 0 again): per rank s, the pieces of its range
    [lo, hi) = spans[s] of that ring (0 <= lo < padded, hi - lo <= padded),
    in order. Raises when a piece lies on a rank that is not s or a ring
    neighbour of s."""
    if height % size:
        raise ValueError(f"{height} rows do not divide over {size} spatial "
                         "ranks")
    n = height // size
    plan = []
    for s, (lo, hi) in enumerate(spans):
        if not 0 <= lo < padded or not lo <= hi <= lo + padded:
            raise ValueError(f"ring range [{lo}, {hi}) of {padded} rows")
        pieces, r = [], lo
        while r < hi:
            g = r % padded
            if g >= height:
                take = min(hi - r, padded - g)
                pieces.append((-1, 0, take))
            else:
                o = g // n
                take = min(hi - r, (o + 1) * n - g)
                if (o - s) % size not in (0, 1, size - 1):
                    raise ValueError(
                        f"rank {s} of {size} needs rows {g}..{g + take - 1} "
                        f"of {height} from rank {o}, past its ring "
                        "neighbours")
                pieces.append((o, g - o * n, g - o * n + take))
            r += take
        plan.append(tuple(pieces))
    return tuple(plan)


def window_row_blocks(height: int, window: int, size: int
                      ) -> Tuple[Tuple[int, int], ...]:
    """The window rows [r0, r1) of each of `size` ranks, over a map of
    `height` rows padded to R = ceil(height / window) window rows: rank s
    takes [floor(s R / S), floor((s + 1) R / S)). Raises when R < S (a rank
    would hold no window)."""
    R = -(-height // window)
    if R < size:
        raise ValueError(f"{R} window rows of {window} do not spread over "
                         f"{size} spatial ranks")
    return tuple((s * R // size, (s + 1) * R // size) for s in range(size))


@functools.lru_cache(maxsize=None)
def window_slab_plan(height: int, window: int, shift: int, size: int):
    """The Swin block's window slabs on the spatial axis: ((r0, r1) window
    rows per rank (window_row_blocks), the ring_rows plan that gives each
    rank the rows of its windows in the image padded to whole windows and
    rolled up by `shift` rows)."""
    blocks = window_row_blocks(height, window, size)
    padded = -(-height // window) * window
    spans = [(r0 * window + shift, r1 * window + shift) for r0, r1 in blocks]
    return blocks, ring_rows_plan(height, padded, spans, size)


def _sent(plan, o: int):
    """(asker, piece index) of the pieces ranks ask of owner o, in the
    order o sends them."""
    return [(t, k) for t, pieces in enumerate(plan) if t != o
            for k, (owner, _, _) in enumerate(pieces) if owner == o]


def _returned(plan, t: int):
    """Piece indices of rank t's range that other ranks own, in the order
    t returns their gradients."""
    return [k for k, (owner, _, _) in enumerate(plan[t])
            if owner not in (-1, t)]


def _length(piece: Piece) -> int:
    return piece[2] - piece[1]


def _padded_cat(parts: List[torch.Tensor], like: torch.Tensor, dim: int,
                length: int) -> torch.Tensor:
    """torch.cat(parts, dim), zero rows appended up to `length` rows."""
    have = sum(p.shape[dim] for p in parts)
    if have < length:
        shape = list(like.shape)
        shape[dim] = length - have
        parts = parts + [like.new_zeros(shape)]
    return torch.cat(parts, dim)


def _fetch(x: torch.Tensor, sp: SpatialGroup, plan, dim: int
           ) -> torch.Tensor:
    """The rank's ring range of the map whose blocks x are (along dim)."""
    s, S = sp.rank, sp.size
    width = max(sum(_length(plan[t][k]) for t, k in _sent(plan, o))
                for o in range(S))
    parts = None
    if width:
        mine = [x.narrow(dim, a, b - a) for t, k in _sent(plan, s)
                for _, a, b in (plan[t][k],)]
        parts = _all_gather(_padded_cat(mine, x, dim, width), sp)
    out = []
    for k, (o, a, b) in enumerate(plan[s]):
        if o == -1:
            shape = list(x.shape)
            shape[dim] = b - a
            out.append(x.new_zeros(shape))
        elif o == s:
            out.append(x.narrow(dim, a, b - a))
        else:
            sent = _sent(plan, o)
            off = sum(_length(plan[t][j]) for t, j in sent[:sent.index(
                (s, k))])
            out.append(parts[o].narrow(dim, off, b - a))
    return torch.cat(out, dim)


def _give_back(y: torch.Tensor, sp: SpatialGroup, plan, dim: int, n: int
               ) -> torch.Tensor:
    """The transpose of _fetch: each row of the rank's range `y` added to
    its owner's block (n rows along dim); padding rows are dropped."""
    s, S = sp.rank, sp.size
    starts = [[0] for _ in range(S)]
    for t in range(S):
        for piece in plan[t]:
            starts[t].append(starts[t][-1] + _length(piece))
    width = max(sum(_length(plan[t][k]) for k in _returned(plan, t))
                for t in range(S))
    parts = None
    if width:
        mine = [y.narrow(dim, starts[s][k], _length(plan[s][k]))
                for k in _returned(plan, s)]
        parts = _all_gather(_padded_cat(mine, y, dim, width), sp)
    shape = list(y.shape)
    shape[dim] = n
    dx = y.new_zeros(shape)
    for k, (o, a, b) in enumerate(plan[s]):
        if o == s:
            dx.narrow(dim, a, b - a).add_(y.narrow(dim, starts[s][k], b - a))
    for t in range(S):
        if t == s or not width:
            continue
        off = 0
        for k in _returned(plan, t):
            o, a, b = plan[t][k]
            if o == s:
                dx.narrow(dim, a, b - a).add_(parts[t].narrow(dim, off,
                                                              b - a))
            off += b - a
    return dx


class _RingRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, plan, dim):
        ctx.sp, ctx.plan, ctx.dim, ctx.n = sp, plan, dim, x.shape[dim]
        return _fetch(x, sp, plan, dim)

    @staticmethod
    def backward(ctx, g):
        return (_give_back(g.contiguous(), ctx.sp, ctx.plan, ctx.dim, ctx.n),
                None, None, None)


class _RingRowsBack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, sp, plan, dim, n):
        ctx.sp, ctx.plan, ctx.dim = sp, plan, dim
        return _give_back(y, sp, plan, dim, n)

    @staticmethod
    def backward(ctx, g):
        return (_fetch(g.contiguous(), ctx.sp, ctx.plan, ctx.dim), None, None,
                None, None)


def ring_rows(x: torch.Tensor, sp: SpatialGroup, plan, dim: int
              ) -> torch.Tensor:
    """The rank's range of a ring_rows_plan `plan` (a new contiguous
    tensor), from x, the rank's equal block of the map along `dim`."""
    return _RingRows.apply(x, sp, plan, dim)


def ring_rows_back(y: torch.Tensor, sp: SpatialGroup, plan, dim: int,
                   n: int) -> torch.Tensor:
    """The transpose of ring_rows: the rows of the rank's range `y` added
    into their owners' blocks of `n` rows along `dim` (zero rows where no
    rank's range holds a row); the rank gets its block."""
    return _RingRowsBack.apply(y, sp, plan, dim, n)
