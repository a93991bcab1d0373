"""Seeded synthetic inputs of the P2P pass, and a float64 numpy sum over
them, shared by ``test_torch_p2p_plain.py`` (CPU) and
``test_torch_p2p_cuda.py`` (the card).  No JAX."""

import numpy as np

FAR = 1e18


def synthetic(nsub, CB, Gb=6, dtype=np.float32, seed=0, deg_hi=6,
              long_row=0, dim=3, degrees=()):
    """(pos [Gb, CB, dim], row_ptr [Gb*nsub+1] int32, col2d [Gb*nsub, dmax]
    int32) with FAR pads trailing each sub-leaf (one sub-leaf full, one all
    pads), a row of degree 0, a full row holding every lane-group mask 0
    .. 2^nsub - 1 of block 0, a row of degree `long_row` (if set), rows 4,
    5, ... of the given `degrees`, a row whose degree is above dmax
    (clamped), the sentinel block id Gb and mask 0 among the random
    entries, and random values past each degree (never read)."""
    rng = np.random.default_rng(seed)
    C = CB // nsub
    G = Gb * nsub
    pos = rng.normal(scale=0.01, size=(Gb, nsub, C, dim))
    nreal = rng.integers(0, C + 1, size=(Gb, nsub))
    nreal[0, 0] = nreal[1 // nsub, 1 % nsub] = C
    nreal[-1, -1] = 0
    pos[np.arange(C)[None, None, :] >= nreal[..., None]] = FAR
    pos = pos.reshape(Gb, CB, dim).astype(dtype)
    masks = np.arange(1 << nsub, dtype=np.uint64)
    deg = rng.integers(0, deg_hi + 1, size=G)
    deg[0] = 0
    deg[1] = len(masks)
    if long_row:
        deg[2] = long_row
    deg[4:4 + len(degrees)] = degrees
    dmax = int(deg.max())
    deg[3] = dmax + 7
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    blk = rng.integers(0, Gb + 1, size=(G, dmax)).astype(np.uint64)
    bits = rng.integers(0, 1 << nsub, size=(G, dmax)).astype(np.uint64)
    bits[1, :len(masks)] = masks
    blk[1, :len(masks)] = 0                  # full rows: real pairs exist
    col = (blk | (bits << np.uint64(32 - nsub))).astype(np.uint32)
    return pos, row_ptr, col.view(np.int32)


def brute(pos, row_ptr, col2d, nsub, eps2):
    """The near-field sum in float64, one partner entry at a time: weight
    r^3 in dim 3, r^2 in dim 2."""
    Gb, CB, dim = pos.shape
    C = CB // nsub
    shift = 32 - nsub
    p = pos.astype(np.float64)
    src = np.concatenate([p, np.full((1, CB, dim), FAR)])
    tgt = p.reshape(Gb * nsub, C, dim)
    out = np.zeros_like(tgt)
    cols = col2d.view(np.uint32)
    for row in range(Gb * nsub):
        for e in range(min(row_ptr[row + 1] - row_ptr[row], cols.shape[1])):
            v = int(cols[row, e])
            blk, bits = v & ((1 << shift) - 1), v >> shift
            groups = [q for q in range(nsub) if (bits >> q) & 1]
            if not groups:
                continue
            s = src[blk].reshape(nsub, C, dim)[groups].reshape(-1, dim)
            d = tgt[row][:, None, :] - s[None, :, :]
            r = 1.0 / np.sqrt(eps2 + (d * d).sum(-1))
            w = r * r * r if dim == 3 else r * r
            out[row] += (d * w[..., None]).sum(1)
    return out.reshape(Gb, CB, dim)


def rel_dev(got, ref):
    """max row-norm of got - ref over the max row-norm of ref."""
    dim = ref.shape[-1]
    d = np.linalg.norm((np.asarray(got, np.float64) - ref).reshape(-1, dim),
                       axis=1)
    return float(d.max() / np.linalg.norm(ref.reshape(-1, dim),
                                          axis=1).max())


def segment_items(work, row_ptr, dmax, ntile, K):
    """The dim-2 kernel's items as it reads them from its work plan
    (``p2p_cuda.segment_plan``; csrc/p2p2d.cu): a list, in item order, of
    (row, tile, segment, segments of the row, first entry, end entry)."""
    work = np.asarray(work, np.int64)
    deg = np.clip(np.diff(np.asarray(row_ptr, np.int64)), 0, dmax)
    R = deg.shape[0]
    X = int(work[R])
    items = []
    for i in range(X + R * ntile):
        if i < X:
            row = int(np.searchsorted(work[:R + 1], i, side="right")) - 1
            d, tile = divmod(i - int(work[row]), ntile)
            n = (int(work[row + 1]) - int(work[row])) // ntile + 1
            seg = n - 1 - d
        else:
            row, tile = divmod(i - X, ntile)
            seg = 0
            n = max(1, -(-int(deg[row]) // K))
        e0 = seg * K
        items.append((row, tile, seg, n, e0, min(e0 + K, int(deg[row]))))
    return items


def p2p_segments(pos, row_ptr, col2d, nsub, eps2, K):
    """Plain emulation (torch) of the dim-2 kernel's summation order: each
    row's segments of at most K partner entries summed apart
    (``p2p_cuda.p2p_plain_entries``), then added highest segment first,
    out = ((p_(n-1) + p_(n-2)) + ...) + p_0."""
    import torch
    from coulomb_oscillators_tpu_torch.ops.fmm import p2p_cuda
    deg = (row_ptr[1:] - row_ptr[:-1]).clamp(0, col2d.shape[1])
    cols = torch.arange(col2d.shape[1])
    out = torch.zeros_like(pos)
    for s in reversed(range(max(1, -(-int(deg.max()) // K)))):
        sel = (cols[None, :] < deg[:, None]) & (cols[None, :] >= s * K) & (
            cols[None, :] < (s + 1) * K)
        rows, ks = torch.nonzero(sel, as_tuple=True)
        out = out + p2p_cuda.p2p_plain_entries(pos, rows, col2d[rows, ks],
                                               nsub, eps2)
    return out
