"""Memory-speed content hashing of host arrays.

A copy of the JAX package's ``hashing.py`` (numpy only), so that fingerprints
agree between the two packages: an operator saved by either one loads in
the other; and ``array_fingerprint``, the identity cache for read-only
arrays that the JAX package keeps in ``search/grid.py``.

Operator caches and the mesh-prep cache must be keyed by the *content*
of the source/target geometry: the reference's name-only ``.npy`` caches
silently reuse weights across different meshes of equal size (reference
multi_mesh/components/interpolator.py:724-740).  blake2b over every byte
would be safe but slow on a throttled host CPU; the digest below is a
position-sensitive numpy reduction that runs at memory speed and still
detects every byte-level change plus the coordinated-edit collision
classes a plain checksum misses.
"""
from __future__ import annotations

import hashlib
import weakref

import numpy as np


def content_hash(a: np.ndarray) -> bytes:
    """Full-coverage 16-byte content digest of a host array.

    Two independent layers feed one blake2b:

    1. *Weighted-sum layer* (covers every byte): the buffer is viewed
       as uint32, reshaped [R, 4096], and reduced along BOTH axes twice
       -- plain wrapping sums, plus sums weighted by a
       position-dependent odd multiplier of the *other* axis index.
       The plain sums catch any single-value change; the weighted sums
       are position-sensitive, so coordinated edits that preserve every
       row and column sum (e.g. +d,-d,-d,+d at the corners of a
       rectangle) still move the digest: the weighted column sum of a
       changed column shifts by d*(w[r1]-w[r2]), nonzero for distinct
       rows because i -> i*odd+1 is injective mod 2^32.
    2. *Cryptographic sample layer*: blake2b over every 64th 4 KB page
       (all pages for arrays under 256 KB).  An accidental or crafted
       collision of layer 1 must ALSO leave every sampled page
       byte-identical to collide overall, so the linear-algebraic
       structure of layer 1 cannot be exploited end to end; the
       sample covers 1/64 of the bytes, keeping the cost ~1.6% of a
       full blake2b pass.

    Implementation notes: a column-vector broadcast multiply
    (``head * w_r[:, None]``) runs far slower than the sums
    (scalar inner loop + fresh large allocation), so the row-weighted
    column sum is computed with ADDS ONLY via a two-level fold that is
    algebraically identical mod 2^32:

      sum_i (i*q+1) * x[i,:]  =  q * sum_i i*x[i,:] + colsum
      sum_i i*x[i,:]          =  g * sum_G G*gsum[G,:] + sum_j j*fold[j,:]

    where rows are grouped into G groups of g (i = G*g + j),
    gsum = group sums, fold = sum over groups of each in-group offset.
    The two small weighted sums run as per-row scalar multiplies.  The
    column-weighted row sum keeps the (fast) row-vector broadcast but
    writes into a preallocated block buffer to avoid large allocs."""
    a = np.ascontiguousarray(a)
    # uint32 view regardless of input dtype (uint64 multiply can be a
    # scalar loop); sub-4-byte tail hashes separately
    b8 = a.reshape(-1).view(np.uint8)
    n32 = b8.shape[0] // 4
    if n32 == 0:  # empty / sub-word arrays: nothing to reduce
        return hashlib.blake2b(b8.tobytes(), digest_size=16).digest()
    v = b8[: n32 * 4].view(np.uint32)
    tail_bytes = b8[n32 * 4 :]
    C = 4096
    R = n32 // C
    head = v[: R * C].reshape(R, C) if R else v.reshape(1, -1)
    Rh, Ch = head.shape
    dt = np.dtype(np.uint32)
    q_r = dt.type((2654435761 & 0xFFFFFFFF) | 1)
    w_c = (np.arange(Ch, dtype=dt)
           * dt.type((40503 & 0xFFFFFFFF) | 1) + dt.type(1))

    def _iweighted(m):
        # sum_j j*m[j,:] for a SMALL m, as per-row scalar multiplies
        acc = np.zeros(m.shape[1], dt)
        for j in range(1, m.shape[0]):
            acc += m[j] * dt.type(j)
        return acc

    g = 256 if Rh >= 256 else max(1, Rh)
    G = Rh // g
    with np.errstate(over="ignore"):
        main = head[: G * g].reshape(G, g, Ch)
        gsum = main.sum(axis=1, dtype=dt)          # [G, C]
        fold = main.sum(axis=0, dtype=dt)          # [g, C]
        col = gsum.sum(axis=0, dtype=dt)
        iw = dt.type(g) * _iweighted(gsum) + _iweighted(fold)
        base = dt.type(G * g)
        for j, r in enumerate(head[G * g :]):      # < g tail rows
            col += r
            iw += r * (base + dt.type(j))
        colw = q_r * iw + col
        row = np.empty(Rh, dt)
        roww = np.empty(Rh, dt)
        blk = max(1, (1 << 23) // Ch)
        buf = np.empty((min(blk, Rh), Ch), dt)
        for r0 in range(0, Rh, blk):
            hb = head[r0 : r0 + blk]
            row[r0 : r0 + hb.shape[0]] = hb.sum(axis=1, dtype=dt)
            bb = buf[: hb.shape[0]]
            np.multiply(hb, w_c[None, :], out=bb)
            roww[r0 : r0 + hb.shape[0]] = bb.sum(axis=1, dtype=dt)
    h = hashlib.blake2b(digest_size=16)
    h.update(col.tobytes())
    h.update(row.tobytes())
    h.update(colw.tobytes())
    h.update(roww.tobytes())
    h.update(v[R * C :].tobytes())  # unaligned 4-byte words, < C of them
    h.update(tail_bytes.tobytes())  # sub-word tail, < 4 bytes
    # layer 2: cryptographic digest of every 64th 4 KB page (see
    # docstring); page-partial tail bytes are already covered above
    page = 4096
    n_pages = b8.size // page
    if n_pages:
        sample = b8[: n_pages * page].reshape(n_pages, page)[::64]
        h.update(hashlib.blake2b(
            np.ascontiguousarray(sample).tobytes(), digest_size=16
        ).digest())
    return h.digest()


def content_fingerprint(*arrays) -> int:
    """64-bit content fingerprint of host arrays (shape + dtype + every
    byte, via :func:`content_hash` per array)."""
    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        a = np.asarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(content_hash(a))
    return int.from_bytes(h.digest(), "little")


def _guard_digest(a: np.ndarray) -> bytes:
    """Strided sample digest (~64K bytes read whatever the size), taken
    again on every identity-cache hit as a tripwire for unfreeze, mutate,
    refreeze, which the id and the read-only flag cannot see.  It is a
    sample: a bulk rewrite always trips it, a sparse edit of an array far
    larger than 64 KB can land between its points.  Freezing an array is
    the caller's promise that the buffer will not change."""
    b8 = a.reshape(-1).view(np.uint8)
    step = max(1, b8.size // 65536)
    return hashlib.blake2b(np.ascontiguousarray(b8[::step]).tobytes(),
                           digest_size=16).digest()


_FROZEN_CACHE: dict = {}  # id -> (weakref, guard digest, fingerprint)


def array_fingerprint(a: np.ndarray) -> int:
    """``content_fingerprint(a)``, paid once for a read-only array.

    A writable array is hashed on every call: numpy buffers are mutable,
    so its identity says nothing about its content.  Freezing one with
    ``a.setflags(write=False)`` promises that the buffer will not change;
    its fingerprint is then cached by identity, so a GB-scale lattice is
    hashed once per mesh, not once per ``locate``.  The cache holds a weak
    reference (the array is freed with its last user, and the reused id
    of a dead array never matches), and every hit re-checks
    ``_guard_digest``."""
    a = np.asarray(a)
    if a.flags.writeable or not a.flags.c_contiguous:
        return content_fingerprint(a)
    guard = _guard_digest(a)
    ent = _FROZEN_CACHE.get(id(a))
    if ent is not None and ent[0]() is a and ent[1] == guard:
        return ent[2]
    fp = content_fingerprint(a)
    for key in [k for k, e in _FROZEN_CACHE.items() if e[0]() is None]:
        del _FROZEN_CACHE[key]
    if len(_FROZEN_CACHE) > 8:
        _FROZEN_CACHE.clear()
    _FROZEN_CACHE[id(a)] = (weakref.ref(a), guard, fp)
    return fp


def combine_fingerprints(*fps: int) -> int:
    """Order-sensitive 64-bit combination of fingerprints.  Lets callers
    hash large arrays once each (e.g. source and target geometry
    separately, so the target's fingerprint can also key a dedup cache)
    and still derive a single joint cache key."""
    h = hashlib.blake2b(digest_size=8)
    for fp in fps:
        h.update(int(fp).to_bytes(8, "little", signed=False))
    return int.from_bytes(h.digest(), "little")
