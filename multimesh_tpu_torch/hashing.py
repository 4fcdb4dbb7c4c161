"""Memory-speed content hashing of host arrays.

A copy of the JAX package's ``hashing.py``, so that fingerprints agree
between the two packages: an operator saved by either one loads in the
other; and ``array_fingerprint``, the identity cache for read-only
arrays that the JAX package keeps in ``search/grid.py``.  The copy is
numpy; the port adds a card path, ``content_fingerprint_device``, whose
digest equals ``content_fingerprint``'s bit for bit: the weighted-sum
layer of ``content_hash`` is summed by a kernel
(``csrc/content_sums.cu``, plain twin ``layer1_sums_ref``) from the
array's upload, which the caller keeps.

Operator caches and the mesh-prep cache must be keyed by the *content*
of the source/target geometry: the reference's name-only ``.npy`` caches
silently reuse weights across different meshes of equal size (reference
multi_mesh/components/interpolator.py:724-740).  blake2b over every byte
would be safe but slow on a throttled host CPU; the digest below is a
position-sensitive numpy reduction that runs at memory speed and still
detects every byte-level change plus the coordinated-edit collision
classes a plain checksum misses.

Under ``MMT_PROFILE`` the weighted-sum layer counts the bytes it sums:
``fingerprint.card_bytes`` where the kernel sums them,
``fingerprint.host_bytes`` where numpy does.  The words after the last
whole row and the sub-word tail (under 16 KB) go into blake2b as they
are and count in neither.
"""
from __future__ import annotations

import hashlib
import math
import warnings
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Tuple

import numpy as np
import torch

from . import _build
from .utils_profile import count

HASH_COLS = 4096  # uint32 words in a row of the weighted-sum layer
_M32 = 0xFFFFFFFF
_ROW_MUL = (2654435761 & _M32) | 1  # q: row r weighs r * q + 1
_COL_MUL = (40503 & _M32) | 1  # column c weighs c * 40503 + 1


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
       full blake2b pass."""
    a = np.ascontiguousarray(a)
    # uint32 view regardless of input dtype (uint64 multiply can be a
    # scalar loop); sub-4-byte tail hashes separately
    b8 = a.reshape(-1).view(np.uint8)
    n32 = b8.shape[0] // 4
    if n32 == 0:  # empty / sub-word arrays: nothing to reduce
        return hashlib.blake2b(b8.tobytes(), digest_size=16).digest()
    v = b8[: n32 * 4].view(np.uint32)
    R = n32 // HASH_COLS
    head = v[: R * HASH_COLS].reshape(R, HASH_COLS) if R else v.reshape(1, -1)
    count("fingerprint.host_bytes", head.nbytes)
    return _digest(b8, layer1_sums_host(head), _pages_digest(b8))


def layer1_sums_host(head: np.ndarray):
    """(col, row, colw, roww) of the weighted-sum layer of ``head``
    [R, C] uint32, in numpy: col / row the plain wrapping sums down the
    columns / along the rows, colw[c] = sum_i (i*q + 1) * head[i, c],
    roww[r] = sum_c (c*40503 + 1) * head[r, c], all mod 2^32.

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
    Rh, Ch = head.shape
    dt = np.dtype(np.uint32)
    q_r = dt.type(_ROW_MUL)
    w_c = np.arange(Ch, dtype=dt) * dt.type(_COL_MUL) + dt.type(1)

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
    return col, row, colw, roww


def _digest(b8: np.ndarray, sums, pages: bytes | None) -> bytes:
    """``content_hash`` of the bytes ``b8`` (at least one word) from its
    weighted-sum layer ``sums`` = (col, row, colw, roww) and its sampled
    pages' digest ``pages`` (``_pages_digest``): the four sums, the words
    after the last whole row and the sub-word tail, then layer 2."""
    n32 = b8.shape[0] // 4
    v = b8[: n32 * 4].view(np.uint32)
    R = n32 // HASH_COLS
    h = hashlib.blake2b(digest_size=16)
    for part in sums:
        h.update(part.tobytes())
    h.update(v[R * HASH_COLS :].tobytes())  # unaligned 4-byte words, < C
    h.update(b8[n32 * 4 :].tobytes())  # sub-word tail, < 4 bytes
    if pages is not None:
        h.update(pages)
    return h.digest()


def _pages_digest(b8: np.ndarray) -> bytes | None:
    """Layer 2: the cryptographic digest of every 64th 4 KB page of
    ``b8`` (see ``content_hash``), None under one page; page-partial
    tail bytes are covered by layer 1."""
    page = 4096
    n_pages = b8.size // page
    if not n_pages:
        return None
    sample = b8[: n_pages * page].reshape(n_pages, page)[::64]
    return hashlib.blake2b(np.ascontiguousarray(sample).tobytes(),
                           digest_size=16).digest()


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod 2^32 for int64 tensors holding values in [0, 2^32),
    in halves of b so that no product leaves int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def layer1_sums_ref(words: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel (any device): ``words`` [R, C] int32
    holding uint32 bits -> int32 [2C + 2R] holding the uint32 bits of
    (col, colw, row, roww) as ``layer1_sums_host`` defines them, in int64
    arithmetic masked to 32 bits."""
    R, C = words.shape
    x = words.to(torch.int64) & _M32
    i = torch.arange(max(R, C), dtype=torch.int64, device=words.device)
    w_r = (i[:R] * _ROW_MUL + 1) & _M32
    w_c = (i[:C] * _COL_MUL + 1) & _M32
    out = torch.cat([
        x.sum(0) & _M32,
        _mulmod32(w_r[:, None], x).sum(0) & _M32,
        x.sum(1) & _M32,
        _mulmod32(w_c[None, :], x).sum(1) & _M32,
    ])
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def layer1_sums(words: torch.Tensor) -> torch.Tensor:
    """(col, colw, row, roww) of ``words`` [R, 4096] int32 (uint32 bits,
    C-contiguous, R >= 1), as one int32 tensor [8192 + 2R] on their
    device: a CUDA tensor launches ``csrc/content_sums.cu``, a CPU tensor
    runs ``layer1_sums_ref``, any other device raises."""
    if (words.dtype != torch.int32 or words.dim() != 2
            or words.shape[1] != HASH_COLS or words.shape[0] < 1
            or not words.is_contiguous()):
        raise ValueError(
            f"layer1_sums: words must be contiguous int32 [R >= 1, "
            f"{HASH_COLS}], got {words.dtype} {tuple(words.shape)}")
    device = words.device
    if device.type == "cpu":
        return layer1_sums_ref(words)
    if device.type != "cuda":
        raise ValueError(f"layer1_sums: unsupported device {device}")
    if words.data_ptr() % 16:
        raise ValueError("layer1_sums: words must be 16-byte aligned")
    R = words.shape[0]
    out = torch.zeros(2 * HASH_COLS + 2 * R, dtype=torch.int32,
                      device=device)
    # one band of rows a block, a block an SM
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lib = _build.library()
    err = lib.mmt_content_sums(
        words.data_ptr(), R, math.ceil(R / sms), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "layer1_sums")
    layer1_sums.launches += 1
    return out


layer1_sums.launches = 0  # kernel launches in this process


def _fingerprint(pairs) -> int:
    h = hashlib.blake2b(digest_size=8)
    for a, digest in pairs:
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(digest)
    return int.from_bytes(h.digest(), "little")


def content_fingerprint(*arrays) -> int:
    """64-bit content fingerprint of host arrays (shape + dtype + every
    byte, via :func:`content_hash` per array)."""
    return _fingerprint((a, content_hash(a)) for a in map(np.asarray, arrays))


def content_fingerprint_device(a: np.ndarray, device):
    """``(content_fingerprint(a), a on device)``, bit for bit.

    On a CUDA ``device`` the array's bytes are uploaded once, as they
    are, while a worker thread digests the sampled pages (blake2b
    releases the GIL), and the weighted-sum layer of ``content_hash`` is
    summed on the card (``uploaded_fingerprint``).  The upload is
    returned as a tensor of ``a``'s dtype and shape, for a caller that
    needs ``a`` on the card anyway; None where torch has no such dtype
    (a non-native byte order, such as HDF5's big-endian '>f8').  On any
    other device: ``(content_fingerprint(a), None)``."""
    a = np.asarray(a)
    device = torch.device(device)
    if device.type != "cuda":
        return content_fingerprint(a), None
    host = np.ascontiguousarray(a)
    b8 = host.reshape(-1).view(np.uint8)
    with ThreadPoolExecutor(1) as pool:
        pages = pool.submit(_pages_digest, b8)
        dev = _upload(b8, device)
        fp = uploaded_fingerprint(host, dev, pages.result())
    dtype = _torch_dtype(host.dtype)
    if dtype is None:
        return fp, None
    return fp, dev.view(dtype).view(host.shape)


def _torch_dtype(dtype: np.dtype):
    """The torch dtype of a numpy one, None where torch has none."""
    if not dtype.isnative:
        return None
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:
        return None


_UPLOAD_CHUNK = 1 << 23  # bytes of a pinned staging buffer


def _upload(b8: np.ndarray, device) -> torch.Tensor:
    """The bytes ``b8`` (a C-contiguous uint8 vector) on ``device``.
    They go through two pinned staging buffers (torch's caching host
    allocator keeps them for the next call), so that the host's copy of
    one chunk overlaps the card's read of the one before: a pageable
    copy stages the whole array through CUDA's own buffer at a lower
    rate."""
    with warnings.catch_warnings():
        # a frozen array: it is only read
        warnings.filterwarnings("ignore", message=".*not writable")
        src = torch.from_numpy(b8)
    dst = torch.empty(src.numel(), dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device)
    staged = [None, None]  # (buffer, event of its copy to the card)
    for k, lo in enumerate(range(0, src.numel(), _UPLOAD_CHUNK)):
        n = min(_UPLOAD_CHUNK, src.numel() - lo)
        if staged[k % 2] is None:
            buf = torch.empty(min(_UPLOAD_CHUNK, src.numel()),
                              dtype=torch.uint8, pin_memory=True)
        else:
            buf, copied = staged[k % 2]
            copied.synchronize()
        buf[:n].copy_(src[lo:lo + n])
        dst[lo:lo + n].copy_(buf[:n], non_blocking=True)
        staged[k % 2] = (buf, stream.record_event())
    return dst


def uploaded_fingerprint(a: np.ndarray, dev: torch.Tensor,
                         pages: bytes | None) -> int:
    """``content_fingerprint(a)`` for a C-contiguous ``a`` whose bytes
    ``dev`` holds on a device and whose sampled pages digest to
    ``pages`` (``_pages_digest``): ``layer1_sums`` sums the bytes there
    and the four sums come back in one copy.  Arrays under 4,096 words
    are hashed on the host."""
    b8 = a.reshape(-1).view(np.uint8)
    R = b8.shape[0] // 4 // HASH_COLS
    if R == 0:
        return content_fingerprint(a)
    n = R * HASH_COLS
    sums = layer1_sums(
        dev.reshape(-1).view(torch.uint8)[: 4 * n].view(torch.int32)
        .view(R, HASH_COLS))
    count("fingerprint.card_bytes", 4 * n)
    s = sums.cpu().numpy().view(np.uint32)
    C = HASH_COLS
    digest = _digest(b8, (s[:C], s[2 * C : 2 * C + R], s[C : 2 * C],
                          s[2 * C + R :]), pages)
    return _fingerprint([(a, digest)])


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
    return array_fingerprint_hit(a)[0]


def array_fingerprint_hit(a: np.ndarray, device=None) -> Tuple[int, bool]:
    """``(array_fingerprint(a), hit)``: ``hit`` says that the identity
    cache answered and nothing was hashed.  A miss is hashed by
    ``content_fingerprint_device`` on ``device`` (on the host without
    one), the upload dropped."""
    a = np.asarray(a)
    frozen = not a.flags.writeable and a.flags.c_contiguous
    if frozen:
        guard = _guard_digest(a)
        ent = _FROZEN_CACHE.get(id(a))
        if ent is not None and ent[0]() is a and ent[1] == guard:
            return ent[2], True
    fp = (content_fingerprint(a) if device is None
          else content_fingerprint_device(a, device)[0])
    if frozen:
        for key in [k for k, e in _FROZEN_CACHE.items() if e[0]() is None]:
            del _FROZEN_CACHE[key]
        if len(_FROZEN_CACHE) > 8:
            _FROZEN_CACHE.clear()
        _FROZEN_CACHE[id(a)] = (weakref.ref(a), guard, fp)
    return fp, False


def combine_fingerprints(*fps: int) -> int:
    """Order-sensitive 64-bit combination of fingerprints.  Lets callers
    hash large arrays once each (e.g. source and target geometry
    separately, so the target's fingerprint can also key a dedup cache)
    and still derive a single joint cache key."""
    h = hashlib.blake2b(digest_size=8)
    for fp in fps:
        h.update(int(fp).to_bytes(8, "little", signed=False))
    return int.from_bytes(h.digest(), "little")
