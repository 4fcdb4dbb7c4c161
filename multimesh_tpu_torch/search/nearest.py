"""K2: nearest centroid per query (distance + argmin, scores never stored).

Counterpart of ``_nearest_pallas_jit`` in the JAX package's
``search/pallas_argmin.py``.
The kernel is ``csrc/nearest_centroid.cu``; ``nearest_centroid_ref`` is
its plain PyTorch twin, a chunked ``(|c|^2 - 2 q.c^T).argmin``.

Both take f64 ``queries`` [C, d] and ``sources`` [E, d], centre them
jointly on the sources' mean in f64 and rank in f32 (Earth-scale
magnitudes would otherwise cancel catastrophically), and return the
nearest source's index per query, [C] int32, lowest index on a tie.
This is a candidate pass: the locate ladder retries every point whose
candidate fails Newton acceptance, so a swap of two near-tied sources
costs a rescue round, not accuracy.

``nearest`` picks by the tensors' device: CPU tensors run the plain
twin, CUDA tensors launch the kernel, any other device raises.  Under
``MMT_PROFILE`` it counts, on either device, its queries (``k2.rows``)
and the (query, source) pairs it scores (``k2.pairs``), from the shapes.
"""
from __future__ import annotations

import torch

from .. import _build
from ..utils_profile import count

_REF_CHUNK = 32_768  # query rows per [rows, E] score block of the twin


def centre_jointly(queries, sources):
    """(queries, sources) centred on the sources' mean in f64, as f32."""
    center = sources.mean(dim=0)
    return ((queries - center).to(torch.float32).contiguous(),
            (sources - center).to(torch.float32).contiguous())


def nearest_centroid_ref(queries, sources):
    """Plain PyTorch twin of the kernel (any device)."""
    q32, s32 = centre_jointly(queries, sources)
    s_norm = (s32 * s32).sum(dim=-1)
    out = [
        (s_norm[None, :] - 2.0 * (q32[i:i + _REF_CHUNK] @ s32.T))
        .argmin(dim=1).to(torch.int32)
        for i in range(0, q32.shape[0], _REF_CHUNK)
    ]
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=queries.device)
    return torch.cat(out)


def nearest(queries, sources):
    """Nearest source index per query (see module docstring); CUDA
    tensors launch K2, CPU tensors run the twin."""
    for name, t in (("queries", queries), ("sources", sources)):
        if t.dtype != torch.float64 or t.dim() != 2:
            raise ValueError(
                f"nearest: {name} must be 2-D float64, got {t.dtype} "
                f"{tuple(t.shape)}")
        if t.device != queries.device:
            raise ValueError(
                f"nearest: sources on {sources.device}, queries on "
                f"{queries.device}")
    C, d = queries.shape
    if sources.shape[1] != d or d not in (2, 3):
        raise ValueError(
            f"nearest: coordinates must share d in (2, 3), got {d} and "
            f"{sources.shape[1]}")
    if sources.shape[0] == 0:
        raise ValueError("nearest: no sources")
    count("k2.rows", C)
    count("k2.pairs", C * sources.shape[0])
    device = queries.device
    if device.type == "cpu":
        return nearest_centroid_ref(queries, sources)
    if device.type != "cuda":
        raise ValueError(f"nearest: unsupported device {device}")
    out = torch.empty((C,), dtype=torch.int32, device=device)
    if C == 0:
        return out
    # the kernel centres as it loads (centre_jointly's f64 subtract and
    # f32 cast), so only the centre is computed here
    queries, sources = queries.contiguous(), sources.contiguous()
    center = sources.mean(dim=0)
    lib = _build.library()
    err = lib.mmt_nearest_centroid(
        queries.data_ptr(), sources.data_ptr(), center.data_ptr(), C,
        sources.shape[0], d, out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(lib, err, "nearest")
    nearest.launches += 1
    return out


nearest.launches = 0  # kernel launches in this process
