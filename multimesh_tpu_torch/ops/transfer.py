"""The sparse transfer operator: build once, apply as gather + dot.

Counterpart of the JAX package's ``ops/transfer.py``:

    op = TransferOperator.build(src_points, tgt_points, order, ...)
    vals = op.apply(fields)          # gather + weighted reduction
    op.save(dir); TransferOperator.load(dir)

The on-disk format is the JAX package's (elements.npy, refs.npy,
found.npy, meta.npy = uint64 [order, fingerprint], optional refs_lo.npy
and recon.npy, or the dense coeffs.npy), so an operator saved by either
package loads in the other; ``from_numpy`` takes the JAX operator's
state as numpy arrays.  The operator's tensors live on one device, the
one ``build``, ``from_numpy`` or ``load`` was given.

An operator built with ``LocateConfig(df32_polish=True)`` carries
``refs_lo``: ``refs + refs_lo`` is its pair-precision ref, and ``apply``
interpolates there in f64 through K5 (``search.polish.apply_pairs``).
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Union

import numpy as np
import torch

from ..config import DEFAULT_LOCATE, LocateConfig
from ..core import gll
from ..search import polish as _polish
from ..search.locate import locate as _locate
from ..utils_profile import stage_timer

PathLike = Union[str, pathlib.Path]


def _apply_weights(elements, weights, fields):
    """elements [n], weights [n, k], fields [F, E, k] -> [n, F]; element
    -1 (not found) gives 0, as the reference's zero-fill for unlocatable
    points (reference interpolator.py:963-970)."""
    gathered = fields[:, elements.clamp_min(0).long(), :]  # [F, n, k]
    vals = (gathered * weights[None]).sum(dim=-1).T
    return torch.where((elements >= 0)[:, None], vals, 0.0)


def _apply_refs(elements, refs, found, fields, order):
    """Basis weights recomputed from the refs in the fields' dtype, then
    the gather + dot of ``_apply_weights``."""
    weights = gll.tensor_basis(order, refs.to(fields.dtype))
    weights = torch.where(found[:, None], weights, 0.0)
    return _apply_weights(elements, weights, fields)


@dataclasses.dataclass
class TransferOperator:
    """(elements, refs) pair mapping a source mesh onto target points.

    elements: [N] int32 source-element index per target point (-1 missing)
    refs:     [N, d] reference coordinates in that element; found [N] bool
    order:    polynomial order of the source mesh
    recon:    optional [M] reconstruction indices when the operator was
              built on deduplicated unique points (apply expands back)
    n_retry:  rows ``build`` re-ran through the scan retry
    refs_lo:  optional [N, d] f32 pair residuals of f32 refs (df32 polish)
    """

    elements: torch.Tensor
    order: int
    refs: torch.Tensor | None = None
    found: torch.Tensor | None = None
    recon: torch.Tensor | None = None
    _weights: torch.Tensor | None = None  # explicit weights (dense caches)
    n_retry: int = 0
    refs_lo: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.elements.device

    @property
    def weights(self) -> torch.Tensor:
        """[N, (p+1)^d] weights, materialized from the refs unless the
        operator carries explicit ones; with ``refs_lo`` from the f64 sum
        of the pair, so a dense save keeps the pair's precision."""
        if self._weights is not None:
            return self._weights
        refs = self.refs
        if self.refs_lo is not None:
            refs = refs.to(torch.float64) + self.refs_lo.to(torch.float64)
        w = gll.tensor_basis(self.order, refs)
        if self.found is not None:
            w = torch.where(self.found[:, None], w, 0.0)
        return w

    @weights.setter
    def weights(self, value):
        """Explicit [N, (p+1)^d] weights (a dense cache's coefficients):
        ``apply`` then gathers with them and ignores the refs."""
        self._weights = torch.as_tensor(value, device=self.device)

    @classmethod
    def build(cls, source_points, target_points, order: int,
              cfg: LocateConfig = DEFAULT_LOCATE, *,
              fallback: str = "sentinel", use_aabb: bool = False,
              prefilter_m: int = 0, centroids=None, candidates=None,
              recon=None, device=None,
              plain: bool = False) -> "TransferOperator":
        """Locate ``target_points`` [N, d] in the source mesh
        ``source_points`` [E, (p+1)^d, d] on ``device`` (see
        ``search.locate.locate``, also for ``centroids`` and
        ``candidates``; ``plain`` runs the kernels' plain twins)."""
        with stage_timer("operator.build"):
            res = _locate(target_points, source_points, order, cfg,
                          fallback=fallback, use_aabb=use_aabb,
                          centroids=centroids, candidates=candidates,
                          prefilter_m=prefilter_m, want_weights=False,
                          device=device, plain=plain)
        return cls(
            elements=res.elements, order=order, refs=res.refs,
            found=res.found,
            recon=None if recon is None else torch.as_tensor(
                recon, device=res.elements.device),
            n_retry=res.n_retry, refs_lo=res.refs_lo,
        )

    @classmethod
    def from_numpy(cls, elements, refs, found, order: int, recon=None,
                   refs_lo=None, device="cuda") -> "TransferOperator":
        """The JAX package's operator state (numpy arrays) as an operator
        on ``device``; refs keep their dtype, which sets apply's unless
        ``refs_lo`` (the df32 pair residuals) is given."""
        def dev(a, dtype=None):
            return torch.tensor(np.asarray(a, dtype=dtype), device=device)

        return cls(
            elements=dev(elements, np.int32), order=int(order),
            refs=dev(refs),
            found=(dev(elements, np.int32) >= 0 if found is None
                   else dev(found, bool)),
            recon=None if recon is None else dev(recon),
            refs_lo=None if refs_lo is None else dev(refs_lo, np.float32),
        )

    @property
    def n_points(self) -> int:
        return self.elements.shape[0]

    @property
    def num_missing(self) -> int:
        return int((self.elements < 0).sum())

    def apply(self, fields, expand: bool = True, chunk: int = 1_048_576,
              out_chunks: bool = False):
        """Apply to one field [E, n] -> [N] or a stack [F, E, n] -> [N, F].

        The gather runs in the dtype of the refs (or of explicit weights)
        -- f32 for the operator ``build`` makes -- chunked over points to
        bound the [F, chunk, n] gather buffer.  With ``refs_lo`` it runs
        in f64 at the pair refs through ``search.polish.apply_pairs``
        (K5 on the card), as the JAX package's ``_apply_df32``.  With
        ``recon`` and ``expand`` the result is expanded back to the
        original (duplicated) point order.  The result is on the
        operator's device.

        ``out_chunks=True`` returns ``(chunks, chunk)`` -- the list of
        per-chunk tensors (row ranges ``[i*chunk, (i+1)*chunk)``,
        un-expanded, [n, F]) instead of one concatenated tensor, so the
        file path can copy chunk by chunk to the host while earlier rows
        are already being expanded and written (``expand`` is ignored)."""
        fields = torch.as_tensor(fields, device=self.device)
        single = fields.dim() == 2
        if single:
            fields = fields[None]
        N = self.n_points
        if self._weights is not None:
            weights = torch.as_tensor(self._weights, device=self.device)
            fields = fields.to(weights.dtype)
            outs = [
                _apply_weights(self.elements[s:s + chunk],
                               weights[s:s + chunk], fields)
                for s in range(0, N, chunk)
            ]
        elif self.refs_lo is not None:
            fields = fields.to(torch.float64).contiguous()
            refs = self.refs.to(torch.float32)
            d = refs.shape[1]
            outs = [
                _polish.apply_pairs(refs[s:s + chunk],
                                    self.refs_lo[s:s + chunk],
                                    self.elements[s:s + chunk], fields,
                                    self.order, d)
                for s in range(0, N, chunk)
            ]
        else:
            fields = fields.to(self.refs.dtype)
            found = (self.found if self.found is not None
                     else torch.ones((N,), dtype=torch.bool,
                                     device=self.device))
            outs = [
                _apply_refs(self.elements[s:s + chunk],
                            self.refs[s:s + chunk], found[s:s + chunk],
                            fields, self.order)
                for s in range(0, N, chunk)
            ]
        if out_chunks:
            return outs, chunk
        if not outs:
            out = torch.zeros((0, fields.shape[0]), dtype=fields.dtype,
                              device=self.device)
        else:
            out = torch.cat(outs) if len(outs) > 1 else outs[0]
        if expand and self.recon is not None:
            out = out[self.recon.long()]
        return out[:, 0] if single else out.contiguous()

    # -- persistence ------------------------------------------------------
    def save(self, directory: PathLike, fingerprint: int | None = None,
             dense: bool = False):
        """Persist the operator in the JAX package's format: compact
        (elements, refs, found, refs_lo if set) by default, the dense
        elements.npy / coeffs.npy pair with ``dense``; ``fingerprint`` (see
        ``hashing.content_fingerprint``) goes to meta.npy so ``load`` can
        refuse a cache built from other geometry."""
        directory = str(directory)
        os.makedirs(directory, exist_ok=True)

        def save(name, t):
            np.save(os.path.join(directory, name),
                    t.detach().cpu().numpy() if torch.is_tensor(t) else t)

        save("elements.npy", self.elements)
        if self.refs is not None and self._weights is None and not dense:
            save("refs.npy", self.refs)
            save("found.npy", self.found if self.found is not None
                 else np.ones((self.n_points,), bool))
            if self.refs_lo is not None:
                save("refs_lo.npy", self.refs_lo)
        else:
            save("coeffs.npy", self.weights)
        save("meta.npy", np.array(
            [self.order, 0 if fingerprint is None else fingerprint],
            dtype=np.uint64))
        if self.recon is not None:
            save("recon.npy", self.recon)

    @classmethod
    def load(cls, directory: PathLike, fingerprint: int | None = None,
             device="cuda") -> "TransferOperator":
        """Load a saved operator (compact or dense format, auto-detected)
        onto ``device``.  With ``fingerprint``, the cache must carry the
        same value, else ValueError: callers rebuild instead of applying
        another mesh's weights."""
        directory = str(directory)

        def path(name):
            return os.path.join(directory, name)

        elements = np.load(path("elements.npy")).astype(np.int32)
        compact = os.path.exists(path("refs.npy"))
        if compact:
            refs = np.load(path("refs.npy"))
            if not np.isfinite(refs).all():
                raise ValueError(
                    f"stored refs at {directory} contain non-finite values")
            found = np.load(path("found.npy"))
            refs_lo = (np.load(path("refs_lo.npy"))
                       if os.path.exists(path("refs_lo.npy")) else None)
        else:
            weights = np.load(path("coeffs.npy"))
            if np.isnan(weights).any():
                # reference refuses NaN caches (interpolator.py:735-740)
                raise ValueError(f"stored coeffs at {directory} contain NaNs")
        stored_fp = None
        if os.path.exists(path("meta.npy")):
            meta = np.load(path("meta.npy"))
            order = int(meta[0])
            if meta.shape[0] > 1 and int(meta[1]) != 0:
                stored_fp = int(np.asarray(meta, np.uint64)[1])
        elif compact:
            raise ValueError(
                f"compact operator at {directory} lacks meta.npy (order)")
        else:
            order = int(round(weights.shape[1] ** (1 / 3))) - 1
        if fingerprint is not None and stored_fp != fingerprint:
            raise ValueError(
                f"stored operator at {directory} was built from different "
                f"geometry (fingerprint {stored_fp} != {fingerprint})")
        recon = (np.load(path("recon.npy"))
                 if os.path.exists(path("recon.npy")) else None)
        if compact:
            return cls.from_numpy(elements, refs, found, order, recon=recon,
                                  refs_lo=refs_lo, device=device)
        return cls(
            elements=torch.as_tensor(elements, device=device), order=order,
            recon=None if recon is None else torch.as_tensor(
                recon, device=device),
            _weights=torch.as_tensor(weights, device=device),
        )

    @staticmethod
    def exists(directory: PathLike) -> bool:
        d = str(directory)
        return os.path.exists(os.path.join(d, "elements.npy")) and (
            os.path.exists(os.path.join(d, "coeffs.npy"))
            or os.path.exists(os.path.join(d, "refs.npy"))
        )
