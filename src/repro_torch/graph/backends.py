"""Distance backends of the port: Flash and its blocked-mirror layout.

The build and the search only ever compare distances, through this
protocol (every query-side argument is batched over a leading axis Q):

    prepare_query(q (Q, D))            -> qctx     per-vector state
    query_dists(qctx, ids (Q, …))      -> (Q, …)   f32, query -> stored ids
    pair_dists(ids_a, ids_b)           -> f32      stored id <-> stored id
    pair_matrix(ids (B, C))            -> (B, C, C) all-pairs pair_dists
    round_dists(qctxs, ids (B, C))     -> (B, C)   one bulk round's block
                                                   (kernel ``flash_round``)
    supports_expand(r) / fused_beam(qctx, adjacency, beam (Q, ef) …)
                                       -> the whole base-layer beam loop
                                          in one launch (kernel ``flash_beam``)
    neighbor_dists_batch(qctx, nodes, ids (Q, W, R)) -> (Q, W, R): the
                                          unfused step (``flash_scan_blocked``)
    with_updated_edges(ids, nbr_ids)   -> backend  mirror commit hook
    extend(new (m, D))                 -> backend  grown by m vectors under
                                          the frozen coder (``AnnIndex.add``)
    state_dict() / from_state(state)   the reference's dotted keys and dtypes

Distances are int32 ADT/SDT level sums cast to float32, so every
comparison is exact and equal to the reference's. The blocked mirror is
updated in place by ``with_updated_edges`` (it is n·R·⌈M/2⌉ bytes and is
rewritten row by row all through a build); ``clone`` gives a build its own
copy first.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import flash as fl
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device

#: rows of the blocked mirror refreshed per block in ``with_updated_edges``
_MIRROR_BLOCK = 1 << 18

_NOT_PORTED = (
    "backend kind {kind!r} is not ported yet: the fp32/pq/sq/pca backends are "
    "ROADMAP queue 1, item 5d"
)


def _to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _grow_raw(raw, new):
    """extend() helper: grow the optional retained-raw table in lockstep."""
    return None if raw is None else torch.cat([raw, new])


class FlashBackend:
    """HNSW-Flash: quantized ADT (acquisition) + shared quantized SDT
    (selection), one (dist_min, Δ, H) quantizer for both (§3.3.3)."""

    _fields = ("coder", "codes", "raw")

    def __init__(self, coder: fl.FlashCoder, codes: torch.Tensor, raw=None):
        self.coder = coder
        self.codes = codes  # (n, M) int32 in [0, K)
        self.raw = raw  # optional (n, D) raw table (keep_raw=True)

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def has_raw(self) -> bool:
        return self.raw is not None

    def clone(self) -> "FlashBackend":
        """A backend a build may update in place (nothing mutable here)."""
        return self

    # ---- distances ------------------------------------------------------

    def prepare_query(self, q: torch.Tensor) -> fl.FlashQueryCtx:
        return fl.query_ctx(self.coder, q)

    def query_dists(self, qctx: fl.FlashQueryCtx, ids: torch.Tensor) -> torch.Tensor:
        return fl.adc_lookup(qctx.adt_q, self.codes[ids.long()]).to(torch.float32)

    def pair_dists(self, ids_a: torch.Tensor, ids_b: torch.Tensor) -> torch.Tensor:
        return fl.sdc_lookup(
            self.coder, self.codes[ids_a.long()], self.codes[ids_b.long()]
        ).to(torch.float32)

    def pair_matrix(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, C) ids -> (B, C, C) f32, ``pair_dists(ids[:, :, None],
        ids[:, None, :])`` as one batched one-hot product."""
        return fl.sdc_matrix(self.coder, self.codes[ids.long()])

    def round_dists(self, qctxs: fl.FlashQueryCtx, ids: torch.Tensor) -> torch.Tensor:
        """One bulk round's block: the candidates' code rows against each
        row's own ADT, one ``flash_round`` launch. Integer tables, so equal
        to ``query_dists`` row by row."""
        return ops.flash_round(self.codes[ids.long()], qctxs.adt_q).to(torch.float32)

    def supports_expand(self, r: int) -> bool:  # noqa: ARG002
        return False

    def neighbor_dists_batch(self, qctx, nodes, ids):  # noqa: ARG002
        return self.query_dists(qctx, ids)

    def fused_beam(self, qctx, adjacency, beam_d, beam_ids, beam_exp, entry_ids, *, width, max_iters):
        raise NotImplementedError(
            f"{type(self).__name__} has no fused beam path"
        )

    def with_updated_edges(self, ids, nbr_ids):  # noqa: ARG002
        return self

    def extend(self, new_vectors: torch.Tensor) -> "FlashBackend":
        """A new backend with codes for ``new_vectors`` (m, D) appended,
        encoded under the frozen coder."""
        new = new_vectors.to(device=self.device, dtype=torch.float32)
        return FlashBackend(
            self.coder, torch.cat([self.codes, fl.encode(self.coder, new)]),
            _grow_raw(self.raw, new),
        )

    def raw_dists(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        if self.raw is None:
            raise ValueError(
                f"{type(self).__name__} retains no raw vectors; build with "
                "keep_raw=True or rerank through graph.rerank.RawVectors"
            )
        d = self.raw[ids.long()] - q[:, None, :]
        return (d * d).sum(-1)

    # ---- state ----------------------------------------------------------

    def state_dict(self) -> dict:
        """Flat ``{dotted_key: np.ndarray}`` with the reference's keys and
        dtypes (``coder.mean`` … ``coder.h_bits``, ``codes``, …)."""
        out = {}
        for name in self._fields:
            val = getattr(self, name)
            if val is None:
                continue
            if name == "coder":
                for f in fl.FlashCoder._fields:
                    out[f"coder.{f}"] = _to_np(getattr(val, f))
            else:
                out[name] = _to_np(val)
        return out

    @classmethod
    def _coder_from_state(cls, state, dev) -> fl.FlashCoder:
        vals = []
        for f in fl.FlashCoder._fields:
            key = f"coder.{f}"
            if key not in state:
                raise KeyError(f"backend state missing array {key!r}")
            vals.append(torch.as_tensor(np.array(state[key])).to(dev))
        return fl.FlashCoder(*vals)

    @classmethod
    def from_state(cls, state, *, device: str | torch.device = "cuda") -> "FlashBackend":
        dev = resolve_device(device)
        raw = state.get("raw")
        return cls(
            cls._coder_from_state(state, dev),
            torch.as_tensor(np.array(state["codes"])).to(dev),
            None if raw is None else torch.as_tensor(np.array(raw)).to(dev),
        )


class FlashBlockedBackend(FlashBackend):
    """Flash + the access-aware neighbor mirror of §3.3.4, 4-bit packed.

    ``nbr_codes`` keeps each vertex's neighbors' codewords next to the
    vertex — (n, R, ⌈M/2⌉) uint8, two codewords per byte, for K ≤ 16
    coders; (n, R, M) int32 for K > 16 — so a beam step reads one
    contiguous row per expanded vertex. It owns the fused base-layer beam
    (kernel ``flash_beam``, whose every step is ``flash_expand``'s) and the
    unfused step ``neighbor_dists_batch`` (kernel ``flash_scan_blocked``);
    the two are bit-equal.
    """

    _fields = ("coder", "codes", "nbr_codes", "raw")

    def __init__(self, coder, codes, nbr_codes, raw=None):
        super().__init__(coder, codes, raw)
        self.nbr_codes = nbr_codes  # code 0 where the neighbor id is -1

    @property
    def mirror_packed(self) -> bool:
        return self.nbr_codes.dtype == torch.uint8

    def clone(self) -> "FlashBlockedBackend":
        """A copy whose mirror a build may update in place (the coder,
        codes and raw table are shared: nothing writes them)."""
        return FlashBlockedBackend(self.coder, self.codes, self.nbr_codes.clone(), self.raw)

    def _mirror_rows_unpacked(self, nodes: torch.Tensor) -> torch.Tensor:
        rows = self.nbr_codes[nodes.clamp_min(0).long()]
        if self.mirror_packed:
            return fl.unpack_codes(rows, self.coder.m_f)
        return rows

    def supports_expand(self, r: int) -> bool:
        """The fused path serves exactly the mirror's layer width (the
        base layer, where almost all acquisition traffic happens)."""
        return r == self.nbr_codes.shape[1]

    def fused_beam(self, qctx, adjacency, beam_d, beam_ids, beam_exp, entry_ids, *, width, max_iters):
        """The base-layer beam loop of Q queries from their sorted initial
        beam (Q, ef): one ``flash_beam`` launch (its plain version on the
        CPU) -> (beam_d, beam_ids, n_dists, n_hops) of the loop."""
        return ops.flash_beam(
            qctx.adt_q, adjacency, self.nbr_codes, beam_d, beam_ids, beam_exp, entry_ids,
            width=width, max_iters=max_iters,
        )

    def neighbor_dists_batch(self, qctx, nodes, ids):
        """Unfused beam step: the W expanded vertices' mirror rows scored
        by the blocked kernel; other widths take the gather path."""
        if ids.shape[-1] != self.nbr_codes.shape[1]:
            return self.query_dists(qctx, ids)
        rows = self._mirror_rows_unpacked(nodes).contiguous()  # (Q, W, R, M)
        return ops.flash_scan_batch(rows, qctx.adt_q).to(torch.float32)

    def _pack_rows(self, rows: torch.Tensor) -> torch.Tensor:
        return fl.pack_codes(rows) if self.mirror_packed else rows

    def with_updated_edges(self, ids, nbr_ids):
        """Rewrite the mirror rows of vertices ``ids`` (…,) from their new
        lists ``nbr_ids`` (…, R), in place; out-of-range ids are dropped.
        Lists of another width (upper layers) leave the mirror alone."""
        if nbr_ids.shape[-1] != self.nbr_codes.shape[1]:
            return self
        ids = ids.reshape(-1).long()
        nbr_ids = nbr_ids.reshape(-1, nbr_ids.shape[-1])
        keep = (ids >= 0) & (ids < self.n)
        if not bool(keep.all()):
            ids, nbr_ids = ids[keep], nbr_ids[keep]
        for s in range(0, ids.shape[0], _MIRROR_BLOCK):
            nb = nbr_ids[s:s + _MIRROR_BLOCK].long()
            rows = torch.where(
                (nb >= 0)[..., None], self.codes[nb.clamp_min(0)], 0
            )
            self.nbr_codes[ids[s:s + _MIRROR_BLOCK]] = self._pack_rows(rows)
        return self

    def extend(self, new_vectors: torch.Tensor) -> "FlashBlockedBackend":
        """Append codes for the new vectors plus all-empty mirror rows; the
        rows fill in as the growing build commits edges through
        ``with_updated_edges``."""
        new = new_vectors.to(device=self.device, dtype=torch.float32)
        mirror_new = torch.zeros(
            (new.shape[0],) + tuple(self.nbr_codes.shape[1:]),
            dtype=self.nbr_codes.dtype, device=self.device,
        )
        return FlashBlockedBackend(
            self.coder, torch.cat([self.codes, fl.encode(self.coder, new)]),
            torch.cat([self.nbr_codes, mirror_new]), _grow_raw(self.raw, new),
        )

    @classmethod
    def from_state(cls, state, *, device: str | torch.device = "cuda") -> "FlashBlockedBackend":
        """Rebuild from ``state_dict`` output; an unpacked int32 mirror of a
        K ≤ 16 coder is packed (pack∘unpack is the identity on codes < 16)."""
        dev = resolve_device(device)
        raw = state.get("raw")
        coder = cls._coder_from_state(state, dev)
        nbr = torch.as_tensor(np.array(state["nbr_codes"])).to(dev)
        if nbr.dtype != torch.uint8 and coder.k <= 16:
            nbr = fl.pack_codes(nbr)
        return cls(
            coder,
            torch.as_tensor(np.array(state["codes"])).to(dev),
            nbr,
            None if raw is None else torch.as_tensor(np.array(raw)).to(dev),
        )


#: backend kinds of the reference, in paper order
KINDS = ("fp32", "pq", "sq", "pca", "flash", "flash_blocked")

#: backend classes by class name (what a snapshot's meta records)
CLASSES: dict[str, type] = {c.__name__: c for c in (FlashBackend, FlashBlockedBackend)}


def make_backend(
    kind: str,
    data,
    *,
    seed: int = 0,
    r_for_blocked: int | None = None,
    keep_raw: bool = False,
    device: str | torch.device = "cuda",
    **coder_kwargs,
):
    """Fit a coder on ``data`` and wrap it with its backend, on ``device``.

    kind ∈ {"flash", "flash_blocked"}; the others raise and name their
    ROADMAP item. ``coder_kwargs`` go to :func:`core.flash.fit_flash`;
    ``seed`` seeds its k-means generator.
    """
    dev = resolve_device(device)
    if kind not in KINDS:
        raise ValueError(f"unknown backend kind {kind!r}; valid kinds: {', '.join(KINDS)}")
    if kind not in ("flash", "flash_blocked"):
        raise NotImplementedError(_NOT_PORTED.format(kind=kind))
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.array(data, np.float32))
    data = data.to(device=dev, dtype=torch.float32)
    raw = data if keep_raw else None
    coder = fl.fit_flash(data, seed=seed, device=dev, **coder_kwargs)
    codes = fl.encode(coder, data)
    if kind == "flash":
        return FlashBackend(coder, codes, raw)
    if r_for_blocked is None:
        raise ValueError("flash_blocked needs r_for_blocked (max neighbors)")
    if coder.k <= 16:
        nbr = torch.zeros((data.shape[0], r_for_blocked, (coder.m_f + 1) // 2), dtype=torch.uint8, device=dev)
    else:
        nbr = torch.zeros((data.shape[0], r_for_blocked, coder.m_f), dtype=torch.int32, device=dev)
    return FlashBlockedBackend(coder, codes, nbr, raw)
