"""Distance backends of the port: the paper's five methods and the Flash
blocked-mirror layout (reference: repro.graph.backends).

    fp32           unmodified HNSW: full-precision L2
    pq             HNSW-PQ  (§3.2.1): float ADC tables, SDC tables
    sq             HNSW-SQ  (§3.2.2): quantized-domain scaled L2
    pca            HNSW-PCA (§3.2.3): L2 on the first d_PCA principal dims
    flash          HNSW-Flash (§3.3): quantized ADT + quantized SDT
    flash_blocked  Flash + the access-aware neighbor mirror (§3.3.4)

The build and the search only ever compare distances, through this
protocol (every query-side argument is batched over a leading axis Q):

    prepare_query(q (Q, D))            -> qctx     per-vector state: a
                                          FlashQueryCtx, the (Q, M, K) PQ
                                          tables, or (Q, ·) codes / vectors
    ctx_rows(qctx, sel)                -> the contexts of rows ``sel``
    query_dists(qctx, ids (Q, …))      -> (Q, …)   f32, query -> stored ids
    pair_dists(ids_a, ids_b)           -> f32      stored id <-> stored id
    pair_matrix(ids (B, C))            -> (B, C, C) all-pairs pair_dists
    pair_matrix_bytes(c)               -> bytes pair_matrix holds per row
                                          of a (C, C) block (sizes the
                                          selection's blocks)
    round_dists(qctxs, ids (B, C))     -> (B, C)   one bulk round's block
                                          (Flash: kernel ``flash_round``)
    supports_expand(r) / fused_beam(qctx, adjacency, beam (Q, ef) …)
                                       -> the whole base-layer beam loop in
                                          one launch (``flash_blocked``
                                          only: kernel ``flash_beam``)
    neighbor_dists_batch(qctx, nodes, ids (Q, W, R)) -> (Q, W, R): the
                                          unfused step (``flash_blocked``:
                                          kernel ``flash_scan_blocked``)
    with_updated_edges(ids, nbr_ids)   -> backend  mirror commit hook
    extend(new (m, D))                 -> backend  grown by m vectors under
                                          the frozen coder (``AnnIndex.add``)
    raw_dists(q, ids) / recon_vectors(ids)  the exact and the
                                          reconstruct rerank sources
    state_dict() / from_state(state)   the reference's dotted keys and dtypes

Flash distances are int32 ADT/SDT level sums cast to float32, so every
comparison is exact and equal to the reference's. The baselines compute
their distances in plain PyTorch, as the reference computes them in plain
``jnp`` outside its kernels, in the reference's difference-then-square
form. XLA fuses those gathers into reductions and torch materialises them,
so every baseline gather is cut into pieces of at most ``_GATHER_BYTES``
(rows are independent: the pieces do not change any value). The blocked
mirror is updated in place by ``with_updated_edges`` (it is n·R·⌈M/2⌉
bytes and is rewritten row by row all through a build); ``clone`` gives a
build its own copy first.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from repro_torch.core import baselines as bl
from repro_torch.core import flash as fl
from repro_torch.core import quantize as qz
from repro_torch.kernels import ops
from repro_torch.utils import resolve_device

#: rows of the blocked mirror refreshed per block in ``with_updated_edges``
_MIRROR_BLOCK = 1 << 18

#: bytes one gathered operand of a baseline distance may take at once
_GATHER_BYTES = 1 << 28


def _to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _grow_raw(raw, new):
    """extend() helper: grow the optional retained-raw table in lockstep."""
    return None if raw is None else torch.cat([raw, new])


def _l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return (d * d).sum(-1)


def ctx_rows(qctx, sel):
    """The query contexts of rows ``sel`` (a slice or an index tensor): a
    tensor context is indexed, a NamedTuple one field by field."""
    if isinstance(qctx, torch.Tensor):
        return qctx[sel]
    return type(qctx)(*(t[sel] for t in qctx))


def _per_query(fn, qctx, ids: torch.Tensor, width: int) -> torch.Tensor:
    """``fn(qctx, ids)`` over blocks of queries, each gathering at most
    ``_GATHER_BYTES`` of ``width`` float32 values per id."""
    q = ids.shape[0]
    per = max(1, ids[0].numel()) if q else 1
    step = max(1, _GATHER_BYTES // (4 * width * per))
    if q <= step:
        return fn(qctx, ids)
    return torch.cat([fn(ctx_rows(qctx, slice(s, s + step)), ids[s:s + step]) for s in range(0, q, step)])


def _pairwise(fn, ids_a: torch.Tensor, ids_b: torch.Tensor, width: int) -> torch.Tensor:
    """``fn(a, b)`` of broadcastable id tensors, element-wise, in flat
    blocks that gather at most ``_GATHER_BYTES`` of ``width`` floats."""
    a, b = torch.broadcast_tensors(ids_a, ids_b)
    shape = a.shape
    e = a.numel()
    step = max(1, _GATHER_BYTES // (4 * width))
    if e <= step:
        return fn(a, b)
    a, b = a.reshape(-1), b.reshape(-1)
    out = torch.empty(e, dtype=torch.float32, device=a.device)
    for s in range(0, e, step):
        out[s:s + step] = fn(a[s:s + step], b[s:s + step])
    return out.reshape(shape)


def _bcast(qctx: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(Q, D) per-query rows shaped to broadcast against (Q, …, D) gathers."""
    return qctx.reshape(qctx.shape[0], *([1] * (ids.dim() - 1)), qctx.shape[-1])


def _flatten_state(prefix: str, val, out: dict) -> None:
    """A backend field as dotted-key numpy arrays: NamedTuple coders (nested
    ones too, e.g. ``SQCoder.params``) by field name, tensors as leaves."""
    if isinstance(val, tuple) and hasattr(val, "_fields"):
        for f in val._fields:
            _flatten_state(f"{prefix}.{f}", getattr(val, f), out)
    else:
        out[prefix] = _to_np(val)


def _unflatten_state(prefix: str, state, nt_cls, dev: torch.device):
    """Inverse of :func:`_flatten_state`; ``nt_cls`` is the NamedTuple class
    to rebuild (None for a tensor leaf). Nested NamedTuple fields are found
    through the class's resolved type hints."""
    if nt_cls is None:
        if prefix not in state:
            raise KeyError(f"backend state missing array {prefix!r}")
        return torch.as_tensor(np.array(state[prefix])).to(dev)
    hints = typing.get_type_hints(nt_cls)
    vals = []
    for f in nt_cls._fields:
        hint = hints.get(f)
        sub = hint if isinstance(hint, type) and hasattr(hint, "_fields") else None
        vals.append(_unflatten_state(f"{prefix}.{f}", state, sub, dev))
    return nt_cls(*vals)


class _Base:
    """What every backend shares: identity, the state hooks and the
    defaults of the protocol (no fused path, no mirror, nothing mutable)."""

    #: constructor fields in order; ``_coder_fields`` names the NamedTuple
    #: ones, ``_optional_fields`` those that may be None (absent from the
    #: state: the ``raw`` table of a build without ``keep_raw``)
    _fields: tuple = ()
    _coder_fields: dict = {}
    _optional_fields: tuple = ("raw",)
    #: the field whose first axis is the vertex count
    _table = "codes"

    @property
    def n(self) -> int:
        return getattr(self, self._table).shape[0]

    @property
    def device(self) -> torch.device:
        return getattr(self, self._table).device

    @property
    def has_raw(self) -> bool:
        """Whether the backend retains raw vectors for exact rerank."""
        return getattr(self, "raw", None) is not None

    def clone(self):
        """A backend a build may update in place (nothing mutable here)."""
        return self

    def pair_matrix(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, C) ids -> (B, C, C) f32, ``pair_dists(ids[:, :, None],
        ids[:, None, :])``."""
        return self.pair_dists(ids[:, :, None], ids[:, None, :])

    def pair_matrix_bytes(self, c: int) -> int:
        """Bytes :meth:`pair_matrix` holds per row of a (C, C) block: the
        result (its gathers are cut into ``_GATHER_BYTES`` pieces)."""
        return 4 * c * c

    def round_dists(self, qctxs, ids: torch.Tensor) -> torch.Tensor:
        """One bulk round's block: each row's candidates against its own
        context, ``query_dists`` row by row (batched already)."""
        return self.query_dists(qctxs, ids)

    def supports_expand(self, r: int) -> bool:  # noqa: ARG002
        return False

    def neighbor_dists_batch(self, qctx, nodes, ids):  # noqa: ARG002
        return self.query_dists(qctx, ids)

    def fused_beam(self, qctx, adjacency, beam_d, beam_ids, beam_exp, entry_ids, *, width, max_iters):
        raise NotImplementedError(f"{type(self).__name__} has no fused beam path")

    def with_updated_edges(self, ids, nbr_ids):  # noqa: ARG002
        return self

    def raw_dists(self, q: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Exact squared L2 from raw queries (Q, D) to stored ids (Q, C),
        from the retained raw table (``keep_raw=True``)."""
        if self.raw is None:
            raise ValueError(
                f"{type(self).__name__} retains no raw vectors; build with "
                "keep_raw=True or rerank through graph.rerank.RawVectors"
            )
        raw = self.raw
        return _per_query(lambda qq, ii: _l2(raw[ii.long()], _bcast(qq, ii)), q, ids, raw.shape[1])

    # ---- state ----------------------------------------------------------

    def state_dict(self) -> dict:
        """Flat ``{dotted_key: np.ndarray}`` with the reference's keys and
        dtypes (``coder.mean`` …, ``codes``, ``raw`` when retained)."""
        out: dict = {}
        for name in self._fields:
            val = getattr(self, name)
            if val is None and name in self._optional_fields:
                continue
            _flatten_state(name, val, out)
        return out

    @classmethod
    def from_state(cls, state, *, device: str | torch.device = "cuda"):
        """Rebuild from ``state_dict`` output (either package's) on
        ``device``; an absent optional field restores as None."""
        dev = resolve_device(device)
        vals = []
        for name in cls._fields:
            present = name in state or any(k.startswith(name + ".") for k in state)
            if not present and name in cls._optional_fields:
                vals.append(None)
                continue
            vals.append(_unflatten_state(name, state, cls._coder_fields.get(name), dev))
        return cls(*vals)


class FP32Backend(_Base):
    """Unmodified HNSW: exact squared L2 on the raw vectors."""

    _fields = ("vectors",)
    _optional_fields = ()
    _table = "vectors"

    def __init__(self, vectors: torch.Tensor):
        self.vectors = vectors  # (n, D) float32

    @property
    def has_raw(self) -> bool:
        return True  # the stored vectors are raw

    def prepare_query(self, q: torch.Tensor) -> torch.Tensor:
        return q

    def query_dists(self, qctx, ids):
        v = self.vectors
        return _per_query(lambda qq, ii: _l2(v[ii.long()], _bcast(qq, ii)), qctx, ids, v.shape[1])

    def pair_dists(self, ids_a, ids_b):
        v = self.vectors
        return _pairwise(lambda a, b: _l2(v[a.long()], v[b.long()]), ids_a, ids_b, v.shape[1])

    def raw_dists(self, q, ids):
        return self.query_dists(q, ids)

    def recon_vectors(self, ids):
        return self.vectors[ids.long()]  # lossless

    def extend(self, new_vectors):
        new = new_vectors.to(device=self.device, dtype=torch.float32)
        return FP32Backend(torch.cat([self.vectors, new]))


class PCABackend(_Base):
    """HNSW-PCA: exact L2 on the first d_PCA principal components."""

    _fields = ("coder", "z", "raw")
    _coder_fields = {"coder": bl.PCACoder}
    _table = "z"

    def __init__(self, coder: bl.PCACoder, z: torch.Tensor, raw=None):
        self.coder = coder
        self.z = z  # (n, d) projected database
        self.raw = raw

    def prepare_query(self, q):
        return bl.pca_encode(self.coder, q)

    def query_dists(self, qctx, ids):
        z = self.z
        return _per_query(lambda qq, ii: _l2(z[ii.long()], _bcast(qq, ii)), qctx, ids, z.shape[1])

    def pair_dists(self, ids_a, ids_b):
        z = self.z
        return _pairwise(lambda a, b: _l2(z[a.long()], z[b.long()]), ids_a, ids_b, z.shape[1])

    def recon_vectors(self, ids):
        return self.z[ids.long()] @ self.coder.rot.T + self.coder.mean

    def extend(self, new_vectors):
        new = new_vectors.to(device=self.device, dtype=torch.float32)
        return PCABackend(
            self.coder, torch.cat([self.z, bl.pca_encode(self.coder, new)]), _grow_raw(self.raw, new)
        )


class SQBackend(_Base):
    """HNSW-SQ: quantized-domain scaled L2, no decode of either operand."""

    _fields = ("coder", "codes", "raw")
    _coder_fields = {"coder": bl.SQCoder}

    def __init__(self, coder: bl.SQCoder, codes: torch.Tensor, raw=None):
        self.coder = coder
        self.codes = codes  # (n, D) int32 levels
        self.raw = raw

    def prepare_query(self, q):
        return bl.sq_encode(self.coder, q)

    def query_dists(self, qctx, ids):
        c, coder = self.codes, self.coder
        return _per_query(lambda qq, ii: bl.sq_dist(coder, _bcast(qq, ii), c[ii.long()]),
                          qctx, ids, c.shape[1])

    def pair_dists(self, ids_a, ids_b):
        c, coder = self.codes, self.coder
        return _pairwise(lambda a, b: bl.sq_dist(coder, c[a.long()], c[b.long()]), ids_a, ids_b, c.shape[1])

    def recon_vectors(self, ids):
        return qz.sq_decode(self.coder.params, self.codes[ids.long()])

    def extend(self, new_vectors):
        new = new_vectors.to(device=self.device, dtype=torch.float32)
        return SQBackend(
            self.coder, torch.cat([self.codes, bl.sq_encode(self.coder, new)]), _grow_raw(self.raw, new)
        )


class PQBackend(_Base):
    """HNSW-PQ: a float ADC table per query (acquisition), the SDC
    centroid tables (selection)."""

    _fields = ("coder", "codes", "raw")
    _coder_fields = {"coder": bl.PQCoder}

    def __init__(self, coder: bl.PQCoder, codes: torch.Tensor, raw=None):
        self.coder = coder
        self.codes = codes  # (n, M) int32
        self.raw = raw

    def prepare_query(self, q):
        return bl.pq_adc_table(self.coder, q)  # (Q, M, K) f32

    def query_dists(self, qctx, ids):
        c = self.codes
        return _per_query(lambda qq, ii: fl.adc_lookup(qq, c[ii.long()]), qctx, ids, c.shape[1])

    def pair_dists(self, ids_a, ids_b):
        c, coder = self.codes, self.coder
        return _pairwise(lambda a, b: bl.pq_sdc_lookup(coder, c[a.long()], c[b.long()]),
                         ids_a, ids_b, c.shape[1])

    def recon_vectors(self, ids):
        return bl.pq_decode(self.coder, self.codes[ids.long()])  # padded: callers cut to D

    def extend(self, new_vectors):
        new = new_vectors.to(device=self.device, dtype=torch.float32)
        return PQBackend(
            self.coder, torch.cat([self.codes, bl.pq_encode(self.coder, new)]), _grow_raw(self.raw, new)
        )


class FlashBackend(_Base):
    """HNSW-Flash: quantized ADT (acquisition) + shared quantized SDT
    (selection), one (dist_min, Δ, H) quantizer for both (§3.3.3)."""

    _fields = ("coder", "codes", "raw")
    _coder_fields = {"coder": fl.FlashCoder}

    def __init__(self, coder: fl.FlashCoder, codes: torch.Tensor, raw=None):
        self.coder = coder
        self.codes = codes  # (n, M) int32 in [0, K)
        self.raw = raw  # optional (n, D) raw table (keep_raw=True)

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

    def pair_matrix_bytes(self, c: int) -> int:
        """The product's result and its two (C, M·K) float operands per row."""
        return 4 * c * (c + 2 * self.coder.m_f * self.coder.k)

    def round_dists(self, qctxs: fl.FlashQueryCtx, ids: torch.Tensor) -> torch.Tensor:
        """One bulk round's block: the candidates' code rows against each
        row's own ADT, one ``flash_round`` launch. Integer tables, so equal
        to ``query_dists`` row by row."""
        return ops.flash_round(self.codes[ids.long()], qctxs.adt_q).to(torch.float32)

    def recon_vectors(self, ids: torch.Tensor) -> torch.Tensor:
        return fl.decode_codes(self.coder, self.codes[ids.long()])

    def extend(self, new_vectors: torch.Tensor) -> "FlashBackend":
        """A new backend with codes for ``new_vectors`` (m, D) appended,
        encoded under the frozen coder."""
        new = new_vectors.to(device=self.device, dtype=torch.float32)
        return FlashBackend(
            self.coder, torch.cat([self.codes, fl.encode(self.coder, new)]),
            _grow_raw(self.raw, new),
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
        be = super().from_state(state, device=device)
        if not be.mirror_packed and be.coder.k <= 16:
            be.nbr_codes = fl.pack_codes(be.nbr_codes)
        return be


#: backend kinds of the reference, in paper order
KINDS = ("fp32", "pq", "sq", "pca", "flash", "flash_blocked")

#: backend classes by class name (what a snapshot's meta records)
CLASSES: dict[str, type] = {
    c.__name__: c
    for c in (FP32Backend, PCABackend, SQBackend, PQBackend, FlashBackend, FlashBlockedBackend)
}


def kinds() -> tuple[str, ...]:
    """The backend kinds :func:`make_backend` accepts."""
    return KINDS


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

    kind ∈ :data:`KINDS`. ``coder_kwargs`` go to the fitter (``d_f``/``m_f``
    for flash, ``m``/``l_pq`` for pq, ``bits`` for sq, ``d``/``alpha`` for
    pca); fp32 stores the raw vectors and takes none. ``seed`` seeds the
    k-means generator of pq and flash. ``keep_raw=True`` also keeps
    ``data`` on the backend for exact rerank (fp32 is its own raw table).
    """
    dev = resolve_device(device)
    if kind not in KINDS:
        raise ValueError(f"unknown backend kind {kind!r}; valid kinds: {', '.join(KINDS)}")
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.array(data, np.float32))
    data = data.to(device=dev, dtype=torch.float32)
    raw = data if keep_raw else None
    if kind == "fp32":
        if coder_kwargs:
            raise ValueError(
                "fp32 stores raw vectors and takes no coder options; got "
                f"{sorted(coder_kwargs)} (did you mean another kind of {', '.join(KINDS)}?)"
            )
        return FP32Backend(data)
    if kind == "pca":
        coder = bl.fit_pca_coder(data, device=dev, **coder_kwargs)
        return PCABackend(coder, bl.pca_encode(coder, data), raw)
    if kind == "sq":
        coder = bl.fit_sq(data, device=dev, **coder_kwargs)
        return SQBackend(coder, bl.sq_encode(coder, data), raw)
    if kind == "pq":
        coder = bl.fit_pq(data, seed=seed, device=dev, **coder_kwargs)
        return PQBackend(coder, bl.pq_encode(coder, data), raw)
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
