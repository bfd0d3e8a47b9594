"""Flash — the paper's compact coding strategy (§3.3), in PyTorch.

Fit: PCA-rotate and keep ``d_F`` principal dims (round-robin over ``M_F``
subspaces so each gets a share of the variance), fit a ``K = 2^{L_F}``-word
codebook per subspace, precompute the symmetric tables (SDT), and quantize
ADT/SDT entries with one shared ``(dist_min, Δ)`` (Eq. 9).

Per vector, :func:`query_ctx` builds the quantized ADT; the distance to a
neighbor is ``Σ_m ADT[m, code[m]]``, the lookup-accumulate that the
``flash_*`` kernels compute on the card.

Unlike the reference, :func:`query_ctx` and :func:`encode` take a leading
batch axis (the reference ``vmap``s them). The formulas and their op order
are the reference's; float matmuls may still sum in another order, so an ADT
level or a near-tie codeword can differ by one in rare entries (measured in
``tests/test_torch_core.py``). :func:`query_ctx` computes its float table in
float64 and rounds it to float32 once: a float32 product's rounding depends
on the kernel the library picks for its shape (on the H100 a 32-row batch
summed otherwise than the same rows in a batch of 4,000), so the card's
insert batches could quantize an entry one level off the CPU's. In float64
every device and batch size rounds to the same float32 table.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import kmeans as km
from repro_torch.core import pca as pca_mod
from repro_torch.core import quantize as qz
from repro_torch.utils import first_argmin, resolve_device

#: rows encoded per matmul block (bounds the (M, rows, K) distance block)
_ENCODE_BLOCK = 1 << 18


class FlashCoder(NamedTuple):
    """Fitted Flash coding state, all tensors on one device.

    mean:      (D,)        PCA mean.
    rot:       (D, d_pad)  truncated, subspace-permuted PCA rotation.
    codebooks: (M, K, ds)  per-subspace centroids in the PCA domain.
    sdt_q:     (M, K, K)   quantized symmetric tables (int32 levels).
    dist_min:  ()          shared table-quantization floor (Eq. 9).
    delta:     ()          shared table-quantization range (Eq. 9).
    h_bits:    ()          H — bits per quantized table entry (int32).
    """

    mean: torch.Tensor
    rot: torch.Tensor
    codebooks: torch.Tensor
    sdt_q: torch.Tensor
    dist_min: torch.Tensor
    delta: torch.Tensor
    h_bits: torch.Tensor

    @property
    def d_in(self) -> int:
        return self.rot.shape[0]

    @property
    def d_f(self) -> int:
        return self.rot.shape[1]

    @property
    def m_f(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        return self.codebooks.shape[1]

    @property
    def ds(self) -> int:
        return self.codebooks.shape[2]

    @property
    def code_bytes(self) -> float:
        """Bytes per encoded vector, 4-bit packed (M·log2 K / 8)."""
        return self.m_f * (self.k.bit_length() - 1) / 8.0

    @property
    def table_quant(self) -> qz.TableQuant:
        return qz.TableQuant(self.dist_min, self.delta, self.h_bits)


class FlashQueryCtx(NamedTuple):
    """Per-vector state, batched over a leading axis Q.

    adt_q: (Q, M, K) int32 — quantized partial distances (Eq. 9 levels).
    adt_f: (Q, M, K) f32   — unquantized partials.
    codes: (Q, M)    int32 — the vectors' own codewords.
    """

    adt_q: torch.Tensor
    adt_f: torch.Tensor
    codes: torch.Tensor


def _split_subspaces(z: torch.Tensor, m: int, ds: int) -> torch.Tensor:
    """(n, d) -> (m, n, ds), zero-padding d up to m*ds."""
    n, d = z.shape
    pad = m * ds - d
    if pad:
        z = torch.nn.functional.pad(z, (0, pad))
    return z.reshape(n, m, ds).permute(1, 0, 2)


def _partial_dists(subs: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(M, n, ds) vs (M, K, ds) -> per-subspace squared dists (M, n, K)."""
    x2 = (subs * subs).sum(-1, keepdim=True)
    c2 = (codebooks * codebooks).sum(-1)
    xc = torch.bmm(subs, codebooks.transpose(1, 2))
    return torch.clamp_min(x2 + c2[:, None, :] - 2.0 * xc, 0.0)


def fit_flash(
    sample,
    *,
    d_f: int,
    m_f: int,
    l_f: int = 4,
    h: int = 8,
    kmeans_iters: int = 25,
    max_fit_sample: int = 32768,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> FlashCoder:
    """Fit Flash on a training sample (n, D) (numpy or tensor).

    ``d_f`` principal dims kept; ``m_f`` subspaces; ``l_f`` bits per
    codeword (K = 2^l_f); ``h`` bits per quantized table entry; ``seed``
    seeds the k-means ``torch.Generator`` on ``device``.
    """
    dev = resolve_device(device)
    if isinstance(sample, torch.Tensor):
        sample_np = sample.detach().cpu().numpy()
    else:
        sample_np = np.asarray(sample)
    sample_np = sample_np.astype(np.float32, copy=False)
    n, d_in = sample_np.shape
    if d_f > d_in:
        raise ValueError(f"d_f={d_f} exceeds input dim {d_in}")
    k = 1 << l_f
    ds = -(-d_f // m_f)

    model = pca_mod.fit_pca(sample_np, max_sample=max_fit_sample)
    # Principal dims go round-robin over subspaces (subspace m gets dims
    # m, m+M, …) so no subspace dominates the shared quantization range;
    # the permutation and the zero-padding to M·ds fold into the rotation.
    d_pad = m_f * ds
    rot_np = np.zeros((d_in, d_pad), np.float32)
    rot_np[:, :d_f] = model.components[:, :d_f]
    perm = np.concatenate([np.arange(m, d_pad, m_f) for m in range(m_f)])
    rot = torch.from_numpy(np.ascontiguousarray(rot_np[:, perm])).to(dev)
    mean = torch.from_numpy(model.mean).to(dev)

    fit_rows = min(n, max_fit_sample)
    x = torch.from_numpy(sample_np[:fit_rows]).to(dev)
    z = (x - mean) @ rot
    subs = _split_subspaces(z, m_f, ds).contiguous()  # (M, n', ds)

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    codebooks, _ = km.kmeans_fit_batched(gen, subs, k=k, iters=kmeans_iters)

    diff = codebooks[:, :, None, :] - codebooks[:, None, :, :]
    sdt_f = (diff * diff).sum(-1)  # (M, K, K)

    d_sample = _partial_dists(subs, codebooks)  # (M, n', K)
    per_min = torch.minimum(d_sample.amin(dim=(1, 2)), sdt_f.amin(dim=(1, 2)))
    per_max = torch.maximum(d_sample.amax(dim=(1, 2)), sdt_f.amax(dim=(1, 2)))
    tq = qz.fit_table_quant(per_min, per_max, h=h)
    sdt_q = qz.quantize_table(tq, sdt_f)
    return FlashCoder(
        mean=mean, rot=rot, codebooks=codebooks, sdt_q=sdt_q,
        dist_min=tq.dist_min, delta=tq.delta, h_bits=tq.h,
    )


def encode(coder: FlashCoder, x: torch.Tensor) -> torch.Tensor:
    """Encode vectors (n, D) -> codewords (n, M) int32 in [0, K)."""
    out = torch.empty((x.shape[0], coder.m_f), dtype=torch.int32, device=x.device)
    for s in range(0, x.shape[0], _ENCODE_BLOCK):
        z = (x[s:s + _ENCODE_BLOCK] - coder.mean) @ coder.rot
        subs = _split_subspaces(z, coder.m_f, coder.ds).contiguous()
        out[s:s + _ENCODE_BLOCK] = km.assign_codes_batched(subs, coder.codebooks).T
    return out


def query_ctx(coder: FlashCoder, q: torch.Tensor) -> FlashQueryCtx:
    """Per-vector ADTs + own codewords for a batch q (Q, D).

    The argmin over an ADT row is the codeword (paper Remark 2).
    """
    z = (q - coder.mean).double() @ coder.rot.double()  # (Q, d_pad), float64: see the module doc
    subs = _split_subspaces(z, coder.m_f, coder.ds).contiguous()  # (M, Q, ds)
    adt_f = _partial_dists(subs, coder.codebooks.double()).permute(1, 0, 2).to(torch.float32).contiguous()
    adt_q = qz.quantize_table(coder.table_quant, adt_f)
    codes = first_argmin(adt_f, -1).to(torch.int32)
    return FlashQueryCtx(adt_q=adt_q, adt_f=adt_f, codes=codes)


def adc_lookup(adt: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADT scan Σ_m adt[q, m, codes[q, …, m]] for adt (Q, M, K), codes
    (Q, …, M) -> (Q, …) in adt's dtype."""
    q, m, _ = adt.shape
    flat = codes.reshape(q, -1, m).long()
    qi = torch.arange(q, device=adt.device)[:, None, None]
    mi = torch.arange(m, device=adt.device)[None, None, :]
    s = adt[qi, mi, flat].sum(-1).to(adt.dtype)
    return s.reshape(codes.shape[:-1])


def sdc_lookup(coder: FlashCoder, codes_a: torch.Tensor, codes_b: torch.Tensor) -> torch.Tensor:
    """Symmetric distance Σ_m sdt_q[m, a_m, b_m] for broadcastable
    (…, M) codes -> (…,) int32, on the ADT's quantization scale."""
    out = None
    for m in range(coder.m_f):
        v = coder.sdt_q[m][codes_a[..., m].long(), codes_b[..., m].long()]
        out = v if out is None else out + v
    return out


def sdc_matrix(coder: FlashCoder, codes: torch.Tensor) -> torch.Tensor:
    """All-pairs SDT sums of each row's codes: (B, C, M) -> (B, C, C) f32,
    ``[b, i, j] = sdc_lookup(codes[b, i], codes[b, j])``.

    Written as a one-hot product: row i's per-subspace SDT rows (B, C, M·K)
    times the one-hot of the codes (B, M·K, C). Every operand is an integer
    level below 2^H and every sum is below 2^24, so float32 gives the exact
    integer sums in any summation order (and so would TF32 for H ≤ 11).
    """
    b, c, m = codes.shape
    k = coder.k
    cl = codes.long()
    sdt = coder.sdt_q.to(torch.float32)
    rows = sdt[torch.arange(m, device=codes.device), cl]  # (B, C, M, K)
    onehot = torch.zeros((b, c, m, k), dtype=torch.float32, device=codes.device)
    onehot.scatter_(3, cl[..., None], 1.0)
    return torch.bmm(rows.reshape(b, c, m * k), onehot.reshape(b, c, m * k).transpose(1, 2))


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Pack codewords (…, M) in [0, 16) into (…, ⌈M/2⌉) uint8 (odd M is
    zero-padded in the last high nibble)."""
    if codes.shape[-1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    return qz.pack4(codes)


def unpack_codes(packed: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes`: (…, ⌈m/2⌉) uint8 -> (…, m) int32."""
    return qz.unpack4(packed)[..., :m]


def decode_codes(coder: FlashCoder, codes: torch.Tensor) -> torch.Tensor:
    """Codewords (…, M) -> their centroids lifted back to the original
    space (…, D): the concatenated subspace centroids, cut to d_f, rotated
    back and shifted by the mean."""
    m_idx = torch.arange(coder.m_f, device=codes.device)
    gathered = coder.codebooks[m_idx, codes.long()]  # (…, M, ds)
    z_hat = gathered.reshape(*gathered.shape[:-2], -1)[..., : coder.d_f]
    return z_hat @ coder.rot.T + coder.mean


def reconstruct(coder: FlashCoder, x: torch.Tensor) -> torch.Tensor:
    """decode(encode(x)) in the original space: the "derived vector" of
    §3.1 in Theorem 1's error term E_u = u − reconstruct(u)."""
    return decode_codes(coder, encode(coder, x))


def estimate_distance(coder: FlashCoder, q_sum: torch.Tensor) -> torch.Tensor:
    """Map an ADC level sum back to an approximate squared distance
    (diagnostics and rerank thresholds; comparisons never need it)."""
    levels = qz._levels(coder.table_quant)
    return q_sum.to(torch.float32) / levels * coder.delta + float(coder.m_f) * coder.dist_min


def to_neighbor_blocks(codes: torch.Tensor, b: int) -> torch.Tensor:
    """One vertex's neighbor codewords (R, M) -> (R // b, M, b): within a
    block of ``b`` neighbors the codes are grouped by subspace, so one
    contiguous load fetches one subspace's b codes (Figure 5). R must be a
    multiple of b (pad with code 0 / id −1 upstream)."""
    r, m = codes.shape
    if r % b:
        raise ValueError(f"R={r} not a multiple of block size b={b}")
    return codes.reshape(r // b, b, m).permute(0, 2, 1)


def from_neighbor_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_neighbor_blocks`: (nb, M, b) -> (nb·b, M)."""
    nb, m, b = blocks.shape
    return blocks.permute(0, 2, 1).reshape(nb * b, m)
