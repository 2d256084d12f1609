"""IVF (inverted-file) coarse partitioning composed with ICQ (twin of
``repro.index.ivf``): the paper's path to sub-linear query cost.

A coarse k-means splits the database into ``n_lists`` cells; a query
visits only its ``n_probe`` nearest cells and runs the ICQ two-step
search over those candidates:

  1. ``coarse_probe``: one (nq, n_lists) distance matmul and the
     two-key top-k -> probes (nq, n_probe);
  2. ``gather_candidates``: the probed rows of the padded lists and of
     the in-list codes slab -> candidate ids (nq, nc) (-1 pad) and
     codes (nq, nc, Kc) in their stored dtype;
  3. the slab stages: ``CrudeStage.slab`` -> threshold bootstrap from
     the crude top-k -> ``RefineStage.slab``, through the CUDA slab
     kernels on the card and their plain versions on the CPU (the
     reference's fused-kernel composition).

Average Ops generalizes to
``coarse * K / 2 + probed_frac * (|K_fast| + pass_rate * (K - |K_fast|))``
with ``coarse = n_lists / n`` (``ivf_ops_result``).

The build runs the coarse k-means through ``ops.kmeans_assign`` (the
CUDA kernel on the card) and lays the lists out from a stable sort of
the assignments.  Options of the reference still to be ported raise by
name, each naming its ROADMAP.md item: ``search_crude`` (the probes and
crude rungs, queue 1, item 4), ``refine_cap`` and ``filter`` (queue 1,
item 2), ``pipeline`` (queue 1, item 7), ``add`` (``ivf_extend``, queue
1, item 6) and ``shard`` (queue 1, item 10).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import codebooks as cb
from repro_torch.index.base import (SearchResult, build_lut,
                                    chunked_over_queries, full_f32_matmul,
                                    resolve_backend, resolve_lut_dtype)
from repro_torch.index.flat import (_check_fastscan_geometry, _check_filter,
                                    _FlatBase, _not_ported)
from repro_torch.kernels.stages import two_step_stages, topk_two_key

# centroid rows of the lists k-means cannot seed (n_lists > n): huge but
# finite, so probe distances stay ordered, never NaN
_SENTINEL = 1e15


class IVFIndex(NamedTuple):
    centroids: torch.Tensor      # (n_lists, d) f32
    lists: torch.Tensor          # (n_lists, max_len) int32 db ids, -1 pad
    list_lens: torch.Tensor      # (n_lists,) int32
    imbalance: float             # max_len / (n / n_lists)


def _pack_buckets(ids: torch.Tensor, n_lists: int, centroids) -> IVFIndex:
    """Lay the assignment ``ids`` (n,) out as the padded (n_lists,
    max_len) list slab: each list holds its database ids in ascending
    order (a stable sort of the assignments), -1 pads, and max_len >= 1
    so a partition with every list empty stays well formed."""
    n = ids.shape[0]
    ids = ids.long()
    order = torch.argsort(ids, stable=True)
    lens = torch.bincount(ids, minlength=n_lists)
    max_len = max(int(lens.max()) if n else 0, 1)
    starts = torch.cumsum(lens, 0) - lens
    owner = ids[order]
    rank = torch.arange(n, device=ids.device) - starts[owner]
    lists = torch.full((n_lists, max_len), -1, dtype=torch.int32,
                       device=ids.device)
    lists[owner, rank] = order.to(torch.int32)
    return IVFIndex(centroids=centroids, lists=lists,
                    list_lens=lens.to(torch.int32),
                    imbalance=float(max_len / max(n / n_lists, 1)))


def _generator(generator) -> torch.Generator:
    """A ``torch.Generator`` from a generator, an int seed or None
    (seed 0, the reference's default ``PRNGKey(0)`` role)."""
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator().manual_seed(0 if generator is None
                                         else int(generator))


def build_ivf(emb_db: torch.Tensor, n_lists: int, kmeans_iters: int = 20,
              *, generator: Union[torch.Generator, int, None] = None,
              init_ids: Optional[torch.Tensor] = None) -> IVFIndex:
    """Coarse k-means partition of ``emb_db`` (n, d) into padded
    inverted lists of int32 global database ids.  ``init_ids`` (the
    initial centroid rows) overrides the draw from ``generator``."""
    n = int(emb_db.shape[0])
    if n_lists < 1:
        raise ValueError(f"n_lists must be >= 1, got {n_lists}")
    if n == 0:
        raise ValueError("cannot build an IVF over an empty database")
    # k-means cannot seed more centroids than points: fit the real count
    # and pad the remaining rows with the sentinel over empty lists
    k_eff = min(n_lists, n)
    cent, ids = cb.kmeans(emb_db, k_eff, iters=kmeans_iters,
                          generator=_generator(generator), init_ids=init_ids)
    if k_eff < n_lists:
        pad = torch.full((n_lists - k_eff, cent.shape[1]), _SENTINEL,
                         dtype=cent.dtype, device=cent.device)
        cent = torch.cat([cent, pad])
    return _pack_buckets(ids, n_lists, cent)


def ivf_assign(centroids: torch.Tensor, emb_db: torch.Tensor) -> IVFIndex:
    """Inverted lists from fixed coarse centroids: every ``emb_db`` row
    goes to its nearest centroid."""
    ids = cb.kmeans_assign(emb_db.to(torch.float32), centroids)
    return _pack_buckets(ids, centroids.shape[0], centroids)


def ivf_list_codes(ivf: IVFIndex, codes: torch.Tensor) -> torch.Tensor:
    """The stored codes moved inside the lists: one padded (n_lists,
    max_len, Kc) slab in the stored dtype (pad rows repeat codes[0];
    validity rides on the id slab), so serving gathers contiguous list
    rows per probe."""
    return codes[torch.clamp_min(ivf.lists, 0).long()]


# -------------------------------------------------------------- engines ----

def coarse_probe(qs: torch.Tensor, centroids: torch.Tensor,
                 n_probe: int) -> torch.Tensor:
    """Nearest ``n_probe`` centroid ids of a query block: one (nq,
    n_lists) distance matmul and the two-key top-k (lowest index first
    among ties, as ``lax.top_k``).  Returns (nq, n_probe) int32."""
    with full_f32_matmul():
        d2c = (torch.sum(torch.square(centroids), -1)[None, :]
               - 2.0 * qs @ centroids.T)                  # + ||q||^2 const
    return topk_two_key(d2c, n_probe)[1]


def gather_candidates(probes, lists, list_codes, topk: int):
    """Flatten the probed lists into the per-query candidate slab.
    Returns (cand_ids (nq, nc) int32, -1 pad; cand_codes (nq, nc, Kc)
    in the stored dtype), right-padded with invalid columns up to
    ``topk`` so every top-k has enough columns."""
    nq = probes.shape[0]
    p = probes.long()
    cand_ids = lists[p].reshape(nq, -1)
    cand_codes = list_codes[p].reshape(nq, cand_ids.shape[1], -1)
    pad = topk - cand_ids.shape[1]
    if pad > 0:
        cand_ids = F.pad(cand_ids, (0, pad), value=-1)
        cand_codes = F.pad(cand_codes, (0, 0, 0, pad))
    return cand_ids.contiguous(), cand_codes.contiguous()


def _ivf_crude_phase(qs, env, *, topk: int, n_probe: int, quantized: bool,
                     code_bits: int):
    """Probe, gather and the slab crude stage over one query block.
    Returns the carry the refine phase reads."""
    crude_stage, _, _ = two_step_stages(topk=topk, quantized=quantized,
                                        code_bits=code_bits)
    luts = build_lut(qs, env["C"])                        # (nq, K, m)
    probes = coarse_probe(qs, env["centroids"], n_probe)
    cand_ids, cand_codes = gather_candidates(probes, env["lists"],
                                             env["list_codes"], topk)
    out = crude_stage.slab(cand_codes, cand_ids, luts, env["fast"])
    return luts, out.crude, out.cand_vals, out.cand_idx, cand_codes, cand_ids


def _ivf_refine_phase(carry, env, *, topk: int, quantized: bool,
                      code_bits: int):
    """Threshold bootstrap and the slab refine stage.  Returns (ids
    (nq, topk), dist (nq, topk), n_cand (nq,), n_pass (nq,))."""
    luts, crude, cand_vals, cand_pos, cand_codes, cand_ids = carry
    _, tstage, rstage = two_step_stages(topk=topk, quantized=quantized,
                                        code_bits=code_bits)
    valid = cand_ids >= 0
    safe = torch.where(valid, cand_ids, torch.zeros_like(cand_ids))
    thr = tstage.from_slab_candidates(luts, cand_codes, cand_vals, cand_pos,
                                      env["fast"], env["sigma"])
    ids, dist, passed = rstage.slab(cand_codes, luts, crude, thr,
                                    env["fast"], safe)
    # counts are exact in any order
    n_cand = valid.sum(dim=1).to(torch.float32)
    n_pass = passed.sum(dim=1).to(torch.float32)
    return ids, dist, n_cand, n_pass


def _ivf_block(qs, env, *, topk: int, n_probe: int, quantized: bool,
               code_bits: int):
    """The crude and refine phases back to back over one query block."""
    opts = dict(topk=topk, quantized=quantized, code_bits=code_bits)
    return _ivf_refine_phase(_ivf_crude_phase(qs, env, n_probe=n_probe,
                                              **opts), env, **opts)


def ivf_ops_result(ids, dist, n_cand, n_pass, *, n: int, n_lists: int, K,
                   kf) -> SearchResult:
    """Fold per-query candidate and pass counts into the generalized
    Average-Ops accounting (coarse dots cost ~d multiplies each, ~K/2
    LUT adds at m = 2d)."""
    probed_frac = torch.mean(n_cand) / n
    pass_rate = torch.mean(n_pass) / torch.clamp_min(torch.mean(n_cand), 1.0)
    coarse = n_lists / n
    avg_ops = coarse * K / 2 + probed_frac * (kf + pass_rate * (K - kf))
    return SearchResult(ids, dist, avg_ops, pass_rate)


def ivf_two_step_search(queries, codes, C, structure, ivf: IVFIndex,
                        topk: int, n_probe: int, *, list_codes,
                        backend: str = "auto",
                        query_chunk: Optional[int] = None,
                        refine_cap: Optional[int] = None,
                        lut_dtype: str = "f32", code_bits: int = 8,
                        filter=None) -> SearchResult:
    """Batched IVF + ICQ two-step over the in-list codes slab
    ``list_codes`` (``ivf_list_codes``).  ``lut_dtype`` selects the crude
    tables ("f32" | "int8"; the refine pass is always f32);
    ``code_bits=4`` serves nibble-packed codes."""
    resolve_backend(backend, codes.device)
    _check_filter(filter)
    if refine_cap is not None:
        raise _not_ported("refine_cap (the capped refine)", "queue 1, item 2")
    K = C.shape[0]
    n_lists = ivf.lists.shape[0]
    if not 1 <= n_probe <= n_lists:
        raise ValueError(f"n_probe={n_probe} outside [1, {n_lists}]")
    fast = structure.fast_mask
    env = {"C": C, "fast": fast, "sigma": structure.sigma,
           "centroids": ivf.centroids, "lists": ivf.lists,
           "list_codes": list_codes}
    fn = functools.partial(
        _ivf_block, env=env, topk=topk, n_probe=n_probe,
        quantized=resolve_lut_dtype(lut_dtype) == "int8",
        code_bits=_check_fastscan_geometry(code_bits, C.shape[1]))
    ids, dist, n_cand, n_pass = chunked_over_queries(fn, queries,
                                                     query_chunk)
    return ivf_ops_result(ids, dist, n_cand, n_pass, n=codes.shape[0],
                          n_lists=n_lists, K=K,
                          kf=torch.sum(fast.to(torch.float32)))


# --------------------------------------------------------------- index ----

@dataclasses.dataclass(frozen=True)
class IVFTwoStep(_FlatBase):
    """IVF-pruned ICQ two-step index: coarse probe and the candidate-slab
    two-step.  codes (n, Kc) stored rows, C (K, m, d) f32, ``list_codes``
    the in-list codes slab, all on one device."""
    codes: torch.Tensor = None
    C: torch.Tensor = None
    structure: object = None            # core.icq.ICQStructure
    ivf: IVFIndex = None
    n_probe: int = 8
    refine_cap: Optional[int] = None
    list_codes: torch.Tensor = None     # (n_lists, max_len, Kc)

    def __post_init__(self):
        super().__post_init__()
        if self.refine_cap is not None:
            raise _not_ported("index.refine_cap (the capped refine)",
                              "queue 1, item 2")

    @classmethod
    def build(cls, codes, C, structure, *, emb_db=None, ivf=None,
              generator=None, n_lists: int = 64, kmeans_iters: int = 20,
              **opts) -> "IVFTwoStep":
        """Fit the coarse quantizer over ``emb_db`` (the embeddings the
        codes encode, on the codes' device; ``generator`` seeds its
        k-means) or take a stored partition ``ivf``, and move the codes
        inside the lists."""
        if ivf is None:
            if emb_db is None:
                raise ValueError("the IVF index needs emb_db= (the "
                                 "embeddings the codes encode) to fit its "
                                 "coarse quantizer")
            ivf = build_ivf(emb_db, n_lists, kmeans_iters,
                            generator=generator)
        return cls(codes=codes, C=C, structure=structure, ivf=ivf,
                   list_codes=ivf_list_codes(ivf, codes), **opts)

    def search(self, queries, topk: Optional[int] = None, *,
               filter=None) -> SearchResult:
        return ivf_two_step_search(
            queries, self.codes, self.C, self.structure, self.ivf,
            topk if topk is not None else self.topk, self.n_probe,
            list_codes=self.list_codes, backend=self.backend,
            query_chunk=self.query_chunk, lut_dtype=self.lut_dtype,
            code_bits=self.code_bits, filter=filter)

    def search_crude(self, queries, topk=None, n_probe=None, *,
                     filter=None):
        raise _not_ported("search_crude (the probes and crude rungs of "
                          "the degradation ladder)", "queue 1, item 4")

    def add(self, new_vectors, **opts):
        raise _not_ported("IVFTwoStep.add (incremental encode and "
                          "ivf_extend)", "queue 1, item 6")
