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
the assignments.  ``add`` encodes the new rows (the ICM kernel) and
routes them into the fixed lists with ``ivf_extend``, so a grown index
equals ``ivf_assign`` of the same centroids over all rows.

``search_crude`` is the degradation ladder's crude floor: probe, gather
and the slab crude pass, its top-k of slab positions mapped to ids (no
refine); the ladder's probes rung is ``search`` at a reduced
``n_probe``.  ``filter`` and ``refine_cap`` are the reference's
jnp-engine options (``backend="jnp"`` on the card, any backend on the
CPU; the fused engine raises the reference's ``ValueError``), served in
the reference's jnp composition through the slab kernels: filtered
candidates invalid (id -1) in the slab the slab crude kernel masks, the
jnp bootstrap rule over its candidate list
(``ThresholdStage.from_dense_slab_candidates``), then the slab refine
or the survivor selection and re-rank (``CappedStage``).  Every search
is the phase pair of ``ivf_phase_fns`` over ``ivf_phase_env``;
``pipeline="tiles" | "auto"`` runs it through the pipelined executor
(``index/pipelined.py``; queue 1 item 7, done), each ``n_probe`` with a
plan of its own.  ``shard(mesh)`` returns the list-sharded serving clone
(``index/sharded.py``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import codebooks as cb
from repro_torch.index.base import (SearchResult, as_generator, as_torch,
                                    build_lut, chunked_over_queries,
                                    full_f32_matmul, mask_filtered_ids,
                                    resolve_backend, resolve_lut_dtype)
from repro_torch.index.flat import (_check_fastscan_geometry, _check_filter,
                                    _check_refine_cap, _encode_new_rows,
                                    _fast_count, _FlatBase)
from repro_torch.index.pipelined import compose, maybe_pipelined
from repro_torch.kernels.stages import (CappedStage, CrudeStage,
                                        RefineStage, ThresholdStage,
                                        topk_two_key)

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
                          generator=as_generator(generator), init_ids=init_ids)
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


def ivf_extend(ivf: IVFIndex, new_emb: torch.Tensor,
               start_id: int) -> IVFIndex:
    """Route new points into the existing lists, centroids fixed: every
    ``new_emb`` row goes to its nearest centroid (``kmeans_assign``) with
    the global id ``start_id + row``.  The old ids' lists are read back
    from the padded slab and the whole partition is laid out again by
    ``_pack_buckets`` (ascending ids per list, max_len grown as needed),
    so the result equals ``ivf_assign`` over the concatenated
    embeddings."""
    n_lists, max_len = ivf.lists.shape
    valid = ivf.lists >= 0
    old_ids = ivf.lists[valid].long()
    if old_ids.numel() != start_id or (
            start_id and not torch.equal(
                torch.sort(old_ids).values,
                torch.arange(start_id, device=old_ids.device))):
        raise ValueError(f"the lists must hold the ids 0 .. {start_id - 1} "
                         f"once each to be extended from id {start_id}; "
                         f"they hold {old_ids.numel()} ids")
    owner = torch.empty(start_id, dtype=torch.long, device=old_ids.device)
    owner[old_ids] = torch.arange(n_lists, device=old_ids.device)[:, None] \
        .expand(n_lists, max_len)[valid]
    new_ids = cb.kmeans_assign(new_emb.to(torch.float32), ivf.centroids)
    return _pack_buckets(torch.cat([owner, new_ids.long()]), n_lists,
                         ivf.centroids)


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


def ivf_phase_env(codes, C, structure, ivf: IVFIndex, *, list_codes,
                  pred=None) -> dict:
    """The borrowed index state of every IVF phase: codes, codebooks,
    the ICQ structure's fast mask and margin, the coarse centroids, the
    lists and their in-list codes slab, and the optional filter
    predicate."""
    return {"codes": codes, "C": C, "fast": structure.fast_mask,
            "sigma": structure.sigma, "centroids": ivf.centroids,
            "lists": ivf.lists, "list_codes": list_codes, "pred": pred}


def _filtered_slab(qs, env, *, topk: int, n_probe: int, pred):
    """Probe and gather, with the filter folded into validity: returns
    (cand_ids with filtered columns -1, cand_codes, safe ids (0 at the
    gather's pads, the reference's ``safe``), valid (nq, nc))."""
    probes = coarse_probe(qs, env["centroids"], n_probe)
    cand_ids, cand_codes = gather_candidates(probes, env["lists"],
                                             env["list_codes"], topk)
    valid = cand_ids >= 0
    safe = torch.where(valid, cand_ids, torch.zeros_like(cand_ids))
    if pred is not None:
        valid = valid & pred[safe.long()]
        cand_ids = torch.where(valid, cand_ids, torch.full_like(cand_ids,
                                                                -1))
    return cand_ids, cand_codes, safe, valid


def _ivf_crude_phase(qs, env, *, topk: int, n_probe: int, quantized: bool,
                     code_bits: int, has_filter: bool = False, out=None,
                     before_launch=None):
    """Probe, gather (filtered candidates invalid under ``has_filter``:
    id -1, so +inf in the slab crude kernel) and the slab crude stage
    over one query block (``out``, optional, receives the dense slab
    crude matrix; ``before_launch``, optional, runs just before the
    kernel).  Returns the carry (luts, crude, cand_vals, cand_pos,
    cand_codes, safe, valid) the refine phase reads."""
    luts = build_lut(qs, env["C"])                        # (nq, K, m)
    cand_ids, cand_codes, safe, valid = _filtered_slab(
        qs, env, topk=topk, n_probe=n_probe,
        pred=env["pred"] if has_filter else None)
    res = CrudeStage(topk=topk, quantized=quantized,
                     code_bits=code_bits).slab(
        cand_codes, cand_ids, luts, env["fast"], out=out,
        before_launch=before_launch)
    return (luts, res.crude, res.cand_vals, res.cand_idx, cand_codes, safe,
            valid)


def _ivf_refine_phase(carry, env, *, topk: int, quantized: bool,
                      code_bits: int, refine_cap: Optional[int] = None,
                      has_filter: bool = False, before_launch=None):
    """The threshold bootstrap from the slab crude top-k (the fused
    engine's rule, ``from_slab_candidates``; under the jnp engine's
    options the reference's jnp rule, ``from_dense_slab_candidates``),
    then the slab refine stage or, with ``refine_cap``, the survivor
    selection and re-rank (``CappedStage``, the cap clamped into [topk,
    nc]); ``before_launch``, optional, runs just before the first
    kernel.  Returns (ids (nq, topk), dist (nq, topk), n_cand (nq,),
    n_pass (nq,))."""
    luts, crude, cand_vals, cand_pos, cand_codes, safe, valid = carry
    fast = env["fast"]
    tstage = ThresholdStage(topk=topk, quantized=quantized,
                            code_bits=code_bits)
    bootstrap = (tstage.from_dense_slab_candidates
                 if has_filter or refine_cap is not None
                 else tstage.from_slab_candidates)
    thr = bootstrap(luts, cand_codes, cand_vals, cand_pos, fast,
                    env["sigma"])
    passed = crude < thr[:, None]
    if refine_cap is None:
        ids, dist, _ = RefineStage(topk=topk, code_bits=code_bits).slab(
            cand_codes, luts, crude, thr, fast, safe,
            before_launch=before_launch)
    else:
        cap = min(max(refine_cap, topk), crude.shape[1])
        pos, dist = CappedStage(topk=topk, cap=cap, code_bits=code_bits)(
            cand_codes, luts, crude, thr, before_launch=before_launch)
        ids = safe.gather(1, pos)
    if has_filter:
        ids = mask_filtered_ids(ids, dist)
    # counts are exact in any order
    return (ids, dist, valid.sum(dim=1).to(torch.float32),
            passed.sum(dim=1).to(torch.float32))


def _ivf_crude_only_phase(qs, env, *, topk: int, n_probe: int,
                          quantized: bool, code_bits: int,
                          has_filter: bool = False):
    """The crude rung over one query block: probe, gather and the slab
    crude stage, its top-k of slab positions mapped to ids (the
    reference's ``safe[pos]``); no refine.  Returns (ids, dist, n_cand,
    n_pass = 0)."""
    pred = env["pred"] if has_filter else None
    luts = build_lut(qs, env["C"])
    cand_ids, cand_codes, safe, valid = _filtered_slab(
        qs, env, topk=topk, n_probe=n_probe, pred=pred)
    out = CrudeStage(topk=topk, quantized=quantized,
                     code_bits=code_bits).slab(cand_codes, cand_ids, luts,
                                               env["fast"])
    ids = safe.gather(1, out.cand_idx.long())
    if pred is not None:
        ids = mask_filtered_ids(ids, out.cand_vals)
    n_cand = valid.sum(dim=1).to(torch.float32)
    return ids, out.cand_vals, n_cand, torch.zeros_like(n_cand)


def ivf_phase_fns(*, topk: int, n_probe: int, quantized: bool = False,
                  code_bits: int = 8, refine_cap: Optional[int] = None,
                  crude_only: bool = False, has_filter: bool = False):
    """The IVF search split at the crude/refine boundary: returns
    ``(crude_fn, refine_fn)`` over ``(qs | carry, env)``, the pair both
    the sequential searches and the pipelined executor compose.
    ``crude_only`` is the single-phase crude rung (refine_fn None);
    ``filter`` and ``refine_cap`` (the jnp engine's options) take the
    reference's jnp bootstrap rule, otherwise the fused engine's; the
    crude phase takes ``out=`` for its dense slab crude matrix and both
    phases a ``before_launch`` hook."""
    opts = dict(topk=topk, quantized=quantized, code_bits=code_bits,
                has_filter=has_filter)
    if crude_only:
        return functools.partial(_ivf_crude_only_phase, n_probe=n_probe,
                                 **opts), None
    return (functools.partial(_ivf_crude_phase, n_probe=n_probe, **opts),
            functools.partial(_ivf_refine_phase, refine_cap=refine_cap,
                              **opts))


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


def check_n_probe(ivf: IVFIndex, n_probe: int) -> int:
    """Checks ``n_probe`` against the list count; returns the count."""
    n_lists = ivf.lists.shape[0]
    if not 1 <= n_probe <= n_lists:
        raise ValueError(f"n_probe={n_probe} outside [1, {n_lists}]")
    return n_lists


def _ivf_search(queries, codes, C, structure, ivf: IVFIndex, topk: int,
                n_probe: int, *, list_codes, backend: str,
                query_chunk: Optional[int], lut_dtype: str, code_bits: int,
                filter, refine_cap=None, crude_only: bool = False):
    """The IVF phase pair composed block by block and folded into the
    Average-Ops accounting."""
    be = resolve_backend(backend, codes.device)
    pred = _check_filter(filter, codes.shape[0], be, codes.device)
    _check_refine_cap(refine_cap, be)
    n_lists = check_n_probe(ivf, n_probe)
    fns = ivf_phase_fns(
        topk=topk, n_probe=n_probe,
        quantized=resolve_lut_dtype(lut_dtype) == "int8",
        code_bits=_check_fastscan_geometry(code_bits, C.shape[1]),
        refine_cap=refine_cap, crude_only=crude_only,
        has_filter=pred is not None)
    env = ivf_phase_env(codes, C, structure, ivf, list_codes=list_codes,
                        pred=pred)
    out = chunked_over_queries(compose(*fns, env), queries, query_chunk)
    return ivf_ops_result(*out, n=codes.shape[0], n_lists=n_lists,
                          K=C.shape[0], kf=_fast_count(structure))


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
    ``code_bits=4`` serves nibble-packed codes.  ``refine_cap`` and
    ``filter`` (an (n,) bool row predicate; absent slots are id -1 at
    distance +inf) are the jnp engine's options, refused by the fused
    engine."""
    return _ivf_search(queries, codes, C, structure, ivf, topk, n_probe,
                       list_codes=list_codes, backend=backend,
                       query_chunk=query_chunk, lut_dtype=lut_dtype,
                       code_bits=code_bits, filter=filter,
                       refine_cap=refine_cap)


def ivf_crude_search(queries, codes, C, structure, ivf: IVFIndex,
                     topk: int, n_probe: int, *, list_codes,
                     backend: str = "auto",
                     query_chunk: Optional[int] = None,
                     lut_dtype: str = "f32", code_bits: int = 8,
                     filter=None) -> SearchResult:
    """The IVF crude floor of the degradation ladder: probe and the
    crude-only ranking of the candidate slab, equal bit for bit to the
    crude top-k the full path bootstraps from.  ``avg_ops`` drops the
    pass-rate term (nothing refined).  ``filter`` as in
    ``ivf_two_step_search``."""
    return _ivf_search(queries, codes, C, structure, ivf, topk, n_probe,
                       list_codes=list_codes, backend=backend,
                       query_chunk=query_chunk, lut_dtype=lut_dtype,
                       code_bits=code_bits, filter=filter, crude_only=True)


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
        k = topk if topk is not None else self.topk
        res = maybe_pipelined(self, queries, k, filter=filter)
        if res is not None:
            return res
        return ivf_two_step_search(
            queries, self.codes, self.C, self.structure, self.ivf,
            k, self.n_probe,
            list_codes=self.list_codes, backend=self.backend,
            query_chunk=self.query_chunk, refine_cap=self.refine_cap,
            lut_dtype=self.lut_dtype, code_bits=self.code_bits,
            filter=filter)

    def search_crude(self, queries, topk: Optional[int] = None,
                     n_probe: Optional[int] = None, *,
                     filter=None) -> SearchResult:
        """The crude floor of the degradation ladder: probe and the slab
        crude ranking with no refine, equal bit for bit to the full
        path's crude top-k.  ``n_probe`` overrides the index's (under a
        pipeline, with a plan of its own)."""
        k = topk if topk is not None else self.topk
        res = maybe_pipelined(self, queries, k, filter=filter,
                              crude_only=True, n_probe=n_probe)
        if res is not None:
            return res
        return ivf_crude_search(
            queries, self.codes, self.C, self.structure, self.ivf, k,
            n_probe if n_probe is not None else self.n_probe,
            list_codes=self.list_codes, backend=self.backend,
            query_chunk=self.query_chunk, lut_dtype=self.lut_dtype,
            code_bits=self.code_bits, filter=filter)

    def add(self, new_vectors, *, icm_iters: int = 3,
            encode_backend: str = "auto",
            point_chunk: Optional[int] = 8192) -> "IVFTwoStep":
        """Encode ``new_vectors`` ((n_new, d) embeddings, numpy or torch)
        and route them into the lists, coarse centroids fixed, no
        retraining; the in-list codes slab is rebuilt.  Returns a new
        index whose new rows get ids [n, n + n_new); it equals the index
        of ``ivf_assign`` with the same centroids over all rows."""
        x = as_torch(new_vectors).to(self.device, torch.float32)
        new = _encode_new_rows(x, self.C, self.codes.dtype,
                               icm_iters=icm_iters,
                               encode_backend=encode_backend,
                               point_chunk=point_chunk,
                               code_bits=self.code_bits)
        codes = torch.cat([self.codes, new])
        ivf = ivf_extend(self.ivf, x, start_id=self.codes.shape[0])
        return dataclasses.replace(self, codes=codes, ivf=ivf,
                                   list_codes=ivf_list_codes(ivf, codes))
