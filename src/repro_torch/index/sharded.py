"""Mesh-sharded ANN serving (twin of ``repro.index.sharded``): the
packed codes or the inverted lists split over the ``data`` axis of a
``distributed.Mesh``, a local top-k per shard, and a global merge that
returns the single-device ranking.

One process drives every shard (``distributed/sharding.py``).  Per
query block the LUTs and the kernels' LUT operands are built once on
the mesh's first device and copied once to every other device, so all
shards read the same tables; each shard then runs the port's scan
kernels on its own rows (``ops.batched_crude_topk`` /
``ops.batched_refine_topk``, or the slab pair ``ops.ivf_crude_topk`` /
``ops.ivf_refine_topk``) on its device, and its (nq, k_loc) candidate
columns are gathered onto the first device with ``.to()``.  On a CUDA
mesh the kernels launch or raise; on the CPU their plain versions run.
On one card the shards run one after another on the current stream.

Merge discipline: every local top-k carries (distance, global key)
pairs, and ``_gather_sorted`` sorts the gathered columns ascending on
(distance, key), the lowest key winning a tie: the kernels' own total
order, so the merged ranking, the +inf tail included, is the
single-device ranking.  The eq. 2 threshold is bootstrapped from the
*merged* crude top-k (each shard computes its candidates' full
distances from its own codes), so every shard prunes against the
single-device threshold.  Each candidate's distance is the same
per-element arithmetic as on one device, and the pass counts are
integers summed over shards, so ids, distances, ``pass_rate`` and
``avg_ops`` equal the unsharded port's bit for bit (the reference
promises equal ids and distances to reassociation ulps across its SPMD
program; the port holds itself to more).

``lut_dtype`` and ``code_bits`` follow the source index: int8 crude
tables are calibrated per query from the replicated LUT, so every shard
quantizes with the same affine.  ``filter`` is served under every
backend, as the reference's sharded bodies (jnp-only) serve it: row
shards hand their slice of the predicate to the crude kernel, list
shards fold the whole predicate into their slab's ids (global ids), and
the threshold bootstrap follows the reference's jnp rule.
``refine_cap`` behaves as on the unsharded index (the jnp engine's
option, refused by the fused engine): each shard's survivor selection
and the re-rank of its survivors through the kernels, the merged cap
best-crude survivors re-ranked by full distance.  Sharded clones always
serve ``pipeline="off"``: a pipelined source yields a working
non-pipelined clone.

Layouts:
  ShardedFlatADC / ShardedTwoStep   rows sharded: shard s owns global
      rows [s*ns, min((s+1)*ns, n)), ns = ceil(n / D); a short or empty
      trailing shard scans what it has (an empty one launches nothing).
  ShardedIVFTwoStep                 inverted lists sharded: shard s owns
      list rows [s*Ls, (s+1)*Ls) and their in-list codes slab.  Probes
      come from the replicated centroids; a probe slot is scanned only
      by the shard owning its list.  Each shard compacts its owned probe
      slots (in slot order) into a slab of min(n_probe, Ls) slots, the
      rest filled with id -1 (ranked +inf by the slab kernels); the
      candidate keys are slab positions in probe-slot-major order, the
      single-device candidate order, and a filled slot's key sorts after
      every real position.

Dead shards (``mark_shard_dead``) launch nothing.  Row sharding returns
the single-device ranking over the surviving rows; list sharding, the
ranking of the index whose dead lists hold no points (their slab
positions still rank +inf with id 0, as an emptied list's do).
``coverage`` reports the reachable share of the database.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import NamedSharding, shard_rows
from repro_torch.index import base
from repro_torch.index.base import (SearchResult, as_filter, build_lut,
                                    chunked_over_queries, mask_filtered_ids,
                                    resolve_backend, resolve_code_bits,
                                    resolve_lut_dtype)
from repro_torch.index.flat import (_check_refine_cap, _fast_count,
                                    adc_result, two_step_result)
from repro_torch.index.ivf import (check_n_probe, coarse_probe,
                                   ivf_list_codes, ivf_ops_result)
from repro_torch.kernels import ops
from repro_torch.kernels.stages import (crude_lut_operands,
                                        full_lut_operand, slow_lut_operand,
                                        topk_two_key, widen_codes)


def _survivor_full(codes_rows, luts, s_vals, code_bits: int):
    """Full-table distances of a shard's selected survivors (nq, w), in
    survivor order, through the re-rank kernel over all w of them (its
    sorted output scattered back): +inf at the slots past the
    survivors."""
    d, pos = ops.rerank_topk(codes_rows.contiguous(),
                             full_lut_operand(luts, code_bits=code_bits),
                             torch.isfinite(s_vals), s_vals.shape[1],
                             code_bits=code_bits)
    return torch.empty_like(d).scatter_(1, pos.long(), d)

_INF = float("inf")
# the key of a slab column a shard does not own: after every real one
_KEY_MAX = torch.iinfo(torch.int64).max


def _sanitize(dist):
    """Defensive NaN/Inf scrub of a shard's distances: a poisoned shard's
    garbage sorts dead last instead of winning the merge (NaN ordering
    is unspecified).  A no-op on finite data."""
    return torch.nan_to_num(dist, nan=_INF, posinf=_INF, neginf=_INF)


def _gather_sorted(cols, k: int) -> List[torch.Tensor]:
    """The global merge primitive: ``cols`` holds one tuple (dist (nq,
    k_s), key (nq, k_s), *payload) per shard, all on one device.  The
    columns are concatenated and sorted ascending on (dist, key), the
    lowest key first among equal distances (a stable sort by key, then
    a stable sort by distance); returns the first ``k`` columns of
    every operand."""
    cat = [torch.cat(parts, dim=1) for parts in zip(*cols)]
    by_key = torch.sort(cat[1], dim=1, stable=True).indices
    by_dist = torch.sort(cat[0].gather(1, by_key), dim=1,
                         stable=True).indices
    order = by_key.gather(1, by_dist)[:, :k]
    return [c.gather(1, order) for c in cat]


def _fill_topk(ids, dist, k: int):
    """Slots past the merged candidates (fewer rows than ``k`` left)
    report id -1 at distance +inf."""
    pad = k - ids.shape[1]
    if pad <= 0:
        return ids, dist
    return (torch.nn.functional.pad(ids, (0, pad), value=-1),
            torch.nn.functional.pad(dist, (0, pad), value=_INF))


def _gather_rows(codes, pos):
    """(nq, nc, Kc) slab rows at (nq, t) positions -> (nq, t, Kc)."""
    return torch.gather(codes, 1,
                        pos.long()[:, :, None].expand(-1, -1,
                                                      codes.shape[2]))


class _Sharded:
    """Shared surface of the sharded serving clones: the mesh and its
    ``data`` devices, the engine options copied from the source index,
    the dead-shard surface and the grow path.

    ``mark_shard_dead(s, ...)`` excludes shards from serving, in place
    and monotone; a dead shard launches nothing and the merge returns
    the survivors' ranking.  ``coverage`` is the reachable fraction of
    the database's rows (1.0 with no dead shard).  ``add`` grows the
    source index (which the clone keeps: on one device the shards are
    views of its tensors) and shards it again, the dead set carried
    over."""

    # sharded clones never pipeline (module docstring): the engine reads
    # this field as it does on the single-device indexes
    pipeline: str = "off"

    def _setup(self, source, mesh):
        self.mesh = mesh
        self.devices = mesh.axis_devices("data")
        self.lead = self.devices[0]
        self.source = source
        self.topk = source.topk
        self.backend = source.backend
        self.query_chunk = source.query_chunk
        self.lut_dtype = resolve_lut_dtype(source.lut_dtype)
        self.code_bits = resolve_code_bits(source.code_bits)
        self.refine_cap = getattr(source, "refine_cap", None)
        # every shard's device resolves the backend (an unknown backend or
        # device raises here)
        for d in set(self.devices):
            resolve_backend(self.backend, d)
        self._be = resolve_backend(self.backend, self.lead)
        self.C = source.C.to(self.lead)
        self.n = int(source.codes.shape[0])
        self.dead_shards = frozenset()

    @property
    def device(self) -> torch.device:
        return self.lead

    @property
    def num_shards(self) -> int:
        return len(self.devices)

    def mark_shard_dead(self, *shards: int):
        D = self.num_shards
        for s in shards:
            if not 0 <= s < D:
                raise ValueError(f"shard {s} outside [0, {D})")
        dead = self.dead_shards | set(shards)
        if len(dead) >= D:
            raise ValueError(
                f"cannot mark all {D} shards dead — no data would remain "
                "(re-shard the source index instead)")
        self.dead_shards = frozenset(dead)
        return self

    @property
    def coverage(self) -> float:
        if not self.dead_shards:
            return 1.0
        return self._alive_rows() / max(self.n, 1)

    def _per_device(self, tensors):
        """The block's replicated operands, copied once per distinct
        device of the mesh (None entries stay None)."""
        out = {}
        for d in self.devices:
            if d not in out:
                out[d] = tuple(None if t is None else t.to(d)
                               for t in tensors)
        return out

    def add(self, new_vectors, **encode_opts):
        grown = self.source.add(new_vectors, **encode_opts).shard(self.mesh)
        if self.dead_shards:
            grown.mark_shard_dead(*self.dead_shards)
        return grown

    def shard(self, mesh):
        raise ValueError("index is already sharded")


# ------------------------------------------------------------ row shards ----

class _RowSharded(_Sharded):
    """Row sharding of a flat index: shard s holds global rows
    ``shard_rows(n, D)[s]`` on ``devices[s]``."""

    def __init__(self, source, mesh):
        self._setup(source, mesh)
        self.rows = shard_rows(self.n, self.num_shards)
        self.codes = NamedSharding(mesh, ("data",)).put(source.codes)

    def _alive_rows(self) -> int:
        return sum(b - a for s, (a, b) in enumerate(self.rows)
                   if s not in self.dead_shards)

    def _serving(self):
        """(shard, first row, rows, device) of every live, non-empty
        shard."""
        return [(s, a, b - a, self.devices[s])
                for s, (a, b) in enumerate(self.rows)
                if s not in self.dead_shards and b > a]

    def _preds(self, filter):
        """The filter's row slices, one a shard on its device (served
        under every backend, as the reference's sharded bodies serve
        it), or None."""
        if filter is None:
            return None
        pred = as_filter(filter, self.n, self.lead)
        return NamedSharding(self.mesh, ("data",)).put(pred)


class ShardedFlatADC(_RowSharded):
    """Row-sharded one-step ADC: each shard's full-table crude top-k,
    merged by (distance, global row id)."""

    def _block(self, qs, k: int, preds):
        luts = build_lut(qs, self.C)
        rep = self._per_device(crude_lut_operands(
            luts, None, quantized=self.lut_dtype == "int8",
            code_bits=self.code_bits))
        cols = []
        for s, a, rows, dev in self._serving():
            lf, sc, of = rep[dev]
            kl = min(k, rows)
            _, v, i = ops.batched_crude_topk(
                self.codes[s], lf, kl, want_crude=False, lut_scale=sc,
                lut_offset=of, code_bits=self.code_bits,
                pred=None if preds is None else preds[s])
            cols.append((_sanitize(v).to(self.lead),
                         (i.long() + a).to(self.lead)))
        dist, gid = _gather_sorted(cols, k)
        ids = gid.to(torch.int32)
        if preds is not None:
            ids = mask_filtered_ids(ids, dist)
        ids, dist = _fill_topk(ids, dist, k)
        return ids, dist, torch.zeros(qs.shape[0], dtype=torch.float32,
                                      device=self.lead)

    def search(self, queries, topk: Optional[int] = None, *,
               filter=None) -> SearchResult:
        """queries (nq, d) f32 -> SearchResult, equal bit for bit to the
        unsharded index's.  ``filter``: optional (n,) bool row
        predicate, served under every backend."""
        k = self.topk if topk is None else topk
        preds = self._preds(filter)
        out = chunked_over_queries(lambda qs: self._block(qs, k, preds),
                                   queries.to(self.lead), self.query_chunk)
        return adc_result(*out, K=self.C.shape[0])


class ShardedTwoStep(_RowSharded):
    """Row-sharded ICQ two-step: the eq. 2 threshold from the merged
    crude top-k, each shard refines against it, the refine top-k merged
    by (full distance, global row id)."""

    def __init__(self, source, mesh):
        super().__init__(source, mesh)
        self.structure = source.structure
        self.fast = source.structure.fast_mask.to(self.lead)
        self.sigma = source.structure.sigma.to(self.lead)

    def _block(self, qs, k: int, preds):
        K, cb = self.C.shape[0], self.code_bits
        quant = self.lut_dtype == "int8"
        # filter and refine_cap take the reference's jnp composition: its
        # bootstrap rule (one full-table sum in f32, every slot of the
        # crude top-k in the argmax)
        dense = preds is not None or self.refine_cap is not None
        luts = build_lut(qs, self.C)
        rep = self._per_device(
            crude_lut_operands(luts, self.fast, quantized=quant,
                               code_bits=cb)
            + (slow_lut_operand(luts, self.fast, code_bits=cb), luts,
               self.fast))
        serving = self._serving()

        # phase 1: each shard's crude top-k with its candidates' full
        # distances, merged before the threshold bootstrap
        crude_of, cols = {}, []
        for s, a, rows, dev in serving:
            lf, sc, of, _, lu, fm = rep[dev]
            kl = min(k, rows)
            crude, v, i = ops.batched_crude_topk(
                self.codes[s], lf, kl, lut_scale=sc, lut_offset=of,
                code_bits=cb, pred=None if preds is None else preds[s])
            cand = widen_codes(self.codes[s][i.long()], K, cb)
            full = (base.lut_sum(lu, cand) if dense and not quant
                    else v + base.lut_sum(lu, cand, ~fm))
            crude_of[s] = crude
            cols.append((_sanitize(v).to(self.lead),
                         (i.long() + a).to(self.lead), full.to(self.lead)))
        sv, _, sf = _gather_sorted(cols, k)
        far = torch.argmax(sf, dim=1)
        thr = sv.gather(1, far[:, None])[:, 0] + self.sigma

        # phase 2: every shard prunes against the global threshold
        cap = (None if self.refine_cap is None
               else min(max(self.refine_cap, k), self.n))
        passes = torch.zeros(qs.shape[0], dtype=torch.int64,
                             device=self.lead)
        cols = []
        for s, a, rows, dev in serving:
            _, _, _, ls, lu, _ = rep[dev]
            crude, t = crude_of[s], thr.to(dev)
            passed = crude < t[:, None]
            passes += passed.sum(dim=1).to(self.lead)
            if cap is None:
                d, i = ops.batched_refine_topk(self.codes[s], ls, crude, t,
                                               min(k, rows), code_bits=cb)
                cols.append((_sanitize(d).to(self.lead),
                             (i.long() + a).to(self.lead)))
            else:
                v, i = ops.select_topk(crude, t, min(cap, rows))
                full = _survivor_full(self.codes[s][i.long()], lu, v, cb)
                cols.append((v.to(self.lead), (i.long() + a).to(self.lead),
                             full.to(self.lead)))
        if cap is None:
            dist, gid = _gather_sorted(cols, k)
        else:
            # the cap best-crude survivors, re-ranked by full distance
            # (ties by compaction slot, as the unsharded compaction)
            v, g, full = _gather_sorted(cols, cap)
            dist, pos = topk_two_key(torch.where(
                torch.isfinite(v), full, torch.full_like(full, _INF)), k)
            gid = g.gather(1, pos.long())
        ids = gid.to(torch.int32)
        if preds is not None:
            ids = mask_filtered_ids(ids, dist)
        ids, dist = _fill_topk(ids, dist, k)
        # a count of passes is exact in any order; one rounding divides
        return ids, dist, passes.to(torch.float32) / self.n

    def search(self, queries, topk: Optional[int] = None, *,
               filter=None) -> SearchResult:
        """queries (nq, d) f32 -> SearchResult; ids, distances, pass_rate
        and avg_ops equal bit for bit to the unsharded index's.
        ``filter``: optional (n,) bool row predicate, served under every
        backend; absent slots are id -1 at distance +inf."""
        k = self.topk if topk is None else topk
        preds = self._preds(filter)
        _check_refine_cap(self.refine_cap, self._be)
        out = chunked_over_queries(lambda qs: self._block(qs, k, preds),
                                   queries.to(self.lead), self.query_chunk)
        return two_step_result(*out, K=self.C.shape[0],
                               kf=_fast_count(self.structure))


# ----------------------------------------------------------- list shards ----

class ShardedIVFTwoStep(_Sharded):
    """List-sharded IVF two-step: shard s owns list rows
    ``shard_rows(n_lists, D)[s]`` and their in-list codes slab on
    ``devices[s]``; centroids and codebooks are replicated on the first
    device, where the probes are taken."""

    def __init__(self, source, mesh):
        self._setup(source, mesh)
        self.structure = source.structure
        self.fast = source.structure.fast_mask.to(self.lead)
        self.sigma = source.structure.sigma.to(self.lead)
        ivf = source.ivf
        self.centroids = ivf.centroids.to(self.lead)
        self.n_lists, self.max_len = ivf.lists.shape
        self.n_probe = source.n_probe
        self.list_rows = shard_rows(self.n_lists, self.num_shards)
        slab = (source.list_codes if source.list_codes is not None
                else ivf_list_codes(ivf, source.codes))
        put = NamedSharding(mesh, ("data",)).put
        self.lists = put(ivf.lists)
        self.list_codes = put(slab)
        # host-side list sizes, so coverage needs no device read
        self._list_lens = np.asarray(ivf.list_lens.cpu(), np.int64)

    def _alive_rows(self) -> int:
        return int(sum(self._list_lens[a:b].sum()
                       for s, (a, b) in enumerate(self.list_rows)
                       if s not in self.dead_shards))

    def _keys(self, s: int, probes, nc0: int, nc: int):
        """The slab positions shard s answers for in a query block: its
        owned probe slots (``sel`` (nq, slots) slot indices, ``own`` the
        mask of real ones) and their columns' keys (nq, ncl) int64, the
        slab positions in probe-slot-major order, ``_KEY_MAX`` on filler
        slots; on shard 0 also the invalid columns [nc0, nc) that pad a
        slab thinner than topk.  ``order`` (or None) sorts the columns
        into ascending key order.  Reads only the probes, so a dead
        shard's keys come from the first device."""
        L0, L1 = self.list_rows[s]
        nq, n_probe = probes.shape
        ml = self.max_len
        local = (probes >= L0) & (probes < L1)
        slot = torch.arange(n_probe, device=probes.device)[None, :]
        rank = torch.where(local, slot, torch.full_like(slot, n_probe))
        sel = torch.sort(rank, dim=1, stable=True).indices[
            :, :min(n_probe, L1 - L0)]
        own = local.gather(1, sel)
        key = torch.where(own[:, :, None], sel[:, :, None] * ml
                          + torch.arange(ml, device=probes.device),
                          torch.full((), _KEY_MAX, device=probes.device))
        key = key.reshape(nq, -1)
        order = None
        if s == 0 and nc > nc0:
            key = torch.cat([key, (nc0 + torch.arange(
                nc - nc0, device=key.device)).expand(nq, nc - nc0)], dim=1)
            order = torch.sort(key, dim=1, stable=True).indices
            key = key.gather(1, order)
        return sel, own, key, order

    def _layout(self, s: int, probes, nc0: int, nc: int):
        """Shard s's compacted slab for a query block, its columns in
        ascending key order (``_keys``): owned slots first, in slot
        order, then filler slots of id -1.  Returns (ids (nq, ncl)
        int32, -1 invalid; codes (nq, ncl, Kc) stored rows; key)."""
        sel, own, key, order = self._keys(s, probes, nc0, nc)
        nq = probes.shape[0]
        rows = torch.where(own, probes.gather(1, sel).long()
                           - self.list_rows[s][0], torch.zeros_like(sel))
        ids = torch.where(own[:, :, None], self.lists[s][rows],
                          torch.full((), -1, dtype=torch.int32,
                                     device=probes.device)).reshape(nq, -1)
        codes = self.list_codes[s][rows].reshape(nq, ids.shape[1], -1)
        if order is not None:
            extra = key.shape[1] - ids.shape[1]
            ids = torch.nn.functional.pad(ids, (0, extra), value=-1)
            codes = torch.nn.functional.pad(codes, (0, 0, 0, extra))
            ids, codes = ids.gather(1, order), _gather_rows(codes, order)
        return ids.contiguous(), codes.contiguous(), key

    def _block(self, qs, k: int, n_probe: int, pred):
        K, cb = self.C.shape[0], self.code_bits
        quant = self.lut_dtype == "int8"
        dense = pred is not None or self.refine_cap is not None
        luts = build_lut(qs, self.C)
        probes = coarse_probe(qs, self.centroids, n_probe)
        nc0 = n_probe * self.max_len
        nc = max(nc0, k)
        rep = self._per_device(
            crude_lut_operands(luts, self.fast, quantized=quant,
                               code_bits=cb)
            + (slow_lut_operand(luts, self.fast, code_bits=cb), luts,
               self.fast, probes, pred))
        owners = [s for s, (a, b) in enumerate(self.list_rows) if b > a]
        live = [s for s in owners if s not in self.dead_shards]
        lay, crude_of = {}, {}

        # phase 1 on the live shards: the slab crude top-k of slab
        # positions and its candidates' full distances
        cols = []
        for s in live:
            lf, sc, of, _, lu, fm, pr, pd = rep[self.devices[s]]
            ids, codes, key = lay[s] = self._layout(s, pr, nc0, nc)
            valid = ids >= 0
            safe = torch.where(valid, ids, torch.zeros_like(ids))
            if pd is not None:
                valid = valid & pd[safe.long()]
                ids = torch.where(valid, ids, torch.full_like(ids, -1))
            kl = min(k, ids.shape[1])
            crude, v, pos = ops.ivf_crude_topk(
                codes, ids, lf, kl, lut_scale=sc, lut_offset=of,
                code_bits=cb)
            ok = torch.isfinite(v)
            cand = widen_codes(_gather_rows(
                codes, torch.where(ok, pos, torch.zeros_like(pos))), K, cb)
            full = (base.lut_sum(lu, cand) if dense and not quant
                    else v + base.lut_sum(lu, cand, ~fm))
            crude_of[s] = (crude, safe, valid)
            cols.append((_sanitize(v).to(self.lead),
                         key.gather(1, pos.long()).to(self.lead),
                         full.to(self.lead)))
        sv, _, sf = _gather_sorted(cols, k)
        far = torch.argmax(torch.where(torch.isfinite(sv), sf,
                                       torch.full_like(sf, -_INF)), dim=1)
        thr = sv.gather(1, far[:, None])[:, 0] + self.sigma

        # phase 2: the live shards refine against the global threshold;
        # a dead shard's positions rank +inf with id 0, as an emptied
        # list's do
        cap = (None if self.refine_cap is None
               else min(max(self.refine_cap, k), nc))
        n_cand = torch.zeros(qs.shape[0], dtype=torch.int64,
                             device=self.lead)
        n_pass = torch.zeros_like(n_cand)
        cols = []
        for s in owners:
            if s in self.dead_shards:
                key = self._keys(s, probes, nc0, nc)[2]
                key = key[:, :min(k if cap is None else cap, key.shape[1])]
                inf = torch.full(key.shape, _INF, device=self.lead)
                zero = torch.zeros(key.shape, dtype=torch.int32,
                                   device=self.lead)
                cols.append((inf, key) + ((zero,) if cap is None
                                          else (inf, zero)))
                continue
            ids, codes, key = lay[s]
            width = min(k if cap is None else cap, ids.shape[1])
            dev = self.devices[s]
            _, _, _, ls, lu, _, _, _ = rep[dev]
            crude, safe, valid = crude_of[s]
            t = thr.to(dev)
            passed = crude < t[:, None]
            n_cand += valid.sum(dim=1).to(self.lead)
            n_pass += passed.sum(dim=1).to(self.lead)
            if cap is None:
                d, pos = ops.ivf_refine_topk(codes, ls, crude, t, width,
                                             code_bits=cb)
                pos = torch.clamp(pos.long(), max=ids.shape[1] - 1)
                cols.append((_sanitize(d).to(self.lead),
                             key.gather(1, pos).to(self.lead),
                             safe.gather(1, pos).to(self.lead)))
            else:
                v, pos = ops.select_topk(crude, t, width)
                pos = pos.long()
                full = _survivor_full(_gather_rows(codes, pos), lu, v, cb)
                cols.append((v.to(self.lead),
                             key.gather(1, pos).to(self.lead),
                             full.to(self.lead),
                             safe.gather(1, pos).to(self.lead)))
        if cap is None:
            dist, _, ids = _gather_sorted(cols, k)
        else:
            v, _, full, surv = _gather_sorted(cols, cap)
            dist, pos = topk_two_key(torch.where(
                torch.isfinite(v), full, torch.full_like(full, _INF)), k)
            ids = surv.gather(1, pos.long())
        if pred is not None:
            ids = mask_filtered_ids(ids, dist)
        # counts are exact in any order
        return ids, dist, n_cand.to(torch.float32), n_pass.to(torch.float32)

    def search(self, queries, topk: Optional[int] = None, *,
               filter=None) -> SearchResult:
        """queries (nq, d) f32 -> SearchResult with the IVF Average-Ops
        accounting; ids, distances and counts equal bit for bit to the
        unsharded index's.  ``filter``: optional (n,) bool row predicate,
        served under every backend (list-sharded ids are global, so
        every shard reads the whole predicate)."""
        k = self.topk if topk is None else topk
        pred = None if filter is None else as_filter(filter, self.n,
                                                     self.lead)
        _check_refine_cap(self.refine_cap, self._be)
        check_n_probe(self.source.ivf, self.n_probe)
        out = chunked_over_queries(
            lambda qs: self._block(qs, k, self.n_probe, pred),
            queries.to(self.lead), self.query_chunk)
        return ivf_ops_result(*out, n=self.n, n_lists=self.n_lists,
                              K=self.C.shape[0],
                              kf=_fast_count(self.structure))


def shard_index(index, mesh):
    """The sharded serving clone of a flat, two-step or IVF index over
    ``mesh`` (which needs a ``data`` axis)."""
    from repro_torch.index.flat import FlatADC, TwoStep
    from repro_torch.index.ivf import IVFTwoStep

    if "data" not in mesh.axis_names:
        raise ValueError(f"sharded serving needs a mesh with a 'data' axis, "
                         f"got axes {mesh.axis_names}")
    for cls, clone in ((IVFTwoStep, ShardedIVFTwoStep),
                       (TwoStep, ShardedTwoStep),
                       (FlatADC, ShardedFlatADC)):
        if isinstance(index, cls):
            return clone(index, mesh)
    raise TypeError(f"cannot shard a {type(index).__name__}")

