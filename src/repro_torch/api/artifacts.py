"""Persistent artifacts (twin of ``repro.api.artifacts``): one directory
with ``manifest.json`` (format version, config and config hash, array
inventory, model and index metadata) and ``arrays.npz``.  The layout is
the reference's, so a directory written by either package loads in the
other.

Guarantees, as in the reference: atomic saves (stage into
``<path>.tmp``, swap by renames; ``load`` recovers a ``<path>.old`` left
by a crash inside the swap), verified loads (format version, npz byte
size, per-array dtype and shape, and with ``verify_checksums`` the
sha256 of every tensor), each failure an ``ArtifactError`` naming what
failed, and a bitwise round trip: fit -> save -> load -> search serves
the in-process ids and distances.

The model section (embedding params, codebooks, database codes,
structure, variance estimate) serializes any ``trainer.base.ICQModel``
whose embedder is a built-in (linear / cnn / identity): the apply
function is rebuilt from the recorded kind, as in the reference.  An
OPQ model's embedding is its rotation R (``model/embed/R``) folded into
the apply; neither package records that apply, so its reload raises an
``ArtifactError`` naming the rotation, where the reference's embed
fails later with a bare ``KeyError`` (ROADMAP.md section 3).

An IVF index stores its partition (``index/ivf/{centroids,lists,
list_lens}``, meta ``imbalance``, ``n_probe``, ``list_codes``); the
in-list codes slab is recomputed on load, and ``n_probe`` follows the
(possibly overridden) config, as in the reference.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.api.config import ICQConfig
from repro_torch.index import make_index
from repro_torch.index.flat import FlatADC, TwoStep
from repro_torch.index.ivf import IVFIndex, IVFTwoStep

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_TMP_SUFFIX = ".tmp"
_OLD_SUFFIX = ".old"
_STRUCTURE = ("xi", "fast_mask", "sigma")
# embedders rebuilt from a recorded kind (core/embed.py)
_EMBED_KINDS = ("linear", "cnn", "identity")


class ArtifactError(RuntimeError):
    """An artifact directory failed to load or save; the message says
    which check failed and on what."""


def tensor_sha256(a: np.ndarray) -> str:
    """Content hash of one tensor's raw C-contiguous bytes."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def index_opts(index, serve) -> Dict[str, Any]:
    """Engine options of an index from the config's ``index`` and
    ``serve`` sections, shared by ``build_index`` and the artifact
    loader so a loaded index serves as the original did
    (``serve.block_q``/``block_n`` have no counterpart in the port,
    whose kernels choose their own tiles)."""
    opts: Dict[str, Any] = dict(topk=serve.topk, backend=serve.backend,
                                query_chunk=serve.query_chunk,
                                lut_dtype=serve.lut_dtype,
                                code_bits=index.code_bits,
                                pipeline=serve.pipeline,
                                pipeline_tile=serve.pipeline_tile)
    if index.kind != "flat":
        opts["refine_cap"] = index.refine_cap
    if index.kind == "ivf":
        opts["n_probe"] = index.n_probe
    return opts


def index_from_numpy(arrays: Dict[str, np.ndarray], config_dict, *,
                     device=None, imbalance: Optional[float] = None):
    """A port index from the reference's index state: ``index/codes``,
    ``index/C``, ``index/structure/{xi,fast_mask,sigma}`` and, for IVF,
    ``index/ivf/{centroids,lists,list_lens}`` (the keys of
    ``arrays.npz``), built as ``config_dict`` (an ``ICQConfig`` or its
    dict) describes, on ``device`` (the card unless named).  An IVF
    index also takes the manifest's ``imbalance``."""
    config = (config_dict if isinstance(config_dict, ICQConfig)
              else ICQConfig.from_dict(config_dict))
    kind = config.index.kind
    structure, extra = None, {}
    if kind != "flat":
        structure = tuple(np.asarray(arrays[f"index/structure/{k}"])
                          for k in _STRUCTURE)
    if kind == "ivf":
        if imbalance is None:
            raise ArtifactError("an IVF index needs the manifest's "
                                "index.imbalance")
        extra["ivf"] = IVFIndex(
            centroids=np.asarray(arrays["index/ivf/centroids"]),
            lists=np.asarray(arrays["index/ivf/lists"]),
            list_lens=np.asarray(arrays["index/ivf/list_lens"]),
            imbalance=float(imbalance))
    return make_index(kind, np.asarray(arrays["index/codes"]),
                      np.asarray(arrays["index/C"]), structure,
                      device=device, **extra,
                      **index_opts(config.index, config.serve))


def _embed_apply_for(kind: str):
    from repro_torch.core import embed as embed_mod

    if kind == "linear":
        return embed_mod.linear_apply
    if kind == "cnn":
        return embed_mod.cnn_apply
    if kind == "identity":
        return embed_mod.identity_apply
    raise ArtifactError(
        f"unknown embed kind {kind!r} in manifest; this build rebuilds "
        f"{list(_EMBED_KINDS)}")


def _nest(flat: Dict[str, np.ndarray], device) -> Dict:
    """A nested dict of tensors on ``device`` from ``a/b/c``-keyed
    arrays (the embed params are plain nested dicts)."""
    out: Dict = {}
    for key, a in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(a)).to(device)
    return out


def _stored_codes(codes: np.ndarray, m: int) -> np.ndarray:
    """Codes in the reference's stored width: the port keeps m > 256
    codes as int32, the reference stores m <= 65536 as uint16."""
    if codes.dtype == np.int32 and 256 < m <= 65536:
        return codes.astype(np.uint16)
    return codes


def _codes_tensor(a: np.ndarray, device) -> torch.Tensor:
    """Stored codes as the port holds them: uint8, or int32 for the
    reference's uint16 (PyTorch's uint16 covers few ops)."""
    t = torch.from_numpy(np.array(a))
    if t.dtype not in (torch.uint8, torch.int32):
        t = t.to(torch.int32)
    return t.to(device)


@dataclasses.dataclass
class Artifacts:
    """A saved (or about-to-be-saved) system: config + optional trained
    model + optional built index."""
    config: ICQConfig
    model: Optional[Any] = None          # trainer.base.ICQModel
    index: Optional[Any] = None          # FlatADC | TwoStep | IVFTwoStep
    manifest: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------- save --
    def save(self, path: str) -> str:
        """Write the artifact directory atomically; returns ``path``."""
        arrays: Dict[str, np.ndarray] = {}
        manifest: Dict[str, Any] = {
            "format_version": FORMAT_VERSION,
            "config": self.config.to_dict(),
            "config_hash": self.config.config_hash(),
        }
        if self.model is not None:
            manifest["model"] = self._save_model(arrays)
        if self.index is not None:
            manifest["index"] = self._save_index(arrays)
        if self.model is None and self.index is None:
            raise ArtifactError("nothing to save: artifacts need a model, "
                                "an index, or both")
        manifest["arrays"] = {
            k: {"dtype": str(a.dtype), "shape": list(a.shape),
                "sha256": tensor_sha256(a)}
            for k, a in arrays.items()}

        base = path.rstrip("/")
        tmp, old = base + _TMP_SUFFIX, base + _OLD_SUFFIX
        for stale in (tmp, old):
            if os.path.exists(stale):
                shutil.rmtree(stale)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _ARRAYS), **arrays)
        manifest["arrays_bytes"] = os.path.getsize(
            os.path.join(tmp, _ARRAYS))
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)

        if os.path.exists(path):
            os.rename(path, old)
        try:
            os.rename(tmp, path)
        except OSError:
            if os.path.exists(old):      # put the previous version back
                os.rename(old, path)
            raise
        if os.path.exists(old):
            shutil.rmtree(old)
        self.manifest = manifest
        return path

    def _save_model(self, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """The reference's model section: ``model/embed/<path>`` (none
        for an identity embedder), ``model/{C,codes,lam}`` and
        ``model/structure/{xi,fast_mask,sigma}``; meta mode, embed kind
        (the config's ``train.embed``, or identity without params) and
        n.  An OPQ model's params ``{"base", "R"}`` are saved as they
        are, under the config's kind, as the reference saves them."""
        from repro_torch.distributed.checkpoint import flatten_pytree

        model = self.model
        embed_kind = self.config.train.embed
        if model.embed_params is None:
            embed_kind = "identity"
        else:
            for k, a in flatten_pytree(model.embed_params).items():
                arrays[f"model/embed/{k}"] = a
        C = model.C.detach().cpu().numpy()
        arrays["model/C"] = C
        arrays["model/codes"] = _stored_codes(model.codes.cpu().numpy(),
                                              C.shape[1])
        arrays["model/lam"] = model.lam.detach().cpu().numpy()
        for k, t in zip(_STRUCTURE, model.structure):
            arrays[f"model/structure/{k}"] = t.cpu().numpy()
        return {"mode": model.mode, "embed": embed_kind,
                "n": int(model.codes.shape[0])}

    def _save_index(self, arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
        idx = self.index
        kind = {FlatADC: "flat", TwoStep: "two-step",
                IVFTwoStep: "ivf"}.get(type(idx))
        if kind is None:
            raise ArtifactError(
                f"cannot serialize index type {type(idx).__name__}; "
                "supported: FlatADC, TwoStep, IVFTwoStep")
        if idx.code_bits != self.config.index.code_bits:
            raise ArtifactError(
                f"index.code_bits={idx.code_bits} on the index being saved "
                f"disagrees with the config's "
                f"index.code_bits={self.config.index.code_bits}; the "
                "embedded config describes the reload, so align them")
        arrays["index/codes"] = _stored_codes(idx.codes.cpu().numpy(),
                                              idx.C.shape[1])
        arrays["index/C"] = idx.C.cpu().numpy()
        if kind != "flat":
            for k, t in zip(_STRUCTURE, idx.structure):
                arrays[f"index/structure/{k}"] = t.cpu().numpy()
        meta = {"kind": kind, "n": int(idx.codes.shape[0]),
                "code_bits": int(idx.code_bits)}
        if kind == "ivf":
            if int(idx.n_probe) != self.config.index.n_probe:
                raise ArtifactError(
                    f"index.n_probe={int(idx.n_probe)} on the index being "
                    f"saved disagrees with the config's "
                    f"index.n_probe={self.config.index.n_probe}; the "
                    "embedded config describes the reload, so align them")
            for k in ("centroids", "lists", "list_lens"):
                arrays[f"index/ivf/{k}"] = getattr(idx.ivf, k).cpu().numpy()
            meta["imbalance"] = float(idx.ivf.imbalance)
            meta["n_probe"] = int(idx.n_probe)      # informational
            # the port always serves from the in-list codes slab
            meta["list_codes"] = True
        return meta

    # ------------------------------------------------------------- load --
    @classmethod
    def load(cls, path: str, *, overrides=None,
             verify_checksums: Optional[bool] = False,
             device=None, load_model: bool = True) -> "Artifacts":
        """Read and verify an artifact directory and rebuild its model
        and index on ``device`` (the card unless named).  ``overrides``
        (dotted config paths) apply before the index is rebuilt, except
        ``index.kind``, which names the stored layout.
        ``verify_checksums=None`` defers to the embedded
        ``resilience.verify_artifacts``.  ``load_model=False`` verifies
        the model section's arrays but does not rebuild the model (a
        serving engine needs the index alone)."""
        cls._recover(path)
        manifest = cls._read_manifest(path)
        config = cls._config_of(manifest, path, overrides)
        if verify_checksums is None:
            verify_checksums = config.resilience.verify_artifacts
        arrays = cls._load_arrays(path, manifest,
                                  verify_checksums=verify_checksums)
        model = index = None
        if "model" in manifest and load_model:
            model = cls._load_model(path, arrays, manifest["model"], config,
                                    device)
        if "index" in manifest:
            index = cls._load_index(arrays, manifest["index"], config,
                                    device)
        return cls(config=config, model=model, index=index,
                   manifest=manifest)

    @classmethod
    def load_config(cls, path: str, *, overrides=None) -> ICQConfig:
        """The embedded config of an artifact directory, with
        ``overrides`` applied, without reading its arrays."""
        cls._recover(path)
        return cls._config_of(cls._read_manifest(path), path, overrides)

    @staticmethod
    def _config_of(manifest: Dict[str, Any], path: str,
                   overrides) -> ICQConfig:
        config = ICQConfig.from_dict(manifest["config"])
        if overrides:
            if "index.kind" in overrides and overrides["index.kind"] \
                    != config.index.kind:
                raise ArtifactError(
                    f"index.kind cannot be overridden on load (artifacts "
                    f"at {path} store a {config.index.kind!r} index); "
                    "rebuild and re-save to change the index kind")
            config = config.with_overrides(overrides)
        return config

    @staticmethod
    def _recover(path: str) -> None:
        """Finish a save that crashed between its two renames."""
        old = path.rstrip("/") + _OLD_SUFFIX
        if (not os.path.exists(path)
                and os.path.isfile(os.path.join(old, _MANIFEST))):
            os.rename(old, path)

    @staticmethod
    def _read_manifest(path: str) -> Dict[str, Any]:
        manifest_path = os.path.join(path, _MANIFEST)
        if not os.path.isfile(manifest_path):
            raise ArtifactError(
                f"{path!r} is not an artifacts directory (no {_MANIFEST})")
        try:
            with open(manifest_path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise ArtifactError(
                f"{path}: corrupt {_MANIFEST}: {e}") from None
        version = manifest.get("format_version")
        if version != FORMAT_VERSION:
            raise ArtifactError(
                f"{path}: artifact format_version={version!r} is not "
                f"supported (this build reads {FORMAT_VERSION}); "
                "re-export the artifacts with a matching build")
        if "config" not in manifest:
            raise ArtifactError(f"{path}: manifest has no embedded config")
        return manifest

    @staticmethod
    def _load_arrays(path: str, manifest: Dict, *,
                     verify_checksums: bool = False) -> Dict[str, np.ndarray]:
        npz_path = os.path.join(path, _ARRAYS)
        if not os.path.isfile(npz_path):
            raise ArtifactError(f"{path}: missing {_ARRAYS}")
        expected_bytes = manifest.get("arrays_bytes")
        if expected_bytes is not None:
            found = os.path.getsize(npz_path)
            if found != expected_bytes:
                raise ArtifactError(
                    f"{path}: {_ARRAYS} is truncated or padded — expected "
                    f"{expected_bytes} bytes, found {found}")
        try:
            with np.load(npz_path) as z:
                arrays = {k: z[k] for k in z.files}
        except Exception as e:     # any decode failure of the npz file
            raise ArtifactError(f"{path}: corrupt {_ARRAYS}: {e}") from None
        inventory = manifest.get("arrays", {})
        missing = set(inventory) - set(arrays)
        if missing:
            raise ArtifactError(
                f"{path}: {_ARRAYS} is missing array(s) "
                f"{sorted(missing)} listed in the manifest inventory")
        for name, spec in inventory.items():
            a = arrays[name]
            if (str(a.dtype) != spec["dtype"]
                    or list(a.shape) != list(spec["shape"])):
                raise ArtifactError(
                    f"{path}: array {name!r} is {a.dtype}{list(a.shape)} "
                    f"but the manifest records {spec['dtype']}"
                    f"{spec['shape']} — artifact is corrupt or tampered")
            if verify_checksums and "sha256" in spec:
                got = tensor_sha256(a)
                if got != spec["sha256"]:
                    raise ArtifactError(
                        f"{path}: array {name!r} failed checksum "
                        f"verification (sha256 {got[:12]}… != manifest "
                        f"{spec['sha256'][:12]}…) — tensor is corrupted")
        return arrays

    @staticmethod
    def _load_model(path: str, arrays, meta: Dict, config: ICQConfig,
                    device):
        from repro_torch.core.icq import ICQStructure
        from repro_torch.index.base import resolve_device
        from repro_torch.trainer.base import ICQModel

        dev = resolve_device(device)
        needed = ["model/C", "model/codes", "model/lam"] + [
            f"model/structure/{k}" for k in _STRUCTURE]
        missing = [k for k in needed if k not in arrays]
        if missing:
            raise ArtifactError(f"{path}: the model section lacks "
                                f"array(s) {missing}")
        prefix = "model/embed/"
        embed_flat = {k[len(prefix):]: a for k, a in arrays.items()
                      if k.startswith(prefix)}
        if "R" in embed_flat:
            raise ArtifactError(
                f"{path}: the model's embedding holds an OPQ rotation "
                "(model/embed/R), and its apply (the base embedder, then "
                "x @ R) is not recorded: the manifest names the embed "
                f"kind {meta['embed']!r}, which cannot rebuild it; serve "
                "the index with load_ann_engine and rotate the queries "
                "with the fitted model")
        embed_apply = _embed_apply_for(meta["embed"])
        structure = ICQStructure(*(
            torch.from_numpy(np.array(arrays[f"model/structure/{k}"]))
            .to(dev) for k in _STRUCTURE))
        return ICQModel(
            icq_cfg=config.train.hyperparams(
                icm_iters=config.encode.icm_iters),
            embed_params=_nest(embed_flat, dev) if embed_flat else None,
            embed_apply=embed_apply,
            C=torch.from_numpy(np.array(arrays["model/C"])).to(dev),
            codes=_codes_tensor(arrays["model/codes"], dev),
            structure=structure,
            lam=torch.from_numpy(np.array(arrays["model/lam"])).to(dev),
            mode=meta["mode"])

    @staticmethod
    def _load_index(arrays, meta: Dict, config: ICQConfig, device):
        kind = meta["kind"]
        if kind != config.index.kind:
            raise ArtifactError(
                f"manifest index kind {kind!r} disagrees with the embedded "
                f"config's index.kind={config.index.kind!r}")
        stored_bits = int(meta.get("code_bits", 8))
        if stored_bits != config.index.code_bits:
            raise ArtifactError(
                f"index.code_bits cannot be overridden on load (artifacts "
                f"store the {stored_bits}-bit packed layout); re-encode "
                "and re-save to change the code width")
        return index_from_numpy(arrays, config, device=device,
                                imbalance=meta.get("imbalance"))



def save_artifacts(path: str, *, config: ICQConfig, model=None,
                   index=None) -> str:
    """One-call save: ``Artifacts(config, model, index).save(path)``."""
    return Artifacts(config=config, model=model, index=index).save(path)


def load_artifacts(path: str, *, verify_checksums: bool = False,
                   device=None) -> Artifacts:
    """One-call load: ``Artifacts.load(path)`` on ``device`` (the card
    unless named)."""
    return Artifacts.load(path, verify_checksums=verify_checksums,
                          device=device)
