"""Persistent artifacts (the index side of ``repro.api.artifacts``): one
directory with ``manifest.json`` (format version, config and config
hash, array inventory, index metadata) and ``arrays.npz``.  The layout
is the reference's, so a directory written by either package loads in
the other.

Guarantees, as in the reference: atomic saves (stage into
``<path>.tmp``, swap by renames; ``load`` recovers a ``<path>.old`` left
by a crash inside the swap), and verified loads (format version, npz
byte size, per-array dtype and shape, and with ``verify_checksums`` the
sha256 of every tensor), each failure an ``ArtifactError`` naming what
failed.  A manifest with a ``model`` section loads and its arrays are
verified, but only the index is rebuilt: the model loader waits for the
training slice (ROADMAP.md, queue 1, item 9).

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


@dataclasses.dataclass
class Artifacts:
    """A saved (or about-to-be-saved) index with its config."""
    config: ICQConfig
    index: Optional[Any] = None          # FlatADC | TwoStep | IVFTwoStep
    manifest: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------- save --
    def save(self, path: str) -> str:
        """Write the artifact directory atomically; returns ``path``."""
        if self.index is None:
            raise ArtifactError("nothing to save: the port saves an index "
                                "(model artifacts wait for the training "
                                "slice)")
        arrays: Dict[str, np.ndarray] = {}
        manifest: Dict[str, Any] = {
            "format_version": FORMAT_VERSION,
            "config": self.config.to_dict(),
            "config_hash": self.config.config_hash(),
            "index": self._save_index(arrays),
        }
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
        codes = idx.codes.cpu().numpy()
        m = idx.C.shape[1]
        if codes.dtype == np.int32 and 256 < m <= 65536:
            codes = codes.astype(np.uint16)   # the reference's stored width
        arrays["index/codes"] = codes
        arrays["index/C"] = idx.C.cpu().numpy()
        if kind != "flat":
            for k, t in zip(_STRUCTURE, idx.structure):
                arrays[f"index/structure/{k}"] = t.cpu().numpy()
        meta = {"kind": kind, "n": int(codes.shape[0]),
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
             device=None) -> "Artifacts":
        """Read and verify an artifact directory and rebuild its index on
        ``device`` (the card unless named).  ``overrides`` (dotted
        config paths) apply before the index is rebuilt, except
        ``index.kind``, which names the stored layout.
        ``verify_checksums=None`` defers to the embedded
        ``resilience.verify_artifacts``."""
        cls._recover(path)
        manifest = cls._read_manifest(path)
        config = ICQConfig.from_dict(manifest["config"])
        if overrides:
            if "index.kind" in overrides and overrides["index.kind"] \
                    != config.index.kind:
                raise ArtifactError(
                    f"index.kind cannot be overridden on load (artifacts "
                    f"at {path} store a {config.index.kind!r} index); "
                    "rebuild and re-save to change the index kind")
            config = config.with_overrides(overrides)
        if verify_checksums is None:
            verify_checksums = config.resilience.verify_artifacts
        arrays = cls._load_arrays(path, manifest,
                                  verify_checksums=verify_checksums)
        index = None
        if "index" in manifest:
            index = cls._load_index(arrays, manifest["index"], config,
                                    device)
        return cls(config=config, index=index, manifest=manifest)

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

