"""The port's package boundary, config and artifacts against the
reference: the port imports neither JAX nor the JAX package, hashes
configs as the reference does, and reads and writes artifact
directories the reference reads and writes."""
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ref_api
from repro.data.synthetic import make_synthetic_index as ref_synthetic
from repro_torch.api import (ArtifactError, Artifacts, ICQConfig,
                             index_from_numpy, load_ann_engine)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _ref_artifact(tmp_path, kind, code_bits, lut_dtype="f32", n=700):
    """A reference-built index saved by the reference; returns (path,
    reference config, reference index)."""
    m = 16 if code_bits == 4 else 256
    cfg = ref_api.ICQConfig().with_overrides({
        "train.codebook_size": m, "index.kind": kind,
        "index.code_bits": code_bits, "serve.topk": 10,
        "serve.backend": "jnp", "serve.lut_dtype": lut_dtype})
    codes, C, st = ref_synthetic(jax.random.PRNGKey(code_bits), n, d=16,
                                 K=8, m=m, num_fast=2, sigma=1.0)
    idx = ref_api.build_index(codes, C, st, index_cfg=cfg.index,
                              serve_cfg=cfg.serve)
    path = str(tmp_path / f"ref-{kind}-{code_bits}")
    ref_api.Artifacts(config=cfg, index=idx).save(path)
    return path, cfg, idx


# ---------------------------------------------------------------- imports --

def test_port_imports_without_jax_or_reference():
    """Every port module and ``chip_smoke`` import with ``jax`` blocked
    and the reference package unimportable."""
    modules = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py"))
    modules = [m.removesuffix(".__init__") for m in modules]
    script = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
        for name in {modules!r} + ["chip_smoke"]:
            importlib.import_module(name)
        assert "jax" not in [m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None]
        print("ok", len(sys.modules))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_sources_name_no_jax_or_reference():
    pattern = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                         r"import repro\b|from repro\.|from repro import)",
                         re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_entry_points_need_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    path, _, _ = _ref_artifact(tmp_path, "two-step", 8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        load_ann_engine(path)
    assert load_ann_engine(path, device="cpu").device.type == "cpu"


# ----------------------------------------------------------------- config --

@pytest.mark.parametrize("overrides", [
    {},
    {"serve.topk": 100, "serve.lut_dtype": "int8"},
    {"train.codebook_size": 16, "index.code_bits": 4,
     "index.kind": "flat", "serve.backend": "pallas"},
    {"resilience.deadline_ms": 5.0, "serve.query_chunk": 32,
     "train.d": 128},
])
def test_config_hash_matches_reference(overrides):
    ref = ref_api.ICQConfig().with_overrides(overrides)
    port = ICQConfig().with_overrides(overrides)
    assert port.to_dict() == ref.to_dict()
    assert port.config_hash() == ref.config_hash()
    assert ICQConfig.from_json(ref.to_json()).config_hash() \
        == ref.config_hash()


# -------------------------------------------------------------- artifacts --

@pytest.mark.parametrize("kind", ["flat", "two-step"])
@pytest.mark.parametrize("code_bits", [8, 4])
def test_reference_artifact_loads_with_equal_arrays(tmp_path, kind,
                                                    code_bits):
    path, cfg, ref_idx = _ref_artifact(tmp_path, kind, code_bits)
    art = Artifacts.load(path, device="cpu", verify_checksums=True)
    idx = art.index
    assert art.config.config_hash() == cfg.config_hash()
    np.testing.assert_array_equal(idx.codes.numpy(),
                                  np.asarray(ref_idx.codes))
    assert idx.codes.dtype == torch.uint8
    np.testing.assert_array_equal(idx.C.numpy(), np.asarray(ref_idx.C))
    assert (idx.code_bits, idx.topk, idx.lut_dtype) == (code_bits, 10, "f32")
    if kind == "two-step":
        for got, want in zip(idx.structure, ref_idx.structure):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same state handed over in memory
    arrays = {"index/codes": np.asarray(ref_idx.codes),
              "index/C": np.asarray(ref_idx.C)}
    if kind == "two-step":
        for k, a in zip(("xi", "fast_mask", "sigma"), ref_idx.structure):
            arrays[f"index/structure/{k}"] = np.asarray(a)
    live = index_from_numpy(arrays, cfg.to_dict(), device="cpu")
    assert torch.equal(live.codes, idx.codes) and torch.equal(live.C, idx.C)


@pytest.mark.parametrize("kind,code_bits", [("two-step", 8), ("flat", 4)])
def test_port_artifact_serves_in_reference(tmp_path, kind, code_bits):
    """Reference save -> port load -> port save -> reference load: the
    reference serves the port-saved directory exactly as the original."""
    path, cfg, ref_idx = _ref_artifact(tmp_path, kind, code_bits)
    port_path = str(tmp_path / "port")
    Artifacts.load(path, device="cpu").save(port_path)
    back = ref_api.Artifacts.load(port_path, verify_checksums=True)
    assert back.manifest["config_hash"] == cfg.config_hash()
    q = jax.random.normal(jax.random.PRNGKey(9), (6, 16))
    want = ref_idx.search(q)
    got = back.index.search(q)
    np.testing.assert_array_equal(np.asarray(got.indices),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(np.asarray(got.distances),
                                  np.asarray(want.distances))


def test_damaged_artifacts_raise_by_name(tmp_path):
    path, _, _ = _ref_artifact(tmp_path, "two-step", 8)
    npz = os.path.join(path, "arrays.npz")
    raw = pathlib.Path(npz).read_bytes()
    # same-size bit rot inside the codes tensor: caught by the checksum
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["index/codes"] = arrays["index/codes"].copy()
    arrays["index/codes"][0, 0] ^= 1
    np.savez(npz, **arrays)
    assert os.path.getsize(npz) == len(raw)
    Artifacts.load(path, device="cpu")      # shape and size still agree
    with pytest.raises(ArtifactError, match="index/codes"):
        Artifacts.load(path, device="cpu", verify_checksums=True)
    pathlib.Path(npz).write_bytes(raw[:-100])
    with pytest.raises(ArtifactError, match="truncated"):
        Artifacts.load(path, device="cpu")
    with pytest.raises(ArtifactError, match="not an artifacts directory"):
        Artifacts.load(str(tmp_path / "missing"), device="cpu")


def test_atomic_save_and_old_recovery(tmp_path):
    path, _, _ = _ref_artifact(tmp_path, "flat", 8)
    art = Artifacts.load(path, device="cpu")
    dst = str(tmp_path / "dst")
    art.save(dst)
    art.save(dst)                     # replaces the live directory
    os.rename(dst, dst + ".old")      # a crash between the two renames
    again = Artifacts.load(dst, device="cpu")
    assert torch.equal(again.index.codes, art.index.codes)
    assert not os.path.exists(dst + ".old")
    with pytest.raises(ArtifactError, match="index.kind cannot be"):
        Artifacts.load(dst, device="cpu",
                       overrides={"index.kind": "two-step"})


def test_model_section_loads_and_is_verified(tmp_path):
    """A manifest with a ``model`` section loads, its model is rebuilt
    (identity embed, the stored C, codes, lam and structure), and the
    model's arrays are held to the inventory."""
    import json
    from repro.api.artifacts import tensor_sha256
    path, _, ref_idx = _ref_artifact(tmp_path, "two-step", 8)
    npz, man = os.path.join(path, "arrays.npz"), os.path.join(
        path, "manifest.json")
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["model/C"] = np.asarray(ref_idx.C)
    arrays["model/codes"] = np.asarray(ref_idx.codes)
    arrays["model/lam"] = np.ones((arrays["model/C"].shape[-1],),
                                  np.float32)
    for k in ("xi", "fast_mask", "sigma"):
        arrays[f"model/structure/{k}"] = arrays[f"index/structure/{k}"]
    manifest = json.loads(pathlib.Path(man).read_text())
    manifest["model"] = {"mode": "icq", "embed": "identity", "n": 700}
    for k, a in arrays.items():
        manifest["arrays"][k] = {"dtype": str(a.dtype),
                                 "shape": list(a.shape),
                                 "sha256": tensor_sha256(a)}
    np.savez(npz, **arrays)
    manifest["arrays_bytes"] = os.path.getsize(npz)
    pathlib.Path(man).write_text(json.dumps(manifest))
    art = Artifacts.load(path, device="cpu", verify_checksums=True)
    assert art.index is not None and "model" in art.manifest
    np.testing.assert_array_equal(art.model.C.numpy(), arrays["model/C"])
    np.testing.assert_array_equal(art.model.codes.numpy(),
                                  arrays["model/codes"])
    assert art.model.embed_params is None and art.model.mode == "icq"
    arrays["model/C"] = arrays["model/C"] + 1.0
    np.savez(npz, **arrays)
    with pytest.raises(ArtifactError, match="model/C"):
        Artifacts.load(path, device="cpu", verify_checksums=True)
