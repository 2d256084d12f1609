"""The frozen config tree behind ``repro.api`` (docs/api.md): one
JSON-round-trippable ``ICQConfig`` covering the whole lifecycle —
training (``TrainConfig``), database encoding (``EncodeConfig``), index
construction (``IndexConfig``), serving (``ServeConfig``), and
behavior under faults and deadlines (``ResilienceConfig``).

Every entry point that used to take its own ad-hoc kwarg set
(``trainer.fit``, ``Index.build``, ``build_ann_engine``, the
``launch/{train,serve}.py`` CLIs, ``benchmarks/run.py``) now reads from
this tree; the old kwargs/flags survive as *overrides* on top of a
config.  The tree is:

  - frozen (hashable, safe to share across sessions and jit closures);
  - schema-versioned (``schema_version``) — configs written by a newer
    schema are rejected with a clear error instead of being silently
    misread;
  - validated on construction *and* on ``from_dict``: unknown keys,
    wrong types, and out-of-choice values all name the offending
    ``section.field`` and the accepted values;
  - content-addressed: ``config_hash()`` is the sha256 of the canonical
    (sorted-key, whitespace-free) JSON, recorded in artifact manifests
    so a loaded index can be traced to the exact config that built it.

This is the port's own copy of ``repro.api.config``: the same tree,
fields, defaults and validation, so ``config_hash`` equals the
reference's for the same config and artifacts written by either
package load in the other.  ``serve.backend`` keeps its reference
choices (auto | jnp | pallas): on a CUDA device all three run the
hand-written kernels, auto and pallas as the reference's fused engine
and jnp with the reference's jnp-engine options (``filter``,
``refine_cap``, the capped rung); on the CPU all three run the plain
PyTorch versions (``repro_torch.index.base.resolve_backend``).
``encode.backend="jnp"`` names the plain ICM sweep, which only the CPU
runs (``resolve_encode_backend``).
``TrainConfig.hyperparams`` bridges to the trainer's record
(``repro_torch.configs.base.ICQConfig``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional

SCHEMA_VERSION = 1

# accepted values per "section.field" — the single source the validator,
# the error messages, and docs/api.md all describe
CHOICES = {
    "train.quantizer": ("icq", "sq", "pqn", "pq", "opq", "cq"),
    "train.embed": ("linear", "cnn", "identity"),
    "encode.backend": ("auto", "jnp", "pallas"),
    "index.kind": ("flat", "two-step", "ivf"),
    "index.code_bits": (8, 4),
    "serve.backend": ("auto", "jnp", "pallas"),
    "serve.lut_dtype": ("f32", "int8"),
    "serve.pipeline": ("off", "tiles", "auto"),
}

# the joint trainer modes behind the api quantizer names; the remaining
# names ("pq", "opq", "cq") are the protocol baselines in
# trainer.quantizers driven by the generic init/step/finalize loop
JOINT_MODES = {"icq": "icq", "sq": "cq", "pqn": "pq"}

# float fields with a sign constraint (everything else — alpha2, the
# loss weights' theoretical range — is intentionally unconstrained)
_POSITIVE_FLOATS = {"train.lr", "train.tau",
                    "resilience.backoff_base_ms",
                    "resilience.backoff_max_ms"}
_NONNEG_FLOATS = {"train.pi1", "train.pi2", "train.gamma_p",
                  "train.gamma_icq", "train.gamma_cq",
                  "train.margin_scale", "serve.batch_window_ms"}
# int fields where 0 is meaningful (exceptions to the positive-int rule)
_NONNEG_INTS = {"resilience.max_retries"}


class ConfigError(ValueError):
    """A config failed validation; the message names the offending
    ``section.field`` and what would have been accepted."""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """What to train: quantizer kind, code geometry, embedding, loss
    and prior hyper-parameters, and the epoch loop's shape."""
    quantizer: str = "icq"       # icq | sq | pqn (joint) | pq | opq | cq
    d: int = 16                  # embedding dim
    num_codebooks: int = 8       # K
    codebook_size: int = 256     # m
    num_fast: int = 2            # |K_fast|
    epochs: int = 5
    batch_size: int = 256
    lr: float = 1e-3
    tau: float = 1.0
    embed: str = "linear"        # linear | cnn | identity
    num_classes: int = 10
    img_hw: Optional[int] = None          # cnn embedder input size
    channels: Optional[int] = None        # cnn embedder input channels
    # prior / loss hyper-parameters (paper eq. 4 and §3.3)
    pi1: float = 0.9
    pi2: float = 0.1
    alpha2: float = -10.0
    gamma_p: float = 0.2
    gamma_icq: float = 2.0
    gamma_cq: float = 0.1
    margin_scale: float = 1.0
    learn_embedding: bool = True

    def hyperparams(self, *, icm_iters: int = 3):
        """The paper-level hyper-parameter record
        (``repro_torch.configs.base.ICQConfig``) the trainer layer
        consumes.  ``icm_iters`` comes from the sibling ``EncodeConfig``
        (the api tree keeps encoding knobs out of the train section)."""
        from repro_torch.configs.base import ICQConfig as CoreICQConfig

        return CoreICQConfig(
            d=self.d, num_codebooks=self.num_codebooks,
            codebook_size=self.codebook_size, num_fast=self.num_fast,
            pi1=self.pi1, pi2=self.pi2, alpha2=self.alpha2,
            gamma_p=self.gamma_p, gamma_icq=self.gamma_icq,
            gamma_cq=self.gamma_cq, margin_scale=self.margin_scale,
            icm_iters=icm_iters, learn_embedding=self.learn_embedding)


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """How databases are encoded against the trained codebooks: the
    tiled ICM engine's iteration count, chunking, and backend."""
    icm_iters: int = 3
    chunk: int = 8192            # rows per jitted embed+encode call
    backend: str = "auto"        # auto | jnp | pallas
    point_chunk: Optional[int] = 8192     # Index.add engine chunk


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Which index to build over the encoded database and its
    construction-time parameters."""
    kind: str = "two-step"       # flat | two-step | ivf
    n_lists: int = 64            # ivf coarse cells
    n_probe: int = 8             # ivf probed cells per query
    kmeans_iters: int = 20       # ivf coarse k-means iterations
    refine_cap: Optional[int] = None      # static survivor compaction
    code_bits: int = 8           # 8 | 4 (nibble-packed fast-scan, §12)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """How the index answers query batches: result size, backend
    dispatch, crude-pass LUT precision, tiling/chunking knobs
    (``None`` keeps each index class's own tile defaults), and the
    async serving loop's coalescing/tenancy knobs (``repro.serve``,
    docs/serving.md — ignored by the offline batch paths)."""
    topk: int = 50
    backend: str = "auto"        # auto | jnp | pallas
    lut_dtype: str = "f32"       # f32 | int8 (DESIGN.md §8)
    query_chunk: Optional[int] = None
    block_q: Optional[int] = None
    block_n: Optional[int] = None
    pipeline: str = "off"        # off | tiles | auto (DESIGN.md §13)
    pipeline_tile: Optional[int] = None   # queries per pipeline tile
    batch_window_ms: float = 2.0 # serving loop: max coalescing wait
    batch_tile: int = 32         # serving loop: rows per dispatched tile
    max_queue: int = 4096        # serving loop: queued-row backpressure
    tenant: Optional[str] = None # serving loop: this artifact's tenant name


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """How serving behaves under pressure and faults
    (docs/robustness.md): the default search deadline, the degradation
    ladder's knobs, Pallas→jnp failover retries, and artifact checksum
    policy.  Configs written before this section existed load with
    these defaults (``from_dict`` treats a missing section as ``{}``)."""
    deadline_ms: Optional[float] = None   # default per-batch deadline
    degraded_refine_cap: Optional[int] = None  # "capped" rung's cap
    min_n_probe: int = 1                  # "probes" rung's floor (ivf)
    max_retries: int = 2                  # failover retry budget (0 = none)
    backoff_base_ms: float = 10.0         # retry backoff schedule
    backoff_max_ms: float = 1000.0
    pallas_failover: bool = True          # blacklist pallas on fault
    verify_artifacts: bool = False        # full checksum pass on load


_SECTIONS = {"train": TrainConfig, "encode": EncodeConfig,
             "index": IndexConfig, "serve": ServeConfig,
             "resilience": ResilienceConfig}


@dataclasses.dataclass(frozen=True)
class ICQConfig:
    """The one front door's config: ``train`` + ``encode`` + ``index``
    + ``serve`` + ``resilience`` (docs/api.md has the field-by-field
    reference).

    Build programmatically (``ICQConfig(train=TrainConfig(epochs=8))``),
    from JSON (``ICQConfig.load(path)`` / ``from_json``), or from a base
    config plus dotted CLI-style overrides
    (``cfg.with_overrides({"train.epochs": 8})``).  Validation runs on
    every construction path and raises ``ConfigError`` naming the
    offending field."""
    schema_version: int = SCHEMA_VERSION
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    encode: EncodeConfig = dataclasses.field(default_factory=EncodeConfig)
    index: IndexConfig = dataclasses.field(default_factory=IndexConfig)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig)

    def __post_init__(self):
        _validate(self)

    # --------------------------------------------------------- to/from --
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, data: Any) -> "ICQConfig":
        if not isinstance(data, dict):
            raise ConfigError(
                f"config root must be a JSON object, got {type(data).__name__}")
        version = data.get("schema_version", None)
        if version is None:
            raise ConfigError(
                "config is missing 'schema_version' — not an api config "
                f"(this build writes schema_version={SCHEMA_VERSION})")
        if not isinstance(version, int) or isinstance(version, bool):
            raise ConfigError(
                f"schema_version must be an int, got {version!r}")
        if version != SCHEMA_VERSION:
            raise ConfigError(
                f"config schema_version={version} is not supported by this "
                f"build (reads exactly {SCHEMA_VERSION}); "
                + ("re-export it with a matching version"
                   if version > SCHEMA_VERSION else
                   "migrate it to the current schema"))
        unknown = set(data) - set(_SECTIONS) - {"schema_version"}
        if unknown:
            raise ConfigError(
                f"unknown config section(s) {sorted(unknown)}; expected "
                f"{sorted(_SECTIONS)} (+ schema_version)")
        sections = {}
        for name, section_cls in _SECTIONS.items():
            sections[name] = _section_from_dict(section_cls,
                                                data.get(name, {}), name)
        return cls(schema_version=version, **sections)

    @classmethod
    def from_json(cls, text: str) -> "ICQConfig":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise ConfigError(f"config is not valid JSON: {e}") from None
        return cls.from_dict(data)

    @classmethod
    def load(cls, path: str) -> "ICQConfig":
        """Read + validate a config JSON file."""
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            raise ConfigError(f"cannot read config {path!r}: {e}") from None
        try:
            return cls.from_json(text)
        except ConfigError as e:
            raise ConfigError(f"{path}: {e}") from None

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    # -------------------------------------------------------- overrides --
    def with_overrides(self, overrides: Dict[str, Any]) -> "ICQConfig":
        """A new config with dotted-path overrides applied — the CLI
        bridge (``--icq-epochs 4`` becomes ``{"train.epochs": 4}``).
        Unknown paths raise ``ConfigError``; values are validated like
        any other construction."""
        if not overrides:
            return self
        data = self.to_dict()
        for path, value in overrides.items():
            section, _, field = path.partition(".")
            if section not in _SECTIONS or not field:
                raise ConfigError(
                    f"override path {path!r} must be 'section.field' with "
                    f"section in {sorted(_SECTIONS)}")
            if field not in {f.name for f in
                             dataclasses.fields(_SECTIONS[section])}:
                raise ConfigError(
                    f"unknown override field {path!r}; {section} has: "
                    f"{sorted(f.name for f in dataclasses.fields(_SECTIONS[section]))}")
            data[section][field] = value
        return ICQConfig.from_dict(data)

    # ------------------------------------------------------------- hash --
    def config_hash(self) -> str:
        """sha256 of the canonical JSON — the identity recorded in
        artifact manifests (``repro.api.artifacts``)."""
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(canon.encode("utf-8")).hexdigest()


# ----------------------------------------------------------- validation ----

def _type_ok(value, py_type, optional: bool) -> bool:
    if value is None:
        return optional
    if py_type is int:
        return isinstance(value, int) and not isinstance(value, bool)
    if py_type is float:
        return (isinstance(value, (int, float))
                and not isinstance(value, bool))
    if py_type is bool:
        return isinstance(value, bool)
    if py_type is str:
        return isinstance(value, str)
    return True


def _field_spec(f: dataclasses.Field):
    """(py_type, optional) from the field's (string) annotation."""
    ann = f.type if isinstance(f.type, str) else getattr(
        f.type, "__name__", str(f.type))
    optional = ann.startswith("Optional[")
    if optional:
        ann = ann[len("Optional["):-1]
    return {"int": int, "float": float, "bool": bool,
            "str": str}.get(ann, object), optional


def _check_field(section: str, f: dataclasses.Field, value):
    where = f"{section}.{f.name}"
    py_type, optional = _field_spec(f)
    if not _type_ok(value, py_type, optional):
        want = py_type.__name__ + (" or null" if optional else "")
        raise ConfigError(
            f"{where} must be {want}, got {value!r} "
            f"({type(value).__name__})")
    choices = CHOICES.get(where)
    if choices is not None and value not in choices:
        raise ConfigError(
            f"{where}={value!r} is not one of {list(choices)}")
    if value is None or optional:
        return
    if py_type is int and where in _NONNEG_INTS:
        if value < 0:
            raise ConfigError(f"{where} must be >= 0, got {value!r}")
    elif py_type is int and value <= 0:
        raise ConfigError(f"{where} must be a positive int, got {value!r}")
    if where in _POSITIVE_FLOATS and value <= 0:
        raise ConfigError(f"{where} must be > 0, got {value!r}")
    if where in _NONNEG_FLOATS and value < 0:
        raise ConfigError(f"{where} must be >= 0, got {value!r}")


def _section_from_dict(section_cls, data: Any, section: str):
    if not isinstance(data, dict):
        raise ConfigError(f"config section {section!r} must be a JSON "
                          f"object, got {type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(section_cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ConfigError(
            f"unknown field(s) {sorted(unknown)} in section {section!r}; "
            f"valid fields: {sorted(fields)}")
    kwargs = {}
    for name, f in fields.items():
        if name in data:
            value = data[name]
            py_type, _ = _field_spec(f)
            # JSON has one number type: accept ints for float fields
            if py_type is float and isinstance(value, int) \
                    and not isinstance(value, bool):
                value = float(value)
            kwargs[name] = value
    return section_cls(**kwargs)


def _validate(cfg: "ICQConfig"):
    if cfg.schema_version != SCHEMA_VERSION:
        raise ConfigError(
            f"config schema_version={cfg.schema_version!r} is not "
            f"supported by this build (reads exactly {SCHEMA_VERSION})")
    for section, section_cls in _SECTIONS.items():
        obj = getattr(cfg, section)
        if not isinstance(obj, section_cls):
            raise ConfigError(
                f"config.{section} must be a {section_cls.__name__}, "
                f"got {type(obj).__name__}")
        for f in dataclasses.fields(section_cls):
            _check_field(section, f, getattr(obj, f.name))
    if cfg.train.num_fast >= cfg.train.num_codebooks:
        raise ConfigError(
            f"train.num_fast={cfg.train.num_fast} must be < "
            f"train.num_codebooks={cfg.train.num_codebooks} (the slow "
            "group cannot be empty)")
    if cfg.index.n_probe > cfg.index.n_lists:
        raise ConfigError(
            f"index.n_probe={cfg.index.n_probe} cannot exceed "
            f"index.n_lists={cfg.index.n_lists}")
    if cfg.index.code_bits == 4 and cfg.train.codebook_size > 16:
        raise ConfigError(
            f"index.code_bits=4 requires "
            f"train.codebook_size={cfg.train.codebook_size} <= 16 (4-bit "
            "codes address at most 16 codewords per codebook); set "
            "train.codebook_size <= 16 or keep index.code_bits=8")
    if cfg.train.embed == "cnn" and (cfg.train.img_hw is None
                                     or cfg.train.channels is None):
        raise ConfigError(
            "train.embed='cnn' needs train.img_hw and train.channels")
    res = cfg.resilience
    if res.deadline_ms is not None and res.deadline_ms <= 0:
        raise ConfigError(
            f"resilience.deadline_ms must be > 0 (or null), got "
            f"{res.deadline_ms!r}")
    if res.degraded_refine_cap is not None and res.degraded_refine_cap < 1:
        raise ConfigError(
            f"resilience.degraded_refine_cap must be >= 1 (or null), got "
            f"{res.degraded_refine_cap!r}")
    if res.backoff_max_ms < res.backoff_base_ms:
        raise ConfigError(
            f"resilience.backoff_max_ms={res.backoff_max_ms} cannot be "
            f"smaller than resilience.backoff_base_ms={res.backoff_base_ms}")
