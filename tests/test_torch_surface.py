"""The package surface of the port's twins: each package holds the
reference's ``__all__``, every exported name resolves, and every name
left out is listed here with the ROADMAP.md item that brings it."""
import importlib

import pytest

# reference names the port does not export yet, with the reason
MISSING = {
    "trainer": {
        # the reference compiles an epoch into one lax.scan; the port's
        # epoch is the plain loop run_epoch, so there is nothing to
        # compile
        "compile_epoch": "none: the port's epoch is run_epoch",
    },
}
PACKAGES = ["", "api", "index", "trainer", "core", "core.baselines",
            "core.train", "core.search", "data", "distributed", "configs",
            "models", "quant"]


def _pair(sub):
    name = f".{sub}" if sub else ""
    return (importlib.import_module(f"repro{name}"),
            importlib.import_module(f"repro_torch{name}"))


@pytest.mark.parametrize("sub", PACKAGES, ids=[p or "root" for p in
                                               PACKAGES])
def test_twin_holds_reference_all(sub):
    ref, port = _pair(sub)
    missing = set(ref.__all__) - set(port.__all__)
    assert missing == set(MISSING.get(sub, {})), sorted(missing)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_root_exports_resolve_lazily():
    import repro_torch
    from repro_torch import api, index, trainer
    assert repro_torch.icq_session is api.icq_session
    assert repro_torch.FlatADC is index.FlatADC
    assert repro_torch.make_quantizer is trainer.make_quantizer
    assert repro_torch.index is index
    with pytest.raises(AttributeError):
        repro_torch.not_a_name     # noqa: B018


def test_index_kinds_map_kind_to_class():
    from repro.index import INDEX_KINDS as REF
    from repro_torch.index import INDEX_KINDS
    assert {k: v.__name__ for k, v in INDEX_KINDS.items()} == {
        k: v.__name__ for k, v in REF.items()}
