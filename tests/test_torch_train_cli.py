"""The port's training command (``repro_torch.launch.train --icq``) and
the serving command's ``--ann-backend`` on the CPU, against the
reference's commands.

``--icq`` runs at a small size (500 rows of dataset2, one epoch, 16
held-out rows): the port's command twice with one seed (in-process),
the reference's once (a subprocess, started first so that its JAX
compile overlaps the port's runs).  The port's lines keep the
reference's three formats and two same-seed runs print the same
numbers; the numbers are not compared across the packages, because
they draw from separate random streams and training is chaotic (a 2e-7
start drifts to ~1e-3, ``scripts/train_divergence.py``).  What crosses
is the artifact: the directory either command saves is served by the
other package's ``load_ann_engine`` with the same ids, and on the CPU
both commands save the same config hash (``serve.backend = "jnp"``).
"""
import contextlib
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api import load_ann_engine as ref_load_ann_engine
from repro_torch.api import load_ann_engine
from repro_torch.launch import train as port_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "JAX_PLATFORMS": "cpu"}
SMALL = ["--icq", "--icq-n", "500", "--icq-epochs", "1", "--icq-add", "16",
         "--seed", "3"]
FIT = re.compile(r"^icq: fit n=(\d+) epochs=(\d+) shards=(\d+) in "
                 r"[0-9.]+s; psi=(\d+)/(\d+) fast=(\d+)/(\d+)$", re.M)
INDEX = re.compile(r"^icq: index=(\S+) grown (\d+) -> (\d+); query batch ok "
                   r"\(pass_rate=([0-9.]+)\); added-row "
                   r"self-recall@(\d+)=([0-9.]+)$", re.M)
SAVED = re.compile(r"^icq: artifacts \(config hash ([0-9a-f]{12})\) -> "
                   r"(\S+); reload with launch/serve.py --load-artifacts "
                   r"or repro(?:_torch)?\.api\.load_ann_engine$", re.M)


def _port_run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port_train.main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port stdout, its dir), twice, and (reference stdout, its dir)."""
    base = tmp_path_factory.mktemp("train_cli")
    ref_dir = str(base / "ref")
    ref = subprocess.Popen(
        [sys.executable, "-m", "repro.launch.train", *SMALL,
         "--save-artifacts", ref_dir], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=ENV)
    try:
        port = []
        for i in range(2):
            d = str(base / f"port{i}")
            port.append((_port_run(SMALL + ["--device", "cpu",
                                            "--save-artifacts", d]), d))
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err
    return port, (out, ref_dir)


def test_train_cli_prints_the_reference_formats(runs):
    port, (ref_out, _) = runs
    for text in (port[0][0], ref_out):
        fit, index, saved = (r.search(text) for r in (FIT, INDEX, SAVED))
        assert fit and index and saved, text
        assert fit.group(1, 2, 3, 5, 7) == ("484", "1", "1", "16", "8")
        assert index.group(1, 2, 3, 5) == ("two-step", "484", "500", "20")
    # the CPU keeps the CLI's serve.backend = "jnp": the reference's hash
    assert SAVED.search(port[0][0]).group(1) == SAVED.search(ref_out).group(1)


def test_train_cli_same_seed_prints_the_same_numbers(runs):
    (a, _), (b, _) = runs[0]
    strip = lambda t: re.sub(r"in [0-9.]+s;", "", re.sub(  # noqa: E731
        r"-> \S+;", "", t))
    assert strip(a) == strip(b)
    assert FIT.search(a) and INDEX.search(a)


def _queries(d, seed=0):
    return np.random.default_rng(seed).standard_normal((8, d)).astype(
        np.float32)


@pytest.mark.parametrize("saved_by", ["port", "reference"])
def test_train_cli_artifacts_serve_in_both_packages(runs, saved_by):
    """The saved index (500 rows after the grow) served by both
    packages' ``load_ann_engine`` on the same embedded-space queries:
    equal ids."""
    path = runs[0][0][1] if saved_by == "port" else runs[1][1]
    port = load_ann_engine(path, device="cpu")
    ref = ref_load_ann_engine(path)
    assert port.n == ref.n == 500
    q = _queries(int(port.index.C.shape[-1]))
    got, want = port(q), ref(q)
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.distances.numpy(),
                               np.asarray(want.distances), rtol=1e-5,
                               atol=1e-5)


def test_train_cli_shards_on_the_cpu():
    """``--icq-shards 2``: the data-parallel fit and the sharded index
    over a CPU mesh of two positions (one device repeated)."""
    text = _port_run(["--icq", "--icq-n", "300", "--icq-epochs", "1",
                      "--icq-add", "8", "--icq-shards", "2", "--device",
                      "cpu"])
    fit, index = FIT.search(text), INDEX.search(text)
    assert fit and fit.group(3) == "2" and index, text
    assert index.group(2, 3) == ("292", "300")


def test_train_cli_arch_exits_naming_item_22(tmp_path):
    """``--arch`` trains now (it exited naming ROADMAP item 22 before LM
    training was ported): the command runs a smoke LM on the CPU and
    prints the reference's step and done lines; with no card and no
    ``--device`` it raises before it trains."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", "mamba2-1.3b", "--smoke", "--device",
                          "cpu", "--steps", "2", "--seq-len", "16",
                          "--global-batch", "2", "--ckpt-dir",
                          str(tmp_path / "ck")], capture_output=True,
                         text=True, timeout=120, env=ENV)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [line.split()[:2] for line in lines[:2]] == [
        ["step", "0"], ["step", "1"]], lines
    assert lines[-1] == "done: final_step=1 restarts=0 resumed_from=None"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            port_train.main(["--arch", "tinyllama-1.1b", "--smoke"])


def test_train_cli_defaults_to_the_card():
    """With no ``--device`` the command runs on the card (where the CLI's
    ``serve.backend = "jnp"`` default becomes ``"auto"``); with no card
    it raises before it trains."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_train.main(SMALL)


def test_serve_cli_takes_ann_backend(runs):
    """``--ann-backend`` with the reference's choices: ``jnp`` serves on
    the CPU (before, the flag was unrecognized), ``auto`` overrides the
    train command's saved ``jnp`` for ``--load-artifacts``; another
    choice is refused by the parser."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--ann",
           "--device", "cpu", "--ann-n", "2000", "--ann-queries", "8",
           "--batches", "1"]
    out = subprocess.run(cmd + ["--ann-backend", "jnp"], capture_output=True,
                         text=True, timeout=120, env=ENV)
    assert out.returncode == 0, out.stderr
    assert "ann: index=two-step n=2000" in out.stdout
    loaded = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--load-artifacts", runs[1][1], "--ann-backend", "auto",
         "--ann-queries", "8", "--batches", "1"], capture_output=True,
        text=True, timeout=120, env=ENV)
    assert loaded.returncode == 0, loaded.stderr
    assert "ann-loaded:" in loaded.stdout and "n=500" in loaded.stdout
    bad = subprocess.run(cmd + ["--ann-backend", "cuda"],
                         capture_output=True, text=True, timeout=120,
                         env=ENV)
    assert bad.returncode == 2 and "invalid choice" in bad.stderr
