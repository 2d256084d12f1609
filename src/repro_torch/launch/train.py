"""Training command of the port (twin of ``repro.launch.train``): an LM
(``--arch``) or the retrieval pipeline (``--icq``), on the card, or on
the CPU with ``--device cpu``.

``--arch`` trains the LM of a config from random weights (``init`` from
seed 0) on the synthetic ``TokenPipeline`` stream: microbatches of the
arch's ``microbatch_size`` accumulate into one step
(``launch.steps.build_train_step``: remat, the flash kernel's backward
kernels on the card, AdamW on the cosine schedule), under
``TrainSupervisor``'s checkpointing (every ``--save-every`` steps and
the last) into ``--ckpt-dir``.  Each step prints ``step N loss= gnorm=
dt=``, the run ``done: ...``, as the reference's command.  ``--resume``
continues from the newest checkpoint of ``--ckpt-dir`` and replays the
token stream from the next step (the pipeline's state is the step
index), so the resumed steps equal an uninterrupted run's bit for bit;
without it a directory that already holds checkpoints is refused (the
reference resumes from whatever its directory holds).  With no
``--ckpt-dir`` the checkpoints go to a new temporary directory:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --seq-len 2048 --global-batch 16 --steps 4 --save-every 2 \
        --ckpt-dir /path/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --seq-len 2048 --global-batch 16 --steps 6 --save-every 2 \
        --ckpt-dir /path/ck --resume
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --device cpu --steps 3 --seq-len 32 --global-batch 4

``--icq`` trains the joint quantizer through the front door
(``repro_torch.api.icq_session``) on a synthetic Table-1 dataset,
optionally data-parallel over ``--icq-shards`` mesh positions, then
builds the serving index, grows it with held-out rows through
``Searcher.add``, serves a query batch and the held-out rows' own
queries (their self-recall), and with ``--save-artifacts`` saves the
model and index as one artifact directory, which either package's
``load_ann_engine`` serves:

    PYTHONPATH=src python -m repro_torch.launch.train --icq --icq-epochs 4
    PYTHONPATH=src python -m repro_torch.launch.train --icq --icq-shards 4
    PYTHONPATH=src python -m repro_torch.launch.train --icq --device cpu \\
        --icq-n 1000 --icq-epochs 1 --save-artifacts /path/run0

"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np


def make_host_batch(pipe, cfg, shape, n_micro, step):
    """The step's batch from the token stream, microbatch-major (n_micro,
    B / n_micro, ...) numpy: the VLM's text cut to leave room for its
    patches and seeded patch embeddings, whisper's seeded audio frames
    (the reference launcher's draws, bit for bit)."""
    raw = pipe.batch(step)
    B = shape.global_batch

    def shape_mb(x):
        return x.reshape((n_micro, B // n_micro) + x.shape[1:])

    batch = {k: shape_mb(v) for k, v in raw.items()}
    if cfg.frontend == "vision_stub":
        v = cfg.num_vision_tokens
        batch["tokens"] = batch["tokens"][..., : shape.seq_len - v]
        batch["labels"] = batch["labels"][..., : shape.seq_len - v]
        batch["patch_emb"] = np.random.default_rng(step).standard_normal(
            (n_micro, B // n_micro, v, cfg.vision_dim)).astype(np.float32)
    if cfg.encdec:
        batch["audio_emb"] = np.random.default_rng(step).standard_normal(
            (n_micro, B // n_micro, cfg.encoder_seq_len, cfg.d_model)
        ).astype(np.float32)
    return batch


def run_lm(args):
    """Train ``args.arch`` under the supervisor; returns {"losses",
    "gnorms", "dts": by step index, "state": the final {"params", "opt"},
    "step_fn": the supervisor's step function (``step_fn(state, i) ->
    (state, metrics)``), "report", "ckpt_dir", "n_micro", "cfg"}."""
    import torch

    from repro_torch.configs import ShapeSpec, get_config, smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.distributed import CheckpointManager, TrainSupervisor
    from repro_torch.distributed.sharding import axis_size
    from repro_torch.index.base import resolve_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_train_step, num_microbatches

    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None:
        if args.resume:
            raise SystemExit("--resume needs the --ckpt-dir to resume from")
        ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    if ckpt.all_steps() and not args.resume:
        raise SystemExit(f"--ckpt-dir {ckpt_dir} holds checkpoints (steps "
                         f"{ckpt.all_steps()}); pass --resume to continue "
                         "from the newest, or name another directory")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeSpec(name="cli", seq_len=args.seq_len,
                      global_batch=args.global_batch, kind="train")
    mesh = make_host_mesh(device)
    n_micro = num_microbatches(cfg, shape, axis_size(mesh, "data"))

    train_step, model, opt, init_opt = build_train_step(
        cfg, n_micro=n_micro, mesh=mesh)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    state = {"params": params, "opt": init_opt(params)}
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                         global_batch=shape.global_batch)
    sup = TrainSupervisor(ckpt, save_every=args.save_every)
    losses, gnorms, dts = {}, {}, {}

    def one_step(state, idx):
        batch = make_host_batch(pipe, cfg, shape, n_micro, idx)
        t0 = time.time()
        p, o, metrics = train_step(state["params"], state["opt"], batch)
        loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
        dts[idx] = time.time() - t0
        losses[idx], gnorms[idx] = loss, gnorm
        print(f"step {idx:5d} loss={loss:8.4f} gnorm={gnorm:7.3f} "
              f"dt={dts[idx]:5.2f}s", flush=True)
        return {"params": p, "opt": o}, {"loss": loss}

    state, report = sup.run(state, one_step, args.steps)
    print(f"done: final_step={report.final_step} restarts={report.restarts} "
          f"resumed_from={report.resumed_from}", flush=True)
    return dict(losses=losses, gnorms=gnorms, dts=dts, state=state,
                step_fn=one_step, report=report, ckpt_dir=ckpt_dir,
                n_micro=n_micro, cfg=cfg)


def icq_config_from_args(args):
    """The run's ``repro_torch.api.ICQConfig``: ``--config path.json``
    (validated, schema-versioned) or the CLI default, with the legacy
    flags applied as dotted overrides; a flag left at its ``None``
    default defers to the config."""
    from repro_torch.api import ICQConfig, ServeConfig, TrainConfig

    if args.config is not None:
        cfg = ICQConfig.load(args.config)
    else:                       # the historical CLI defaults
        cfg = ICQConfig(
            train=TrainConfig(codebook_size=64, epochs=3, batch_size=256),
            serve=ServeConfig(topk=20, backend="jnp"))
    overrides = {}
    if args.icq_epochs is not None:
        overrides["train.epochs"] = args.icq_epochs
    if args.icq_batch is not None:
        overrides["train.batch_size"] = args.icq_batch
    if args.icq_index is not None:
        overrides["index.kind"] = args.icq_index
    return cfg.with_overrides(overrides)


def run_icq(args):
    """Train -> index -> add -> query -> (save): the retrieval pipeline
    through the front door, on ``args.device`` (the card unless it names
    the CPU).  The CLI's default ``serve.backend = "jnp"`` serves on
    both: through the CUDA kernels (with the jnp engine's options) on
    the card, through their plain versions on the CPU, so the saved
    config hash is the reference CLI's on both."""
    import torch

    from repro_torch.api import icq_session
    from repro_torch.data import make_table1_dataset
    from repro_torch.index.base import recall_at, resolve_device

    device = resolve_device(args.device)
    cfg = icq_config_from_args(args)
    xtr, ytr, xte, yte = make_table1_dataset(args.icq_dataset)
    xtr, ytr = xtr[: args.icq_n], ytr[: args.icq_n]
    n_held = max(args.icq_add, 1)
    x_held, xtr = xtr[-n_held:], xtr[:-n_held]       # rows added post-build
    ytr = ytr[:-n_held]

    mesh = None
    if args.icq_shards > 1:
        # N positions over the visible cards (or the CPU), each device
        # repeated over a block of positions when there are fewer
        from repro_torch.distributed.sharding import make_mesh_auto
        mesh = make_mesh_auto((args.icq_shards,), ("data",),
                              devices=None if device.type == "cuda"
                              else device)

    session = icq_session(cfg, device=device)
    t0 = time.time()
    model = session.fit(xtr, ytr, seed=args.seed, mesh=mesh, verbose=True)
    print(f"icq: fit n={xtr.shape[0]} epochs={cfg.train.epochs} "
          f"shards={args.icq_shards} in {time.time() - t0:.1f}s; "
          f"psi={int(model.structure.xi.sum())}/{cfg.train.d} "
          f"fast={int(model.structure.fast_mask.sum())}"
          f"/{cfg.train.num_codebooks}")

    searcher = session.index(mesh=mesh, seed=args.seed + 1)
    n0 = searcher.n
    searcher.add(x_held)                             # incremental build
    res = searcher.search(xte[:64])
    # the held-out rows must be findable: query with themselves
    n_self = min(n_held, 16)
    self_res = searcher.search(x_held[:n_self])
    self_ids = torch.arange(n0, n0 + n_self,
                            device=self_res.indices.device)[:, None]
    hit = float(recall_at(self_res.indices, self_ids))
    print(f"icq: index={cfg.index.kind} grown {n0} -> {searcher.n}; "
          f"query batch ok (pass_rate={float(res.pass_rate):.3f}); "
          f"added-row self-recall@{cfg.serve.topk}={hit:.3f}")

    if args.save_artifacts:
        path = searcher.save(args.save_artifacts)
        print(f"icq: artifacts (config hash "
              f"{cfg.config_hash()[:12]}) -> {path}; reload with "
              "launch/serve.py --load-artifacts or "
              "repro_torch.api.load_ann_engine")
    return searcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="train this LM (configs.list_archs())")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the arch family")
    ap.add_argument("--ckpt-dir", default=None,
                    help="--arch checkpoints (default: a new temporary "
                         "directory)")
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint of "
                         "--ckpt-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--icq", action="store_true",
                    help="run the retrieval trainer pipeline (no LM): "
                         "fit -> index -> add -> query")
    ap.add_argument("--config", default=None,
                    help="ICQConfig JSON driving the --icq run; the --icq-* "
                         "flags below override individual fields")
    ap.add_argument("--save-artifacts", default=None, metavar="DIR",
                    help="after the --icq run, save config + model + index "
                         "(repro_torch.api.Artifacts); reload with "
                         "launch/serve.py --load-artifacts DIR")
    ap.add_argument("--icq-dataset", default="dataset2")
    ap.add_argument("--icq-n", type=int, default=4000)
    ap.add_argument("--icq-epochs", type=int, default=None,
                    help="override train.epochs (config default: 3)")
    ap.add_argument("--icq-batch", type=int, default=None,
                    help="override train.batch_size (config default: 256)")
    ap.add_argument("--icq-shards", type=int, default=1,
                    help="data-parallel training/serving mesh size")
    ap.add_argument("--icq-index", default=None,
                    choices=["flat", "two-step", "ivf"],
                    help="override index.kind (config default: two-step)")
    ap.add_argument("--icq-add", type=int, default=64,
                    help="held-out rows appended via Searcher.add after "
                         "the build")
    args = ap.parse_args(argv)

    if args.icq:
        return run_icq(args)
    if args.arch is None:
        ap.error("--arch is required unless --icq is given")
    return run_lm(args)


if __name__ == "__main__":
    main()
