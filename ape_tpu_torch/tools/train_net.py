"""Training and evaluation entry point (counterpart of ``tools/train_net.py``):

    python -m ape_tpu_torch.tools.train_net --config-file <config> \\
        [--eval-only] [--resume] key=value ...

The config is read by the port's ``LazyConfig`` (no JAX, flax or PIL) and
the dotted overrides applied; ``do_train`` builds the model
(``model_zoo.build_model``), the criteria, AdamW with its schedule, one
loader a dataset group (the group's mapper from the config, its sampler,
its dataset id), the text router, and runs the ``Trainer`` with periodic
checkpoints and evaluation; ``--eval-only`` (``do_test``) loads
``train.init_checkpoint`` and evaluates every registered test dataset
(``run_eval``).

Training across processes (``parallel.mesh``): ``--num-gpus N`` spawns N
ranks (``launch``; ``--num-machines``, ``--machine-rank`` and
``--dist-url tcp://host:port`` across machines), and torchrun's environment
(``WORLD_SIZE`` > 1) is read as well. The ranks form JAX's mesh: ``fsdp =
gcd(train.fsdp, world)`` and a data axis of the gcd of every group's
micro-batch and ``world // fsdp`` (``mesh.data_axis``); ranks past ``data *
fsdp``, whose devices JAX would leave idle, log that and return without
joining. ``train.fsdp > 1`` shards the model with FSDP2, else DDP wraps it;
each rank loads its chunk of every group's micro-batch (``mesh.batch_rows``)
and the step is the one-process step on the global batch. NCCL on the card
(one card a rank), gloo on the CPU. ``--eval-only`` evaluates in one
process, as JAX's ``run_eval``; evaluation during training runs on the main
rank while the others wait (``mesh.run_on_main``).

The language tower (``build_language``) is ``language.kind``'s: the port's
EVA-CLIP (``eva02clip``, the default) or the BERT, T5 or Llama-2 tower read
from ``language.model_name_or_path``, a Hugging Face directory (JAX's
routes, ``modeling/text/hf_wrappers.py``). Evaluation and the demo encode
their prompts with it; training embeds its prompts by the text router's
hash, as JAX's does, unless ``train.text_tower=True``, which encodes each
step's prompts with the frozen tower (a name vocabulary once, cached), as
the reference model encodes them. The run takes
the CUDA card; with no card it raises unless ``device="cpu"`` is passed to
``main`` or ``train.device=cpu`` is set. The model computes in bfloat16 on
the card (the reference's AMP) and in float32 on the CPU; its parameters are
f32.

The datasets are those the catalog holds: the builtin tables register every
dataset whose files exist under ``$DETECTRON2_DATASETS`` when a config
imports ``ape_tpu.data.datasets`` (its ``metadata``, as most do; the port's
``data/datasets/builtin.py``), and some configs register their own. As
JAX's: ``train.fast_dev_run.enabled`` (20 iterations, eval at 10, a
log line a step, and synthetic data when the config's datasets are not
registered; without it a dataset that is not registered raises, where JAX
falls back to the synthetic data), a group's ``copypaste_prob`` (its mapper
wrapped in the copy-paste mapper), ``iter_size`` (micro-batches a step), ``ema_decay``
(evaluation reads the EMA when there is one), ``dataset_ratio`` (the
per-step group choice), ``init_checkpoint`` (weights only, tolerant) and
``--resume`` (the newest checkpoint of ``train.output_dir``: model,
optimizer, scheduler, EMA, iteration, generator, loaders and text bank).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import sys
import time

import numpy as np
import torch

from ape_tpu_torch.parallel import mesh

logger = logging.getLogger("ape_tpu_torch")


def setup_logger(output_dir: str = "", main: bool = True):
    """INFO lines of the port's logger on stderr and, with ``output_dir``,
    into its ``log.txt`` (a later call moves the file handler); a rank other
    than the main one logs warnings alone, to stderr."""
    logger.setLevel(logging.INFO if main else logging.WARNING)
    if not main:
        output_dir = ""
    fmt = logging.Formatter("[%(asctime)s %(name)s]: %(message)s")
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        logger.addHandler(h)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        h = logging.FileHandler(os.path.join(output_dir, "log.txt"))
        h.setFormatter(fmt)
        logger.addHandler(h)


def synthetic_loader(batch_size, image_size, num_text, text_dim, max_gt=8, mask_size=None,
                     chunk=(0, 1), iter_size=1):
    """fast_dev_run data when no dataset is registered (smoke tests, CI):
    JAX's stream, NumPy on the host. ``batch_size`` is the global batch (of
    ``iter_size`` micro-batches); a rank keeps its ``chunk`` (index, count)
    of every micro-batch (``mesh.local_rows``)."""
    mask_size = mask_size or image_size // 4
    rng = np.random.RandomState(0)

    def gen():
        while True:
            n_valid = rng.randint(1, max_gt)
            boxes = np.zeros((batch_size, max_gt, 4), np.float32)
            boxes[:, :, :2] = rng.uniform(0.3, 0.7, (batch_size, max_gt, 2))
            boxes[:, :, 2:] = rng.uniform(0.1, 0.25, (batch_size, max_gt, 2))
            batch = {
                "images": rng.randn(batch_size, image_size, image_size, 3).astype(np.float32),
                "image_sizes": np.asarray([[image_size, image_size]] * batch_size, np.int32),
                "targets": {
                    "labels": rng.randint(0, num_text, (batch_size, max_gt)).astype(np.int32),
                    "boxes": boxes,
                    "valid": (np.arange(max_gt)[None] < n_valid).repeat(batch_size, 0),
                    "masks": (rng.rand(batch_size, max_gt, mask_size, mask_size) > 0.8
                              ).astype(np.float32),
                },
            }
            if chunk[1] > 1:
                batch = mesh.local_rows(batch, *chunk, iter_size)
            yield batch

    class Loader:
        def __iter__(self):
            return gen()

    return Loader()


def build_language(cfg, device):
    """The frozen language tower of ``cfg.language`` on ``device``: ``kind``
    "eva02clip" (the default) the port's EVA02CLIP; "bert", "t5" and "llama2"
    the Hugging Face towers (``hf_wrappers.build_hf_text_model``, which
    raises ``KeyError`` on any other kind), as JAX's ``build_language``
    routes them."""
    from ape_tpu_torch.modeling.text.wrapper import EVA02CLIP

    lang_cfg = dict(cfg.get("language", {}) or {})
    kind = lang_cfg.pop("kind", "eva02clip")
    if kind != "eva02clip":
        from ape_tpu_torch.modeling.text.hf_wrappers import build_hf_text_model

        lang_cfg.pop("output_dim", None)
        return build_hf_text_model(kind, **lang_cfg, device=device)
    lang_cfg.setdefault("output_dim", int(cfg.train.get("text_dim", 1024)))
    return EVA02CLIP(**lang_cfg, device=device)


def _train_groups(cfg):
    """``cfg.dataloader.train`` as a list of group dicts: its ``groups``, or
    the single-group form."""
    dl = cfg.dataloader.train
    groups = dl.get("groups", None)
    return list(groups) if groups else [dl]


def build_text_fn(cfg, model_language=None):
    """Prompt-routing text features per batch (JAX's ``build_text_fn``)."""
    from ape_tpu_torch.engine.text_router import TextRouter

    groups = _train_groups(cfg)
    prompts = list(cfg.train.get("dataset_prompts", [])
                   or [g.get("prompt", "name") for g in groups])
    return TextRouter(
        model_language=model_language,
        num_text=int(cfg.train.get("num_text", 80)),
        text_dim=int(cfg.train.get("text_dim", 1024)),
        dataset_prompts=prompts,
        dataset_names=[list(g.get("dataset_names", [])) for g in groups],
        num_datasets=len(groups),
        seed=int(cfg.train.get("seed", 0)),
    )


def _build(cfg, device):
    """The model, seeded by ``train.seed`` (torch's default init drawn on
    the CPU; JAX's init draws from its own key, so the random weights
    differ between the two)."""
    from ape_tpu_torch.model_zoo import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(cfg.train.get("seed", 0)))
        model = build_model(cfg, device="cpu",
                            dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    return model.to(device)


@contextlib.contextmanager
def swapped_in(model, ema):
    """The EMA's values in the model's trainable parameters for the block."""
    if ema is None:
        yield model
        return
    params = [p for p in model.parameters() if p.requires_grad]
    saved = [p.detach().clone() for p in params]
    with torch.no_grad():
        for p, e in zip(params, ema):
            p.copy_(e)
    try:
        yield model
    finally:
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)


def do_train(args, cfg, device, fsdp: int = 1) -> dict:
    """Train as the config says (module docstring), on this rank's share
    when a process group is joined (``fsdp``: its FSDP axis). Returns a
    summary: the iterations run, the checkpoints kept, the seconds of each
    save and of the load, the trainer, the model (wrapped, across ranks),
    its optimizer and scheduler, and this rank's (index, count) chunk of
    each group's batch."""
    from ape_tpu_torch.checkpoint.checkpointer import (
        Checkpointer,
        PeriodicCheckpointer,
        ema_state,
        load_ema,
        load_optimizer_state,
        model_state,
        optimizer_state,
    )
    from ape_tpu_torch.checkpoint.convert import load_checkpoint_tolerant
    from ape_tpu_torch.config import instantiate
    from ape_tpu_torch.data.build import (
        build_detection_train_loader,
        load_loader_state,
        loader_state,
    )
    from ape_tpu_torch.data.catalog import DatasetCatalog
    from ape_tpu_torch.data.samplers import MultiDatasetSampler
    from ape_tpu_torch.engine.optimizer import build_optimizer, lr_lambda
    from ape_tpu_torch.engine.train_step import GRAD_CLIP, make_train_step
    from ape_tpu_torch.engine.trainer import Trainer
    from ape_tpu_torch.model_zoo import build_criterion

    train = cfg.train
    if train.fast_dev_run.enabled:
        train.max_iter = 20
        train.eval_period = 10
        train.log_period = 1
    groups = _train_groups(cfg)
    names = [n for g in groups for n in g.get("dataset_names", [])]
    missing = [n for n in names if n not in DatasetCatalog]
    registered = bool(names) and not missing
    if not registered and not train.fast_dev_run.enabled:
        raise ValueError(
            f"training datasets not registered: {missing or 'the config names none'}. The "
            f"configs register them from $DETECTRON2_DATASETS (now "
            f"{os.environ.get('DETECTRON2_DATASETS', 'unset')!r}); "
            "train.fast_dev_run.enabled=True trains on synthetic data instead")
    seed = int(train.get("seed", 0))
    model = _build(cfg, device)
    logger.info(f"model parameters: {sum(p.numel() for p in model.parameters()) / 1e6:.1f}M")
    # the weights load into the one-process model, which DDP then copies and
    # FSDP2 shards (every rank reads the file)
    ckpt = Checkpointer(train.output_dir, keep=2)
    t0 = time.perf_counter()
    state, start_iter = ckpt.resume_or_load(resume=args.resume)
    if state is not None:
        model.load_state_dict(state["model"])
    elif train.get("init_checkpoint", ""):
        load_checkpoint_tolerant(train.init_checkpoint, model)
    load_seconds = time.perf_counter() - t0
    world = mesh.get_world_size()
    if world > 1:
        logger.info(f"mesh (data={world // fsdp}, fsdp={fsdp}): "
                    f"{'FSDP2' if fsdp > 1 else 'DDP'} over {world} ranks")
    model = mesh.wrap_model(model, mesh.make_mesh(world, fsdp, device.type), fsdp)
    module = mesh.unwrap(model)
    n_crit = len(cfg.get("criterions", None) or [cfg.criterion])
    criterions = [build_criterion(cfg, i) for i in range(n_crit)]

    opt_cfg = dict(cfg.optimizer)
    if float(opt_cfg.pop("grad_clip", GRAD_CLIP)) != GRAD_CLIP:
        raise NotImplementedError(f"optimizer.grad_clip={cfg.optimizer.grad_clip}: every config "
                                  f"clips at {GRAD_CLIP}, make_train_step's constant")
    optimizer, scheduler = build_optimizer(module, **opt_cfg)
    factor = lr_lambda(opt_cfg.get("milestones", ()), opt_cfg.get("warmup_steps", 0))
    base_lr = float(opt_cfg.get("base_lr", 2e-4))
    iter_size = int(train.get("iter_size", 1))
    ema_decay = float(train.get("ema_decay", 0.0))
    ema = ([p.detach().clone() for p in module.parameters() if p.requires_grad]
           if ema_decay > 0 else None)
    generator = torch.Generator(device=device).manual_seed(seed)

    img = int(train.get("image_size", 1024))
    num_text = int(train.get("num_text", 80))
    text_dim = int(train.get("text_dim", 1024))
    micro = [int(g.get("batch_size", 1)) for g in groups]
    rows = [mesh.batch_rows(b) for b in micro]  # this rank's rows of each group's batch
    chunks = [(r.index, r.count) for r in rows]
    if registered:
        loaders = [build_detection_train_loader(
            list(g["dataset_names"]), instantiate(g["mapper"]), b // count * iter_size,
            g.get("sampler", "TrainingSampler"), seed=seed + i, rank=index, world_size=count,
            dataset_id=i, filter_empty=bool(g.get("filter_empty", True)),
            copypaste_prob=float(g.get("copypaste_prob", 0.0)))
            for i, (g, b, (index, count)) in enumerate(zip(groups, micro, chunks))]
    else:
        logger.warning("datasets not registered; fast_dev_run trains on synthetic data")
        loaders = [synthetic_loader(b * iter_size, img, num_text, text_dim, chunk=chunk,
                                    iter_size=iter_size) for b, chunk in zip(micro, chunks)]
    ratio = list(train.get("dataset_ratio", [1.0] * len(groups)))
    mds = MultiDatasetSampler(ratio, seed=seed) if len(loaders) > 1 else None
    text_fn = build_text_fn(cfg, build_language(cfg, device) if train.get("text_tower", False)
                            else None)

    t0 = time.perf_counter()
    if state is not None:
        load_optimizer_state(model, optimizer, state["optimizer"])
        scheduler.load_state_dict(state["scheduler"])
        if ema is not None and state.get("ema") is not None:
            load_ema(ema, state["ema"])
        generator.set_state(state["generator"])
        for ld, s, chunk in zip(loaders, state.get("loaders", []), chunks):
            load_loader_state(ld, s, *chunk)
        if mds is not None and state.get("dataset_sampler") is not None:
            mds.load_state_dict(state["dataset_sampler"])
        if state.get("text_bank") is not None:
            text_fn.bank[...] = state["text_bank"]
    load_seconds += time.perf_counter() - t0

    def state_fn():  # on every rank: gathering FSDP2's shards is collective
        return {
            "model": model_state(model),
            "optimizer": optimizer_state(model, optimizer),
            "scheduler": scheduler.state_dict(),
            "ema": ema_state(ema),
            "generator": generator.get_state(),
            "loaders": [loader_state(ld, *chunk) for ld, chunk in zip(loaders, chunks)],
            "dataset_sampler": mds.state_dict() if mds is not None else None,
            "text_bank": text_fn.bank.copy(),
        }

    dataset_prompts = list(train.get("dataset_prompts", []) or [])

    @functools.lru_cache(maxsize=None)
    def _step_fn_for(crit_idx: int, prompt: str, group_rows):
        return make_train_step(model, criterions[crit_idx], optimizer, scheduler,
                               iter_size=iter_size, ema_decay=ema_decay, prompt=prompt, ema=ema,
                               rows=group_rows)

    def step_fn_for(ds_id: int):
        # groups sharing one (criterion, prompt type, rows) share one step function
        prompt = dataset_prompts[ds_id] if ds_id < len(dataset_prompts) else "name"
        return _step_fn_for(min(ds_id, len(criterions) - 1), prompt, rows[ds_id])

    eval_fn = None
    if train.get("eval_period", 0) and cfg.dataloader.get("tests", []):
        def eval_fn():  # on every rank: the main one evaluates, the others wait
            with swapped_in(module, ema):
                return eval_on_main(cfg, model, device)

    trainer = Trainer(
        step_fn_for, loaders, device, generator=generator, dataset_sampler=mds, text_fn=text_fn,
        max_iter=train.max_iter, log_period=train.get("log_period", 20),
        output_dir=train.output_dir,
        checkpointer=PeriodicCheckpointer(ckpt, train.get("checkpoint_period", 5000),
                                          train.max_iter),
        state_fn=state_fn, eval_fn=eval_fn, eval_period=int(train.get("eval_period", 0)),
        lr_fn=lambda it: base_lr * factor(it), profile_dir=train.get("profile_dir", None),
        profile_start=int(train.get("profile_start", 10)),
        profile_iters=int(train.get("profile_iters", 5)),
        sync_debug=bool(train.get("sync_debug", False)))
    trainer.train(start_iter)
    return {"start_iter": start_iter, "max_iter": train.max_iter, "checkpoints": ckpt.kept(),
            "checkpoint_seconds": trainer.checkpoint_seconds, "load_seconds": load_seconds,
            "trainer": trainer, "model": model, "optimizer": optimizer, "scheduler": scheduler,
            "batch_chunks": chunks}


def run_eval(cfg, model, device) -> dict:
    """Evaluate ``model`` on every registered test dataset of the config
    (JAX's ``run_eval``): each dataset's metrics and stage seconds
    (``evaluate_dataset``) under its name."""
    from ape_tpu_torch.config import instantiate
    from ape_tpu_torch.data.catalog import DatasetCatalog
    from ape_tpu_torch.engine.ape_wrapper import APE
    from ape_tpu_torch.evaluation.eval_runner import evaluate_dataset
    from ape_tpu_torch.evaluation.other_evals import aggregate_benchmark_suite

    tests = cfg.dataloader.get("tests", [])
    names = [t["dataset_name"] for t in tests if t["dataset_name"] in DatasetCatalog]
    if not names:
        logger.warning("no registered eval datasets; nothing to evaluate")
        return {}
    lang = build_language(cfg, device)
    keep = [t for t in tests if t["dataset_name"] in names]
    box_list = cfg.dataloader.get("select_box_nums_for_evaluation_list", None)
    fusion_list = cfg.dataloader.get("name_prompt_fusion_text", None)
    if box_list is not None:
        box_list = [int(v) for t, v in zip(tests, box_list) if t["dataset_name"] in names]
    if fusion_list is not None:
        fusion_list = [bool(v) for t, v in zip(tests, fusion_list) if t["dataset_name"] in names]
    ape = APE(model, lang, dataset_names=names,
              dataset_prompts=[t.get("prompt", "name") for t in keep],
              max_text=int(cfg.train.get("num_text", 80)),
              select_box_nums_for_evaluation=int(cfg.train.get("select_box_nums_for_evaluation",
                                                               300)),
              select_box_nums_for_evaluation_list=box_list, name_prompt_fusion_text=fusion_list,
              name_prompt_fusion_type=cfg.train.get("name_prompt_fusion_type", "zero"))
    was_training = model.training
    model.eval()
    results = {}
    try:
        for t in keep:
            name = t["dataset_name"]
            mapper = instantiate(t["mapper"]) if t.get("mapper") is not None else None
            iou_types = tuple(t.get("iou_types") or (
                ("bbox", "segm") if cfg.model.get("mask_on", True) else ("bbox",)))
            results[name] = evaluate_dataset(ape, name, mapper, iou_types,
                                             max_dets=int(t.get("max_dets", 100)),
                                             evaluator_type=t.get("evaluator_type"))
            logger.info(f"{name}: {results[name]}")
    finally:
        model.train(was_training)
    results.update(aggregate_benchmark_suite(results))
    return results


def eval_on_main(cfg, model, device) -> dict:
    """``run_eval`` on the main rank over the whole set while the other
    ranks wait (JAX's ``run_eval`` takes no rank; ``mesh.run_on_main``, a
    wait that outlasts a collective's timeout): DDP's module as it is,
    FSDP2's gathered into a one-process model first (a collective of every
    rank). One process evaluates ``model``; the other ranks return {}."""
    if not torch.distributed.is_initialized():
        return run_eval(cfg, model, device)
    plain = mesh.unwrap(model)
    if mesh.is_sharded(model):
        from ape_tpu_torch.checkpoint.checkpointer import model_state

        state = model_state(model)
        if mesh.is_main_process():
            plain = _build(cfg, device)
            plain.load_state_dict(state)
    return mesh.run_on_main(lambda: run_eval(cfg, plain, device)) or {}


def do_test(args, cfg, device) -> dict:
    """``--eval-only``: the model with ``train.init_checkpoint``'s weights
    (its EMA when the file holds one), evaluated by ``run_eval``."""
    from ape_tpu_torch.checkpoint.convert import load_checkpoint_tolerant

    model = _build(cfg, device)
    init = cfg.train.get("init_checkpoint", "")
    if init:
        load_checkpoint_tolerant(init, model)
        if init.endswith((".pth", ".pt")):
            ema = torch.load(init, map_location="cpu", weights_only=False).get("ema")
            if ema is not None:
                params = [p for p in model.parameters() if p.requires_grad]
                with torch.no_grad():
                    for p, e in zip(params, ema):
                        p.copy_(e)
                logger.info(f"evaluating the EMA of {init}")
    else:
        logger.warning("eval-only with NO init_checkpoint: model AND text tower are "
                       "random-init — metrics are smoke-test noise, not a real evaluation")
    return run_eval(cfg, model, device)


def _setup(argv, device):
    """(args, cfg, device) of a command line: the parsed arguments, the
    config with its overrides, the device (module docstring)."""
    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.device import default_device
    from ape_tpu_torch.engine.defaults import default_argument_parser

    args = default_argument_parser().parse_args(argv)
    cfg = LazyConfig.load(args.config_file)
    LazyConfig.apply_overrides(cfg, [o for o in (args.opts or []) if "=" in o])
    device = torch.device(default_device("train_net", device or cfg.train.get("device", None)))
    return args, cfg, device


def train_ranks(args, cfg, device):
    """Train in this process, one rank of torchrun's or ``launch``'s
    environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; one process
    without them): JAX's mesh arithmetic over the world, the extra ranks
    leaving before they join, the others joining the process group for
    ``do_train`` and leaving it after. Returns ``do_train``'s summary, None
    on a rank that left."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    setup_logger(cfg.train.get("output_dir", ""), main=rank == 0)
    if world <= 1:
        return do_train(args, cfg, device)
    micro = [int(g.get("batch_size", 1)) for g in _train_groups(cfg)]
    data, fsdp = mesh.data_axis(micro, world, int(cfg.train.get("fsdp", 1)))
    used = data * fsdp
    if rank >= used:
        logger.warning(f"rank {rank} leaves: the mesh (data={data}, fsdp={fsdp}) takes {used} of "
                       f"{world} ranks (micro-batches {micro}), as JAX leaves devices idle")
        return None
    if used == 1:
        return do_train(args, cfg, device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    mesh.initialize_distributed(world_size=used, device_type=device.type)
    try:
        return do_train(args, cfg, device, fsdp=fsdp)
    finally:
        torch.distributed.destroy_process_group()


def _rank_main(argv, device):
    """One spawned rank of ``main``'s ``launch``."""
    args, cfg, device = _setup(argv, device)
    train_ranks(args, cfg, device)


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line), load and override the
    config, and train or evaluate. ``device``: where to run (default the
    config's ``train.device``, else the CUDA card, raising without one).
    ``--num-gpus`` (times ``--num-machines``) above 1 spawns the ranks
    (``mesh.launch``) and returns None; one process returns the summary
    of ``do_train`` or the results of ``do_test``."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args, cfg, device = _setup(argv, device)
    if args.eval_only:
        setup_logger(cfg.train.get("output_dir", ""))
        return do_test(args, cfg, device)
    if args.num_gpus * args.num_machines > 1:
        # the ranks unpickle the function by its module's name, which a run
        # as __main__ (python -m) does not give
        from ape_tpu_torch.tools.train_net import _rank_main

        setup_logger(cfg.train.get("output_dir", ""))
        mesh.launch(_rank_main, args.num_gpus, args.num_machines, args.machine_rank,
                    args.dist_url, args=(argv, str(device)), device_type=device.type)
        return None
    return train_ranks(args, cfg, device)


if __name__ == "__main__":
    main()
