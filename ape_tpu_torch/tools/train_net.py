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

One card and one process: ``--num-gpus`` or ``--num-machines`` above 1 and
``train.fsdp > 1`` raise until DDP and FSDP are ported (ROADMAP Queue 1 #3),
as does a language tower of another kind than ``eva02clip``. The run takes
the CUDA card; with no card it raises unless ``device="cpu"`` is passed to
``main`` or ``train.device=cpu`` is set. The model computes in bfloat16 on
the card (the reference's AMP) and in float32 on the CPU; its parameters are
f32.

As JAX's: ``train.fast_dev_run.enabled`` (20 iterations, eval at 10, a
log line a step, and synthetic data when the config's datasets are not
registered; without it a dataset that is not registered raises, where JAX
falls back to the synthetic data), ``iter_size`` (micro-batches a step), ``ema_decay``
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
import time

import numpy as np
import torch

logger = logging.getLogger("ape_tpu_torch")

ROADMAP_DDP = "ROADMAP Queue 1 #3, item 2: DDP/FSDP"


def setup_logger(output_dir: str = ""):
    """INFO lines of the port's logger on stderr and, with ``output_dir``,
    into its ``log.txt`` (a later call moves the file handler)."""
    logger.setLevel(logging.INFO)
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


def synthetic_loader(batch_size, image_size, num_text, text_dim, max_gt=8, mask_size=None):
    """fast_dev_run data when no dataset is registered (smoke tests, CI):
    JAX's stream, NumPy on the host."""
    mask_size = mask_size or image_size // 4
    rng = np.random.RandomState(0)

    def gen():
        while True:
            n_valid = rng.randint(1, max_gt)
            boxes = np.zeros((batch_size, max_gt, 4), np.float32)
            boxes[:, :, :2] = rng.uniform(0.3, 0.7, (batch_size, max_gt, 2))
            boxes[:, :, 2:] = rng.uniform(0.1, 0.25, (batch_size, max_gt, 2))
            yield {
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

    class Loader:
        def __iter__(self):
            return gen()

    return Loader()


def build_language(cfg, device):
    """The frozen language tower of ``cfg.language`` (the port's EVA02CLIP;
    other kinds wait for their wrappers)."""
    from ape_tpu_torch.modeling.text.wrapper import EVA02CLIP

    lang_cfg = dict(cfg.get("language", {}) or {})
    kind = lang_cfg.pop("kind", "eva02clip")
    if kind != "eva02clip":
        raise NotImplementedError(f"language kind {kind!r}: the port has the EVA-CLIP tower only "
                                  "(the BERT, T5 and Llama-2 wrappers are not ported)")
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


def do_train(args, cfg, device) -> dict:
    """Train as the config says (module docstring). Returns a summary: the
    iterations run, the checkpoints kept, the seconds of each save and of
    the load, the trainer, the model, its optimizer and scheduler."""
    from ape_tpu_torch.checkpoint.checkpointer import Checkpointer, PeriodicCheckpointer
    from ape_tpu_torch.checkpoint.convert import load_checkpoint_tolerant
    from ape_tpu_torch.config import instantiate
    from ape_tpu_torch.data.build import build_detection_train_loader
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
    n_crit = len(cfg.get("criterions", None) or [cfg.criterion])
    criterions = [build_criterion(cfg, i) for i in range(n_crit)]

    opt_cfg = dict(cfg.optimizer)
    if float(opt_cfg.pop("grad_clip", GRAD_CLIP)) != GRAD_CLIP:
        raise NotImplementedError(f"optimizer.grad_clip={cfg.optimizer.grad_clip}: every config "
                                  f"clips at {GRAD_CLIP}, make_train_step's constant")
    optimizer, scheduler = build_optimizer(model, **opt_cfg)
    factor = lr_lambda(opt_cfg.get("milestones", ()), opt_cfg.get("warmup_steps", 0))
    base_lr = float(opt_cfg.get("base_lr", 2e-4))
    iter_size = int(train.get("iter_size", 1))
    ema_decay = float(train.get("ema_decay", 0.0))
    ema = ([p.detach().clone() for p in model.parameters() if p.requires_grad]
           if ema_decay > 0 else None)
    generator = torch.Generator(device=device).manual_seed(seed)

    img = int(train.get("image_size", 1024))
    num_text = int(train.get("num_text", 80))
    text_dim = int(train.get("text_dim", 1024))
    if registered:
        loaders = [build_detection_train_loader(
            list(g["dataset_names"]), instantiate(g["mapper"]),
            int(g.get("batch_size", 1)) * iter_size, g.get("sampler", "TrainingSampler"),
            seed=seed + i, dataset_id=i, filter_empty=bool(g.get("filter_empty", True)),
            copypaste_prob=float(g.get("copypaste_prob", 0.0))) for i, g in enumerate(groups)]
    else:
        logger.warning("datasets not registered; fast_dev_run trains on synthetic data")
        loaders = [synthetic_loader(int(g.get("batch_size", 1)) * iter_size, img, num_text,
                                    text_dim) for g in groups]
    ratio = list(train.get("dataset_ratio", [1.0] * len(groups)))
    mds = MultiDatasetSampler(ratio, seed=seed) if len(loaders) > 1 else None
    text_fn = build_text_fn(cfg)

    ckpt = Checkpointer(train.output_dir, keep=2)
    t0 = time.perf_counter()
    state, start_iter = ckpt.resume_or_load(resume=args.resume)
    if state is not None:
        model.load_state_dict(state["model"])
        optimizer.load_state_dict(state["optimizer"])
        scheduler.load_state_dict(state["scheduler"])
        if ema is not None and state.get("ema") is not None:
            for e, v in zip(ema, state["ema"]):
                e.copy_(v)
        generator.set_state(state["generator"])
        for ld, s in zip(loaders, state.get("loaders", [])):
            if s is not None and hasattr(ld, "load_state_dict"):
                ld.load_state_dict(s)
        if mds is not None and state.get("dataset_sampler") is not None:
            mds.load_state_dict(state["dataset_sampler"])
        if state.get("text_bank") is not None:
            text_fn.bank[...] = state["text_bank"]
    elif train.get("init_checkpoint", ""):
        load_checkpoint_tolerant(train.init_checkpoint, model)
    load_seconds = time.perf_counter() - t0

    def state_fn():
        return {
            "model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(),
            "ema": ema,
            "generator": generator.get_state(),
            "loaders": [ld.state_dict() if hasattr(ld, "state_dict") else None for ld in loaders],
            "dataset_sampler": mds.state_dict() if mds is not None else None,
            "text_bank": text_fn.bank.copy(),
        }

    dataset_prompts = list(train.get("dataset_prompts", []) or [])

    @functools.lru_cache(maxsize=None)
    def _step_fn_for(crit_idx: int, prompt: str):
        return make_train_step(model, criterions[crit_idx], optimizer, scheduler,
                               iter_size=iter_size, ema_decay=ema_decay, prompt=prompt, ema=ema)

    def step_fn_for(ds_id: int):
        # groups sharing one (criterion, prompt type) share one step function
        prompt = dataset_prompts[ds_id] if ds_id < len(dataset_prompts) else "name"
        return _step_fn_for(min(ds_id, len(criterions) - 1), prompt)

    eval_fn = None
    if train.get("eval_period", 0) and cfg.dataloader.get("tests", []):
        def eval_fn():
            with swapped_in(model, ema):
                return run_eval(cfg, model, device)

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
            "trainer": trainer, "model": model, "optimizer": optimizer, "scheduler": scheduler}


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


def main(argv=None, device=None):
    """Parse ``argv`` (default: the command line), load and override the
    config, and train or evaluate. ``device``: where to run (default the
    config's ``train.device``, else the CUDA card, raising without one)."""
    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.device import default_device
    from ape_tpu_torch.engine.defaults import default_argument_parser

    args = default_argument_parser().parse_args(argv)
    if args.num_gpus > 1 or args.num_machines > 1:
        raise NotImplementedError(f"--num-gpus {args.num_gpus} --num-machines "
                                  f"{args.num_machines}: one card and one process until DDP is "
                                  f"ported ({ROADMAP_DDP})")
    cfg = LazyConfig.load(args.config_file)
    LazyConfig.apply_overrides(cfg, [o for o in (args.opts or []) if "=" in o])
    if int(cfg.train.get("fsdp", 1)) > 1:
        raise NotImplementedError(f"train.fsdp={cfg.train.fsdp}: FSDP is not ported "
                                  f"({ROADMAP_DDP})")
    setup_logger(cfg.train.get("output_dir", ""))
    device = torch.device(default_device("train_net", device or cfg.train.get("device", None)))
    if args.eval_only:
        return do_test(args, cfg, device)
    return do_train(args, cfg, device)


if __name__ == "__main__":
    main()
