"""Training across processes (``ape_tpu_torch.parallel.mesh``) on the CPU:
two and four gloo ranks spawned by the port's ``launch``
(``tests/torch_parallel_worker.py``, interpreters that refuse JAX), each
with a collective timeout and a join timeout, on the tiny config
``configs/tests/ape_deta_tiny.py`` with the weights of JAX's init
(``state_dict_from_jax``).

  * DDP at W = 2 and FSDP2 at (data, fsdp) = (1, 2), (2, 1) and (2, 2): the
    loss terms, every parameter's gradient and the parameters after one
    AdamW step equal the one-process step on the global batch (f32, within
    1e-5 of each parameter's largest gradient: only the order of the sums
    differs; the parameters within what AdamW's update makes of the two
    gradients, ``_assert_params_within_update``);
  * the same gradients against JAX's jitted step on its mesh
    (``make_mesh``, ``param_sharding``, ``shard_batch``; 8 virtual CPU
    devices) at ``tests/test_torch_train.py``'s ``GRAD_RTOL``;
  * ``iter_size = 2`` under ``no_sync``; a NaN on one rank raises
    ``FloatingPointError`` on both; every rank takes the same group of a
    two-group mix; extra ranks leave where JAX would idle devices;
  * a checkpoint saved at W = 2 under FSDP2 loads at W = 1 and the other
    way round, its state bit for bit, and the next step on one batch is
    within the bounds above of the uninterrupted one; ``train_net`` resumed
    at W = 2 equals the uninterrupted run bit for bit, and its checkpoint
    loads at W = 1 bit for bit (the loaders' global position carried over);
  * evaluation during training on rank 0 that outlasts the process group's
    timeout: the other rank waits it out (``mesh.run_on_main``).
"""

import copy
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_runtime import write_tiny_setup
from tests.test_torch_train import GRAD_RTOL
from tests.torch_config_tree import ROOT
from tests.torch_parity import flatten, init_params, unflatten

from ape_tpu.config import ConfigDict as JConfigDict
from ape_tpu.config import LazyConfig as JLazyConfig
from ape_tpu.config import instantiate as j_instantiate
from ape_tpu_torch.checkpoint.checkpointer import load_optimizer_state, optimizer_state
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.config import LazyConfig
from ape_tpu_torch.engine.optimizer import build_optimizer
from ape_tpu_torch.engine.train_step import make_train_step
from ape_tpu_torch.model_zoo import build_criterion, build_model

TINY = str(ROOT / "configs" / "tests" / "ape_deta_tiny.py")
GLOBAL = 4  # the global batch: 2 rows a rank at W = 2, 1 at W = 4
GRAD_BOUND = 1e-5  # of each parameter's largest gradient
JOIN_TIMEOUT = 300  # seconds a job of ranks may take before it fails its test
# evaluation on rank 0 that takes EVAL_SLEEP seconds, in a process group whose
# collectives time out after EVAL_GROUP_TIMEOUT
EVAL_GROUP_TIMEOUT, EVAL_SLEEP = 10, 15
STEP_CASES = {"ddp": dict(world=2, wrap="ddp"), "fsdp_1x2": dict(world=2, wrap="fsdp", fsdp=2),
              "fsdp_2x1": dict(world=2, wrap="fsdp", fsdp=1),
              "fsdp_2x2": dict(world=4, wrap="fsdp", fsdp=2)}


def _batch(seed):
    """A global batch: 4 images at 64^2, 8 texts, 1-3 valid targets an
    image (positives stay under the assigners' caps, so JAX's subsample
    and the port's keep the same) with masks at the mask resolution."""
    rng = np.random.RandomState(seed)
    n_valid = np.array([3, 1, 2, 3])
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (GLOBAL, 4, 2)),
                            rng.uniform(0.1, 0.3, (GLOBAL, 4, 2))], -1).astype(np.float32)
    return {"images": rng.randn(GLOBAL, 64, 64, 3).astype(np.float32),
            "image_sizes": np.full((GLOBAL, 2), 64, np.int32),
            "text_features": rng.randn(GLOBAL, 8, 256).astype(np.float32),
            "text_valid": np.ones((GLOBAL, 8), bool),
            "targets": {"labels": rng.randint(0, 8, (GLOBAL, 4)).astype(np.int32), "boxes": boxes,
                        "valid": np.arange(4)[None] < n_valid[:, None],
                        "masks": (rng.rand(GLOBAL, 4, 16, 16) > 0.7).astype(np.float32)}}


def _tensors(batch):
    if isinstance(batch, dict):
        return {k: _tensors(v) for k, v in batch.items()}
    t = torch.from_numpy(batch)
    return t.long() if t.dtype == torch.int32 else t


def _one_process(weights, batch, iter_size=1, then=None, ckpt=None):
    """The port's one-process step on the global batch, as the worker saves
    its ranks' steps: from ``ckpt`` (a checkpoint's dict) when given, a step
    on ``batch`` (None: none), and with ``then`` a second step on it."""
    cfg = LazyConfig.load(TINY)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(weights)
    opt_cfg = dict(cfg.optimizer)
    opt_cfg.pop("grad_clip")
    optimizer, scheduler = build_optimizer(model, **opt_cfg)
    if ckpt is not None:
        model.load_state_dict(ckpt["model"])
        load_optimizer_state(model, optimizer, ckpt["optimizer"])
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler, iter_size=iter_size)
    lr = {id(p): g["lr"] for g in optimizer.param_groups for p in g["params"]}
    out = {}
    if ckpt is not None:
        out["loaded"] = {"model": copy.deepcopy(model.state_dict()),
                         "optimizer": copy.deepcopy(optimizer_state(model, optimizer))}
    for key, b, seed in (("first", batch, 0), ("second", then, 1)):
        if b is None:
            continue
        metrics = step(_tensors(b), torch.Generator().manual_seed(seed))
        out[key] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "params": copy.deepcopy(model.state_dict()),
            "optimizer": copy.deepcopy(optimizer_state(model, optimizer)),
            "lr": {n: lr[id(p)] for n, p in model.named_parameters()}}
    return out


def _run_job(tmp, name, job):
    """Start ``tests/torch_parallel_worker.py`` on a job; returns the process."""
    path = tmp / f"{name}.job.pt"
    torch.save({"threads": 1, **job}, path)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_worker", str(path)],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait(proc):
    out, _ = proc.communicate(timeout=JOIN_TIMEOUT)
    assert proc.returncode == 0, out[-4000:]
    return out


TWO_GROUPS = textwrap.dedent("""
    from ape_tpu.config import LazyConfig

    _base = LazyConfig.load({tiny!r})
    model, criterion, optimizer, train = _base.model, _base.criterion, _base.optimizer, _base.train
    train.dataset_ratio = [1.0, 3.0]
    dataloader = dict(train=dict(groups=[dict(dataset_names=[], batch_size=2),
                                         dict(dataset_names=[], batch_size=2)]), tests=[])
""")


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """The jobs that need nothing of ``setup``, started first: the
    two-group mix at W = 2, three ranks through the command line, and
    ``train_net`` under FSDP2 at W = 2 for two steps."""
    from tests.test_torch_train_net import RUN

    tmp = tmp_path_factory.mktemp("parallel_background")
    cfg = tmp / "two_groups.py"
    cfg.write_text(TWO_GROUPS.format(tiny=TINY))
    groups = _run_job(tmp, "groups", dict(kind="train_net", world=2, out=str(tmp / "groups.pt"),
                                          argv=["--config-file", str(cfg),
                                                f"train.output_dir={tmp / 'groups'}"]))
    leave_cfg = write_tiny_setup(tmp / "leave", "parallel_leave")
    leave = subprocess.Popen(
        [sys.executable, "-c", RUN, "--num-gpus", "3", "--config-file", leave_cfg,
         "train.device=cpu", f"train.output_dir={tmp / 'leave_out'}", "train.max_iter=1",
         "train.eval_period=0"], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    tn_cfg = write_tiny_setup(tmp / "tn", "parallel_ckpt")
    tn_common = ["--config-file", tn_cfg, "train.checkpoint_period=1", "train.eval_period=0",
                 "train.log_period=1"]
    whole = _run_job(tmp, "whole", dict(
        kind="train_net", world=2, out=str(tmp / "whole.pt"),
        argv=tn_common + ["train.fsdp=2", f"train.output_dir={tmp / 'c'}", "train.max_iter=2"]))
    slow_eval = _run_job(tmp, "slow_eval", dict(
        kind="train_net", world=2, out=str(tmp / "slow_eval.pt"), timeout=EVAL_GROUP_TIMEOUT,
        eval_sleep=EVAL_SLEEP, argv=["--config-file", TINY, f"train.output_dir={tmp / 'e'}",
                                     "train.max_iter=3", "train.eval_period=2",
                                     "train.checkpoint_period=100"]))
    return dict(tmp=tmp, groups=groups, leave=leave, whole=whole, tn_common=tn_common,
                slow_eval=slow_eval)


@pytest.fixture(scope="module")
def setup(background, tmp_path_factory):
    """The weights, the global batch, the one-process steps and the rank
    jobs' results (the W = 2 and W = 4 jobs run side by side)."""
    tmp = tmp_path_factory.mktemp("parallel")
    jm = j_instantiate(JConfigDict(model=JLazyConfig.load(TINY).model))["model"]
    flat, _ = init_params(jm, jnp.zeros((1, 64, 64, 3)), jnp.asarray([[64, 64]]),
                          jnp.zeros((1, 8, 256)), jnp.ones((1, 8), bool), heads=2)
    # the MSDA offset kernels at 0, the reference's init: with random ones a
    # sample's location follows the activations, and a rounding-size change
    # of them (a rank's products take fewer rows) moves a sample across a
    # pixel, where its location gradient is one-sided (tests/
    # test_torch_train.py's masked_pair saw 1.8e-2 from that)
    flat = {k: (np.zeros_like(v) if re.fullmatch(r".*sampling_offsets/kernel", k) else v)
            for k, v in flat.items()}
    tree = unflatten(flat)
    weights = state_dict_from_jax(flat)
    torch.save(weights, tmp / "weights.pt")
    batch, batch2 = _batch(5), _batch(6)
    torch.save(batch, tmp / "batch.pt")
    torch.save(batch2, tmp / "batch2.pt")
    # W = 1: a step, its checkpoint (for the W = 2 job to load), the next step
    w1 = _one_process(weights, batch, then=batch2)
    torch.save({"model": w1["first"]["params"], "optimizer": w1["first"]["optimizer"]},
               tmp / "w1.ckpt.pt")
    common = dict(kind="steps", weights=str(tmp / "weights.pt"), batch=str(tmp / "batch.pt"))
    two = [dict(STEP_CASES[c], out=str(tmp / f"{c}.pt")) for c in ("ddp", "fsdp_2x1")]
    two += [dict(STEP_CASES["fsdp_1x2"], out=str(tmp / "fsdp_1x2.pt"),
                 save=str(tmp / "w2.ckpt.pt"), then=str(tmp / "batch2.pt"),
                 out2=str(tmp / "w2_second.pt")),
            dict(STEP_CASES["fsdp_1x2"], load=str(tmp / "w1.ckpt.pt"),
                 loaded=str(tmp / "w1_at_w2.pt"), then=str(tmp / "batch2.pt"),
                 out2=str(tmp / "w1_at_w2_second.pt")),
            dict(wrap="ddp", iter_size=2, out=str(tmp / "iter2.pt")),
            dict(wrap="ddp", nan_rank=1, out=str(tmp / "nan.pt"))]
    jobs = [_run_job(tmp, "two", dict(common, world=2, scenarios=two)),
            _run_job(tmp, "four", dict(common, world=4, scenarios=[
                dict(STEP_CASES["fsdp_2x2"], out=str(tmp / "fsdp_2x2.pt"))]))]
    ref = {1: w1["first"], 2: _one_process(weights, batch, iter_size=2)["first"]}
    for proc in jobs:
        _wait(proc)
    # W = 2's checkpoint at W = 1, and its next step
    w2_at_w1 = _one_process(weights, None, then=batch2,
                            ckpt=torch.load(tmp / "w2.ckpt.pt", weights_only=False))
    return dict(tmp=tmp, jm=jm, tree=tree, batch=batch, ref=ref, w1=w1, w2_at_w1=w2_at_w1)


def _load(setup, name):
    return torch.load(setup["tmp"] / f"{name}.pt", weights_only=False)


EPS = 1e-8  # AdamW's


def _adam_direction(m, v, t):
    """AdamW's bias-corrected step direction after t steps from its moments,
    in f64."""
    m, v = m.double(), v.double()
    return (m / (1 - 0.9 ** t)) / ((v / (1 - 0.999 ** t)).sqrt() + EPS)


def _assert_params_within_update(got, want, gaps, lr):
    """Parameters that started equal, after a step whose gradients differ
    within the bound: apart by no more than the learning rate times the gap
    between the two AdamW directions (``gaps``, by name; a gradient at
    AdamW's eps, ~1e-8, turns a 1e-10 difference into a visible one) and
    one f32 rounding of each update and of the result."""
    f32 = torch.finfo(torch.float32).eps
    for name, w in want.items():
        gap = gaps.get(name, torch.zeros_like(w, dtype=torch.float64))
        rounding = f32 * torch.maximum(got[name].abs(), w.abs()).double() + 2 * f32 * lr.get(
            name, 0.0)
        bound = rounding + lr.get(name, 0.0) * gap
        diff = (got[name] - w).abs().double()
        assert bool((diff <= bound).all()), (name, float(diff.max()))


def _assert_step_equal(got, want, t=1):
    """Loss terms, every gradient within 1e-5 of its largest entry, the
    clip's norm, and the parameters after AdamW's ``t``-th step (from
    moments equal before it)."""
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-6, atol=1e-7, err_msg=k)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, w in want["grads"].items():
        bound = GRAD_BOUND * float(w.abs().max())
        assert float((got["grads"][name] - w).abs().max()) <= bound, name
    assert sorted(got["params"]) == sorted(want["params"])
    gaps = {}
    for name, a in got["optimizer"]["state"].items():
        b = want["optimizer"]["state"][name]
        gaps[name] = (_adam_direction(a["exp_avg"], a["exp_avg_sq"], t)
                      - _adam_direction(b["exp_avg"], b["exp_avg_sq"], t)).abs()
    _assert_params_within_update(got["params"], want["params"], gaps, want["lr"])


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_rank_step_equals_one_process(setup, case):
    """DDP and FSDP2's W-rank step against the one-process step on the
    global batch."""
    got = _load(setup, case)
    assert got["rows"] == GLOBAL // STEP_CASES[case]["world"]
    _assert_step_equal(got, setup["ref"][1])


def test_iter_size_two_under_no_sync(setup):
    """Two micro-batches, the first backward without the reduction: the
    one-process step with ``iter_size = 2`` on the global batch."""
    got = _load(setup, "iter2")
    assert got["rows"] == GLOBAL // 2 and "loss_class" not in got["metrics"]
    _assert_step_equal(got, setup["ref"][2])


def test_nan_on_one_rank_raises_on_both(setup):
    """A NaN pixel on rank 1 alone: the averaged loss is NaN on both ranks,
    and both raise before the update."""
    for rank in (0, 1):
        marker = setup["tmp"] / f"nan.pt.rank{rank}"
        assert marker.exists(), rank
        assert "non-finite" in marker.read_text()


def _jax_mesh_grads(setup, fsdp):
    """JAX's loss terms and gradients of the global batch, jitted on a
    (2, fsdp) mesh of the virtual CPU devices with its parameter and batch
    shardings."""
    from ape_tpu.modeling.ape_deta import criterion as j_criterion
    from ape_tpu.parallel.mesh import make_mesh, param_sharding, shard_batch

    jm, batch = setup["jm"], setup["batch"]
    node = JLazyConfig.load(TINY).criterion
    crit = j_instantiate(JConfigDict(criterion=node))["criterion"]
    assert isinstance(crit, j_criterion.DeformableCriterion)
    mesh = make_mesh(n_devices=2 * fsdp, fsdp=fsdp)
    params = jax.device_put(setup["tree"], param_sharding(mesh, setup["tree"], min_size=2**10))
    sharded = shard_batch(mesh, {k: jnp.asarray(v) if not isinstance(v, dict) else
                                 {kk: jnp.asarray(vv) for kk, vv in v.items()}
                                 for k, v in batch.items()})

    def loss(p, b):
        out = jm.apply({"params": p}, b["images"], b["image_sizes"], b["text_features"],
                       b["text_valid"], deterministic=False, align_on_fused=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        nb = jnp.clip(jnp.sum(b["targets"]["valid"].astype(jnp.float32)), 1.0)
        losses = crit(jax.random.PRNGKey(0), out, b["targets"], nb, None)
        return crit.total(losses), losses

    (total, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, sharded)
    grads = state_dict_from_jax({k: np.asarray(v) for k, v in flatten(grads).items()})
    return float(total), {k: float(v) for k, v in losses.items()}, grads


@pytest.fixture(scope="module")
def jax_mesh(setup):
    """JAX's step on its (data, fsdp) = (2, 2) mesh."""
    return _jax_mesh_grads(setup, 2)


@pytest.mark.parametrize("case", ["ddp", "fsdp_1x2", "fsdp_2x2"])
def test_rank_step_equals_jax_mesh(setup, jax_mesh, case):
    """The ranks' loss terms and gradients (the clip undone) against JAX's
    step on its own mesh, with data over one axis and the parameters
    sharded over the other."""
    got = _load(setup, case)
    total, losses, grads = jax_mesh
    for k, v in losses.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["metrics"]["total_loss"], total, rtol=1e-4)
    norm = got["metrics"]["grad_norm"]
    unclip = (norm + 1e-6) / 0.1 if norm > 0.1 else 1.0
    bad = {}
    for name, w in grads.items():
        g = got["grads"].get(name, torch.zeros_like(w)) * unclip
        err = float((g - w).abs().max())
        if err > max(GRAD_RTOL * float(w.abs().max()), 1e-5):
            bad[name] = err
    assert not bad




def test_ranks_take_the_same_group(background):
    """A two-group mix over 20 fast_dev_run steps at W = 2: both ranks take
    the same group every step, and both groups come up."""
    _wait(background["groups"])
    out = background["tmp"] / "groups.pt"
    ids = [torch.load(f"{out}.ids{r}") for r in (0, 1)]
    assert len(ids[0]) == 20 and ids[0] == ids[1]
    assert set(ids[0]) == {0.0, 1.0}


def test_extra_ranks_leave(background):
    """Three ranks for a micro-batch of 2 (``--num-gpus 3``): JAX's data axis
    is gcd(2, 3) = 1, so ranks 1 and 2 log that they leave and rank 0
    trains alone."""
    log = _wait(background["leave"])
    for rank in (1, 2):
        assert f"rank {rank} leaves: the mesh (data=1, fsdp=1) takes 1 of 3 ranks" in log
    assert (background["tmp"] / "leave_out" / "model_final.pth").exists()


def test_evaluation_outlasts_the_group_timeout(background):
    """Evaluation during training (``eval_period``) on rank 0 that takes
    longer than a collective may wait: rank 1 waits for it all the same,
    and both ranks finish; rank 0 returns the results, rank 1 none."""
    _wait(background["slow_eval"])
    out = background["tmp"] / "slow_eval.pt"
    evaluated = [torch.load(f"{out}.evaluated{r}") for r in (0, 1)]
    assert evaluated == [[{"slow": {"AP": 1.0}}], [{}]]
    assert torch.load(out, weights_only=False)["start_iter"] == 0


def _same(a, b) -> bool:
    """Nested dicts, lists, tensors and arrays equal bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, torch.as_tensor(b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_checkpoint_w2_loads_at_w1(setup):
    """FSDP2's checkpoint at W = 2 (one-process format: names, full tensors,
    the optimizer's state keyed by name) in one process: the loaded model and
    optimizer equal it bit for bit, and the next step is the W = 2 run's
    next step within the bounds."""
    saved = _load(setup, "w2.ckpt")
    assert not any(k.startswith("module.") for k in saved["model"])
    loaded = setup["w2_at_w1"]["loaded"]
    assert _same(saved["model"], loaded["model"])
    assert _same(saved["optimizer"], loaded["optimizer"])
    _assert_step_equal(_load(setup, "w2_second"), setup["w2_at_w1"]["second"], t=2)


def test_checkpoint_w1_loads_at_w2(setup):
    """A one-process checkpoint under FSDP2 at W = 2: the state the ranks
    hold, gathered, equals it bit for bit, and their next step is the
    one-process run's next step within the bounds."""
    saved = _load(setup, "w1.ckpt")
    loaded = _load(setup, "w1_at_w2")
    assert _same(saved["model"], loaded["model"])
    assert _same(saved["optimizer"], loaded["optimizer"])
    _assert_step_equal(_load(setup, "w1_at_w2_second"), setup["w1"]["second"], t=2)


def test_train_net_resumes_across_world_sizes(background):
    """``train_net`` under FSDP2 at W = 2 for two steps, a checkpoint after
    each: resumed from the first, its second step equals the uninterrupted
    run's bit for bit (each rank its own loader position and mapper
    draws); one process resumes the same checkpoint with the model,
    optimizer, dataset sampler and text bank bit for bit and the loaders'
    global position carried over."""
    from ape_tpu_torch.tools import train_net

    tmp, common = background["tmp"], background["tn_common"]
    _wait(background["whole"])
    want = torch.load(tmp / "c" / "model_final.pth", weights_only=False)
    dumped = torch.load(tmp / "whole.pt", weights_only=False)
    for k in ("model", "optimizer", "loaders"):
        assert _same(want[k], dumped[k]), k
    for d in ("b", "d"):  # the run as it stood after its first step
        shutil.copytree(tmp / "c", tmp / d)
        (tmp / d / "model_final.pth").unlink()
        (tmp / d / "checkpoints.json").write_text(json.dumps([[1, "model_0000001.pth"]]))
    saved = torch.load(tmp / "b" / "model_0000001.pth", weights_only=False)
    assert saved["iteration"] == 1 and len(saved["loaders"][0]["chunks"]) == 2
    resumed = _run_job(tmp, "resumed", dict(
        kind="train_net", world=2, out=str(tmp / "resumed.pt"),
        argv=["--resume"] + common + ["train.fsdp=2", f"train.output_dir={tmp / 'd'}",
                                      "train.max_iter=2"]))
    summary = train_net.main(["--resume"] + common + [f"train.output_dir={tmp / 'b'}",
                                                      "train.max_iter=1"], device="cpu")
    assert summary["start_iter"] == 1
    assert _same(saved["model"], summary["model"].state_dict())
    assert _same(saved["optimizer"], optimizer_state(summary["model"], summary["optimizer"]))
    assert _same(saved["text_bank"], summary["trainer"].text_fn.bank)
    position = sum(c["consumed"] for c in saved["loaders"][0]["chunks"])
    assert summary["trainer"].loaders[0].state_dict()["consumed"] == position == 2
    _wait(resumed)
    got = torch.load(tmp / "d" / "model_final.pth", weights_only=False)
    assert want["iteration"] == got["iteration"] == 2
    for k in ("model", "optimizer", "loaders", "scheduler", "generator"):
        assert _same(want[k], got[k]), k


FSDP_CONFIGS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*_fsdp.py"))


@pytest.mark.parametrize("config", FSDP_CONFIGS)
def test_fsdp_configs_build(config):
    """Every ``_fsdp`` config loads and builds through the port's model zoo
    (the structure, on the meta device) with ``train.fsdp`` read: on eight
    ranks JAX's arithmetic gives the mesh (data, fsdp) = (4, 2)."""
    from ape_tpu_torch.parallel import mesh
    from ape_tpu_torch.tools.train_net import _train_groups

    cfg = LazyConfig.load(str(ROOT / config))
    assert int(cfg.train.fsdp) == 2
    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) > 3e8
    assert build_criterion(cfg).num_classes > 0
    micro = [int(g.get("batch_size", 1)) for g in _train_groups(cfg)]
    assert mesh.data_axis(micro, 8, cfg.train.fsdp) == (4, 2)
